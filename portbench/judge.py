"""What decides `correct`: every query's output held to the reference.

Inside the window each query's output (omega, and the arcs it keeps whose
endpoints both stay active, as the program's `PruneResult.edge_mask`
defines them) is reduced on the device to a fingerprint: the number of
omega pairs and of arcs, and an order-free 64-bit hash of each key set.
The first output of each template with a given fingerprint is also copied
to the host whole. Once the window has closed, each such output is
compared with the reference's key sets exactly, and counts for every query
that gave the same fingerprint.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

# splitmix64's multipliers, as signed 64-bit integers
_M1 = 0x9E3779B97F4A7C15 - (1 << 64)
_M2 = 0xBF58476D1CE4E5B9 - (1 << 64)


def _mix(k: torch.Tensor) -> torch.Tensor:
    x = k * _M1
    x = x ^ (x >> 31)
    x = x * _M2
    return x ^ (x >> 29)


@dataclasses.dataclass
class _Output:
    omega_keys: np.ndarray
    arc_keys: np.ndarray
    count: Optional[int]
    queries: int = 0


class Outputs:
    """Every query's output, by template and fingerprint."""

    def __init__(self, n: int):
        self.n = n
        self._seen: Dict[tuple, _Output] = {}
        self.queries = 0
        self.missing = 0

    def take(self, template: int, omega: torch.Tensor,
             edge_active: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             count: Optional[int] = None) -> None:
        """One query's answer: omega bool[n, n0] and the arc mask over the
        arcs src -> dst, as the program returned them."""
        n0 = omega.shape[1]
        vq = torch.nonzero(omega)
        okeys = vq[:, 0] * n0 + vq[:, 1]
        idx = torch.nonzero(edge_active).flatten()
        s, d = src[idx].long(), dst[idx].long()
        vm = omega.any(dim=1)
        keep = vm[s] & vm[d]
        akeys = s[keep] * self.n + d[keep]
        hashes = torch.stack([_mix(okeys).sum(), _mix(akeys).sum()]).tolist()
        key = (template, okeys.numel(), hashes[0], akeys.numel(), hashes[1],
               count)
        out = self._seen.get(key)
        if out is None:
            out = _Output(
                omega_keys=torch.sort(okeys).values.cpu().numpy(),
                arc_keys=torch.sort(akeys).values.cpu().numpy(),
                count=count)
            self._seen[key] = out
        out.queries += 1
        self.queries += 1

    def substitute(self, answers: Dict[int, "object"]) -> None:
        """Put answers (by template) where the program's stood: the
        control is judged in the program's place."""
        for (t, *_), out in self._seen.items():
            a = answers[t]
            out.omega_keys, out.arc_keys, out.count = (
                a.omega_keys, a.arc_keys, a.count)

    def templates(self) -> List[int]:
        return sorted({k[0] for k in self._seen})

    def judge(self, refs: Dict[int, "object"], with_count: bool) -> Dict[str, dict]:
        """The numbers compared, each with its limit: omega pairs and arcs
        that differ from the reference, summed over the queries, match
        counts off by, and queries that gave no answer."""
        omega_diff = arc_diff = count_diff = 0
        for (t, *_), out in self._seen.items():
            ref = refs[t]
            omega_diff += out.queries * np.setxor1d(
                out.omega_keys, ref.omega_keys, assume_unique=True).size
            arc_diff += out.queries * np.setxor1d(
                out.arc_keys, ref.arc_keys, assume_unique=True).size
            if with_count:
                count_diff += out.queries * (
                    abs(out.count - ref.count)
                    if out.count is not None and ref.count is not None
                    else 1)
        checks = {"omega_diff": {"value": omega_diff, "limit": 0},
                  "arc_diff": {"value": arc_diff, "limit": 0}}
        if with_count:
            checks["count_diff"] = {"value": count_diff, "limit": 0}
        checks["missing"] = {"value": self.missing, "limit": 0}
        return checks
