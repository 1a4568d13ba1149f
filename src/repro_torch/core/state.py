"""Per-vertex / per-edge pruning state (paper Alg. 2) and pack/unpack helpers.

Canonical single-device representation, as torch tensors on one device:
  omega:       bool[n, n0]   — candidate template vertices per background vertex
  edge_active: bool[m]       — per arc, in the dst-sorted DeviceGraph order

The bitset kernels use the packed form: W = ceil(n0/32) words per vertex.
PyTorch has no shifts or comparisons on uint32, so a packed word is an int32
with the same bit pattern as the JAX package's uint32 word (bit 31 is the
sign bit; `(w >> s) & 1` still reads bit s under the arithmetic shift).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.graph.structs import DeviceGraph, resolve_device
from repro_torch.core.template import Template


def packed_words(n0: int) -> int:
    return (n0 + 31) // 32


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def source_bits(n: int, rows: torch.Tensor, bits: torch.Tensor
                ) -> torch.Tensor:
    """int32[n, S/32] (S % 32 == 0) with bit j % 32 of word j // 32 of row
    rows[j] (int64[S]) set where bits[j] (bool[S]), all else 0. Each column
    names one (row, word, bit), so the values scattered into one word are
    distinct bits: their int32 sum stays within int32 at every step (the
    bits below 31 sum to under 2^31, bit 31 is -2^31) and is their OR."""
    S = rows.shape[0]
    W = S // 32
    cols = torch.arange(S, device=rows.device)
    one = torch.ones(S, dtype=torch.int32, device=rows.device)
    words = torch.zeros(n * W, dtype=torch.int32, device=rows.device)
    words.scatter_add_(0, rows * W + cols // 32,
                       bits.to(torch.int32) * (one << (cols % 32).to(torch.int32)))
    return words.view(n, W)


def seeded_frontier(seeds: torch.Tensor, cand0: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """A wave's hop-0 frontier -> int32[n, S/32]: bit j of row seeds[j] set
    where seeds[j] >= 0 (-1 = a pad) and cand0[seeds[j]] (bool[n])."""
    safe = seeds.long().clamp(0, n - 1)
    return source_bits(n, safe, (seeds >= 0) & cand0[safe])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., n0] -> int32[..., W]; bit b of word w is column 32*w + b.
    One word at a time, so the int64 intermediate is 32 columns wide."""
    n0 = bits.shape[-1]
    W = packed_words(n0)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    out = torch.empty(bits.shape[:-1] + (W,), dtype=torch.int32,
                      device=bits.device)
    for w in range(W):
        b = bits[..., 32 * w: 32 * (w + 1)].to(torch.int64)
        out[..., w] = as_int32_bits(
            torch.sum(b << shifts[: b.shape[-1]], dim=-1))
    return out


def unpack_bits(words: torch.Tensor, n0: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., n0], one word at a time."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    W = words.shape[-1]
    out = torch.empty(words.shape[:-1] + (W * 32,), dtype=torch.bool,
                      device=words.device)
    for w in range(W):
        out[..., 32 * w: 32 * (w + 1)] = (words[..., w, None] >> shifts) & 1
    return out[..., :n0]


@dataclasses.dataclass
class PruneState:
    omega: torch.Tensor  # bool[n, n0]
    edge_active: torch.Tensor  # bool[m] (dst-sorted arc order)

    def counts(self) -> Dict[str, int]:
        return {
            "active_vertices": int(torch.sum(torch.any(self.omega, dim=1))),
            "active_edges": int(torch.sum(self.edge_active)),
            "omega_bits": int(torch.sum(self.omega)),
        }


def solution_counts(state: PruneState) -> Dict[str, int]:
    """The state's active vertices, active arcs and omega bits."""
    return state.counts()


def init_state(dg: DeviceGraph, template: Template) -> PruneState:
    """Alg. 2 initialization: omega(v) = {q : l(q) == l(v)}; all edges active."""
    n_labels = max(int(template.labels.max()) + 1, int(torch.max(dg.labels)) + 1)
    lm = torch.from_numpy(template.label_matrix(n_labels)).to(dg.device)  # [n0, L]
    omega = lm.T[dg.labels.long()]  # [n, n0]
    edge_active = torch.ones((dg.m,), dtype=torch.bool, device=dg.device)
    return PruneState(omega=omega, edge_active=edge_active)


def state_from_numpy(omega: np.ndarray, edge_active: np.ndarray,
                     device=None) -> PruneState:
    """A pruning state given as host arrays (for example the JAX package's
    `PruneState` read back with `np.asarray`) as the port's state on
    `device`: the way a run carries state across from the reference."""
    dev = resolve_device(device)
    return PruneState(
        omega=torch.from_numpy(np.asarray(omega, dtype=bool).copy()).to(dev),
        edge_active=torch.from_numpy(
            np.asarray(edge_active, dtype=bool).copy()).to(dev),
    )
