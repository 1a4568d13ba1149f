"""Graph statistics for plan-level query optimization.

The planner (`core/planner.py`) costs candidate constraint orders with a
survival model driven by two histograms: how many vertices carry each label
(the selectivity of a label-candidacy test) and how out-degrees are
distributed (the fan-out of a token-forwarding step). On a `DeviceGraph`
both are computed on its device and read back together, one host read
whatever the graph's size; a host `Graph` takes numpy.

Stats are summarised into a coarse bucket string: plans are tuned per
(template signature, stats bucket), so a plan tuned on one R-MAT instance
applies to any graph of the same rough scale, density and label skew.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.graph.structs import DeviceGraph, Graph

# log2-bucketed degree histogram: bucket i holds vertices of out-degree in
# [2^(i-1), 2^i), bucket 0 the isolated ones; 32 buckets cover any int32 graph
DEGREE_BUCKETS = 32


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Host-side summary: label and degree histograms."""

    n: int
    m: int
    label_hist: np.ndarray   # int64[n_labels], vertices per label
    degree_hist: np.ndarray  # int64[DEGREE_BUCKETS], log2-bucketed out-degree

    @property
    def n_labels(self) -> int:
        return int(self.label_hist.shape[0])

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

    def label_skew(self) -> float:
        """max / mean label frequency: 1.0 for uniform labels, large when one
        label dominates."""
        nz = self.label_hist[self.label_hist > 0]
        if nz.size == 0:
            return 1.0
        return float(nz.max() / nz.mean())

    def bucket(self) -> str:
        """Plan-cache bucket: power-of-two vertex count, average degree and
        label-skew class, e.g. ``n2048xd8xs2``."""
        return "n%dxd%dxs%d" % (
            _pow2(self.n),
            _pow2(int(round(self.avg_degree))),
            _pow2(int(round(self.label_skew()))),
        )


def _pow2(d: int) -> int:
    d = max(int(d), 1)
    b = 1
    while b < d:
        b <<= 1
    return b


def collect_graph_stats(g: Union[Graph, DeviceGraph],
                        n_labels: Optional[int] = None) -> GraphStats:
    """Label and degree histograms of a host `Graph` (numpy) or of a
    `DeviceGraph` (on its device, one readback; `n_labels` is then required,
    since reading `labels.max()` would be a second readback)."""
    if isinstance(g, Graph):
        nl = int(n_labels) if n_labels is not None else g.n_labels
        label_hist = np.bincount(g.labels, minlength=max(nl, 1)).astype(np.int64)
        deg = g.degrees()
        buckets = np.where(deg > 0, np.ceil(np.log2(deg + 1)), 0).astype(np.int64)
        buckets = np.clip(buckets, 0, DEGREE_BUCKETS - 1)
        degree_hist = np.bincount(buckets, minlength=DEGREE_BUCKETS).astype(np.int64)
        return GraphStats(n=g.n, m=g.m, label_hist=label_hist,
                          degree_hist=degree_hist[:DEGREE_BUCKETS])
    if n_labels is None:
        raise ValueError("n_labels is required for DeviceGraph stats "
                         "(labels.max() would be an extra readback)")
    nl = max(int(n_labels), 1)
    flat = _device_histograms(g.labels, g.src, g.n, nl).cpu().numpy()
    return GraphStats(n=g.n, m=g.m, label_hist=flat[:nl].astype(np.int64),
                      degree_hist=flat[nl:nl + DEGREE_BUCKETS].astype(np.int64))


def _device_histograms(labels: torch.Tensor, src: torch.Tensor, n: int,
                       nl: int) -> torch.Tensor:
    """Label histogram and log2 out-degree histogram as one int64 vector.
    Labels at or past `nl` are not counted, as the JAX package's scatter
    drops them."""
    lab = labels.long()
    label_hist = torch.bincount(lab[lab < nl], minlength=nl)
    deg = torch.bincount(src.long(), minlength=n)
    buckets = torch.where(
        deg > 0, torch.ceil(torch.log2(deg.to(torch.float32) + 1.0)).long(), 0)
    buckets = buckets.clamp(0, DEGREE_BUCKETS - 1)
    degree_hist = torch.bincount(buckets, minlength=DEGREE_BUCKETS)
    return torch.cat([label_hist, degree_hist])
