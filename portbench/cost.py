"""The yardstick of the kernel probes: the least work of a `bitset_spmm` and
a `bitset_wave` call on given inputs, and the time bound that work gives on
the card.

Frozen copies of the formulas the program's chip checks use, so that a
change to the program cannot move them. Each input byte is read once and
each output byte written once; where the work depends on the data (active
arcs, candidates) the count is what these inputs need.

The rates are the NVIDIA H100 SXM data sheet's at its 700 W power limit:
3.35 TB/s of HBM3, and 67 TFLOP/s of f32 outside the tensor cores, the rate
taken for 32-bit integer and bitwise work. A card held below 700 W runs
slower than these; a share of the bound is stated against them, with the
card's power limit beside it.
"""
from __future__ import annotations

from typing import Tuple

import torch

HBM_BW = 3.35e12          # bytes/s of device memory
PEAK_FLOPS = 989e12       # dense bf16 FLOP/s on the tensor cores
PEAK_FLOPS_F32 = 67e12    # f32 FLOP/s (and int32 op/s) outside the tensor cores

Cost = Tuple[int, int]


def spmm_cost(g, edge_active: torch.Tensor, w: int) -> Cost:
    """(bytes, operations) one bitset_spmm call must at least spend: the
    active flag of every arc, the source of every active arc, the dst
    offsets, each vals row an active arc reads, and n rows written; one OR
    per word per active arc. `g` has n, m, src, dst and dst_ptr."""
    active = int(edge_active.sum())
    rows = int(torch.unique(g.src[edge_active]).numel())
    nbytes = g.m + active * 4 + (g.n + 1) * 8 + rows * 4 * w + g.n * 4 * w
    return nbytes, active * w


def wave_cost(g, edge_active: torch.Tensor, cand: torch.Tensor, w: int) -> Cost:
    """(bytes, operations) the L hops of bitset_wave must at least spend:
    the L candidacy rows, the offsets and in-arcs (active flag, and source
    if active) of every vertex that is a candidate in some hop, the vals
    rows the first hop reads, and the [n, W] output written once. The
    frontiers between hops need not leave the chip, so they count no bytes.
    Operations: per hop, one OR per word per active in-arc of a candidate
    and one AND per word per candidate."""
    live = cand != 0                                        # bool[L, n]
    any_live = live.any(0)
    deg = g.dst_ptr[1:] - g.dst_ptr[:-1]
    active_in = torch.bincount(g.dst[edge_active].long(), minlength=g.n)
    first = edge_active & live[0][g.dst.long()]
    rows = int(torch.unique(g.src[first]).numel())
    nbytes = (g.n * 4 * w + cand.numel() * 4 + int(any_live.sum()) * 16
              + int(deg[any_live].sum()) + int(active_in[any_live].sum()) * 4
              + rows * 4 * w)
    ops = sum((int(active_in[live[r]].sum()) + int(live[r].sum())) * w
              for r in range(cand.shape[0]))
    return nbytes, ops


def bound(cost: Cost, peak: float = PEAK_FLOPS_F32) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    nbytes, ops = cost
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
