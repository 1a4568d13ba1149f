"""Segment reductions over arc arrays, on torch tensors.

`segment_or_bool` and `segment_sum` scatter into a zero tensor with
`include_self=True`, so an empty segment reduces to False / 0 -- the JAX
package reaches the same result by comparing `segment_max > 0`.

`segment_max` and `segment_min` keep the JAX package's empty-segment values:
the identity of the reduction, -inf / +inf for floats and the type's
min / max for integers (`jax.ops.segment_max` / `segment_min`). They scatter
into a tensor filled with that identity, so a segment no index names keeps
it. The GNN layers read an empty segment's min and max through that value
(`models/gnn.py`, `_agg_stats`).

Segment ids need not be sorted.
"""
from __future__ import annotations

import torch


def _expand_ids(segment_ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    idx = segment_ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return idx.expand_as(values)


def segment_or_bool(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Boolean OR-reduce [m, C] by segment -> bool[num_segments, C]."""
    acc = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=torch.int32, device=values.device)
    acc.scatter_reduce_(0, _expand_ids(segment_ids, values),
                        values.to(torch.int32), "amax", include_self=True)
    return acc > 0


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum [m, ...] by segment -> [num_segments, ...]; integer sums are exact."""
    acc = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return acc.index_add_(0, segment_ids.long(), values)


def _identity(dtype: torch.dtype, high: bool) -> float:
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def _segment_extreme(values, segment_ids, num_segments, reduce, high):
    acc = torch.full((num_segments,) + tuple(values.shape[1:]),
                     _identity(values.dtype, high), dtype=values.dtype,
                     device=values.device)
    return acc.scatter_reduce_(0, _expand_ids(segment_ids, values), values,
                               reduce, include_self=True)


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max [m, ...] by segment; an empty segment holds -inf (integer min)."""
    return _segment_extreme(values, segment_ids, num_segments, "amax", False)


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Min [m, ...] by segment; an empty segment holds +inf (integer max)."""
    return _segment_extreme(values, segment_ids, num_segments, "amin", True)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Number of entries per segment -> [num_segments] of `dtype`."""
    ones = torch.ones(segment_ids.shape[:1], dtype=dtype,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean by segment; an empty segment's mean is 0."""
    s = segment_sum(values, segment_ids, num_segments)
    cnt = segment_count(segment_ids, num_segments, values.dtype)
    return s / cnt.clamp_min(1).reshape((-1,) + (1,) * (values.dim() - 1))


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Edge-softmax (GAT): softmax over entries grouped by segment."""
    ids = segment_ids.long()
    mx = segment_max(scores, segment_ids, num_segments)
    ex = torch.exp(scores - mx[ids])
    den = segment_sum(ex, segment_ids, num_segments)
    return ex / den[ids].clamp_min(1e-16)


class _Variance(torch.autograd.Function):
    """E[x^2] - mean^2 with the product kept exact: one rounding, after the
    difference, as an FMA gives it. XLA contracts the reference's
    `sq / degc - mean * mean` into fma(-mean, mean, sq / degc) on the CPU;
    rounding mean^2 first as well loses what digits the cancellation left
    at a vertex whose neighbours are close in a column, and its 1e-12
    floor then turns that noise into a gradient of up to 5e5 x d var / dx.
    The product of two f32 values is exact in float64, so the difference is
    taken there and rounded once. Where a segment's samples are all equal
    in a column (`flat`: one sample, a repeated arc, a column ReLU zeroed)
    the variance is exactly 0, as the reference computes it where XLA does
    not contract; the FMA's residue there would stand in for it. The
    backward is the formula's, in the input's type: nothing wider is
    saved."""

    @staticmethod
    def forward(ctx, sq_mean, mean, flat):
        var = (sq_mean.double() - mean.double() * mean.double()).to(sq_mean.dtype)
        ctx.save_for_backward(mean)
        return torch.where(flat, 0.0, var)

    @staticmethod
    def backward(ctx, g):
        (mean,) = ctx.saved_tensors
        return g, -(g * mean) * 2, None


def mean_and_std(s: torch.Tensor, sq: torch.Tensor, deg: torch.Tensor,
                 mn: torch.Tensor, mx: torch.Tensor):
    """PNA's mean and std from a segment's sum s, sum of squares sq, min mn
    and max mx [..., F] over deg [...] samples: mean = s / max(deg, 1),
    std = sqrt(max(sq / max(deg, 1) - mean^2, 0) + 1e-12) (`_Variance` for
    the rounding; 0 where mn == mx). The 1e-12 keeps d std / d var finite
    at 0, and `torch.maximum` splits its gradient at a tie as `jnp.maximum`
    does."""
    degc = deg.clamp_min(1.0)[..., None]
    mean = s / degc
    var = _Variance.apply(sq / degc, mean, mn == mx)
    std = torch.sqrt(torch.maximum(var, torch.zeros_like(var)) + 1e-12)
    return mean, std
