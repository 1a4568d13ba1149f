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
