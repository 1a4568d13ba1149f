"""Segment reductions over dst-sorted arc arrays, on torch tensors.

`segment_or_bool` and `segment_sum` scatter into a zero tensor with
`include_self=True`, so an empty segment reduces to False / 0 -- the JAX
package reaches the same result by comparing `segment_max > 0`.
"""
from __future__ import annotations

import torch


def segment_or_bool(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Boolean OR-reduce [m, C] by segment -> bool[num_segments, C]."""
    acc = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=torch.int32, device=values.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    acc.scatter_reduce_(0, idx.expand_as(values), values.to(torch.int32),
                        "amax", include_self=True)
    return acc > 0


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum [m, C] by segment -> [num_segments, C]; integer sums are exact."""
    acc = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return acc.index_add_(0, segment_ids.long(), values)
