"""The least work of each hand-written kernel's call, from its shapes: the
(bytes, operations) a call must spend, each input read once and each output
written once, and the time bound they give on the card (`bound`).

One source for `chip_smoke.py`'s bounds and for the cost counter of the dry
run (`launch/op_cost.py`), which counts a kernel wrapper's call by these
formulas whether the kernel or its plain version runs. The prune's kernels,
whose work depends on the data (the active arcs, the candidates), keep
their formulas beside the runs that read them (`chip_smoke.py`).

Where a caller cannot see the data, its count is an upper bound, not the
least work: the counter charges embedding_bag for min(ids, V) table rows,
one a slot, where a run's ids may name fewer distinct rows. A cell's
counted bytes are likewise the eager program's traffic (each aten op's
operands and outputs, `launch/op_cost.py`), not the function's least.

The rates are the NVIDIA H100 SXM data sheet's at its 700 W power limit:
3.35 TB/s HBM3; 989 TFLOP/s dense bf16 on the tensor cores; 67 TFLOP/s f32
outside them, the rate taken for f32 products (TF32 off) and for 32-bit
integer and bitwise work. A card held below 700 W runs slower than these.
`launch/roofline.py` reads them from here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

HBM_BW = 3.35e12          # bytes/s of device memory
PEAK_FLOPS = 989e12       # dense bf16 FLOP/s on the tensor cores
PEAK_FLOPS_F32 = 67e12    # f32 FLOP/s (and int32 op/s) outside the tensor cores

Cost = Tuple[int, int]


def segment_agg_cost(nt: int, d: int, f: int, elem_bytes: int) -> Cost:
    """One segment_agg call: feats and mask read once, the f32 [NT, 4, F]
    output written once; per valid element an add, a min, a max, a
    multiply and an add."""
    return (nt * d * f * elem_bytes + nt * d + nt * 4 * f * 4,
            5 * nt * d * f)


def segment_agg_backward_cost(nt: int, d: int, f: int, elem_bytes: int) -> Cost:
    """One segment_agg backward: feats, mask and the f32 [NT, 4, F]
    cotangent read once, the [NT, D, F] gradient written once; per element
    two compares, two selects, a multiply and three adds."""
    return (2 * nt * d * f * elem_bytes + nt * d + nt * 4 * f * 4, 8 * nt * d * f)


def attention_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that attend: the logits the kernel must compute."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = q if causal else np.full_like(q, s - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_cost(b: int, hq: int, hkv: int, s: int, d: int, elem_bytes: int,
                   causal: bool = True, window: Optional[int] = None,
                   dv: Optional[int] = None) -> Cost:
    """One attention call: q, k [.., d] and v [.., dv] (dv = d unless
    given) read once and the output [.., dv] written once; a multiply-add
    per live (query, key) pair and head dimension of q k^T (d) and of p v
    (dv)."""
    dv = d if dv is None else dv
    nbytes = (b * hq * s * (d + dv) + b * hkv * s * (d + dv)) * elem_bytes
    return nbytes, 2 * b * hq * (d + dv) * attention_pairs(s, causal, window)


def attention_backward_cost(b: int, hq: int, hkv: int, s: int, d: int,
                            elem_bytes: int, causal: bool = True,
                            window: Optional[int] = None,
                            dv: Optional[int] = None) -> Cost:
    """One attention backward as the port computes it (recomputed from q,
    k and v; no saved softmax statistics): q, k, v and the output's
    cotangent read once, dq, dk and dv written once; per live (query, key)
    pair and head, the logits again (d), dp = do v^T (dv), dv += p^T do
    (dv), dq += dl k (d) and dk += dl^T q (d), a multiply-add each."""
    dv = d if dv is None else dv
    nbytes = (2 * b * hq * s * d + b * hq * s * dv
              + 2 * b * hkv * s * (d + dv)) * elem_bytes
    return nbytes, 2 * b * hq * (3 * d + 2 * dv) * attention_pairs(s, causal, window)


def embedding_bag_cost(n_bags: int, bag_len: int, d: int, elem_bytes: int,
                       rows: int) -> Cost:
    """One embedding_bag call: the int32 ids and f32 weights read once,
    each of the `rows` distinct table rows the ids name read once, one row
    written per bag; a multiply-add per element per slot."""
    slots = n_bags * bag_len
    return (slots * 8 + rows * d * elem_bytes + n_bags * d * elem_bytes,
            slots * d * 2)


def bound(cost: Cost, peak: float = PEAK_FLOPS_F32) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type (PEAK_FLOPS_F32, or
    PEAK_FLOPS for bf16 on the tensor cores)."""
    nbytes, ops = cost
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
