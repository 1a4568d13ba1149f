"""Public wrappers of the kernels.

Argument order and results follow the JAX package's `kernels/ops.py`, with
the device graph in place of (src, dst, n, blocked). A CUDA tensor goes to
the hand-written kernel (`csrc/bitset.cu`, `csrc/segment_agg.cu`,
`csrc/flash_attention_sm90.cu` and `csrc/flash_attention.cu`,
`csrc/embedding_bag.cu`), a CPU tensor to its plain PyTorch version
(`ref.py`); see `registry.py`. Each wrapper reports its kernel's name and
mode to the registry's dispatch hook before it runs (`registry.use_kernel`),
and runs the plain version on the card only under the degradation ladder's
`registry.mode_override(MODE_REF)`.

The bitset kernels take any packed width W and any graph that fits the
card's memory: they keep no frontier in shared memory, so the TPU's VMEM
budget (`BITSET_WAVE_VMEM_BUDGET` in the JAX package) has no counterpart
here. The hard limits are the grids (ceil(n / 8) blocks for `bitset_spmm`
at W > 2, ceil(n / 256) for the wave's worklist pass, below CUDA's
2^31 - 1) and the wave's int32 item counts (`wave_item_capacity`).

`segment_agg` and `attention` have gradients: on an input that requires
grad each runs in an autograd Function whose forward is the kernel (or the
plain version on the CPU) and whose backward is the plain one in
`ref.py`. `embedding_bag` refuses such inputs.

`attention` has two kernels: bf16 inputs take the tensor-core kernel
(`csrc/flash_attention_sm90.cu`, variant "bf16_tc"), f32 inputs the
CUDA-core kernel (`csrc/flash_attention.cu`, variant "f32"). Both take q and
k of one head dim Dqk and v of its own, Dv: the GQA pairs (64, 64),
(128, 128), (256, 256), and MLA's (192, 128).

Under the cost counter (`launch/op_cost.py`, `registry.set_cost_hook`),
`segment_agg`, `attention` (and its plain backward) and `embedding_bag`
report their call's work by `kernels/cost.py`, whichever of the kernel and
the plain version runs. A meta tensor (the dry run) takes neither: the
wrapper gives its output's shape and dtype, and computes nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.graph.structs import DeviceGraph
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry


def _counted(name: str, cost: Callable, tensor_core: bool = False):
    """The cost hook's context around a wrapper's work, given the call's
    (bytes, operations) as a thunk; a null context without a hook."""
    hook = registry.get_cost_hook()
    return contextlib.nullcontext() if hook is None else hook(name, cost(), tensor_core)


def _check_inputs(vals: torch.Tensor, dg: DeviceGraph,
                  edge_active: torch.Tensor) -> None:
    if vals.dtype != torch.int32 or vals.dim() != 2 or vals.shape[0] != dg.n:
        raise ValueError(
            f"vals must be int32[{dg.n}, W], got {vals.dtype}{list(vals.shape)}")
    if edge_active.dtype != torch.bool or edge_active.shape != (dg.m,):
        raise ValueError(f"edge_active must be bool[{dg.m}]")
    for name, t in (("dg.src", dg.src), ("dg.dst", dg.dst),
                    ("dg.dst_ptr", dg.dst_ptr), ("edge_active", edge_active)):
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
    if (dg.src.dtype != torch.int32 or dg.dst.dtype != torch.int32
            or dg.dst_ptr.dtype != torch.int64):
        raise ValueError("dg.src and dg.dst must be int32 and dg.dst_ptr int64")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# dtype codes of the float kernels' C interfaces
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_grad_input(name: str, *ts: torch.Tensor) -> None:
    """`embedding_bag` has no backward yet: refuse inputs that need one."""
    if _needs_grad(*ts):
        raise RuntimeError(
            f"{name}'s CUDA kernel has no backward: run it under "
            "torch.no_grad() or on tensors that do not require grad")


# ------------------------------------------------------------- bitset_spmm
# dst-sorted arcs per warp of the edge-balanced kernel that runs bitset_spmm
# at W <= 2, passed to it with each launch
BITSET_ARC_CHUNK = 256


def _bitset_spmm_cuda(vals, dg, edge_active):
    from repro_torch.kernels import build

    _check_inputs(vals, dg, edge_active)
    vals = vals.contiguous()
    edge_active = edge_active.contiguous()
    if dg.m == 0 and vals.shape[1] <= 2:
        # the edge-balanced kernel has no arc to take: nothing is launched
        return torch.zeros_like(vals)
    out = torch.empty_like(vals)
    if dg.n == 0:
        return out
    lib = build.library()
    code = lib.bitset_spmm_launch(
        vals.data_ptr(), dg.src.data_ptr(), dg.dst.data_ptr(),
        dg.dst_ptr.data_ptr(), edge_active.data_ptr(), out.data_ptr(), dg.n,
        dg.m, BITSET_ARC_CHUNK, vals.shape[1], vals.device.index or 0,
        _stream(vals))
    build.check(code, "bitset_spmm")
    registry.count_launch("bitset_spmm")
    return out


def bitset_or_aggregate(
    vals: torch.Tensor,          # int32[n, W] packed per-vertex words
    dg: DeviceGraph,
    edge_active: torch.Tensor,   # bool[m]
) -> torch.Tensor:
    """OR-aggregate packed words along active arcs -> int32[n, W]."""
    if registry.use_kernel("bitset_spmm", vals):
        return _bitset_spmm_cuda(vals, dg, edge_active)
    return _ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, edge_active)


# one all-true arc mask per device, grown to the longest arc list seen, that
# every `bitset_segment_or` call without its own mask shares
_ALL_ARCS: Dict[str, torch.Tensor] = {}


def _all_arcs(m: int, device: torch.device) -> torch.Tensor:
    key = str(device)
    mask = _ALL_ARCS.get(key)
    if mask is None or mask.shape[0] < m:
        mask = torch.ones(m, dtype=torch.bool, device=device)
        _ALL_ARCS[key] = mask
    return mask[:m]


def _bitset_segment_or_cuda(vals, src, dst, dst_ptr, n_out, active):
    from repro_torch.kernels import build

    m = int(src.shape[0])
    if active is None:
        active = _all_arcs(m, vals.device)
    if vals.dtype != torch.int32 or vals.dim() != 2:
        raise ValueError(f"vals must be int32[R, W], got {vals.dtype}{list(vals.shape)}")
    if (src.dtype != torch.int32 or dst.dtype != torch.int32
            or dst.shape != (m,) or dst_ptr.dtype != torch.int64
            or dst_ptr.shape != (n_out + 1,)
            or active.dtype != torch.bool or active.shape != (m,)):
        raise ValueError(
            f"src, dst must be int32[m], active bool[m], dst_ptr "
            f"int64[{n_out + 1}] (m = {m})")
    for name, t in (("src", src), ("dst", dst), ("dst_ptr", dst_ptr),
                    ("active", active)):
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
    vals = vals.contiguous()
    w = vals.shape[1]
    if m == 0 and w <= 2:
        # the edge-balanced kernel has no arc to take: nothing is launched
        return torch.zeros((n_out, w), dtype=torch.int32, device=vals.device)
    out = torch.empty((n_out, w), dtype=torch.int32, device=vals.device)
    if n_out == 0:
        return out
    lib = build.library()
    code = lib.bitset_spmm_launch(
        vals.data_ptr(), src.contiguous().data_ptr(),
        dst.contiguous().data_ptr(), dst_ptr.contiguous().data_ptr(),
        active.contiguous().data_ptr(), out.data_ptr(), n_out, m,
        BITSET_ARC_CHUNK, w, vals.device.index or 0, _stream(vals))
    build.check(code, "bitset_spmm")
    registry.count_launch("bitset_spmm")
    return out


def bitset_segment_or(
    vals: torch.Tensor,     # int32[R, W] packed rows, any R
    src: torch.Tensor,      # int32[m] row of vals per arc
    dst: torch.Tensor,      # int32[m] out row per arc, sorted ascending
    dst_ptr: torch.Tensor,  # int64[n_out + 1] CSR offsets of dst
    n_out: int,
    active: Optional[torch.Tensor] = None,  # bool[m]; None: every arc
) -> torch.Tensor:
    """OR the rows of `vals` into `n_out` rows along a dst-sorted arc list
    -> int32[n_out, W]: out[v] = OR over active arcs k with dst[k] == v of
    vals[src[k]]. The `bitset_spmm` kernel with the source rows apart from
    the out rows (it reads `vals` only through `src`): the receive side of
    the sharded backends, which OR received buffers into their vertices."""
    if registry.use_kernel("bitset_spmm", vals):
        return _bitset_segment_or_cuda(vals, src, dst, dst_ptr, n_out, active)
    return _ref.bitset_segment_or_ref(vals, src, dst, n_out, active)


# ------------------------------------------------------------- bitset_wave
# scratch frontiers the wave kernel rotates hops 0 .. L-2 over; it refuses
# fewer than min(3, L - 1) (csrc/bitset.cu)
BITSET_WAVE_BUFFERS = 3


def wave_item_capacity(n: int, m: int) -> int:
    """Work items one hop of the wave kernel may list: a candidate with d
    in-arcs lists max(1, ceil(d / BITSET_ARC_CHUNK)) <= 1 + d // chunk."""
    return n + m // BITSET_ARC_CHUNK


def _bitset_wave_cuda(vals, dg, edge_active, cand):
    from repro_torch.kernels import build

    _check_inputs(vals, dg, edge_active)
    L = int(cand.shape[0])
    if cand.dtype != torch.int32 or cand.shape != (L, dg.n):
        raise ValueError(f"cand must be int32[L, {dg.n}]")
    if cand.device != vals.device:
        raise ValueError(f"cand is on {cand.device}, vals on {vals.device}")
    vals = vals.contiguous()
    edge_active = edge_active.contiguous()
    cand = cand.contiguous()
    out = torch.empty_like(vals)
    if dg.n == 0:
        return out
    cap = wave_item_capacity(dg.n, dg.m)
    if cap >= 2**31:
        raise ValueError(f"a hop may list {cap} work items, more than int32 counts")
    w = vals.shape[1]
    dev = vals.device
    buffers = min(BITSET_WAVE_BUFFERS, L - 1)
    scratch = (torch.empty((buffers, dg.n, w), dtype=torch.int32, device=dev)
               if L > 1 else None)
    items = torch.empty((L, cap, 2), dtype=torch.int32, device=dev)
    counts = torch.empty(L, dtype=torch.int32, device=dev)
    lib = build.library()
    code = lib.bitset_wave_launch(
        vals.data_ptr(), dg.src.data_ptr(), dg.dst_ptr.data_ptr(),
        edge_active.data_ptr(), cand.data_ptr(), L,
        scratch.data_ptr() if scratch is not None else None, buffers,
        items.data_ptr(), counts.data_ptr(), out.data_ptr(), dg.n, cap,
        BITSET_ARC_CHUNK, w, dev.index or 0, _stream(vals))
    build.check(code, "bitset_wave")
    registry.count_launch("bitset_wave", 1 + L)  # the worklist pass, a kernel per hop
    return out


def bitset_wave(
    vals: torch.Tensor,          # int32[n, W] packed initial frontier
    dg: DeviceGraph,
    edge_active: torch.Tensor,   # bool[m]
    cand: torch.Tensor,          # int32[L, n] per-hop candidacy words
) -> torch.Tensor:
    """Run the full L-hop NLCC wave -> int32[n, W]: F_r = OR over active
    arcs (u -> v) of F_{r-1}[u], & cand[r][v], for any candidacy words (the
    NLCC waves pass 0 / -1)."""
    if cand.shape[0] == 0:
        return vals
    if registry.use_kernel("bitset_wave", vals):
        return _bitset_wave_cuda(vals, dg, edge_active, cand)
    return _ref.bitset_wave_ref(vals, dg.src, dg.dst, dg.n, edge_active, cand)


# ------------------------------------------------------------- segment_agg
def _segment_agg_cuda(feats, mask):
    from repro_torch.kernels import build

    if mask.device != feats.device:
        raise ValueError(f"mask is on {mask.device}, feats on {feats.device}")
    feats = feats.contiguous()
    mask = mask.contiguous()
    nt, d, f = feats.shape
    out = torch.empty((nt, 4, f), dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    code = lib.segment_agg_launch(
        feats.data_ptr(), mask.data_ptr(), out.data_ptr(), nt, d, f,
        _KERNEL_DTYPES[feats.dtype], feats.device.index or 0,
        _stream(feats))
    build.check(code, "segment_agg")
    registry.count_launch("segment_agg")
    return out


def segment_agg(
    feats: torch.Tensor,  # [NT, D, F] f32 or bf16 gathered neighbour features
    mask: torch.Tensor,   # bool[NT, D] valid-neighbour mask
) -> torch.Tensor:
    """Sum / min / max / sum of squares over the valid neighbours ->
    f32[NT, 4, F]. A row without a valid neighbour holds 0, +3e38, -3e38, 0.

    Any NT, D and F: the TPU tile's NT % 8 and F % 128 gate has no
    counterpart here."""
    if feats.dim() != 3 or feats.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"feats must be f32 or bf16 [NT, D, F], got {feats.dtype}{list(feats.shape)}")
    if mask.dtype != torch.bool or mask.shape != feats.shape[:2]:
        raise ValueError(f"mask must be bool{list(feats.shape[:2])}, got "
                         f"{mask.dtype}{list(mask.shape)}")
    with _counted("segment_agg", lambda: _cost.segment_agg_cost(
            *feats.shape, feats.element_size())):
        if _needs_grad(feats):
            return _SegmentAgg.apply(feats, mask)
        return _segment_agg_forward(feats, mask)


def _segment_agg_forward(feats, mask):
    if feats.is_meta:
        return feats.new_empty((feats.shape[0], 4, feats.shape[2]), dtype=torch.float32)
    if registry.use_kernel("segment_agg", feats):
        return _segment_agg_cuda(feats, mask)
    return _ref.segment_agg_ref(feats, mask)


class _SegmentAgg(torch.autograd.Function):
    """`segment_agg` with a gradient: the forward is the kernel (on the card)
    or its plain version (on the CPU), the backward the plain
    `ref.segment_agg_backward` on either, as the JAX package differentiates
    its plain reference."""

    @staticmethod
    def forward(ctx, feats, mask):
        ctx.save_for_backward(feats, mask)
        return _segment_agg_forward(feats, mask)

    @staticmethod
    def backward(ctx, grad):
        feats, mask = ctx.saved_tensors
        return _ref.segment_agg_backward(feats, mask, grad), None


def neighborhood_agg(
    feats: torch.Tensor,    # [NT, D, F] gathered neighbour features
    mask: torch.Tensor,     # bool[NT, D]
    degrees: torch.Tensor,  # f32[NT] true degrees (for mean / std)
) -> Dict[str, torch.Tensor]:
    """Fused sum/mean/min/max/std neighbourhood aggregation (PNA's bank),
    through one `segment_agg` call. A row of degree 0 gets min = max = 0."""
    raw = segment_agg(feats, mask)
    s, mn, mx, sq = raw[:, 0], raw[:, 1], raw[:, 2], raw[:, 3]
    deg = degrees.clamp_min(1.0)[:, None]
    empty = (degrees <= 0)[:, None]
    mean = s / deg
    # a maximum that splits its gradient at a tie, as jnp.maximum does
    # (clamp_min passes all of it): the variance of a degree-1 row is 0
    var = sq / deg - mean * mean
    var = torch.maximum(var, torch.zeros_like(var))
    zero = torch.zeros_like(s)
    return {
        "sum": s,
        "mean": mean,
        "min": torch.where(empty, zero, mn),
        "max": torch.where(empty, zero, mx),
        # +eps: sqrt has an infinite derivative at 0 (NaN in a backward)
        "std": torch.sqrt(var + 1e-12),
    }


# --------------------------------------------------------- flash_attention
# the head dims of GQA (q, k and v alike)
ATTENTION_HEAD_DIMS = (64, 128, 256)
# the (Dqk, Dv) pairs both kernels take: GQA's, and MLA's (DeepSeek: q and k
# of qk_nope + qk_rope = 192, v of 128)
ATTENTION_HEAD_DIM_PAIRS = tuple((d, d) for d in ATTENTION_HEAD_DIMS) + ((192, 128),)
# the kernel each dtype takes: bf16 the tensor-core kernel, f32 the
# CUDA-core kernel, which keeps f32 inputs exact to f32 rounding
ATTENTION_VARIANTS = {torch.bfloat16: "bf16_tc", torch.float32: "f32"}
# keys per kv tile of the tensor-core kernel for each (Dqk, Dv), passed to
# it with each launch (csrc/flash_attention_sm90.cu builds these triples):
# two stages of K and V tiles beside the 128-row q tile fit the 227 KB of
# shared memory a block may use (209 KB at (192, 128)); its numerics are
# attention_blockwise's at this block size
ATTENTION_KV_TILE = {(64, 64): 128, (128, 128): 128, (256, 256): 64,
                     (192, 128): 128}
# TMA reads bf16 q, k, v from a 16-byte-aligned base, with batch, head and
# position strides that are multiples of 16 bytes
TMA_ALIGN_BYTES = 16


def attention_variant(dtype: torch.dtype, d: int, dv: Optional[int] = None) -> str:
    """The kernel that takes q, k [.., d] and v [.., dv] (dv = d unless
    given) of this dtype on the card: "bf16_tc" or "f32". Raises for another
    dtype or (d, dv) pair."""
    dv = d if dv is None else dv
    if (d, dv) not in ATTENTION_HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention takes (Dqk, Dv) in "
                         f"{ATTENTION_HEAD_DIM_PAIRS}, got ({d}, {dv})")
    if dtype not in ATTENTION_VARIANTS:
        raise ValueError(f"flash_attention takes f32 or bf16, got {dtype}")
    return ATTENTION_VARIANTS[dtype]


def tma_strides(name: str, t: torch.Tensor, pair=None):
    """The element strides (batch, head, position) of t [B, H, S, D], whose
    last axis is contiguous, as the tensor-core kernel's TMA maps take them.
    Raises ValueError (naming the (Dqk, Dv) `pair` where one is given)
    unless t's base address is 16-byte aligned and the stride of each of
    those axes longer than 1 is a multiple of 16 bytes; an axis of length 1
    is given its contiguous stride, which TMA never steps."""
    elem = t.element_size()
    at = f" at (Dqk, Dv) = {pair}" if pair else ""
    if t.data_ptr() % TMA_ALIGN_BYTES:
        raise ValueError(f"{name}{at} starts at an address that is not "
                         f"{TMA_ALIGN_BYTES}-byte aligned: pass a contiguous copy")
    out = []
    for axis in range(3):
        if t.shape[axis] == 1:
            out.append(math.prod(t.shape[axis + 1:]))
        elif (t.stride(axis) * elem) % TMA_ALIGN_BYTES:
            raise ValueError(f"{name}{at}: stride {t.stride(axis)} along axis "
                             f"{axis} is not a multiple of {TMA_ALIGN_BYTES} bytes: "
                             "pass a contiguous copy")
        else:
            out.append(t.stride(axis))
    return tuple(out)


def tma_operand(name: str, t: torch.Tensor, pair):
    """(t, its TMA strides): t as it is where TMA can read it in place (a
    view such as MLA's v, a slice of the kv projection, usually can), else a
    contiguous copy, which always can."""
    try:
        return t, tma_strides(name, t, pair)
    except ValueError:
        t = t.contiguous()
        return t, tma_strides(name, t, pair)


def _attention_cuda(q, k, v, causal, window):
    from repro_torch.kernels import build

    b, hq, s, d = q.shape
    dv = v.shape[3]
    variant = attention_variant(q.dtype, d, dv)
    if variant == "f32" and (b > 65535 or hq > 65535):
        raise ValueError(f"batch {b} or heads {hq} exceed the grid's 65535")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, hq, s, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if variant == "bf16_tc":
        (q, sq), (k, sk), (v, sv) = (tma_operand(name, t, (d, dv)) for name, t in
                                     (("q", q), ("k", k), ("v", v)))
        st = [*sq, *sk, *sv, *out.stride()[:3]]
    else:
        st = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], s, d, dv)
    rest = ((ctypes.c_longlong * 12)(*st), int(causal),
            0 if window is None else int(window), q.device.index or 0, _stream(q))
    lib = build.library()
    if variant == "bf16_tc":
        code = lib.flash_attention_bf16_launch(*head, ATTENTION_KV_TILE[d, dv], *rest)
    else:
        code = lib.flash_attention_launch(*head, *rest)
    build.check(code, f"flash_attention ({variant})")
    registry.count_launch("flash_attention", variant=variant)
    return out


def attention(
    q: torch.Tensor,  # [B, Hq, S, Dqk]
    k: torch.Tensor,  # [B, Hkv, S, Dqk]
    v: torch.Tensor,  # [B, Hkv, S, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dqk) + mask) v -> [B, Hq, S, Dv] in q's dtype;
    query head h reads kv head h // (Hq / Hkv); `window` keeps the keys
    after query - window. f32 or bf16, all three of one dtype. Dv = Dqk for
    GQA; MLA's v has its own head dim.

    Any S: the TPU kernel's S % 128 and D >= 128 gate has no counterpart;
    the CUDA kernels take the (Dqk, Dv) pairs of ATTENTION_HEAD_DIM_PAIRS
    (`attention_variant` names the one a dtype takes)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be [B, Hq, S, Dqk], k [B, Hkv, S, Dqk] and v "
                         f"[B, Hkv, S, Dv], got {list(q.shape)}, {list(k.shape)}, "
                         f"{list(v.shape)}")
    b, hq, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hq % k.shape[1]:
        raise ValueError(f"k {list(k.shape)} does not fit q {list(q.shape)}")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"v {list(v.shape)} does not fit k {list(k.shape)}: "
                         "(B, Hkv, S) must agree")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share f32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    with _counted("flash_attention", lambda: _cost.attention_cost(
            b, hq, k.shape[1], s, d, q.element_size(), causal, window,
            v.shape[3]), tensor_core=q.dtype == torch.bfloat16):
        if _needs_grad(q, k, v):
            return _Attention.apply(q, k, v, causal, window)
        return _attention_forward(q, k, v, causal, window)


def _attention_forward(q, k, v, causal, window):
    if q.is_meta:
        return q.new_empty(q.shape[:3] + v.shape[3:])
    if registry.use_kernel("flash_attention", q):
        return _attention_cuda(q, k, v, causal, window)
    return _ref.attention_plain(q, k, v, causal=causal, window=window)


class _Attention(torch.autograd.Function):
    """`attention` with a gradient: the forward is the kernel (on the card)
    or its plain version (on the CPU), the backward the plain
    `ref.attention_backward` on either, recomputed from the saved q, k and v
    in f32, as the JAX package differentiates its plain reference. A bf16
    forward on the card rounds the softmax weights to bf16 before p v; the
    backward does not."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _attention_forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        b, hq, s, d = q.shape
        # counted by its formula, as the kernels are; f32 arithmetic
        with _counted("attention_backward", lambda: _cost.attention_backward_cost(
                b, hq, k.shape[1], s, d, q.element_size(), ctx.causal, ctx.window,
                v.shape[3])):
            if q.is_meta:
                return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape), None, None
            dq, dk, dv = _ref.attention_backward(q, k, v, do, causal=ctx.causal,
                                                 window=ctx.window)
        return dq, dk, dv, None, None


# ----------------------------------------------------------- embedding_bag
def _embedding_bag_cuda(table, ids, weights, mode):
    from repro_torch.kernels import build

    _no_grad_input("embedding_bag", table, weights)
    for name, t in (("ids", ids), ("weights", weights)):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
    table, ids, weights = table.contiguous(), ids.contiguous(), weights.contiguous()
    n_bags, bag_len = ids.shape
    out = torch.empty((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    code = lib.embedding_bag_launch(
        table.data_ptr(), ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
        n_bags, bag_len, table.shape[1], table.shape[0], int(mode == "mean"),
        _KERNEL_DTYPES[table.dtype], table.device.index or 0, _stream(table))
    build.check(code, "embedding_bag")
    registry.count_launch("embedding_bag")
    return out


def embedding_bag(
    table: torch.Tensor,                      # [V, D] f32 or bf16
    ids: torch.Tensor,                        # int32[B, L], padding id 0
    weights: Optional[torch.Tensor] = None,   # f32[B, L], padding 0
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """Weighted bags of table rows -> [B, D] in the table's dtype, summed in
    f32; "mean" divides by the count of nonzero weights (at least 1).
    `weights` defaults to ones."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.dim() != 2 or table.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"table must be f32 or bf16 [V, D], got "
                         f"{table.dtype}{list(table.shape)}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32[B, L], got {ids.dtype}{list(ids.shape)}")
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    if weights.dtype != torch.float32 or weights.shape != ids.shape:
        raise ValueError(f"weights must be f32{list(ids.shape)}, got "
                         f"{weights.dtype}{list(weights.shape)}")
    # the distinct rows the ids name depend on the data: at most one a slot
    with _counted("embedding_bag", lambda: _cost.embedding_bag_cost(
            *ids.shape, table.shape[1], table.element_size(),
            min(ids.numel(), table.shape[0]))):
        if table.is_meta:
            return table.new_empty((ids.shape[0], table.shape[1]))
        if registry.use_kernel("embedding_bag", table):
            return _embedding_bag_cuda(table, ids, weights, mode)
        return _ref.embedding_bag_ref(table, ids, weights, mode=mode)
