"""Public wrappers of the bitset kernels.

Argument order and results follow the JAX package's `kernels/ops.py`, with
the device graph in place of (src, dst, n, blocked). A CUDA tensor goes to
the hand-written kernel (`csrc/bitset.cu`), a CPU tensor to its plain
PyTorch version (`ref.py`); see `registry.py`.

The kernels take any packed width W and any graph that fits the card's
memory: they keep no frontier in shared memory, so the TPU's VMEM budget
(`BITSET_WAVE_VMEM_BUDGET` in the JAX package) has no counterpart here. The
one hard limit is the grid: ceil(n / 8) blocks for W > 2, below CUDA's
2^31 - 1.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import DeviceGraph
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry


def _check_inputs(vals: torch.Tensor, dg: DeviceGraph,
                  edge_active: torch.Tensor) -> None:
    if vals.dtype != torch.int32 or vals.dim() != 2 or vals.shape[0] != dg.n:
        raise ValueError(
            f"vals must be int32[{dg.n}, W], got {vals.dtype}{list(vals.shape)}")
    if edge_active.dtype != torch.bool or edge_active.shape != (dg.m,):
        raise ValueError(f"edge_active must be bool[{dg.m}]")
    for name, t in (("dg.src", dg.src), ("dg.dst_ptr", dg.dst_ptr),
                    ("edge_active", edge_active)):
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
    if dg.src.dtype != torch.int32 or dg.dst_ptr.dtype != torch.int64:
        raise ValueError("dg.src must be int32 and dg.dst_ptr int64")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------- bitset_spmm
def _bitset_spmm_cuda(vals, dg, edge_active):
    from repro_torch.kernels import build

    _check_inputs(vals, dg, edge_active)
    vals = vals.contiguous()
    edge_active = edge_active.contiguous()
    out = torch.empty_like(vals)
    if dg.n == 0:
        return out
    lib = build.library()
    code = lib.bitset_spmm_launch(
        vals.data_ptr(), dg.src.data_ptr(), dg.dst_ptr.data_ptr(),
        edge_active.data_ptr(), out.data_ptr(), dg.n,
        vals.shape[1], vals.device.index or 0, _stream(vals))
    build.check(code, "bitset_spmm")
    registry.count_launch("bitset_spmm")
    return out


def bitset_or_aggregate(
    vals: torch.Tensor,          # int32[n, W] packed per-vertex words
    dg: DeviceGraph,
    edge_active: torch.Tensor,   # bool[m]
) -> torch.Tensor:
    """OR-aggregate packed words along active arcs -> int32[n, W]."""
    if registry.uses_kernel(vals):
        return _bitset_spmm_cuda(vals, dg, edge_active)
    return _ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, edge_active)


# ------------------------------------------------------------- bitset_wave
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
    scratch = torch.empty_like(vals) if L > 1 else None
    lib = build.library()
    code = lib.bitset_wave_launch(
        vals.data_ptr(), dg.src.data_ptr(), dg.dst_ptr.data_ptr(),
        edge_active.data_ptr(), cand.data_ptr(), L,
        scratch.data_ptr() if scratch is not None else None, out.data_ptr(),
        dg.n, vals.shape[1], vals.device.index or 0, _stream(vals))
    build.check(code, "bitset_wave")
    registry.count_launch("bitset_wave", L)  # one hop kernel per hop
    return out


def bitset_wave(
    vals: torch.Tensor,          # int32[n, W] packed initial frontier
    dg: DeviceGraph,
    edge_active: torch.Tensor,   # bool[m]
    cand: torch.Tensor,          # int32[L, n] per-hop candidacy, 0 / -1
) -> torch.Tensor:
    """Run the full L-hop NLCC wave -> int32[n, W]."""
    if cand.shape[0] == 0:
        return vals
    if registry.uses_kernel(vals):
        return _bitset_wave_cuda(vals, dg, edge_active, cand)
    return _ref.bitset_wave_ref(vals, dg.src, dg.dst, dg.n, edge_active, cand)
