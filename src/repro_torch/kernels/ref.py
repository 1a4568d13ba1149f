"""Plain PyTorch versions of the kernels.

They compute what the CUDA kernels in `csrc/` compute, with plain
tensor operations, on any device. The CPU path of every wrapper in `ops.py`
runs them, the tests hold them against the JAX package's oracles, and
`chip_smoke.py` holds each CUDA kernel against them on the card. Nothing on
the CUDA path calls them.

Packed words are int32 (see `core/state.py`).
"""
from __future__ import annotations

import torch

from repro_torch.core.state import pack_bits, unpack_bits

# Arcs per scatter chunk of `bitset_spmm_ref` are capped so that one chunk's
# message plane holds at most this many bits, whatever the packed width.
SPMM_REF_CHUNK_BITS = 1 << 26


def bitset_spmm_ref(
    vals: torch.Tensor,         # int32[n, W] packed
    src: torch.Tensor,          # int32[m] dst-sorted
    dst: torch.Tensor,          # int32[m]
    n: int,
    edge_active: torch.Tensor,  # bool[m]
) -> torch.Tensor:
    """out[v] = OR over active arcs (u -> v) of vals[u] -> int32[n, W].

    Bit planes: unpack, gather by the sources of the active arcs, max-scatter
    by their destinations into a zero plane (so a vertex with no active
    in-arc gets 0), pack."""
    w = vals.shape[1]
    bits = unpack_bits(vals, 32 * w)                      # bool[n, 32W]
    acc = torch.zeros((n, 32 * w), dtype=torch.int32, device=vals.device)
    arcs = torch.nonzero(edge_active).squeeze(1)
    src_a, dst_a = src[arcs].long(), dst[arcs].long()
    step = max(1, SPMM_REF_CHUNK_BITS // (32 * w))
    for off in range(0, arcs.shape[0], step):
        msgs = bits[src_a[off: off + step]].to(torch.int32)
        idx = dst_a[off: off + step, None].expand_as(msgs)
        acc.scatter_reduce_(0, idx, msgs, "amax", include_self=True)
    return pack_bits(acc > 0)


def bitset_wave_ref(
    vals: torch.Tensor,         # int32[n, W] packed initial frontier (hop 0)
    src: torch.Tensor,          # int32[m] dst-sorted
    dst: torch.Tensor,          # int32[m]
    n: int,
    edge_active: torch.Tensor,  # bool[m]
    cand: torch.Tensor,         # int32[L, n] per-hop candidacy, 0 / -1
) -> torch.Tensor:
    """Fused L-hop wave: F_r = OR-aggregate(F_{r-1}) & cand[r], r = 1..L."""
    packed = vals
    for r in range(cand.shape[0]):
        packed = (bitset_spmm_ref(packed, src, dst, n, edge_active)
                  & cand[r][:, None])
    return packed


# BIG of the JAX package's `segment_agg`: the min / max identity, not FLT_MAX.
SEGMENT_AGG_BIG = 3.0e38


def segment_agg_ref(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """feats [NT, D, F], mask bool[NT, D] -> f32[NT, 4, F]: sum, min, max and
    sum of squares over the valid neighbours, in f32; a row without one
    holds 0, +BIG, -BIG, 0. Masked slots are replaced, never multiplied by
    the mask, so a NaN or Inf there cannot leak."""
    x = feats.float()
    valid = mask[:, :, None]
    s = torch.where(valid, x, 0.0).sum(1)
    mn = torch.where(valid, x, SEGMENT_AGG_BIG).amin(1)
    mx = torch.where(valid, x, -SEGMENT_AGG_BIG).amax(1)
    sq = torch.where(valid, x * x, 0.0).sum(1)
    return torch.stack([s, mn, mx, sq], dim=1)
