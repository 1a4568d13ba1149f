"""Plain PyTorch versions of the kernels.

They compute what the CUDA kernels in `csrc/` compute, with plain
tensor operations, on any device. The CPU path of every wrapper in `ops.py`
runs them, the tests hold them against the JAX package's oracles, and
`chip_smoke.py` holds each CUDA kernel against them on the card. Nothing on
the CUDA path calls the plain forwards. The two backwards
(`segment_agg_backward`, `attention_backward`) are the gradients of their
kernels on both devices: the JAX package differentiates its plain oracles
and has no backward kernel.

Packed words are int32 (see `core/state.py`).
"""
from __future__ import annotations

from typing import Optional

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
    """out[v] = OR over active arcs (u -> v) of vals[u] -> int32[n, W]."""
    return bitset_segment_or_ref(vals, src, dst, n, edge_active)


def bitset_segment_or_ref(
    vals: torch.Tensor,         # int32[R, W] packed rows, any R
    src: torch.Tensor,          # int32[m] row of vals per arc
    dst: torch.Tensor,          # int32[m] out row per arc, < n_out
    n_out: int,
    edge_active: Optional[torch.Tensor] = None,  # bool[m]; None: every arc
) -> torch.Tensor:
    """out[v] = OR over active arcs k with dst[k] == v of vals[src[k]] ->
    int32[n_out, W]; `vals` and `out` may differ in rows (the sharded
    backends OR received buffers into their vertices).

    Bit planes: unpack the rows, gather them by the sources of the active
    arcs, max-scatter by their destinations into a zero plane (so a row
    with no active arc gets 0), pack. Where there are no fewer rows than
    arcs (a receive buffer, each row one arc's), the rows are unpacked a
    chunk of arcs at a time instead, so no [R, 32W] plane is made, and the
    arcs whose row is zero (an inactive sender's message) are left out:
    they OR nothing in."""
    w = vals.shape[1]
    acc = torch.zeros((n_out, 32 * w), dtype=torch.int32, device=vals.device)
    if edge_active is None:
        src_a, dst_a = src.long(), dst.long()
    else:
        arcs = torch.nonzero(edge_active).squeeze(1)
        src_a, dst_a = src[arcs].long(), dst[arcs].long()
    if vals.shape[0] < src.shape[0]:
        bits = unpack_bits(vals, 32 * w)                   # bool[R, 32W]
    else:
        bits = None
        live = vals.ne(0).any(dim=1)[src_a]
        src_a, dst_a = src_a[live], dst_a[live]
    step = max(1, SPMM_REF_CHUNK_BITS // (32 * w))
    for off in range(0, src_a.shape[0], step):
        rows = src_a[off: off + step]
        msgs = (bits[rows] if bits is not None
                else unpack_bits(vals[rows], 32 * w)).to(torch.int32)
        idx = dst_a[off: off + step, None].expand_as(msgs)
        acc.scatter_reduce_(0, idx, msgs, "amax", include_self=True)
    return pack_bits(acc > 0)


def bitset_wave_ref(
    vals: torch.Tensor,         # int32[n, W] packed initial frontier (hop 0)
    src: torch.Tensor,          # int32[m] dst-sorted
    dst: torch.Tensor,          # int32[m]
    n: int,
    edge_active: torch.Tensor,  # bool[m]
    cand: torch.Tensor,         # int32[L, n] per-hop candidacy words
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


def segment_agg_backward(feats: torch.Tensor, mask: torch.Tensor,
                         grad: torch.Tensor) -> torch.Tensor:
    """The vector-Jacobian product of `segment_agg_ref` (what JAX's autodiff
    of the reference's `segment_agg_ref` computes; the JAX package has no
    backward kernel): grad f32[NT, 4, F], the cotangent of (sum, min, max,
    sum of squares) -> the cotangent of feats, in feats' dtype.

    The sum's cotangent goes to every valid slot, the sum of squares' as
    2 x g. The min's and the max's go to the slots that hold the extremum,
    split equally among tied slots (`jnp.min`/`jnp.max`'s rule: a masked
    slot holding the +-BIG identity counts in the tie, as it does there). A
    masked slot gets 0 whatever it holds: the product 2 x g is replaced, not
    multiplied by the mask, so a NaN or Inf there cannot leak (JAX's
    autodiff gives 2 x 0 = NaN in a masked NaN slot)."""
    x = feats.float()
    valid = mask[:, :, None]
    g = grad.float()
    gs, gmn, gmx, gsq = (g[:, i, None, :] for i in range(4))
    xmn = torch.where(valid, x, SEGMENT_AGG_BIG)
    xmx = torch.where(valid, x, -SEGMENT_AGG_BIG)
    at_mn = xmn == xmn.amin(1, keepdim=True)
    at_mx = xmx == xmx.amax(1, keepdim=True)
    dx = (gs
          + torch.where(at_mn, gmn / at_mn.sum(1, keepdim=True), 0.0)
          + torch.where(at_mx, gmx / at_mx.sum(1, keepdim=True), 0.0)
          + 2.0 * x * gsq)
    return torch.where(valid, dx, 0.0).to(feats.dtype)


# The masked logit of the attention kernels and of their plain versions.
ATTENTION_NEG_INF = -1e30


def _attention_live(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window) -> torch.Tensor:
    """bool[len(q_pos), len(k_pos)]: which (query, key) pairs attend."""
    live = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        live &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        live &= k_pos[None, :] > q_pos[:, None] - window
    return live


def _repeat_kv(q, k, v):
    """GQA: kv head h // group serves query head h (`jnp.repeat`)."""
    group = q.shape[1] // k.shape[1]
    if group != 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return k, v


def attention_ref(
    q: torch.Tensor,  # [B, Hq, S, Dqk]
    k: torch.Tensor,  # [B, Hkv, S, Dqk]
    v: torch.Tensor,  # [B, Hkv, S, Dv]
    *,
    causal: bool = True,
    window=None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dqk) + mask) v -> [B, Hq, S, Dv], materialising
    the [S, S] logits in f32 (scaled after the product) -> q's dtype. Dv may
    differ from Dqk (MLA); the scale is q's head dim."""
    s, d = q.shape[2], q.shape[3]
    k, v = _repeat_kv(q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    pos = torch.arange(s, device=q.device)
    live = _attention_live(pos, pos, causal, window)
    logits = torch.where(live, logits, ATTENTION_NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def attention_backward(
    q: torch.Tensor,   # [B, Hq, S, Dqk]
    k: torch.Tensor,   # [B, Hkv, S, Dqk]
    v: torch.Tensor,   # [B, Hkv, S, Dv]
    do: torch.Tensor,  # [B, Hq, S, Dv], the output's cotangent
    *,
    causal: bool = True,
    window=None,
):
    """The vector-Jacobian product of `attention_ref` (JAX's autodiff of the
    reference's oracle; the JAX package has no backward kernel) -> (dq, dk,
    dv) in the inputs' dtype.

    Recomputed from q, k and v in f32, one (batch, kv head) chunk at a time:
    the chunk's group of Hq / Hkv query heads against its kv head, so at
    most one [Hq / Hkv, S, S] plane of logits is live, never [B, Hq, S, S].
    Masked pairs get no gradient; dk and dv sum over the query heads of the
    group (the transpose of `_repeat_kv`). With bf16 inputs the forward
    kernel rounds the softmax weights p to bf16 before p v; this backward
    does not (it differentiates the f32 oracle)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = 1.0 / d ** 0.5
    pos = torch.arange(s, device=q.device)
    live = _attention_live(pos, pos, causal, window)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for bi in range(b):
        for j in range(hkv):
            heads = slice(j * group, (j + 1) * group)
            qc = q[bi, heads].float()                 # [G, S, Dqk]
            kc, vc = k[bi, j].float(), v[bi, j].float()  # [S, Dqk], [S, Dv]
            doc = do[bi, heads].float()
            logits = torch.where(live, (qc @ kc.T) * scale, ATTENTION_NEG_INF)
            p = torch.softmax(logits, dim=-1)          # [G, S, S]
            dp = doc @ vc.T
            dv[bi, j] = (p.transpose(1, 2) @ doc).sum(0)
            dl = p * (dp - (p * dp).sum(-1, keepdim=True))
            dl = torch.where(live, dl, 0.0) * scale
            dq[bi, heads] = dl @ kc
            dk[bi, j] = (dl.transpose(1, 2) @ qc).sum(0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_blockwise(
    q: torch.Tensor,  # [B, Hq, S, Dqk]
    k: torch.Tensor,  # [B, Hkv, S, Dqk]
    v: torch.Tensor,  # [B, Hkv, S, Dv]
    *,
    causal: bool = True,
    window=None,
    block_k: int = 1024,
) -> torch.Tensor:
    """The same function with an online softmax over kv blocks of `block_k`
    keys: O(S * block_k) live memory. Products of input-dtype values summed
    in f32, and p cast to v's dtype before the second product, as the JAX
    package's blockwise oracle does."""
    b, hq, s, d = q.shape
    k, v = _repeat_kv(q, k, v)
    scale = 1.0 / d ** 0.5
    q32 = q.float()
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, hq, s), ATTENTION_NEG_INF, device=q.device)
    l = torch.zeros((b, hq, s), device=q.device)
    acc = torch.zeros((b, hq, s, v.shape[-1]), device=q.device)
    for k0 in range(0, s, block_k):
        # the JAX oracle pads the last block with masked keys, whose p is
        # exp(-1e30 - m) = 0 once a row has a live key: they are left out
        kblk = k[:, :, k0:k0 + block_k].float()
        vblk = v[:, :, k0:k0 + block_k]
        k_pos = torch.arange(k0, min(k0 + block_k, s), device=q.device)
        live = _attention_live(q_pos, k_pos, causal, window)
        logits = torch.einsum("bhqd,bhkd->bhqk", q32, kblk) * scale
        logits = torch.where(live, logits, ATTENTION_NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vblk.float())
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# Above this length the plain path runs the blockwise version (O(S * block)
# live memory) instead of materialising the [S, S] logits.
ATTENTION_BLOCKWISE_CUTOFF = 2048


def attention_plain(q, k, v, *, causal: bool = True, window=None) -> torch.Tensor:
    """The plain version `ops.attention` runs on a CPU tensor: `attention_ref`,
    or `attention_blockwise` past ATTENTION_BLOCKWISE_CUTOFF."""
    if q.shape[2] > ATTENTION_BLOCKWISE_CUTOFF:
        return attention_blockwise(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)


def embedding_bag_ref(
    table: torch.Tensor,    # [V, D]
    ids: torch.Tensor,      # int32[B, L]
    weights: torch.Tensor,  # f32[B, L]
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """out[b] = sum_l weights[b, l] * table[ids[b, l]] in f32 -> the table's
    dtype; "mean" divides by the count of nonzero weights (at least 1). Ids
    follow `jnp.take`: negative ids count from the end, ids outside [-V, V)
    read NaN."""
    n_rows = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n_rows, idx)
    valid = (idx >= 0) & (idx < n_rows)
    rows = table[idx.clamp(0, max(n_rows - 1, 0))].float()       # [B, L, D]
    rows = torch.where(valid[..., None], rows, float("nan"))
    out = (rows * weights[:, :, None]).sum(1)
    if mode == "mean":
        counts = (weights != 0).float().sum(1)
        out = out / counts.clamp_min(1.0)[:, None]
    return out.to(table.dtype)
