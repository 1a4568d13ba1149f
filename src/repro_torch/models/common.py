"""Shared model building blocks.

The JAX package draws weights from `jax.random` keys; the port draws them
from an explicit `torch.Generator`. The two give different numbers from the
same seed, so a comparison carries the JAX weights across (each model's
`load_jax_params`).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the running maximum's start and a padded column's logit in the reference's
# blockwise loss
CE_NEG_INF = -1e30


def generator(device: torch.device, seed: int) -> Optional[torch.Generator]:
    """The weights' generator on `device`, seeded; None on the meta device,
    which has no generator: the dry run builds shapes and draws nothing."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int) -> torch.Tensor:
    """f32 N(0, 1) / sqrt(d_in) weights in the JAX layout [d_in, d_out],
    drawn from `gen` on its device."""
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in))


def normal(gen: Optional[torch.Generator], shape, scale: float,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from `gen` on its device, cast to dtype;
    without a generator, an empty meta tensor of that shape (`generator`)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def register_params(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
    """Register each tensor on `module` as a parameter that does not require
    grad, under its own name (names such as "items" that an
    `nn.ParameterDict` would refuse stay as they are)."""
    for k, v in tensors.items():
        module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX parameter tree as flat names: {"mlp": {"w1": a}, "blocks": [{"b":
    c}], "eps": e} -> {"mlp_w1": a, "blocks_0_b": c, "eps": e}."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (Mapping, list, tuple)):
            out.update(flatten_tree(v, f"{prefix}{k}_"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def load_flat(params: Mapping[str, torch.Tensor], tree) -> None:
    """Copy a JAX parameter tree (leaves as numpy arrays, any float dtype)
    into `params`, keyed by `flatten_tree` names; the names and shapes must
    match exactly, else nothing is copied and ValueError is raised."""
    flat = flatten_tree(tree)
    if set(flat) != set(params.keys()):
        raise ValueError(f"parameters {sorted(flat)} given, "
                         f"{sorted(params.keys())} expected")
    for k, v in flat.items():
        if tuple(v.shape) != tuple(params[k].shape):
            raise ValueError(f"{k}: shape {v.shape}, expected "
                             f"{tuple(params[k].shape)}")
    with torch.no_grad():
        for k, v in flat.items():
            params[k].copy_(torch.from_numpy(np.array(v, dtype=np.float32)))


def nest(flat: Mapping[str, torch.Tensor],
         paths: Mapping[str, Tuple]) -> Dict:
    """A nested tree (dicts, and lists where a path holds an int) of the
    tensors of `flat`, each at `paths[name]`: a model's parameters in the
    JAX package's tree ("dense_layers_attn_wq" -> ["dense_layers"]["attn"]
    ["wq"], "layers.0.w" -> ["layers"][0]["w"])."""
    root: Dict = {}
    for name, path in paths.items():
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if key not in node:
                node[key] = {}
            node = node[key]
        node[path[-1]] = flat[name]

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(isinstance(k, int) for k in t):
            return [lists(t[i]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}

    return lists(root)


def unnest(tree, paths: Mapping[str, Tuple]) -> Dict[str, torch.Tensor]:
    """The inverse of `nest`: {name: the leaf at paths[name]}."""
    out = {}
    for name, path in paths.items():
        node = tree
        for key in path:
            node = node[key]
        out[name] = node
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token-level CE in f32. logits [..., V], labels int[...]; with a
    mask, the mean over its true entries (at least 1). With `denom` (a data
    rank's share on a mesh, `ce_denominator`), the masked sum over it."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if denom is not None:
        return (nll if mask is None else nll * mask.float()).sum() / denom
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


def ce_denominator(labels: torch.Tensor, mask: Optional[torch.Tensor],
                   mesh=None) -> torch.Tensor:
    """The count a token-mean CE divides by: the mask's true entries (at
    least 1), or every label; with `mesh` (a `launch/mesh.RankMesh` whose
    data ranks hold different rows), summed over `data`, so that each data
    rank's masked sum over it is its share of the mean. It carries no
    gradient."""
    from repro_torch.launch.mesh import all_reduce

    count = (mask.float().sum() if mask is not None
             else torch.tensor(float(labels.numel()), device=labels.device))
    if mesh is not None:
        count = all_reduce(count, mesh, "data")
    return count.clamp_min(1.0) if mask is not None else count


class _VocabParallelCE(torch.autograd.Function):
    """The masked NLL sum of logits split over `model` by vocabulary: each
    rank holds logits [N, V/model] of the rows v0.. of the vocabulary; the
    row max and the sum of exponentials are combined over `model`, the
    target logit comes from the rank that owns it (Megatron-LM's
    vocab-parallel cross-entropy). w [N] weights each row's NLL. The
    backward gives each rank the gradient of its own logits."""

    @staticmethod
    def forward(ctx, logits, labels, w, v0, mesh):
        from repro_torch.launch.mesh import all_reduce

        x = logits.float()
        vl = x.shape[-1]
        m = all_reduce(x.amax(-1), mesh, "model", "max")
        ex = torch.exp(x - m[:, None])
        se = all_reduce(ex.sum(-1), mesh, "model")
        idx = labels - v0
        own = (idx >= 0) & (idx < vl)
        gold = all_reduce(torch.where(
            own, x.gather(1, idx.clamp(0, vl - 1)[:, None])[:, 0] - m, 0.0),
            mesh, "model")
        ctx.save_for_backward(ex, se, idx, own, w)
        ctx.dtype = logits.dtype
        return ((torch.log(se) - gold) * w).sum()

    @staticmethod
    def backward(ctx, g):
        ex, se, idx, own, w = ctx.saved_tensors
        grad = ex / se[:, None]
        rows = torch.nonzero(own).squeeze(1)
        grad[rows, idx[rows]] -= 1.0
        return (grad * (g * w)[:, None]).to(ctx.dtype), None, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor], denom: torch.Tensor,
                                 mesh, v0: int) -> torch.Tensor:
    """`cross_entropy`'s masked NLL sum over `denom` (`ce_denominator`) in
    f32, of logits [..., V/model] that are this model rank's vocabulary
    rows from v0 (`_VocabParallelCE`)."""
    lab = labels.reshape(-1).long()
    m = (mask.reshape(-1).float() if mask is not None
         else torch.ones(lab.shape, device=logits.device))
    return _VocabParallelCE.apply(logits.reshape(lab.shape[0], -1), lab, m / denom,
                                  v0, mesh)


class _BlockwiseCE(torch.autograd.Function):
    """Mean token NLL streamed over vocabulary blocks; the backward
    recomputes each block's logits instead of keeping them. With `mesh`,
    head holds this model rank's vocabulary columns from v0, and the running
    max, the sum of exponentials and the target logit are combined over
    `model` before the log."""

    @staticmethod
    def forward(ctx, h, head, labels, mk, denom, block, mesh=None, v0=0):
        lse = torch.full(labels.shape, CE_NEG_INF, device=h.device)
        l = torch.zeros(labels.shape, device=h.device)
        gold = torch.zeros(labels.shape, device=h.device)
        h32 = h.float()
        for off in range(0, head.shape[1], block):
            # bf16 products summed in f32 (preferred_element_type=f32)
            logits = h32 @ head[:, off:off + block].float()
            m_new = torch.maximum(lse, logits.amax(1))
            l = l * torch.exp(lse - m_new) + torch.exp(
                logits - m_new[:, None]).sum(1)
            lse = m_new
            idx = labels - v0 - off
            in_blk = (idx >= 0) & (idx < logits.shape[1])
            gold = gold + torch.where(
                in_blk, logits.gather(1, idx.clamp(0, logits.shape[1] - 1)[:, None])[:, 0],
                0.0)
        if mesh is not None:
            from repro_torch.launch.mesh import all_reduce

            m_all = all_reduce(lse, mesh, "model", "max")
            l = all_reduce(l * torch.exp(lse - m_all), mesh, "model")
            lse = m_all
            gold = all_reduce(gold, mesh, "model")
        lse = lse + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(h, head, labels, mk, denom, lse)
        ctx.block, ctx.v0 = block, v0
        return ((lse - gold) * mk).sum() / denom

    @staticmethod
    def backward(ctx, g):
        h, head, labels, mk, denom, lse = ctx.saved_tensors
        h32 = h.float()
        w = g * mk / denom
        dh = torch.zeros(h32.shape, device=h.device)
        dhead = torch.empty(head.shape, dtype=torch.float32, device=h.device)
        for off in range(0, head.shape[1], ctx.block):
            hb = head[:, off:off + ctx.block].float()
            dl = torch.exp(h32 @ hb - lse[:, None])      # softmax over the vocab
            idx = labels - ctx.v0 - off
            in_blk = (idx >= 0) & (idx < hb.shape[1])
            rows = torch.nonzero(in_blk).squeeze(1)
            dl[rows, idx[rows]] -= 1.0
            dl = dl * w[:, None]
            dh += dl @ hb.T
            dhead[:, off:off + ctx.block] = h32.T @ dl
        return dh.to(h.dtype), dhead.to(head.dtype), None, None, None, None, None, None


def blockwise_cross_entropy(h: torch.Tensor, head: torch.Tensor,
                            labels: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            block: int = 8192, denom: Optional[torch.Tensor] = None,
                            mesh=None, v0: int = 0) -> torch.Tensor:
    """Fused softmax-CE streamed over vocabulary blocks (the JAX package's
    `blockwise_cross_entropy`): the [T, V] logits are never materialised.
    A loop over V / block blocks carries a running (max, denominator, gold
    logit) per token, the online-softmax recurrence of flash attention
    applied to the loss; each block's product sums h's dtype in f32. The
    backward recomputes each block's logits from h and head, so it keeps
    one [T, block] plane, not V / block of them. The last block is shorter
    where the reference pads it with masked columns, which add nothing.

    h [..., D], head [D, V], labels int[...]. Returns the mean token NLL
    (over mask's true entries, at least 1, with a mask). On a mesh, `denom`
    (`ce_denominator`) replaces the count, and with `mesh` head holds this
    model rank's vocabulary columns from v0."""
    d = head.shape[0]
    ht = h.reshape(-1, d)
    lab = labels.reshape(-1).long()
    if mask is not None:
        mk = mask.reshape(-1).float()
        if denom is None:
            denom = mk.sum().clamp_min(1.0)
    else:
        mk = torch.ones(lab.shape, device=h.device)
        if denom is None:
            denom = torch.tensor(float(lab.shape[0]), device=h.device)
    return _BlockwiseCE.apply(ht, head, lab, mk, denom, block, mesh, v0)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32, cast back to x's dtype, then the gain (the JAX order)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Biased variance, in f32, cast back to x's dtype before gain and bias."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, D] with D even; positions: int[..., S] or int[S].

    Interleaved pairs: (x[2i], x[2i+1]) rotate by positions * freqs[i], as
    the JAX package does, not the two halves of HF's `rotate_half`."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [D/2]
    angles = positions[..., :, None].float() * freqs           # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, op for op as `jax.nn.gelu(approximate=True)`
    writes it, so a bf16 input rounds where the JAX one does (one fused
    `F.gelu` rounds once, up to a bf16 ulp away)."""
    sqrt_2_over_pi = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(sqrt_2_over_pi * (x + 0.044715 * (x ** 3))))
    return x * cdf


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
