"""Decoder-only transformer covering the five LM archs of the JAX package's
`models/transformer.py`, as one `nn.Module`.

Features (config-selected), as in the JAX package:
  - GQA attention with RoPE, optional QKV bias (qwen2), qk-norm (qwen3: an
    RMSNorm on each head's q and k before RoPE), a sliding window
    (starcoder2), LayerNorm or RMSNorm
  - MLA attention (deepseek v2/v3): low-rank q (optional), the kv latent
    and the decoupled rope dims; prefill and training send q = [q_nope,
    q_rope] and k = [k_nope, k_rope] (head dim 192 at full width) with v of
    its own head dim (128) through the `flash_attention` kernel; decode is
    the absorbed formulation over the latent cache, plain f32 einsums as in
    the JAX package
  - a dense MLP (GELU with biases, or SwiGLU) or MoE with shared and routed
    top-k experts: a sort-based dispatch with static capacity
    (`moe_dispatch`), the per-group dispatch of `moe_groups`, leading dense
    layers at `dense_d_ff`
  - MTP (deepseek-v3): one extra block predicting token t + 2, in the loss

  forward_hidden   tokens [B, S] -> (final hidden states [B, S, D], the
                   router aux loss); one `flash_attention` launch per layer
                   (`kernels/ops.py`). Given a cache, it also writes each
                   layer's roped K and V (GQA; the last s_cache positions at
                   slot p % s_cache in a sliding-window ring) or its normed
                   kv latent and roped k_rope (MLA) into it, and its MoE
                   layers dispatch dropless: the prefill of `serve/engine.py`
  logits_from_hidden, forward (-> logits, aux)
  init_cache, decode_step
                   one token against a static cache per layer: GQA's
                   [B, Hkv, s_cache, hd] K and V (s_cache = min(max_seq,
                   window) with a window: a ring buffer, masked by the
                   reference's age rule), MLA's latent {"ckv", "kr"};
                   decode attention is plain einsums in f32, positions past
                   `pos` masked with -1e30, as in the JAX package (no kernel
                   there either); MoE dropless
  loss_fn          the training loss: next-token CE, plain or blockwise
                   (`fused_ce`), + 0.3 x the MTP block's CE + router_aux_coef
                   x the aux loss, with `remat` around each layer

Parameters keep the JAX layout and names: the layers are stacked with a
leading [n_layers] axis per stack ("dense_layers", then "moe_layers"), and
each parameter's path in the JAX tree is recorded where it is made
(`param_paths`); its name in `params` is the path joined by "_"
("dense_layers_attn_wq", "moe_layers_mlp_shared_w_gate", "mtp_norm_h_g"),
which is also how `load_jax_params` flattens a JAX parameter tree. The
parameters do not require grad, so serving runs without autograd; training
(`train/step.py`) differentiates `loss_fn` with respect to its own tensors,
substituted for them, and gradients flow through the `flash_attention`
kernel (its backward is the plain one, `kernels/ref.py`) and through the
MoE dispatch's gathers and scatters by index.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import LMConfig
from repro_torch.graph.structs import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ATTENTION_NEG_INF
from repro_torch.models import common

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STACKS = ("dense_layers", "moe_layers")
# the MTP block's weight in the loss (the JAX package's loss_fn)
MTP_WEIGHT = 0.3


def check_supported(cfg: LMConfig) -> None:
    """Raise NotImplementedError for a config value neither package runs."""
    missing = [name for name, unsupported in (
        (f"attention={cfg.attention!r}", cfg.attention not in ("gqa", "mla")),
        ("attention='mla' without kv_lora_rank",
         cfg.attention == "mla" and not cfg.kv_lora_rank),
        (f"mlp={cfg.mlp!r}", cfg.mlp not in ("swiglu", "gelu")),
        # the JAX package's experts and shared experts are SwiGLU only
        ("moe with mlp='gelu'", cfg.moe and cfg.mlp != "swiglu"),
        (f"norm={cfg.norm!r}", cfg.norm not in ("rmsnorm", "layernorm")),
        (f"dtype={cfg.dtype!r}", cfg.dtype not in DTYPES),
    ) if unsupported]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not supported")


def _save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of remat="dots": keep the outputs of
    matrix products without batch dimensions (`jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable`), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd).transpose(1, 2)  # [B, H, S, hd]


# ------------------------------------------------------------------------ MoE
def moe_dispatch(x2d: torch.Tensor, router: torch.Tensor, cfg: LMConfig,
                 dropless: bool = False):
    """Sort-based top-k dispatch with static capacity (the JAX package's
    `moe_dispatch`): the router's softmax in f32, top-k with the gates
    renormalised, the Switch aux loss E * sum_e f_e P_e, a stable sort of
    the T*k (token, expert) entries by expert, each entry's place in its
    expert's run, and a slot e * capacity + place for a kept entry or the
    trash slot E * capacity for a dropped one. dropless=True sizes every
    expert at T, so that nothing drops (serving).

    Returns (slot int64[T*k], token_of int64[T*k], keep bool[T*k],
    gate f32[T*k], aux_loss, capacity)."""
    t = x2d.shape[0]
    e, k = cfg.n_routed, cfg.top_k
    logits = x2d.float() @ router                             # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1, sorted=True)  # [T, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    inv = probs.mean(0)
    frac = F.one_hot(top_i, e).float().sum(1).mean(0) / k
    aux = e * (frac * inv).sum()
    flat_e = top_i.reshape(-1)                                # [T*k]
    order = torch.argsort(flat_e, stable=True)                # jnp.argsort is stable
    sorted_e = flat_e[order]
    token_of = order // k
    capacity = t if dropless else int(math.ceil(t * k / e * cfg.capacity_factor))
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=x2d.device))
    pos_in_e = torch.arange(t * k, device=x2d.device) - starts[sorted_e]
    keep = pos_in_e < capacity
    # dropped entries go to a dedicated trash slot (e*capacity): writing them
    # to a clipped in-range slot would clobber a kept token's buffer row
    slot = torch.where(keep, sorted_e * capacity + pos_in_e.clamp(0, capacity - 1),
                       e * capacity)
    gate = top_p.reshape(-1)[order]
    return slot, token_of, keep, gate, aux, capacity


def _dispatch(x2d, slot, token_of, keep, n_slots):
    """The expert input buffer [n_slots, D]: each kept entry's token row at
    its slot, zeros elsewhere (the trash slot, row n_slots, is cut off)."""
    rows = torch.where(keep[:, None], x2d[token_of], torch.zeros((), dtype=x2d.dtype,
                                                                 device=x2d.device))
    buf = x2d.new_zeros((n_slots + 1, x2d.shape[1])).index_put((slot,), rows)
    return buf[:-1]


def _combine(ye_flat, slot, token_of, keep, gate, t):
    """The gate-weighted sum of each token's expert outputs: ye_flat
    [n_slots, D] read at the entries' slots (the trash slot reads the last
    row, as JAX clamps an out-of-range gather, times a zero gate), summed
    by token (`segment_sum`)."""
    rows = ye_flat[slot.clamp_max(ye_flat.shape[0] - 1)]
    contrib = rows * (gate * keep)[:, None].to(ye_flat.dtype)
    return ye_flat.new_zeros((t, ye_flat.shape[1])).index_add(0, token_of, contrib)


# logical sharding specs of the reference's `init`, by the parameter's key
# (a norm's gains and biases are (None,) wherever they are)
_ATTN_SPECS = {
    "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"), "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"), "bq": ("heads",), "bk": ("kv_heads",),
    "bv": ("kv_heads",), "q_norm": (None,), "k_norm": (None,),
    "wq_a": ("embed", None), "q_a_norm": (None,), "wq_b": (None, "heads"),
    "wkv_a": ("embed", None), "kv_a_norm": (None,), "wkv_b": (None, "heads"),
}
_MLP_SPECS = {
    "w_in": ("embed", "ff"), "b_in": ("ff",), "w_out": ("ff", "embed"),
    "b_out": (None,), "w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
}
_MOE_SPECS = {
    "router": ("embed", None), "w_gate": ("expert", "expert_embed", None),
    "w_up": ("expert", "expert_embed", None), "w_down": ("expert", None, "expert_embed"),
}


def _param_spec(cfg: LMConfig, path: Tuple[str, ...]) -> Tuple:
    stacked = path[0] in STACKS
    rest = path[1:] if stacked else (path[2:] if path[:2] == ("mtp", "layer") else path)
    key = rest[-1]
    if path == ("embed",):
        spec = ("vocab", "embed")
    elif path == ("lm_head",):
        spec = ("embed", "vocab")
    elif path == ("mtp", "proj"):
        spec = ("embed", None)
    elif key in ("g", "b"):
        spec = (None,)
    elif rest[0] == "attn":
        spec = _ATTN_SPECS[key]
    elif path[0] == "moe_layers" and len(rest) == 2:
        spec = _MOE_SPECS[key]
    else:
        spec = _MLP_SPECS[key]
    return ((None,) + spec) if stacked else spec


def cache_specs(cfg: LMConfig) -> Dict:
    """The logical sharding specs of `Transformer.init_cache`'s cache (the
    reference's `cache_specs`)."""
    if cfg.attention == "mla":
        per_layer = {"ckv": (None, "batch", None, None), "kr": (None, "batch", None, None)}
    else:
        per_layer = {"k": (None, "batch", "kv_heads", None, None),
                     "v": (None, "batch", "kv_heads", None, None)}
    return {"layers": per_layer, "pos": ()}


class Transformer(nn.Module):
    """The decoder (`cfg`), weights drawn from
    `torch.Generator(device).manual_seed(seed)` on `device`, which defaults
    to `cuda` (raising where there is none); `device="cpu"` runs the plain
    versions of the kernels."""

    def __init__(self, cfg: LMConfig, device=None, seed: int = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        gen = common.generator(dev, seed)
        dt = DTYPES[cfg.dtype]
        d = cfg.d_model
        self.cfg = cfg
        tensors: Dict[str, torch.Tensor] = {}
        self._paths: Dict[str, Tuple[str, ...]] = {}

        def add(path, t):
            name = "_".join(path)
            tensors[name] = t
            self._paths[name] = tuple(path)

        def dense(lead, d_in, d_out, dtype=dt):
            return common.normal(gen, lead + (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)

        def ones(lead, n):
            return torch.ones(lead + (n,), dtype=dt, device=dev)

        def zeros(lead, n):
            return torch.zeros(lead + (n,), dtype=dt, device=dev)

        def norm(path, lead, n):
            add(path + ("g",), ones(lead, n))
            if cfg.norm == "layernorm":
                add(path + ("b",), zeros(lead, n))

        def mlp(path, lead, d_ff):
            if cfg.mlp == "gelu":
                add(path + ("w_in",), dense(lead, d, d_ff))
                add(path + ("b_in",), zeros(lead, d_ff))
                add(path + ("w_out",), dense(lead, d_ff, d))
                add(path + ("b_out",), zeros(lead, d))
            else:
                add(path + ("w_gate",), dense(lead, d, d_ff))
                add(path + ("w_up",), dense(lead, d, d_ff))
                add(path + ("w_down",), dense(lead, d_ff, d))

        def attention(path, lead):
            h, hd = cfg.n_heads, cfg.hd
            if cfg.attention == "mla":
                qk = cfg.qk_nope_dim + cfg.qk_rope_dim
                if cfg.q_lora_rank:
                    add(path + ("wq_a",), dense(lead, d, cfg.q_lora_rank))
                    add(path + ("q_a_norm",), ones(lead, cfg.q_lora_rank))
                    add(path + ("wq_b",), dense(lead, cfg.q_lora_rank, h * qk))
                else:
                    add(path + ("wq",), dense(lead, d, h * qk))
                add(path + ("wkv_a",), dense(lead, d, cfg.kv_lora_rank + cfg.qk_rope_dim))
                add(path + ("kv_a_norm",), ones(lead, cfg.kv_lora_rank))
                add(path + ("wkv_b",), dense(lead, cfg.kv_lora_rank,
                                             h * (cfg.qk_nope_dim + cfg.v_head_dim)))
                add(path + ("wo",), dense(lead, h * cfg.v_head_dim, d))
                return
            add(path + ("wq",), dense(lead, d, h * hd))
            add(path + ("wk",), dense(lead, d, cfg.n_kv_heads * hd))
            add(path + ("wv",), dense(lead, d, cfg.n_kv_heads * hd))
            add(path + ("wo",), dense(lead, h * hd, d))
            if cfg.qkv_bias:
                add(path + ("bq",), zeros(lead, h * hd))
                add(path + ("bk",), zeros(lead, cfg.n_kv_heads * hd))
                add(path + ("bv",), zeros(lead, cfg.n_kv_heads * hd))
            if cfg.qk_norm:
                add(path + ("q_norm",), ones(lead, hd))
                add(path + ("k_norm",), ones(lead, hd))

        def layer(path, lead, moe):
            norm(path + ("ln1",), lead, d)
            attention(path + ("attn",), lead)
            norm(path + ("ln2",), lead, d)
            if not moe:
                mlp(path + ("mlp",), lead,
                    (cfg.dense_d_ff or cfg.d_ff) if cfg.moe else cfg.d_ff)
                return
            e, f = cfg.n_routed, cfg.d_ff
            add(path + ("mlp", "router"), dense(lead, d, e, torch.float32))
            add(path + ("mlp", "w_gate"), common.normal(gen, lead + (e, d, f),
                                                        1.0 / math.sqrt(d), dt))
            add(path + ("mlp", "w_up"), common.normal(gen, lead + (e, d, f),
                                                      1.0 / math.sqrt(d), dt))
            add(path + ("mlp", "w_down"), common.normal(gen, lead + (e, f, d),
                                                        1.0 / math.sqrt(f), dt))
            if cfg.n_shared:
                mlp(path + ("mlp", "shared"), lead, cfg.n_shared * f)

        add(("embed",), common.normal(gen, (cfg.vocab, d), 0.02, dt))
        norm(("final_norm",), (), d)
        n_dense = cfg.first_dense_layers if cfg.moe else cfg.n_layers
        n_moe = cfg.n_layers - n_dense if cfg.moe else 0
        if n_dense:
            layer(("dense_layers",), (n_dense,), moe=False)
        if n_moe:
            layer(("moe_layers",), (n_moe,), moe=True)
        if not cfg.tie_embeddings:
            add(("lm_head",), dense((), d, cfg.vocab))
        if cfg.mtp:
            add(("mtp", "proj"), dense((), 2 * d, d))
            norm(("mtp", "norm_h"), (), d)
            norm(("mtp", "norm_e"), (), d)
            layer(("mtp", "layer"), (), moe=False)
        common.register_params(self, tensors)

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        """The parameters by their flattened JAX names."""
        return self._parameters

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def load_jax_params(self, tree) -> "Transformer":
        """Copy a JAX parameter tree ({"embed", "final_norm": {"g"[, "b"]},
        "dense_layers" / "moe_layers": {"ln1", "attn", "ln2", "mlp"},
        "mtp": {...}, ...}, leaves as numpy arrays, the layers' with their
        stack's leading axis) into this module; names and shapes must
        match."""
        common.load_flat(self.params, tree)
        return self

    def param_paths(self) -> Dict[str, tuple]:
        """Each parameter's name -> its path in the JAX parameter tree, as
        recorded when it was made ("dense_layers_attn_wq" -> ("dense_layers",
        "attn", "wq"), "moe_layers_mlp_shared_w_gate" -> ("moe_layers",
        "mlp", "shared", "w_gate"))."""
        return dict(self._paths)

    def param_specs(self) -> Dict:
        """The reference's logical sharding spec of each parameter, in the
        JAX tree (the second value of its `init`), from its recorded path;
        a stacked layer's spec leads with None for the stack's axis."""
        return common.nest({name: _param_spec(self.cfg, path)
                            for name, path in self._paths.items()}, self._paths)

    def _group(self, prefix: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
        """The parameters under `prefix`, by the rest of their path joined
        with "_" ("attn_wq", "mlp_shared_w_gate")."""
        n = len(prefix)
        return {"_".join(path[n:]): self.params[name]
                for name, path in self._paths.items() if path[:n] == prefix}

    def _layers(self) -> List[Tuple[Dict[str, torch.Tensor], bool]]:
        """(parameters by their names inside the layer, is MoE) for each
        layer, the dense stack then the MoE stack: views of the stacked
        tensors by `unbind`, whose backward stacks the layers' gradients once
        (indexing layer by layer would make each layer's gradient a
        zero-filled [L, ...] tensor, summed L times)."""
        out = []
        for stack in STACKS:
            stacked = {k: v.unbind(0) for k, v in self._group((stack,)).items()}
            if stacked:
                n = len(next(iter(stacked.values())))
                out += [({k: v[i] for k, v in stacked.items()}, stack == "moe_layers")
                        for i in range(n)]
        return out

    def _norm(self, p, name, x):
        cfg = self.cfg
        if cfg.norm == "layernorm":
            return common.layer_norm(x, p[name + "_g"], p[name + "_b"], cfg.norm_eps)
        return common.rms_norm(x, p[name + "_g"], cfg.norm_eps)

    # -------------------------------------------------------------- attention
    def _gqa_qkv(self, p, x, positions):
        """Projections, heads, qk-norm and RoPE -> q [B, H, S, hd], k, v
        [B, Hkv, S, hd]; positions int[B, S] (or [B, 1, 1] in decode)."""
        cfg = self.cfg
        q, k, v = x @ p["attn_wq"], x @ p["attn_wk"], x @ p["attn_wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["attn_bq"], k + p["attn_bk"], v + p["attn_bv"]
        q = _split_heads(q, cfg.n_heads, cfg.hd)
        k = _split_heads(k, cfg.n_kv_heads, cfg.hd)
        v = _split_heads(v, cfg.n_kv_heads, cfg.hd)
        if cfg.qk_norm:
            q = common.rms_norm(q, p["attn_q_norm"], cfg.norm_eps)
            k = common.rms_norm(k, p["attn_k_norm"], cfg.norm_eps)
        pos = positions if positions.dim() == 3 else positions[:, None, :]
        return (common.apply_rope(q, pos, cfg.rope_theta),
                common.apply_rope(k, pos, cfg.rope_theta), v)

    def _gqa_attention(self, p, x, positions, kv_out=None):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._gqa_qkv(p, x, positions)
        if kv_out is not None:  # prefill: the roped K and V go to the cache
            kc, vc = kv_out
            s_cache = kc.shape[2]
            if s <= s_cache:
                kc[:, :, :s], vc[:, :, :s] = k, v
            else:  # a ring shorter than the prompt keeps its last s_cache
                keep = torch.arange(s - s_cache, s, device=x.device)
                kc[:, :, keep % s_cache] = k[:, :, keep]
                vc[:, :, keep % s_cache] = v[:, :, keep]
        o = kops.attention(q, k, v, causal=True, window=cfg.window)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
        return o @ p["attn_wo"]

    def _mla_q(self, p, x):
        """[B, S, D] -> q [B, H, S, qk_nope + qk_rope], before RoPE."""
        cfg = self.cfg
        b, s, _ = x.shape
        if cfg.q_lora_rank:
            cq = common.rms_norm(x @ p["attn_wq_a"], p["attn_q_a_norm"], cfg.norm_eps)
            q = cq @ p["attn_wq_b"]
        else:
            q = x @ p["attn_wq"]
        return q.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim
                         ).transpose(1, 2)

    def _mla_latent(self, p, x):
        """[B, S, D] -> (c_kv [B, S, r] normed, k_rope [B, S, dr] before
        RoPE)."""
        cfg = self.cfg
        kv_a = x @ p["attn_wkv_a"]                          # [B, S, r + dr]
        c_kv = common.rms_norm(kv_a[..., :cfg.kv_lora_rank], p["attn_kv_a_norm"],
                               cfg.norm_eps)
        return c_kv, kv_a[..., cfg.kv_lora_rank:]

    def _mla_attention(self, p, x, positions, kv_out=None):
        """MLA prefill and training (the JAX package's `_mla_qkv` and
        `_mla_attention`): q = [q_nope, q_rope], k = [k_nope, k_rope
        broadcast over the heads] of head dim qk_nope + qk_rope, v of
        v_head_dim, through the kernel."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        q = self._mla_q(p, x)
        c_kv, k_rope = self._mla_latent(p, x)
        kv = (c_kv @ p["attn_wkv_b"]).reshape(b, s, h, dn + dv).transpose(1, 2)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        pos = positions[:, None, :]
        q_rope = common.apply_rope(q[..., dn:], pos, cfg.rope_theta)
        k_rope = common.apply_rope(k_rope[:, None], pos, cfg.rope_theta)  # [B, 1, S, dr]
        if kv_out is not None:  # prefill: the latent and the roped k_rope
            kv_out[0][:, :s] = c_kv
            kv_out[1][:, :s] = k_rope[:, 0]
        q = torch.cat([q[..., :dn], q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, h, s, dr)], dim=-1)
        o = kops.attention(q, k, v, causal=True, window=None)
        o = o.transpose(1, 2).reshape(b, s, h * dv)
        return o @ p["attn_wo"]

    # -------------------------------------------------------------------- MLP
    def _mlp(self, p, x, prefix="mlp_"):
        if self.cfg.mlp == "gelu":
            return (common.gelu(x @ p[prefix + "w_in"] + p[prefix + "b_in"])
                    @ p[prefix + "w_out"] + p[prefix + "b_out"])
        return common.swiglu(x, p[prefix + "w_gate"], p[prefix + "w_up"],
                             p[prefix + "w_down"])

    def _experts(self, p, xe, spec):
        """SwiGLU of every expert on its buffer rows (einsum `spec` over the
        expert axis e)."""
        h = F.silu(torch.einsum(spec[0], xe, p["mlp_w_gate"])) * torch.einsum(
            spec[0], xe, p["mlp_w_up"])
        return torch.einsum(spec[1], h, p["mlp_w_down"])

    def _moe_block(self, p, x2d, dropless: bool = False):
        """Routed experts (+ shared) on tokens [T, D] -> ([T, D], aux). The
        expert products and the segment sum are plain PyTorch ops, as they
        are plain XLA ops outside any Pallas kernel in the JAX package.
        Dropless, the buffers hold the largest expert's load (read once from
        the device) in place of T rows per expert: the same products of the
        same rows, without E x T x D of zeros."""
        cfg = self.cfg
        t, d = x2d.shape
        if cfg.moe_groups > 1 and not dropless and t % cfg.moe_groups == 0:
            return self._moe_block_grouped(p, x2d)
        e = cfg.n_routed
        slot, token_of, keep, gate, aux, cap = moe_dispatch(
            x2d, p["mlp_router"], cfg, dropless=dropless)
        # every entry is kept: slot = expert * T + place. A meta tensor (the
        # dry run) has no load to read and keeps the reference's T rows
        if dropless and not x2d.is_meta:
            expert, place = slot // cap, slot % cap
            cap = int(place.max()) + 1
            slot = expert * cap + place
        xe = _dispatch(x2d, slot, token_of, keep, e * cap).reshape(e, cap, d)
        ye = self._experts(p, xe, ("ecd,edf->ecf", "ecf,efd->ecd"))
        y = _combine(ye.reshape(e * cap, d), slot, token_of, keep, gate, t)
        if cfg.n_shared:
            y = y + self._mlp(p, x2d, "mlp_shared_")
        return y, aux

    def _moe_block_grouped(self, p, x2d):
        """The per-group dispatch (`moe_groups` = G > 1, T % G == 0): sort,
        capacity, scatter and gather within each group of T / G tokens; the
        aux loss is the mean over the groups. The JAX package's sharding
        constraints (and `moe_gather_weights`) place nothing on one card."""
        cfg = self.cfg
        t, d = x2d.shape
        e, g = cfg.n_routed, cfg.moe_groups
        tl = t // g
        xg = x2d.reshape(g, tl, d)
        metas, bufs, auxes = [], [], []
        for i in range(g):
            slot, token_of, keep, gate, aux, cap = moe_dispatch(xg[i], p["mlp_router"], cfg)
            bufs.append(_dispatch(xg[i], slot, token_of, keep, e * cap).reshape(e, cap, d))
            metas.append((slot, token_of, keep, gate))
            auxes.append(aux)
        xe = torch.stack(bufs).transpose(0, 1)                  # [E, G, C, D]
        ye = self._experts(p, xe, ("egcd,edf->egcf", "egcf,efd->egcd")).transpose(0, 1)
        y = torch.cat([_combine(ye[i].reshape(-1, d), *metas[i], tl)
                       for i in range(g)])
        if cfg.n_shared:
            y = y + self._mlp(p, x2d, "mlp_shared_")
        return y, torch.stack(auxes).mean()

    # ---------------------------------------------------------------- forward
    def _block(self, p, x, positions, moe=False, kv_out=None):
        """One layer -> (x, its router aux loss, 0 for a dense layer). MoE
        dispatches dropless when the layer fills a cache (serving)."""
        attend = self._mla_attention if self.cfg.attention == "mla" else self._gqa_attention
        h = x + attend(p, self._norm(p, "ln1", x), positions, kv_out)
        hn = self._norm(p, "ln2", h)
        if moe:
            b, s, d = hn.shape
            y, aux = self._moe_block(p, hn.reshape(b * s, d), dropless=kv_out is not None)
            return h + y.reshape(b, s, d), aux
        return h + self._mlp(p, hn), torch.zeros((), device=x.device)

    def _cache_slices(self, cache, i):
        if cache is None:
            return None
        layers = cache["layers"]
        if self.cfg.attention == "mla":
            return layers["ckv"][i], layers["kr"][i]
        return layers["k"][i], layers["v"][i]

    def forward_hidden(self, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       cache: Optional[dict] = None,
                       remat=False):
        """Token ids [B, S] -> (final hidden states [B, S, D], the router aux
        loss summed over the layers). With `cache` (from `init_cache`), each
        layer's K and V (or MLA's latent) are written into it, and MoE
        dispatches dropless. `remat` (the JAX package's): True recomputes
        each layer in the backward from its input (`torch.utils.checkpoint`),
        "dots" / "dots_with_no_batch_dims" save the layer's matrix products
        without batch dimensions and recompute the rest; False keeps every
        activation. The values are the same."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
        x = self.params["embed"][tokens.long()]
        block = self._block
        if remat in ("dots", "dots_with_no_batch_dims"):
            block = functools.partial(
                _ckpt.checkpoint, self._block, use_reentrant=False,
                context_fn=functools.partial(
                    _ckpt.create_selective_checkpoint_contexts, _save_dots))
        elif remat:  # full remat: keep only the layer boundaries
            block = functools.partial(_ckpt.checkpoint, self._block,
                                      use_reentrant=False)
        aux_total = torch.zeros((), device=x.device)
        # the layers' tensors are taken here, so that a recompute in the
        # backward reads the ones this forward read
        for i, (p, moe) in enumerate(self._layers()):
            x, aux = block(p, x, positions, moe, self._cache_slices(cache, i))
            aux_total = aux_total + aux
        return self._norm(self.params, "final_norm", x), aux_total

    def logits_from_hidden(self, h: torch.Tensor) -> torch.Tensor:
        """[..., D] -> logits [..., V] in the model's dtype."""
        if self.cfg.tie_embeddings:
            return h @ self.params["embed"].T
        return h @ self.params["lm_head"]

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None, remat=False):
        """-> (logits [B, S, V], the router aux loss), as the JAX package's
        `forward`."""
        h, aux = self.forward_hidden(tokens, positions, remat=remat)
        return self.logits_from_hidden(h), aux

    # ------------------------------------------------------------------- loss
    def loss(self, batch, remat=False):
        """Next-token CE over {"tokens", "labels"[, "mask"]}, + 0.3 x the
        MTP block's CE on the labels rolled by one (its last column masked),
        + router_aux_coef x the aux loss -> (loss, {"ce", "aux"}), "ce"
        with the MTP term, as the JAX package reports it. `cfg.fused_ce` > 0
        streams the CE over vocabulary blocks of that size
        (`common.blockwise_cross_entropy`)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        h, aux = self.forward_hidden(tokens, remat=remat)
        if cfg.fused_ce:
            head = self.params["embed"].T if cfg.tie_embeddings else self.params["lm_head"]
            loss = common.blockwise_cross_entropy(
                h, head, labels, batch.get("mask"), block=cfg.fused_ce)
        else:
            loss = common.cross_entropy(self.logits_from_hidden(h), labels,
                                        batch.get("mask"))
        if cfg.mtp:
            mp = self._group(("mtp",))
            # predict t+2: combine h_t with the embedding of the (t+1) label
            emb_next = self.params["embed"][labels.long()]
            comb = torch.cat([self._norm(mp, "norm_h", h),
                              self._norm(mp, "norm_e", emb_next)], dim=-1) @ mp["proj"]
            b, s = tokens.shape
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
            h2, _ = self._block(self._group(("mtp", "layer")), comb, positions)
            logits2 = self.logits_from_hidden(self._norm(self.params, "final_norm", h2))
            labels2 = torch.roll(labels, -1, dims=1)
            mask2 = torch.ones(labels2.shape, device=labels.device)
            mask2[:, -1:] = 0.0
            loss = loss + MTP_WEIGHT * common.cross_entropy(logits2, labels2, mask2)
        return loss + cfg.router_aux_coef * aux, {"ce": loss, "aux": aux}

    # ----------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_seq: int) -> dict:
        """Static cache, zeros in the model's dtype: GQA {"layers": {"k",
        "v": [L, B, Hkv, s_cache, hd]}, "pos": 0}, s_cache = min(max_seq,
        window) with a sliding window (a ring buffer), else max_seq; MLA
        {"layers": {"ckv": [L, B, max_seq, kv_lora_rank], "kr": [L, B,
        max_seq, qk_rope_dim]}, "pos": 0}, the latent alone."""
        cfg = self.cfg
        dt, dev = DTYPES[cfg.dtype], self.device
        if cfg.attention == "mla":
            lead = (cfg.n_layers, batch, max_seq)
            layers = {"ckv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dt, device=dev),
                      "kr": torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dt, device=dev)}
        else:
            s_cache = min(max_seq, cfg.window) if cfg.window else max_seq
            shape = (cfg.n_layers, batch, cfg.n_kv_heads, s_cache, cfg.hd)
            layers = {"k": torch.zeros(shape, dtype=dt, device=dev),
                      "v": torch.zeros(shape, dtype=dt, device=dev)}
        return {"layers": layers, "pos": 0}

    def _gqa_decode(self, p, x, kcache, vcache, pos: int):
        """x [B, 1, D] -> [B, 1, D]; writes this token's K, V at `pos`, or
        at pos % s_cache in a sliding-window ring, masked by the JAX
        package's age rule."""
        cfg = self.cfg
        b, hd = x.shape[0], cfg.hd
        s_cache = kcache.shape[2]
        posb = torch.full((b, 1, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = self._gqa_qkv(p, x, posb)             # [B, H, 1, hd]
        write = pos % s_cache if cfg.window else pos
        kcache[:, :, write] = k[:, :, 0]
        vcache[:, :, write] = v[:, :, 0]
        # GQA: fold the group into the q batch for a single matvec
        group = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(b, cfg.n_kv_heads, group, hd)
        scores = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                              kcache.float()) / math.sqrt(hd)
        idx = torch.arange(s_cache, device=x.device)
        if cfg.window:
            base = pos - pos % s_cache
            age = pos - torch.where(idx <= pos % s_cache, base + idx,
                                    base - s_cache + idx)
            valid = (age >= 0) & (age < cfg.window) & (idx < min(pos + 1, s_cache))
        else:
            valid = idx <= pos
        scores = torch.where(valid, scores, ATTENTION_NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bkgs,bksd->bkgd", probs, vcache.float())
        o = o.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
        return o @ p["attn_wo"]

    def _mla_decode(self, p, x, ckv, kr, pos: int):
        """Absorbed MLA over the latent cache (the JAX package's
        `_mla_decode_layer`): x [B, 1, D] -> [B, 1, D]; writes this token's
        normed latent and roped k_rope at `pos`. W_uk is absorbed into q and
        W_uv applied after the sum over positions, in f32, the scores scaled
        by 1 / sqrt(qk_nope + qk_rope)."""
        cfg = self.cfg
        b = x.shape[0]
        h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        posb = torch.full((b, 1, 1), pos, dtype=torch.int32, device=x.device)
        q = self._mla_q(p, x)                                   # [B, H, 1, dn + dr]
        q_rope = common.apply_rope(q[..., dn:], posb, cfg.rope_theta)
        c_new, kr_new = self._mla_latent(p, x)                  # [B, 1, r], [B, 1, dr]
        ckv[:, pos] = c_new[:, 0]
        kr[:, pos] = common.apply_rope(kr_new[:, None], posb, cfg.rope_theta)[:, 0, 0]
        wkv_b = p["attn_wkv_b"].reshape(r, h, dn + dv)
        w_uk, w_uv = wkv_b[..., :dn].float(), wkv_b[..., dn:].float()
        q_lat = torch.einsum("bhd,rhd->bhr", q[:, :, 0, :dn].float(), w_uk)
        ckv32 = ckv.float()
        scores = (torch.einsum("bhr,bsr->bhs", q_lat, ckv32)
                  + torch.einsum("bhd,bsd->bhs", q_rope[:, :, 0].float(), kr.float())
                  ) / math.sqrt(dn + dr)
        valid = torch.arange(ckv.shape[1], device=x.device) <= pos
        scores = torch.where(valid, scores, ATTENTION_NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", probs, ckv32)
        o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
        return o.reshape(b, 1, h * dv).to(x.dtype) @ p["attn_wo"]

    def decode_step(self, token: torch.Tensor, cache: dict):
        """One decode step: token int[B] -> (logits [B, V], cache). The cache
        is updated in place (this token's entry, then pos + 1) and returned.
        MoE layers dispatch dropless."""
        pos = int(cache["pos"])
        x = self.params["embed"][token.long()][:, None, :]   # [B, 1, D]
        b = x.shape[0]
        for i, (p, moe) in enumerate(self._layers()):
            hn = self._norm(p, "ln1", x)
            if self.cfg.attention == "mla":
                o = self._mla_decode(p, hn, *self._cache_slices(cache, i), pos)
            else:
                o = self._gqa_decode(p, hn, *self._cache_slices(cache, i), pos)
            h = x + o
            hn2 = self._norm(p, "ln2", h)
            if moe:
                y, _ = self._moe_block(p, hn2.reshape(b, -1), dropless=True)
                y = y.reshape(b, 1, -1)
            else:
                y = self._mlp(p, hn2)
            x = h + y
        h = self._norm(self.params, "final_norm", x)
        cache["pos"] = pos + 1
        return self.logits_from_hidden(h)[:, 0], cache


def loss_fn(model: Transformer, batch, remat=False):
    """The training loss (the JAX package's `loss_fn(params, cfg, batch,
    remat)`, with the model in place of params and cfg) -> (loss, metrics)."""
    return model.loss(batch, remat=remat)
