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
from repro_torch.launch import mesh as rmesh
from repro_torch.models import common
from repro_torch.sharding import resolve_axis_spec

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


class MeshPlan:
    """How the training forward runs on a `launch/mesh.RankMesh` of (data,
    model) ranks, as the reference's rules place each leaf.

    Every parameter arrives as this rank's block of its reference spec
    (`_param_spec`, resolved with the divisibility guard); `use` turns a
    block into the tensor a computation needs:
      - FSDP: dimensions on `data` are all-gathered at use (inside the remat
        boundary, so that a recompute gathers again); the backward
        reduce-scatters the gradient over `data`, which is also the
        data-parallel sum (this rank's chunk alone when the batch is
        replicated over `data`, `batch_split` False);
      - TP / EP / vocab: heads, ff columns, experts and vocabulary rows split
        evenly over `model` where their count divides (`split`) are used
        where they lie; a leaf whose block is not the part this rank
        computes (qwen2's kv heads at model = 4, a replicated bias) is
        gathered over `model` and the part taken after `copy_to_model`.
    The computation split over `model` is bracketed by Megatron's pair
    (`launch/mesh.copy_to_model` in, `reduce_from_model` out), so everything
    else is replicated over `model`, forward and backward.

    One process runs the same code on the plan of `launch/mesh.local_mesh`
    (mesh=None), a (1, 1) mesh whose collectives are identities: nothing
    splits and every leaf is used whole."""

    def __init__(self, model: "Transformer", mesh=None, batch_split: bool = False):
        mesh = rmesh.local_mesh() if mesh is None else mesh
        self.mesh, self.batch_split = mesh, batch_split
        self.M, self.m = mesh.size("model"), mesh.index("model")
        self.specs: Dict[Tuple, Tuple] = {}
        for name, path in model.param_paths().items():
            spec = resolve_axis_spec(tuple(model.params[name].shape),
                                     _param_spec(model.cfg, path), mesh.shape)
            if path[0] in STACKS:   # a layer's view drops the stack's axis
                self.specs[(path[0], "_".join(path[1:]))] = spec[1:]
            elif path[:2] == ("mtp", "layer"):
                self.specs[("mtp_layer", "_".join(path[2:]))] = spec
            else:
                self.specs[(None, name)] = spec

    def layer(self, stack: str) -> "_LayerPlan":
        return _LayerPlan(self, stack)

    def split(self, n: int) -> Tuple[int, int, bool]:
        """(first, count, split) of n heads, columns, experts or vocabulary
        rows on this model rank: an even split where `model` divides n, else
        all n on every model rank (the computation replicated)."""
        if self.M > 1 and n % self.M == 0:
            return self.m * (n // self.M), n // self.M, True
        return 0, n, False

    def copy(self, x):
        return rmesh.copy_to_model(x, self.mesh)

    def reduce(self, x):
        return rmesh.reduce_from_model(x, self.mesh)

    def use(self, t, spec, want=None):
        """The block t of a leaf stored under `spec`, as a computation uses
        it: want=None, the whole leaf in a computation replicated over
        `model`; "f", the whole leaf in a computation split over `model`;
        (dim, sel), the entries sel (a slice or an index tensor) of dim in a
        computation split over `model`."""
        mesh = self.mesh
        for dim, ax in enumerate(spec):
            if ax == "data":
                t = rmesh.gather_data(t, mesh, dim, self.batch_split)
        on_model = [d for d, ax in enumerate(spec) if ax == "model"]
        if isinstance(want, tuple):
            dim, sel = want
            n = t.shape[dim]
            if (on_model == [dim] and isinstance(sel, slice)
                    and (sel.start, sel.stop) == (self.m * n, (self.m + 1) * n)):
                return t            # the block is the part this rank computes
        for d in on_model:
            t = rmesh.gather_from_model(t, mesh, d)
        if want is None:
            return t
        t = self.copy(t)
        if want == "f":
            return t
        dim, sel = want
        if isinstance(sel, slice):
            return t.narrow(dim, sel.start, sel.stop - sel.start)
        return t.index_select(dim, sel)


class _LayerPlan:
    """A `MeshPlan` seen from one stack's layers: `w(p, key, want)` is the
    layer's parameter `key` as `MeshPlan.use` gives it."""

    def __init__(self, plan: MeshPlan, stack: str):
        self.plan, self.stack = plan, stack

    def w(self, p, key, want=None):
        return self.plan.use(p[key], self.plan.specs[(self.stack, key)], want)

    def spec(self, key):
        return self.plan.specs[(self.stack, key)]


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
        self._local_plan: Optional[MeshPlan] = None

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

    def _layers(self) -> List[Tuple[Dict[str, torch.Tensor], bool, str]]:
        """(parameters by their names inside the layer, is MoE, its stack)
        for each layer, the dense stack then the MoE stack: views of the
        stacked tensors by `unbind`, whose backward stacks the layers'
        gradients once (indexing layer by layer would make each layer's
        gradient a zero-filled [L, ...] tensor, summed L times)."""
        out = []
        for stack in STACKS:
            stacked = {k: v.unbind(0) for k, v in self._group((stack,)).items()}
            if stacked:
                n = len(next(iter(stacked.values())))
                out += [({k: v[i] for k, v in stacked.items()}, stack == "moe_layers",
                         stack) for i in range(n)]
        return out

    def _norm(self, p, name, x):
        cfg = self.cfg
        if cfg.norm == "layernorm":
            return common.layer_norm(x, p[name + "_g"], p[name + "_b"], cfg.norm_eps)
        return common.rms_norm(x, p[name + "_g"], cfg.norm_eps)

    # -------------------------------------------------------------- attention
    def _gqa_qkv(self, p, x, positions, lp):
        """Projections, heads, qk-norm and RoPE -> (q [B, Hl, S, hd] of this
        model rank's heads, k, v [B, Hkv_l, S, hd] of the kv heads they
        read, the output rows' slice, whether the heads split); positions
        int[B, S] (or [B, 1, 1] in decode). On a mesh the q heads split
        over `model`, each reading kv head h // group by its global index
        (hazard m); where a rank's q heads do not map onto whole groups of
        its kv heads, k and v are expanded to one per q head."""
        cfg = self.cfg
        hd, H = cfg.hd, cfg.n_heads
        group = H // cfg.n_kv_heads
        h0, hl, split = lp.plan.split(H)
        kv_of = [(h0 + j) // group for j in range(hl)]
        kv_heads = sorted(set(kv_of))
        per = hl // len(kv_heads)
        if hl % len(kv_heads) == 0 and all(kv_of[j] == kv_heads[j // per]
                                           for j in range(hl)):
            kv_sel, hkv = slice(kv_heads[0] * hd, (kv_heads[-1] + 1) * hd), len(kv_heads)
        else:
            kv_sel = torch.cat([torch.arange(i * hd, (i + 1) * hd) for i in kv_of]
                               ).to(x.device)
            hkv = hl
        rows = slice(h0 * hd, (h0 + hl) * hd)
        wq, wkv, wn = ((1, rows), (1, kv_sel), "f") if split else (None, None, None)
        bq, bkv = ((0, rows), (0, kv_sel)) if split else (None, None)
        xs = lp.plan.copy(x) if split else x
        q = xs @ lp.w(p, "attn_wq", wq)
        k = xs @ lp.w(p, "attn_wk", wkv)
        v = xs @ lp.w(p, "attn_wv", wkv)
        if cfg.qkv_bias:
            q = q + lp.w(p, "attn_bq", bq)
            k = k + lp.w(p, "attn_bk", bkv)
            v = v + lp.w(p, "attn_bv", bkv)
        q = _split_heads(q, hl, hd)
        k = _split_heads(k, hkv, hd)
        v = _split_heads(v, hkv, hd)
        if cfg.qk_norm:
            q = common.rms_norm(q, lp.w(p, "attn_q_norm", wn), cfg.norm_eps)
            k = common.rms_norm(k, lp.w(p, "attn_k_norm", wn), cfg.norm_eps)
        pos = positions if positions.dim() == 3 else positions[:, None, :]
        return (common.apply_rope(q, pos, cfg.rope_theta),
                common.apply_rope(k, pos, cfg.rope_theta), v, rows, split)

    def _row_out(self, p, o, lp, rows, split):
        """The output projection, row-parallel on a mesh: this rank's rows
        of attn_wo, the partial sums reduced over `model`."""
        if not split:
            return o @ lp.w(p, "attn_wo")
        return lp.plan.reduce(o @ lp.w(p, "attn_wo", (0, rows)))

    def _gqa_attention(self, p, x, positions, kv_out, lp):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v, rows, split = self._gqa_qkv(p, x, positions, lp)
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
        o = o.transpose(1, 2).reshape(b, s, q.shape[1] * cfg.hd)
        return self._row_out(p, o, lp, rows, split)

    def _mla_heads(self, lp):
        """(first head, local heads, split, copy): this model rank's heads
        and the identity forward / sum-over-`model` backward that a tensor
        shared by the heads passes through when they split."""
        h0, hl, split = lp.plan.split(self.cfg.n_heads)
        return h0, hl, split, (lp.plan.copy if split else (lambda t: t))

    def _mla_q(self, p, x, lp):
        """[B, S, D] -> q [B, Hl, S, qk_nope + qk_rope] of this model rank's
        heads, before RoPE (after the q-LoRA down-projection and its norm,
        replicated)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h0, hl, split, copy = self._mla_heads(lp)
        width = cfg.qk_nope_dim + cfg.qk_rope_dim
        cols = (1, slice(h0 * width, (h0 + hl) * width)) if split else None
        if cfg.q_lora_rank:
            cq = common.rms_norm(x @ lp.w(p, "attn_wq_a"), p["attn_q_a_norm"],
                                 cfg.norm_eps)
            q = copy(cq) @ lp.w(p, "attn_wq_b", cols)
        else:
            q = copy(x) @ lp.w(p, "attn_wq", cols)
        return q.reshape(b, s, hl, width).transpose(1, 2)

    def _mla_latent(self, p, x, lp):
        """[B, S, D] -> (c_kv [B, S, r] normed, k_rope [B, S, dr] before
        RoPE), shared by the heads: replicated over `model`."""
        cfg = self.cfg
        kv_a = x @ lp.w(p, "attn_wkv_a")                     # [B, S, r + dr]
        c_kv = common.rms_norm(kv_a[..., :cfg.kv_lora_rank], p["attn_kv_a_norm"],
                               cfg.norm_eps)
        return c_kv, kv_a[..., cfg.kv_lora_rank:]

    def _mla_attention(self, p, x, positions, kv_out, lp):
        """MLA prefill and training (the JAX package's `_mla_qkv` and
        `_mla_attention`): q = [q_nope, q_rope], k = [k_nope, k_rope
        broadcast over the heads] of head dim qk_nope + qk_rope, v of
        v_head_dim, through the kernel. On a mesh the q projection, wkv_b's
        up-projection of the latent and the output rows split over `model`
        by heads."""
        cfg = self.cfg
        b, s, _ = x.shape
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        h0, hl, split, copy = self._mla_heads(lp)
        q = self._mla_q(p, x, lp)
        c_kv, k_rope = self._mla_latent(p, x, lp)
        cols = (1, slice(h0 * (dn + dv), (h0 + hl) * (dn + dv))) if split else None
        kv = (copy(c_kv) @ lp.w(p, "attn_wkv_b", cols)).reshape(
            b, s, hl, dn + dv).transpose(1, 2)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        pos = positions[:, None, :]
        q_rope = common.apply_rope(q[..., dn:], pos, cfg.rope_theta)
        k_rope = common.apply_rope(copy(k_rope)[:, None], pos, cfg.rope_theta)  # [B, 1, S, dr]
        if kv_out is not None:  # prefill: the latent and the roped k_rope
            kv_out[0][:, :s] = c_kv
            kv_out[1][:, :s] = k_rope[:, 0]
        q = torch.cat([q[..., :dn], q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, hl, s, dr)], dim=-1)
        o = kops.attention(q, k, v, causal=True, window=None)
        o = o.transpose(1, 2).reshape(b, s, hl * dv)
        return self._row_out(p, o, lp, slice(h0 * dv, (h0 + hl) * dv), split)

    # -------------------------------------------------------------------- MLP
    def _mlp(self, p, x, prefix, lp):
        """GELU with biases or SwiGLU. On a mesh, Megatron's pairing: the
        input projections column-parallel over `model` (this rank's ff
        columns), the output projection row-parallel, its partial sums
        reduced over `model`; a bias of the output added once, after the
        reduce (starcoder2's b_out)."""
        gelu = self.cfg.mlp == "gelu"
        w_in = prefix + ("w_in" if gelu else "w_gate")
        n_ff = p[w_in].shape[1] * (lp.plan.M if lp.spec(w_in)[1] == "model" else 1)
        f0, fl, split = lp.plan.split(n_ff)
        cols, rows = ((1, slice(f0, f0 + fl)), (0, slice(f0, f0 + fl))) if split \
            else (None, None)
        xs = lp.plan.copy(x) if split else x
        if gelu:
            hidden = common.gelu(xs @ lp.w(p, prefix + "w_in", cols)
                                 + lp.w(p, prefix + "b_in", rows))
            y = hidden @ lp.w(p, prefix + "w_out", rows)
        else:
            y = common.swiglu(xs, lp.w(p, prefix + "w_gate", cols),
                              lp.w(p, prefix + "w_up", cols),
                              lp.w(p, prefix + "w_down", rows))
        if split:
            y = lp.plan.reduce(y)
        return y + p[prefix + "b_out"] if gelu else y

    def _experts(self, p, xe, spec):
        """SwiGLU of every expert on its buffer rows (einsum `spec` over the
        expert axis e)."""
        h = F.silu(torch.einsum(spec[0], xe, p["mlp_w_gate"])) * torch.einsum(
            spec[0], xe, p["mlp_w_up"])
        return torch.einsum(spec[1], h, p["mlp_w_down"])

    def _moe_block(self, p, x2d, dropless: bool = False, lp=None):
        """Routed experts (+ shared) on this data rank's tokens [T_l, D] ->
        ([T_l, D], its share of the router aux loss). The expert products
        and the segment sum are plain PyTorch ops, as they are plain XLA ops
        outside any Pallas kernel in the JAX package. Dropless (serving),
        the buffers hold the largest expert's load (read once from the
        device) in place of T rows per expert: the same products of the same
        rows, without E x T x D of zeros.

        The global dispatch (moe_groups <= 1): on a mesh the tokens of every
        data rank are gathered over `data` (the backward reduce-scatters
        their cotangent), so every rank routes all T tokens identically and
        every slot and capacity drop is the reference's global one; each
        model rank runs only its own experts (EP: the expert axis split over
        `model`) on its own slots, its gate-weighted combine is reduced over
        `model`, and the data rank keeps its own rows. The aux loss is then
        computed alike on every data rank: each counts 1/data of it (hazard
        pp). The per-group dispatch (`moe_groups` = G > 1, T % G == 0, not
        dropless): sort, capacity, scatter and gather within each group of
        T / G tokens, the aux loss the mean over the groups; on a mesh each
        data rank dispatches its own G/data groups (G a multiple of the
        data ranks), and its aux loss is its groups' share of the mean."""
        cfg = self.cfg
        lp = lp or self.local_plan().layer("moe_layers")
        plan = lp.plan
        mesh, t_local, d = plan.mesh, x2d.shape[0], x2d.shape[1]
        n_data = mesh.size("data") if plan.batch_split else 1
        t = t_local * n_data
        e0, el, split = plan.split(cfg.n_routed)
        want = (0, slice(e0, e0 + el)) if split else None
        w = {k: lp.w(p, k, want) for k in ("mlp_w_gate", "mlp_w_up", "mlp_w_down")}
        router = lp.w(p, "mlp_router")
        copy = plan.copy if split else (lambda z: z)
        grouped = cfg.moe_groups > 1 and not dropless and t % cfg.moe_groups == 0

        def dispatch(x, slot, token_of, keep, gate, cap):
            """This rank's experts' buffer [el, cap, D]; the other experts'
            entries go to the trash slot, as a dropped entry does."""
            if split:
                own = (slot >= e0 * cap) & (slot < (e0 + el) * cap)
                slot = torch.where(own, slot - e0 * cap, el * cap)
                keep = keep & own
            xe = _dispatch(copy(x), slot, token_of, keep, el * cap).reshape(el, cap, d)
            return xe, (slot, token_of, keep, copy(gate))

        if grouped:
            g = cfg.moe_groups
            if g % n_data:
                raise ValueError(f"moe_groups={g} is not a multiple of the "
                                 f"{n_data} data ranks the batch is split over")
            gl, tl = g // n_data, t // g
            xg = x2d.reshape(gl, tl, d)
            bufs, metas, auxes = [], [], []
            for i in range(gl):
                slot, token_of, keep, gate, aux, cap = moe_dispatch(xg[i], router, cfg)
                xe, meta = dispatch(xg[i], slot, token_of, keep, gate, cap)
                bufs.append(xe)
                metas.append(meta)
                auxes.append(aux)
            xe = torch.stack(bufs).transpose(0, 1)              # [el, G_l, C, D]
            ye = self._experts(w, xe, ("egcd,edf->egcf", "egcf,efd->egcd")).transpose(0, 1)
            y = torch.cat([_combine(ye[i].reshape(-1, d), *metas[i], tl)
                           for i in range(gl)])
            aux = torch.stack(auxes).mean()
            if n_data > 1:
                aux = aux * (gl / g)
        else:
            xa = rmesh.gather_data(x2d, mesh, 0, True) if n_data > 1 else x2d
            slot, token_of, keep, gate, aux, cap = moe_dispatch(xa, router, cfg,
                                                                dropless=dropless)
            # every entry is kept: slot = expert * T + place. A meta tensor
            # (the dry run) has no load to read and keeps the reference's T rows
            if dropless and not xa.is_meta:
                expert, place = slot // cap, slot % cap
                cap = int(place.max()) + 1
                slot = expert * cap + place
            xe, meta = dispatch(xa, slot, token_of, keep, gate, cap)
            ye = self._experts(w, xe, ("ecd,edf->ecf", "ecf,efd->ecd"))
            y = _combine(ye.reshape(el * cap, d), *meta, t)
            if n_data > 1:
                aux = aux / n_data
        if split:
            y = plan.reduce(y)
        if n_data > 1 and not grouped:
            y = y.narrow(0, mesh.index("data") * t_local, t_local)
        if cfg.n_shared:
            y = y + self._mlp(p, x2d, "mlp_shared_", lp)
        return y, aux

    # ---------------------------------------------------------------- forward
    def local_plan(self) -> MeshPlan:
        """The `MeshPlan` of one process (a (1, 1) mesh), made once."""
        if self._local_plan is None:
            self._local_plan = MeshPlan(self)
        return self._local_plan

    def _block(self, p, x, positions, moe, kv_out, lp):
        """One layer of this rank (`lp`, a `_LayerPlan`) -> (x, its router
        aux loss, 0 for a dense layer). MoE dispatches dropless when the
        layer fills a cache (serving)."""
        attend = self._mla_attention if self.cfg.attention == "mla" else self._gqa_attention
        h = x + attend(p, self._norm(p, "ln1", x), positions, kv_out, lp)
        hn = self._norm(p, "ln2", h)
        if moe:
            b, s, d = hn.shape
            y, aux = self._moe_block(p, hn.reshape(b * s, d), kv_out is not None, lp)
            return h + y.reshape(b, s, d), aux
        return h + self._mlp(p, hn, "mlp_", lp), torch.zeros((), device=x.device)

    def _cache_slices(self, cache, i):
        if cache is None:
            return None
        layers = cache["layers"]
        if self.cfg.attention == "mla":
            return layers["ckv"][i], layers["kr"][i]
        return layers["k"][i], layers["v"][i]

    def _embed(self, ids: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
        """The embedding rows of ids; on a mesh vocab-parallel: a masked
        lookup in this model rank's vocabulary rows, reduced over
        `model`."""
        v0, vl, split = plan.split(self.cfg.vocab)
        spec = plan.specs[(None, "embed")]
        table = plan.use(self.params["embed"], spec, (0, slice(v0, v0 + vl)) if split else None)
        if not split:
            return table[ids.long()]
        idx = ids.long() - v0
        own = (idx >= 0) & (idx < vl)
        rows = table[idx.clamp(0, vl - 1)]
        return plan.reduce(torch.where(own[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device)))

    def forward_hidden(self, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       cache: Optional[dict] = None,
                       remat=False, plan: Optional[MeshPlan] = None):
        """Token ids [B, S] -> (final hidden states [B, S, D], the router aux
        loss summed over the layers). With `cache` (from `init_cache`), each
        layer's K and V (or MLA's latent) are written into it, and MoE
        dispatches dropless. `remat` (the JAX package's): True recomputes
        each layer in the backward from its input (`torch.utils.checkpoint`),
        "dots" / "dots_with_no_batch_dims" save the layer's matrix products
        without batch dimensions and recompute the rest; False keeps every
        activation. The values are the same. With `plan` (a `MeshPlan`),
        tokens are this data rank's rows and the layers run on the mesh."""
        plan = plan or self.local_plan()
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
        x = self._embed(tokens, plan)
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
        for i, (p, moe, stack) in enumerate(self._layers()):
            x, aux = block(p, x, positions, moe, self._cache_slices(cache, i),
                           plan.layer(stack))
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
    def _ce(self, h, labels, mask, plan: MeshPlan, fused: int = 0):
        """The mean token CE of this data rank's rows, plain or blockwise
        (`fused` > 0, `common.blockwise_cross_entropy`). On a mesh the head
        is vocab-parallel (the logits stay split over `model`; the max, the
        sum of exponentials and the target logit, from the rank that owns
        it, are combined over `model`) and the masked sum is divided by the
        mask count summed over `data` (`common.ce_denominator`), so that
        the data ranks' terms sum to the reference's mean."""
        cfg = self.cfg
        v0, vl, split = plan.split(cfg.vocab)
        if cfg.tie_embeddings:
            head = plan.use(self.params["embed"], plan.specs[(None, "embed")],
                            (0, slice(v0, v0 + vl)) if split else None).T
        else:
            head = plan.use(self.params["lm_head"], plan.specs[(None, "lm_head")],
                            (1, slice(v0, v0 + vl)) if split else None)
        denom = (common.ce_denominator(labels, mask, plan.mesh)
                 if plan.batch_split else None)
        hs = plan.copy(h) if split else h
        if fused:
            return common.blockwise_cross_entropy(
                hs, head, labels, mask, block=fused, denom=denom,
                mesh=plan.mesh if split else None, v0=v0)
        if split:
            return common.vocab_parallel_cross_entropy(
                hs @ head, labels, mask,
                common.ce_denominator(labels, mask) if denom is None else denom,
                plan.mesh, v0)
        return common.cross_entropy(h @ head, labels, mask, denom=denom)

    def loss(self, batch, remat=False, plan: Optional[MeshPlan] = None):
        """Next-token CE over {"tokens", "labels"[, "mask"]}, + 0.3 x the
        MTP block's CE on the labels rolled by one (its last column masked),
        + router_aux_coef x the aux loss -> (loss, {"ce", "aux"}), "ce"
        with the MTP term, as the JAX package reports it. `cfg.fused_ce` > 0
        streams the CE over vocabulary blocks of that size. With `plan` (a
        `MeshPlan`), the batch holds this data rank's rows and the loss is
        its share: the data ranks' losses sum to the reference's."""
        cfg = self.cfg
        plan = plan or self.local_plan()
        tokens, labels = batch["tokens"], batch["labels"]
        h, aux = self.forward_hidden(tokens, remat=remat, plan=plan)
        loss = self._ce(h, labels, batch.get("mask"), plan, cfg.fused_ce)
        if cfg.mtp:
            mp = self._group(("mtp",))
            # predict t+2: combine h_t with the embedding of the (t+1) label
            emb_next = self._embed(labels, plan)
            proj = plan.use(mp["proj"], plan.specs[(None, "mtp_proj")])
            comb = torch.cat([self._norm(mp, "norm_h", h),
                              self._norm(mp, "norm_e", emb_next)], dim=-1) @ proj
            b, s = tokens.shape
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
            h2, _ = self._block(self._group(("mtp", "layer")), comb, positions,
                                False, None, plan.layer("mtp_layer"))
            labels2 = torch.roll(labels, -1, dims=1)
            mask2 = torch.ones(labels2.shape, device=labels.device)
            mask2[:, -1:] = 0.0
            loss = loss + MTP_WEIGHT * self._ce(
                self._norm(self.params, "final_norm", h2), labels2, mask2, plan)
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

    def _gqa_decode(self, p, x, kcache, vcache, pos: int, lp):
        """x [B, 1, D] -> [B, 1, D]; writes this token's K, V at `pos`, or
        at pos % s_cache in a sliding-window ring, masked by the JAX
        package's age rule."""
        cfg = self.cfg
        b, hd = x.shape[0], cfg.hd
        s_cache = kcache.shape[2]
        posb = torch.full((b, 1, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = self._gqa_qkv(p, x, posb, lp)[:3]     # [B, H, 1, hd]
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

    def _mla_decode(self, p, x, ckv, kr, pos: int, lp):
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
        q = self._mla_q(p, x, lp)                               # [B, H, 1, dn + dr]
        q_rope = common.apply_rope(q[..., dn:], posb, cfg.rope_theta)
        c_new, kr_new = self._mla_latent(p, x, lp)              # [B, 1, r], [B, 1, dr]
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
        plan = self.local_plan()
        for i, (p, moe, stack) in enumerate(self._layers()):
            lp = plan.layer(stack)
            hn = self._norm(p, "ln1", x)
            if self.cfg.attention == "mla":
                o = self._mla_decode(p, hn, *self._cache_slices(cache, i), pos, lp)
            else:
                o = self._gqa_decode(p, hn, *self._cache_slices(cache, i), pos, lp)
            h = x + o
            hn2 = self._norm(p, "ln2", h)
            if moe:
                y, _ = self._moe_block(p, hn2.reshape(b, -1), True, lp)
                y = y.reshape(b, 1, -1)
            else:
                y = self._mlp(p, hn2, "mlp_", lp)
            x = h + y
        h = self._norm(self.params, "final_norm", x)
        cache["pos"] = pos + 1
        return self.logits_from_hidden(h)[:, 0], cache


def loss_fn(model: Transformer, batch, remat=False, plan=None):
    """The training loss (the JAX package's `loss_fn(params, cfg, batch,
    remat)`, with the model in place of params and cfg) -> (loss, metrics);
    with `plan`, this rank's share on a mesh (`MeshPlan`)."""
    return model.loss(batch, remat=remat, plan=plan)
