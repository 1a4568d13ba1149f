"""Decoder-only transformer: the dense GQA path of the JAX package's
`models/transformer.py` (qwen2-1.5b), as one `nn.Module`.

  forward_hidden   tokens [B, S] -> final hidden states [B, S, D]; one
                   `flash_attention` launch per layer (`kernels/ops.py`).
                   Given a cache, it also writes each layer's roped K and V
                   into it: the prefill of `serve/engine.py`
  logits_from_hidden, forward
  init_cache, decode_step
                   one token against a static [B, Hkv, max_seq, hd] cache per
                   layer; decode attention is two plain einsums in f32 over
                   the whole cache, positions past `pos` masked with -1e30,
                   as in the JAX package (no kernel there either)

  loss_fn          the training loss: next-token CE, plain or blockwise
                   (`fused_ce`), with `remat` around each layer

Parameters keep the JAX layout and names: the layers are stacked with a
leading [n_layers] axis, and `params` is keyed by the flattened JAX paths
("dense_layers_attn_wq", "final_norm_g", ...), so `load_jax_params` copies a
JAX parameter tree as it is (`param_paths` gives each name's path). The
parameters do not require grad, so serving runs without autograd; training
(`train/step.py`) differentiates `loss_fn` with respect to its own tensors,
substituted for them, and gradients flow through the `flash_attention`
kernel (its backward is the plain one, `kernels/ref.py`). There is no MoE,
so `forward` returns the logits without the JAX function's router aux loss
(always 0 on this path).

Config fields whose code paths the port does not have raise
`NotImplementedError`: MLA attention, MoE, MTP, qk-norm, the GELU MLP and
LayerNorm, and a sliding window in the decode cache (the ring buffer); a
window in `forward` runs through the kernel.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import LMConfig
from repro_torch.graph.structs import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ATTENTION_NEG_INF
from repro_torch.models import common

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_STACK = "dense_layers_"


def check_supported(cfg: LMConfig) -> None:
    """Raise NotImplementedError for a config field this port cannot run."""
    missing = [name for name, unsupported in (
        ("attention='mla'", cfg.attention != "gqa"),
        ("moe", cfg.moe),
        ("mtp", cfg.mtp),
        ("qk_norm", cfg.qk_norm),
        (f"mlp={cfg.mlp!r}", cfg.mlp != "swiglu"),
        (f"norm={cfg.norm!r}", cfg.norm != "rmsnorm"),
        (f"dtype={cfg.dtype!r}", cfg.dtype not in DTYPES),
    ) if unsupported]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported (the dense GQA path only)")


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


class Transformer(nn.Module):
    """Dense GQA decoder (`cfg`), weights drawn from
    `torch.Generator(device).manual_seed(seed)` on `device`, which defaults
    to `cuda` (raising where there is none); `device="cpu"` runs the plain
    versions of the kernels."""

    def __init__(self, cfg: LMConfig, device=None, seed: int = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = DTYPES[cfg.dtype]
        n, d, hd, f = cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff
        hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

        def dense(d_in, d_out):
            return common.normal(gen, (n, d_in, d_out), 1.0 / math.sqrt(d_in), dt)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        t: Dict[str, torch.Tensor] = {
            "embed": common.normal(gen, (cfg.vocab, d), 0.02, dt),
            "final_norm_g": ones(d),
            _STACK + "ln1_g": ones(n, d),
            _STACK + "attn_wq": dense(d, hq),
            _STACK + "attn_wk": dense(d, hkv),
            _STACK + "attn_wv": dense(d, hkv),
            _STACK + "attn_wo": dense(hq, d),
            _STACK + "ln2_g": ones(n, d),
            _STACK + "mlp_w_gate": dense(d, f),
            _STACK + "mlp_w_up": dense(d, f),
            _STACK + "mlp_w_down": dense(f, d),
        }
        if cfg.qkv_bias:
            t.update({_STACK + "attn_bq": zeros(n, hq),
                      _STACK + "attn_bk": zeros(n, hkv),
                      _STACK + "attn_bv": zeros(n, hkv)})
        if not cfg.tie_embeddings:
            t["lm_head"] = common.normal(gen, (d, cfg.vocab), 1.0 / math.sqrt(d), dt)
        self.cfg = cfg
        common.register_params(self, t)

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        """The parameters by their flattened JAX names."""
        return self._parameters

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def load_jax_params(self, tree) -> "Transformer":
        """Copy a JAX parameter tree ({"embed", "final_norm": {"g"},
        "dense_layers": {"ln1", "attn", "ln2", "mlp"}, ...}, leaves as numpy
        arrays with the leading [n_layers] axis) into this module; names and
        shapes must match."""
        common.load_flat(self.params, tree)
        return self

    def param_paths(self) -> Dict[str, tuple]:
        """Each parameter's name -> its path in the JAX parameter tree
        ("dense_layers_attn_wq" -> ("dense_layers", "attn", "wq"),
        "final_norm_g" -> ("final_norm", "g"))."""
        paths = {}
        for name in self.params:
            if name.startswith(_STACK):
                paths[name] = ("dense_layers",) + tuple(
                    name[len(_STACK):].split("_", 1))
            elif name == "final_norm_g":
                paths[name] = ("final_norm", "g")
            else:
                paths[name] = (name,)
        return paths

    def _layers(self) -> List[Dict[str, torch.Tensor]]:
        """Each layer's parameters, by their names inside the layer: views
        of the stacked tensors by `unbind`, whose backward stacks the L
        layers' gradients once (indexing layer by layer would make each
        layer's gradient a zero-filled [L, ...] tensor, summed L times)."""
        stacked = {k[len(_STACK):]: v.unbind(0) for k, v in self.params.items()
                   if k.startswith(_STACK)}
        return [{k: v[i] for k, v in stacked.items()}
                for i in range(self.cfg.n_layers)]

    # ---------------------------------------------------------------- forward
    def _attention(self, p, x, positions, kv_out=None):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = x @ p["attn_wq"], x @ p["attn_wk"], x @ p["attn_wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["attn_bq"], k + p["attn_bk"], v + p["attn_bv"]
        q = _split_heads(q, cfg.n_heads, cfg.hd)
        k = _split_heads(k, cfg.n_kv_heads, cfg.hd)
        v = _split_heads(v, cfg.n_kv_heads, cfg.hd)
        q = common.apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = common.apply_rope(k, positions[:, None, :], cfg.rope_theta)
        if kv_out is not None:  # prefill: the roped K and V go to the cache
            kv_out[0][:, :, :s] = k
            kv_out[1][:, :, :s] = v
        o = kops.attention(q, k, v, causal=True, window=cfg.window)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
        return o @ p["attn_wo"]

    def forward_hidden(self, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       cache: Optional[dict] = None,
                       remat=False) -> torch.Tensor:
        """Token ids [B, S] -> final hidden states [B, S, D]. With `cache`
        (from `init_cache`), each layer's roped K and V are written into its
        first S positions. `remat` (the JAX package's): True recomputes each
        layer in the backward from its input (`torch.utils.checkpoint`),
        "dots" / "dots_with_no_batch_dims" save the layer's matrix products
        without batch dimensions and recompute the rest; False keeps every
        activation. The values are the same."""
        cfg = self.cfg
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
        # the layers' tensors are taken here, so that a recompute in the
        # backward reads the ones this forward read
        for i, p in enumerate(self._layers()):
            kv_out = None
            if cache is not None:
                kv_out = (cache["layers"]["k"][i], cache["layers"]["v"][i])
            x = block(p, x, positions, kv_out)
        return common.rms_norm(x, self.params["final_norm_g"], cfg.norm_eps)

    def _block(self, p, x, positions, kv_out=None):
        cfg = self.cfg
        h = x + self._attention(
            p, common.rms_norm(x, p["ln1_g"], cfg.norm_eps), positions, kv_out)
        hn = common.rms_norm(h, p["ln2_g"], cfg.norm_eps)
        return h + common.swiglu(hn, p["mlp_w_gate"], p["mlp_w_up"], p["mlp_w_down"])

    def logits_from_hidden(self, h: torch.Tensor) -> torch.Tensor:
        """[..., D] -> logits [..., V] in the model's dtype."""
        if self.cfg.tie_embeddings:
            return h @ self.params["embed"].T
        return h @ self.params["lm_head"]

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.logits_from_hidden(self.forward_hidden(tokens, positions))

    # ------------------------------------------------------------------- loss
    def loss(self, batch, remat=False):
        """Next-token CE over {"tokens", "labels"[, "mask"]} -> (loss,
        metrics); `cfg.fused_ce` > 0 streams it over vocabulary blocks of
        that size (`common.blockwise_cross_entropy`). The JAX function adds
        the router's aux loss, 0 for dense layers, and so does this."""
        cfg = self.cfg
        h = self.forward_hidden(batch["tokens"], remat=remat)
        if cfg.fused_ce:
            head = self.params["embed"].T if cfg.tie_embeddings else self.params["lm_head"]
            loss = common.blockwise_cross_entropy(
                h, head, batch["labels"], batch.get("mask"), block=cfg.fused_ce)
        else:
            loss = common.cross_entropy(self.logits_from_hidden(h), batch["labels"],
                                        batch.get("mask"))
        aux = torch.zeros((), device=loss.device)
        return loss + aux, {"ce": loss, "aux": aux}

    # ----------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_seq: int) -> dict:
        """Static KV cache: {"layers": {"k", "v": [L, B, Hkv, max_seq, hd]},
        "pos": 0}, zeros in the model's dtype."""
        cfg = self.cfg
        if cfg.window:
            raise NotImplementedError(
                f"{cfg.name}: the sliding-window ring cache is not ported")
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.hd)
        dt = DTYPES[cfg.dtype]
        return {"layers": {"k": torch.zeros(shape, dtype=dt, device=self.device),
                           "v": torch.zeros(shape, dtype=dt, device=self.device)},
                "pos": 0}

    def _decode_attention(self, p, x, kcache, vcache, pos: int):
        """x [B, 1, D] -> [B, 1, D]; writes this token's K, V at `pos`."""
        cfg = self.cfg
        b, hd = x.shape[0], cfg.hd
        q, k, v = x @ p["attn_wq"], x @ p["attn_wk"], x @ p["attn_wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["attn_bq"], k + p["attn_bk"], v + p["attn_bv"]
        q = _split_heads(q, cfg.n_heads, hd)          # [B, H, 1, hd]
        k = _split_heads(k, cfg.n_kv_heads, hd)
        v = _split_heads(v, cfg.n_kv_heads, hd)
        posb = torch.full((b, 1, 1), pos, dtype=torch.int32, device=x.device)
        q = common.apply_rope(q, posb, cfg.rope_theta)
        k = common.apply_rope(k, posb, cfg.rope_theta)
        kcache[:, :, pos] = k[:, :, 0]
        vcache[:, :, pos] = v[:, :, 0]
        # GQA: fold the group into the q batch for a single matvec
        group = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(b, cfg.n_kv_heads, group, hd)
        scores = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                              kcache.float()) / math.sqrt(hd)
        valid = torch.arange(kcache.shape[2], device=x.device) <= pos
        scores = torch.where(valid, scores, ATTENTION_NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bkgs,bksd->bkgd", probs, vcache.float())
        o = o.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
        return o @ p["attn_wo"]

    def decode_step(self, token: torch.Tensor, cache: dict):
        """One decode step: token int[B] -> (logits [B, V], cache). The cache
        is updated in place (K, V at position `pos`, then pos + 1) and
        returned."""
        cfg = self.cfg
        if cfg.window:
            raise NotImplementedError(
                f"{cfg.name}: the sliding-window ring cache is not ported")
        pos = int(cache["pos"])
        x = self.params["embed"][token.long()][:, None, :]   # [B, 1, D]
        for i, p in enumerate(self._layers()):
            hn = common.rms_norm(x, p["ln1_g"], cfg.norm_eps)
            h = x + self._decode_attention(p, hn, cache["layers"]["k"][i],
                                           cache["layers"]["v"][i], pos)
            hn2 = common.rms_norm(h, p["ln2_g"], cfg.norm_eps)
            x = h + common.swiglu(hn2, p["mlp_w_gate"], p["mlp_w_up"], p["mlp_w_down"])
        h = common.rms_norm(x, self.params["final_norm_g"], cfg.norm_eps)
        cache["pos"] = pos + 1
        return self.logits_from_hidden(h)[:, 0], cache


def loss_fn(model: Transformer, batch, remat=False):
    """The training loss (the JAX package's `loss_fn(params, cfg, batch,
    remat)`, with the model in place of params and cfg) -> (loss, metrics)."""
    return model.loss(batch, remat=remat)
