"""BERT4Rec, the bidirectional self-attention sequential recommender (Sun et
al., arXiv:1904.06690): the serving half of the JAX package's
`models/bert4rec.py`, as one `nn.Module`.

Item embedding table (row 0 = padding, row n_items + 1 = [MASK]) plus
learned positional embeddings, N bidirectional post-LN blocks with a GELU
FFN, and the tied output projection:

  encode            item ids [B, S] -> hidden [B, S, D]; the blocks' own
                    attention is two plain einsums in f32 (no kernel in the
                    JAX package either)
  serve_scores      next-item logits over the whole catalog from the last
                    position
  retrieval_scores  one (or few) user(s) against C candidate ids: the
                    candidates' rows come through the `embedding_bag` kernel
                    (bags of one id, `kernels/ops.py`), then one [B, D] x
                    [D, C] product in f32

  loss              the Cloze training loss, with the JAX package's three
                    objectives: the full-catalog softmax, the same streamed
                    over item blocks (`fused_ce`), and a sampled softmax
                    over shared negatives (`n_negatives`) drawn as the
                    reference draws them (`models/prng.py`)

Parameters keep the JAX layout and are keyed by the flattened JAX paths
("items", "blocks_0_wq", ...), so `load_jax_params` copies a JAX parameter
tree as it is (`param_paths` gives each name's path). The parameters do not
require grad, so serving runs without autograd; training (`train/step.py`)
differentiates `loss_fn` with respect to its own tensors, substituted for
them. No training loss reaches `embedding_bag`: the loss gathers rows by
indexing, as the reference's `take` does.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.graph.structs import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ATTENTION_NEG_INF
from repro_torch.models import common, prng
from repro_torch.models.transformer import DTYPES

_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "ln1_g", "ln1_b", "w_in", "b_in",
               "w_out", "b_out", "ln2_g", "ln2_b")
# logical sharding specs of the reference's `init`, by the path's last key
_SPECS = {
    "items": ("item", "table_dim"), "pos": (None, None), "out_bias": ("item",),
    "wq": ("embed", "heads"), "wk": ("embed", "heads"), "wv": ("embed", "heads"),
    "wo": ("heads", "embed"), "ln1_g": (None,), "ln1_b": (None,),
    "w_in": ("embed", "ff"), "b_in": ("ff",), "w_out": ("ff", "embed"),
    "b_out": (None,), "ln2_g": (None,), "ln2_b": (None,),
}


def negatives(items: torch.Tensor, n_negatives: int, n_items: int) -> torch.Tensor:
    """The shared negatives of a batch, as the reference draws them:
    `randint(fold_in(key(0), seed), (n_negatives,), 1, n_items + 1)` with
    seed = the uint32 sum of the item ids (wrapping at 2^32) mod 2^31 - 1;
    drawn on the host -> int64[n_negatives] on items' device."""
    total = items.detach().cpu().numpy().astype(np.uint32).sum(dtype=np.uint32)
    seed = int(total % np.uint32(2**31 - 1))
    negs = prng.randint(prng.fold_in(prng.key(0), seed), n_negatives, 1, n_items + 1)
    return torch.from_numpy(negs.astype(np.int64)).to(items.device)


class Bert4Rec(nn.Module):
    """BERT4Rec (`cfg`), weights drawn from
    `torch.Generator(device).manual_seed(seed)` on `device`, which defaults
    to `cuda` (raising where there is none); `device="cpu"` runs the plain
    version of `embedding_bag`."""

    def __init__(self, cfg: RecsysConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.dtype not in DTYPES:
            raise NotImplementedError(f"{cfg.name}: dtype {cfg.dtype!r}")
        dev = resolve_device(device)
        gen = common.generator(dev, seed)
        dt = DTYPES[cfg.dtype]
        d = cfg.embed_dim

        def dense(d_in, d_out):
            return common.normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dt)

        def const(value, *shape):
            return torch.full(shape, value, dtype=dt, device=dev)

        t: Dict[str, torch.Tensor] = {
            "items": common.normal(gen, (cfg.n_items + 2, d), 0.02, dt),
            "pos": common.normal(gen, (cfg.seq_len, d), 0.02, dt),
            "out_bias": const(0.0, cfg.n_items + 2),
        }
        for i in range(cfg.n_blocks):
            t.update({f"blocks_{i}_{k}": v for k, v in {
                "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
                "wo": dense(d, d),
                "ln1_g": const(1.0, d), "ln1_b": const(0.0, d),
                "w_in": dense(d, 4 * d), "b_in": const(0.0, 4 * d),
                "w_out": dense(4 * d, d), "b_out": const(0.0, d),
                "ln2_g": const(1.0, d), "ln2_b": const(0.0, d),
            }.items()})
        self.cfg = cfg
        common.register_params(self, t)

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        """The parameters by their flattened JAX names."""
        return self._parameters

    @property
    def device(self) -> torch.device:
        return self.params["items"].device

    def load_jax_params(self, tree) -> "Bert4Rec":
        """Copy a JAX parameter tree ({"items", "pos", "out_bias", "blocks":
        [...]}, leaves as numpy arrays) into this module; names and shapes
        must match."""
        common.load_flat(self.params, tree)
        return self

    def param_paths(self) -> Dict[str, tuple]:
        """Each parameter's name -> its path in the JAX parameter tree
        ("blocks_0_wq" -> ("blocks", 0, "wq"))."""
        paths = {}
        for name in self.params:
            if name.startswith("blocks_"):
                i, k = name[len("blocks_"):].split("_", 1)
                paths[name] = ("blocks", int(i), k)
            else:
                paths[name] = (name,)
        return paths

    def param_specs(self) -> Dict:
        """The reference's logical sharding spec of each parameter, in the
        JAX tree (the second value of its `init`)."""
        paths = self.param_paths()
        return common.nest({name: _SPECS[path[-1]] for name, path in paths.items()},
                           paths)

    def _block(self, i: int, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        p = {k: self.params[f"blocks_{i}_{k}"] for k in _BLOCK_KEYS}
        b, s, d = x.shape
        h = self.cfg.n_heads
        hd = d // h

        def heads(w):
            return (x @ w).reshape(b, s, h, hd).transpose(1, 2)

        q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
        logits = torch.where(pad_mask[:, None, None, :], logits, ATTENTION_NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(x.dtype)
        o = o.transpose(1, 2).reshape(b, s, d)
        x = common.layer_norm(x + o @ p["wo"], p["ln1_g"], p["ln1_b"])
        y = common.gelu(x @ p["w_in"] + p["b_in"]) @ p["w_out"] + p["b_out"]
        return common.layer_norm(x + y, p["ln2_g"], p["ln2_b"])

    def encode(self, item_ids: torch.Tensor) -> torch.Tensor:
        """item_ids int[B, S] (0 = pad) -> hidden [B, S, D]."""
        pad_mask = item_ids > 0
        x = self.params["items"][item_ids.long()] + self.params["pos"][None]
        for i in range(self.cfg.n_blocks):
            x = self._block(i, x, pad_mask)
        return x

    def logits_all_items(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.params["items"].T + self.params["out_bias"]

    def loss(self, batch) -> tuple:
        """The Cloze objective over {"items", "labels", "mlm_mask"} [B, S]
        -> (loss, {"ce": loss}), the JAX package's `loss_fn`: the mean NLL
        of the masked positions under the full-catalog softmax; with
        `cfg.fused_ce` > 0 the same streamed over item blocks of that size
        (the bias as one more row of the head, h with a column of ones);
        with `cfg.n_negatives` > 0 a softmax over the gold item and the
        batch's shared negatives."""
        cfg, p = self.cfg, self.params
        h = self.encode(batch["items"])
        labels, mask = batch["labels"], batch["mlm_mask"]
        if cfg.n_negatives:
            negs = negatives(batch["items"], cfg.n_negatives, cfg.n_items)
            lab = labels.reshape(-1).long()
            hf = h.reshape(lab.shape[0], -1).float()
            pos = ((hf * p["items"][lab].float()).sum(-1)
                   + p["out_bias"][lab].float())
            neg = hf @ p["items"][negs].T.float() + p["out_bias"][negs].float()
            logz = torch.logsumexp(torch.cat([pos[:, None], neg], dim=1), dim=-1)
            mk = mask.reshape(-1).float()
            loss = ((logz - pos) * mk).sum() / mk.sum().clamp_min(1.0)
        elif cfg.fused_ce:
            head = torch.cat([p["items"].T, p["out_bias"][None, :].to(p["items"].dtype)],
                             dim=0)
            ones = torch.ones(h.shape[:-1] + (1,), dtype=h.dtype, device=h.device)
            loss = common.blockwise_cross_entropy(
                torch.cat([h, ones], dim=-1), head, labels, mask, block=cfg.fused_ce)
        else:
            loss = common.cross_entropy(self.logits_all_items(h), labels, mask)
        return loss, {"ce": loss}

    def serve_scores(self, item_ids: torch.Tensor) -> torch.Tensor:
        """Next-item logits over the full catalog from the last position."""
        return self.logits_all_items(self.encode(item_ids)[:, -1])

    def retrieval_scores(self, item_ids: torch.Tensor,
                         candidate_ids: torch.Tensor) -> torch.Tensor:
        """item_ids [B, S], candidate_ids int32[C] -> f32 scores [B, C]: the
        candidates' embeddings through `embedding_bag` (bags of size 1), then
        one [B, D] x [D, C] product in f32 plus the candidates' biases."""
        h = self.encode(item_ids)[:, -1]                              # [B, D]
        c = candidate_ids.shape[0]
        cand = kops.embedding_bag(
            self.params["items"], candidate_ids.to(torch.int32)[:, None],
            torch.ones((c, 1), dtype=torch.float32, device=candidate_ids.device))
        return (h.float() @ cand.T.float()
                + self.params["out_bias"][candidate_ids.long()].float())


def loss_fn(model: Bert4Rec, batch):
    """The training loss (the JAX package's `loss_fn(params, cfg, batch)`,
    with the model in place of params and cfg) -> (loss, metrics)."""
    return model.loss(batch)
