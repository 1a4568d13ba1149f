"""GNN architectures: PNA, GraphSAGE, GIN, GAT.

The JAX package's `models/gnn.py` as one `nn.Module`. Two input regimes:

  full-graph   batch = {x [n,F], src [m], dst [m]}  (dst need not be sorted)
               -> `GNN.forward`; message passing is a gather over arc
               endpoints and a segment reduction by destination
               (`graph/segment_ops.py`)
  sampled      batch = {x_self [B,F], x_nbr [B,f1,F], x_nbr2 [B,f1,f2,F]}
               -> `GNN.forward_sampled` (GraphSAGE minibatch_lg); the dense
               fanout tensors go through the `segment_agg` kernel
               (`kernels/ops.py:neighborhood_agg`), three calls per forward

Batched small graphs (molecule) are block-diagonal: the same full-graph code
runs unchanged on the concatenated node and arc arrays.

Weights keep the JAX layout, [d_in, d_out], so `load_jax_params` copies a
JAX parameter tree as it is, and `param_paths` names each parameter's place
in that tree. The parameters do not require grad, so serving runs without
autograd; training (`train/step.py`) differentiates `loss_fn` with respect
to its own tensors, substituted for them, and gradients flow through the
`segment_agg` kernel (its backward is the plain one, `kernels/ref.py`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.graph import segment_ops
from repro_torch.graph.structs import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import dense_init, flatten_tree


# logical sharding specs of the reference's `init`, by the path's last keys
_PARAM_SPECS = {
    ("w_self",): ("feat", None), ("w_nbr",): ("feat", None),
    ("mlp", "w1"): ("feat", None), ("mlp", "b1"): (None,),
    ("mlp", "w2"): (None, "feat"), ("mlp", "b2"): (None,), ("eps",): (),
    ("w",): ("feat", None), ("a_src",): (None, None), ("a_dst",): (None, None),
    ("b",): (None,),
}
_HEAD_SPECS = {"w": ("feat", "classes"), "b": ("classes",)}


def _params(**tensors: torch.Tensor) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


def _mlp_params(gen, d_in, d_hidden, d_out) -> Dict[str, torch.Tensor]:
    return {
        "mlp_w1": dense_init(gen, d_in, d_hidden),
        "mlp_b1": torch.zeros(d_hidden),
        "mlp_w2": dense_init(gen, d_hidden, d_out),
        "mlp_b2": torch.zeros(d_out),
    }


def _mlp(p, x):
    return F.relu(x @ p["mlp_w1"] + p["mlp_b1"]) @ p["mlp_w2"] + p["mlp_b2"]


# --------------------------------------------------------- full-graph layers
def _agg_stats(x, src, dst, n):
    """sum / mean / min / max / std by destination (shared by PNA)."""
    msgs = x[src]
    s = segment_ops.segment_sum(msgs, dst, n)
    mn = segment_ops.segment_min(msgs, dst, n)   # +inf where empty
    mx = segment_ops.segment_max(msgs, dst, n)   # -inf where empty
    sq = segment_ops.segment_sum(msgs * msgs, dst, n)
    deg = segment_ops.segment_count(dst, n)
    mean, std = segment_ops.mean_and_std(s, sq, deg, mn, mx)
    empty = (deg <= 0)[:, None]
    big = float(np.finfo(np.float32).max)
    mn = torch.where(empty | (mn >= big), 0.0, mn)
    mx = torch.where(empty | (mx <= -big), 0.0, mx)
    return {"sum": s, "mean": mean, "min": mn, "max": mx, "std": std}, deg


def _pna_layer(p, cfg: GNNConfig, x, src, dst, n, log_deg_avg):
    stats, deg = _agg_stats(x, src, dst, n)
    logd = torch.log(deg + 1.0)[:, None]
    scaled = []
    for a in (stats[name] for name in cfg.aggregators):
        for sc in cfg.scalers:
            if sc in ("identity", "id"):
                scaled.append(a)
            elif sc in ("amplification", "amp"):
                scaled.append(a * (logd / log_deg_avg))
            elif sc in ("attenuation", "atten"):
                scaled.append(a * (log_deg_avg / logd.clamp_min(1e-6)))
            else:
                raise ValueError(sc)
    h = torch.cat(scaled + [x], dim=-1)
    return F.relu(h @ p["w"] + p["b"])


def _sage_layer(p, x, src, dst, n):
    nbr = segment_ops.segment_mean(x[src], dst, n)
    return F.relu(x @ p["w_self"] + nbr @ p["w_nbr"])


def _gin_layer(p, x, src, dst, n):
    agg = segment_ops.segment_sum(x[src], dst, n)
    eps = p["eps"] if "eps" in p else 0.0
    return _mlp(p, (1.0 + eps) * x + agg)


def _gat_layer(p, cfg: GNNConfig, x, src, dst, n, last: bool):
    h, f = cfg.n_heads, p["a_src"].shape[1]
    z = (x @ p["w"]).reshape(n, h, f)
    e_src = (z * p["a_src"]).sum(-1)                    # [n, H]
    e_dst = (z * p["a_dst"]).sum(-1)
    scores = F.leaky_relu(e_src[src] + e_dst[dst], 0.2)  # [m, H]
    alpha = segment_ops.segment_softmax(scores, dst, n)
    msgs = z[src] * alpha[..., None]                    # [m, H, F]
    out = segment_ops.segment_sum(msgs, dst, n)         # [n, H, F]
    if last:
        return out.mean(dim=1)                          # average heads
    return F.elu(out.reshape(n, h * f))


class GNN(nn.Module):
    """PNA / GraphSAGE / GIN / GAT node classifier (`cfg.model`).

    Weights are drawn from `torch.Generator().manual_seed(seed)` on the CPU
    and moved to `device`, which defaults to `cuda` (raising where there is
    none); `device="cpu"` runs the plain versions of the kernels."""

    def __init__(self, cfg: GNNConfig, d_in: int, n_classes: int,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        # drawn on the CPU and moved; nothing is drawn for the meta device
        gen = common.generator(torch.device("cpu") if dev.type != "meta" else dev, seed)
        self.cfg = cfg
        self.layers = nn.ModuleList()
        d_prev = d_in
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            d_out = cfg.d_hidden
            if cfg.model == "graphsage":
                p = _params(w_self=dense_init(gen, d_prev, d_out),
                            w_nbr=dense_init(gen, d_prev, d_out))
            elif cfg.model == "gin":
                t = _mlp_params(gen, d_prev, d_out, d_out)
                if cfg.eps_learnable:
                    t["eps"] = torch.zeros(())
                p = _params(**t)
            elif cfg.model == "gat":
                h = cfg.n_heads
                p = _params(
                    w=dense_init(gen, d_prev, h * d_out),
                    a_src=common.normal(gen, (h, d_out), 0.1),
                    a_dst=common.normal(gen, (h, d_out), 0.1))
                d_prev = h * d_out if not last else d_out
            elif cfg.model == "pna":
                n_in = d_prev * len(cfg.aggregators) * len(cfg.scalers) + d_prev
                p = _params(w=dense_init(gen, n_in, d_out),
                            b=torch.zeros(d_out))
            else:
                raise ValueError(cfg.model)
            self.layers.append(p)
            if cfg.model != "gat":
                d_prev = d_out
        self.head = _params(w=dense_init(gen, d_prev, n_classes),
                            b=torch.zeros(n_classes))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.head["w"].device

    def param_paths(self) -> Dict[str, tuple]:
        """Each parameter's name -> its path in the JAX parameter tree
        ("layers.0.mlp_w1" -> ("layers", 0, "mlp", "w1"))."""
        groups = [(f"layers.{i}", ("layers", i), p) for i, p in enumerate(self.layers)]
        groups.append(("head", ("head",), self.head))
        return {f"{prefix}.{k}": base + (("mlp", k[4:]) if k.startswith("mlp_") else (k,))
                for prefix, base, p in groups for k in p.keys()}

    def param_specs(self) -> Dict:
        """The reference's logical sharding spec of each parameter, in the
        JAX tree (the second value of its `init`)."""
        return common.nest({name: _PARAM_SPECS[path[-2:] if path[-2] == "mlp" else path[-1:]]
                            if path[0] == "layers" else _HEAD_SPECS[path[-1]]
                            for name, path in self.param_paths().items()},
                           self.param_paths())

    def load_jax_params(self, tree: Mapping) -> "GNN":
        """Copy a JAX parameter tree ({"layers": [...], "head": {...}}, leaves
        as numpy arrays) into this module; names and shapes must match."""
        if len(tree["layers"]) != len(self.layers):
            raise ValueError(f"{len(tree['layers'])} layers given, "
                             f"{len(self.layers)} expected")
        pairs = [(p, flatten_tree(t)) for p, t in zip(
            list(self.layers) + [self.head],
            list(tree["layers"]) + [tree["head"]])]
        for p, flat in pairs:
            if set(flat) != set(p.keys()):
                raise ValueError(f"parameters {sorted(flat)} given, "
                                 f"{sorted(p.keys())} expected")
            for k, v in flat.items():
                if tuple(v.shape) != tuple(p[k].shape):
                    raise ValueError(f"{k}: shape {v.shape}, expected "
                                     f"{tuple(p[k].shape)}")
        with torch.no_grad():
            for p, flat in pairs:
                for k, v in flat.items():
                    p[k].copy_(torch.from_numpy(np.array(v, dtype=np.float32)))
        return self

    def forward(self, batch: Mapping) -> torch.Tensor:
        """Full-graph forward -> per-node logits [n, n_classes]."""
        cfg = self.cfg
        x, src, dst = batch["x"], batch["src"].long(), batch["dst"].long()
        n = x.shape[0]
        log_deg_avg = batch.get("log_deg_avg", 1.0)
        for i, p in enumerate(self.layers):
            last = i == len(self.layers) - 1
            if cfg.model == "pna":
                x = _pna_layer(p, cfg, x, src, dst, n, log_deg_avg)
            elif cfg.model == "graphsage":
                x = _sage_layer(p, x, src, dst, n)
            elif cfg.model == "gin":
                x = _gin_layer(p, x, src, dst, n)
            elif cfg.model == "gat":
                x = _gat_layer(p, cfg, x, src, dst, n, last)
        return x @ self.head["w"] + self.head["b"]

    def forward_sampled(self, batch: Mapping) -> torch.Tensor:
        """Two-layer sampled GraphSAGE forward (fanouts f1, f2) -> logits [B, C].

        batch: x_self [B,F], x_nbr [B,f1,F], x_nbr2 [B,f1,f2,F]
               (+ optional masks m_nbr bool[B,f1], m_nbr2 bool[B,f1,f2]).
        Three `segment_agg` calls: layer 1 over each sampled neighbour's own
        f2 neighbours, layer 1 over the seeds' f1 neighbours, and layer 2
        over the layer-1 neighbour representations."""
        if self.cfg.model != "graphsage" or len(self.layers) != 2:
            raise ValueError("the sampled forward is two-layer GraphSAGE")
        x_self, x_nbr, x_nbr2 = batch["x_self"], batch["x_nbr"], batch["x_nbr2"]
        b, f1, f2, d = x_nbr2.shape
        dev = x_nbr2.device
        m_nbr = batch.get("m_nbr")
        if m_nbr is None:
            m_nbr = torch.ones((b, f1), dtype=torch.bool, device=dev)
        m_nbr2 = batch.get("m_nbr2")
        if m_nbr2 is None:
            m_nbr2 = torch.ones((b, f1, f2), dtype=torch.bool, device=dev)
        l1, l2 = self.layers

        # layer 1 on each sampled neighbour: aggregate its own f2 neighbours
        m2 = m_nbr2.reshape(b * f1, f2)
        deg2 = m2.sum(1).float()
        agg2 = kops.neighborhood_agg(x_nbr2.reshape(b * f1, f2, d), m2, deg2)["mean"]
        h_nbr = F.relu(
            x_nbr.reshape(b * f1, d) @ l1["w_self"] + agg2 @ l1["w_nbr"]
        ).reshape(b, f1, -1)
        # layer 1 on the seeds: aggregate the direct neighbours' features
        deg1 = m_nbr.sum(1).float()
        agg1 = kops.neighborhood_agg(x_nbr, m_nbr, deg1)["mean"]
        h_self = F.relu(x_self @ l1["w_self"] + agg1 @ l1["w_nbr"])
        # layer 2 on the seeds: aggregate the layer-1 neighbour representations
        aggh = kops.neighborhood_agg(h_nbr, m_nbr, deg1)["mean"]
        h = F.relu(h_self @ l2["w_self"] + aggh @ l2["w_nbr"])
        return h @ self.head["w"] + self.head["b"]

    def loss(self, batch: Mapping, logits: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """Node-classification cross-entropy (the forward value of the JAX
        `loss_fn`); `train_mask` selects the supervised nodes. Pass the
        logits of this batch to skip the forward."""
        if logits is None:
            logits = (self.forward_sampled(batch) if "x_self" in batch
                      else self.forward(batch))
        logits = logits.float()
        labels = batch["labels"].long()
        nll = (torch.logsumexp(logits, dim=-1)
               - logits.gather(-1, labels[..., None])[..., 0])
        mask = batch.get("train_mask")
        if mask is not None:
            m = mask.float()
            return (nll * m).sum() / m.sum().clamp_min(1.0)
        return nll.mean()


def loss_fn(model: GNN, batch: Mapping):
    """The training loss (the JAX package's `loss_fn(params, cfg, batch)`,
    with the model in place of params and cfg) -> (loss, metrics): node
    classification CE over `train_mask`, through the sampled forward for a
    sampled batch."""
    return model.loss(batch), {}
