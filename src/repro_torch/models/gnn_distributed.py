"""Distributed GNN message passing over the paper's edge partition (the JAX
package's `models/gnn_distributed.py`).

The engine's partition (`graph/partition.py`) puts every arc on its source
shard, bucketed by destination shard at one static padded size B, so one
exchange per aggregation sweep moves exactly the per-arc messages, and each
destination shard reduces what it received locally: the sweep the bitset
engine runs, carrying GNN features in place of omega words.

PNA's aggregators (sum/mean/min/max/std) share ONE exchange: the payload is
sent once and reduced four ways on arrival. Everything is differentiable:
the gathers, the exchange and the segment reductions all have transposes,
so autograd runs through the sharded loss.

The collectives are the engine's `Prims` (`core/engine.py`):
  sim   every shard in this process (`sim_prims`): the exchange is a
        transpose of the leading two axes and the sum is over the shard
        axis, both plain autograd ops;
  spmd  one shard per rank of a `torch.distributed` group
        (`spmd_gnn_prims`): the differentiable `all_to_all_single` and
        `all_reduce` of `torch.distributed.nn.functional`, and each
        parameter's gradient averaged over the ranks (`Prims.replicate`),
        since every rank seeds the backward of the same replicated loss.
The prune's `spmd_prims` carry no gradient and are left as they are.

Layout (leading axis = the Pl shards this process holds):
  x               f32[Pl, n_local, F]
  send_src_local  int32[Pl, P, B]     (n_local = padding sink)
  recv_dst_local  int32[Pl, P*B]      (arrival order; n_local = padding)
  labels, train_mask [Pl, n_local]
  log_deg_avg     f32[]
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import Prims, spmd_prims
from repro_torch.graph import segment_ops
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.structs import Graph, resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.tree import leaves, tree_map, unflatten

MESSAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the fill of a padding slot's min and max, and the reference's test for a
# segment that only padding reached (not +-inf, as in the reference)
BIG = 3.0e38


def message_dtype(cfg: GNNConfig) -> torch.dtype:
    if cfg.message_dtype not in MESSAGE_DTYPES:
        raise ValueError(f"message_dtype must be one of {tuple(MESSAGE_DTYPES)}, "
                         f"got {cfg.message_dtype!r}")
    return MESSAGE_DTYPES[cfg.message_dtype]


def _shard_offsets(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[Pl, 1, ...] offsets p * rows that turn per-shard indices into flat
    ones over the stacked shards."""
    pl = t.shape[0]
    return (torch.arange(pl, device=t.device) * rows).view((pl,) + (1,) * (t.dim() - 1))


def aggregate_sweep(x_local, send_src_local, recv_dst_local, n_local: int,
                    prims: Prims, message_dtype=torch.float32):
    """One message exchange + the fused reduction.

    x_local [Pl, n_local, F] -> ({sum, mean, min, max, std}: [Pl, n_local,
    F] f32, degree [Pl, n_local]). bf16 messages halve the exchange's
    payload (the backward's cotangent crosses in bf16 too); the reductions
    run in f32 on arrival."""
    pl, _, f = x_local.shape
    p, b = send_src_local.shape[1:]
    rows = n_local + 1
    x_sink = torch.cat([x_local, x_local.new_zeros((pl, 1, f))], dim=1)
    flat_src = (send_src_local.long() + _shard_offsets(send_src_local, rows)).reshape(-1)
    msgs = x_sink.to(message_dtype).reshape(pl * rows, f).index_select(0, flat_src)
    recv = prims.exchange(msgs.reshape(pl, p, b, f)).float().reshape(pl * p * b, f)
    seg = (recv_dst_local.long() + _shard_offsets(recv_dst_local, rows)).reshape(-1)
    ns = pl * rows
    valid = (recv_dst_local < n_local).reshape(-1, 1)
    s = segment_ops.segment_sum(torch.where(valid, recv, 0.0), seg, ns)
    sq = segment_ops.segment_sum(torch.where(valid, recv * recv, 0.0), seg, ns)
    mn = segment_ops.segment_min(torch.where(valid, recv, BIG), seg, ns)
    mx = segment_ops.segment_max(torch.where(valid, recv, -BIG), seg, ns)
    deg = segment_ops.segment_sum(valid[:, 0].float(), seg, ns)

    def local(t):  # drop each shard's padding segment
        return t.reshape((pl, rows) + tuple(t.shape[1:]))[:, :-1]

    s, sq, mn, mx, deg = local(s), local(sq), local(mn), local(mx), local(deg)
    mean, std = segment_ops.mean_and_std(s, sq, deg, mn, mx)
    empty = (deg <= 0)[..., None]
    mn = torch.where(empty | (mn >= BIG), 0.0, mn)
    mx = torch.where(empty | (mx <= -BIG), 0.0, mx)
    return {"sum": s, "mean": mean, "min": mn, "max": mx, "std": std}, deg


def pna_layer_local(p, cfg: GNNConfig, x_local, aggs, deg, log_deg_avg):
    """PNA's scalers over the aggregates, then the layer's dense map."""
    logd = torch.log(deg + 1.0)[..., None]
    scaled = []
    for a in cfg.aggregators:
        v = aggs[a]
        for sc in cfg.scalers:
            if sc in ("identity", "id"):
                scaled.append(v)
            elif sc in ("amplification", "amp"):
                scaled.append(v * (logd / log_deg_avg))
            else:
                scaled.append(v * (log_deg_avg / logd.clamp_min(1e-6)))
    h = torch.cat(scaled + [x_local], dim=-1)
    return torch.relu(h @ p["w"] + p["b"])


def build_distributed_pna_loss(cfg: GNNConfig, prims: Prims, n_local: int) -> Callable:
    """loss_fn(params, batch) -> (loss, {}) over the shards of `prims`.

    params: the PNA parameter tree of the JAX layout ({"layers": [{"w",
    "b"}], "head": {"w", "b"}}, `train.step.param_tree`); batch: this
    process's shards (module docstring). The loss is the masked mean
    cross-entropy over every shard's vertices, the same on every rank."""
    if cfg.model != "pna":
        raise ValueError(f"the distributed step is PNA's, got {cfg.model!r}")
    mdt = message_dtype(cfg)

    def loss_fn(params, batch: Mapping):
        if prims.replicate is not None:
            params = tree_map(prims.replicate, params)
        send, recv = batch["send_src_local"], batch["recv_dst_local"]
        log_deg_avg = batch["log_deg_avg"]
        h = batch["x"]
        for p in params["layers"]:
            aggs, deg = aggregate_sweep(h, send, recv, n_local, prims, mdt)
            h = pna_layer_local(p, cfg, h, aggs, deg, log_deg_avg)
        logits = (h @ params["head"]["w"] + params["head"]["b"]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        mk = batch["train_mask"].float()
        num = prims.psum(((logz - gold) * mk).sum(-1))
        den = prims.psum(mk.sum(-1))
        return (num / den.clamp_min(1.0))[0], {}

    return loss_fn


def build_distributed_pna_step(cfg: GNNConfig, prims: Prims, n_local: int,
                               opt: adamw.AdamWConfig) -> Callable:
    """step(state, batch) -> (state, {"loss", "grad_norm"}): the gradient of
    the sharded loss and one AdamW update (the reference cell's step; state
    = {"params", "opt", "step"})."""
    loss_fn = build_distributed_pna_loss(cfg, prims, n_local)

    def step(state, batch):
        params = state["params"]
        xs = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, _ = loss_fn(xs, batch)
            gs = torch.autograd.grad(loss, leaves(xs))
        grads = unflatten(xs, list(gs))
        new_params, new_opt, om = adamw.update(grads, state["opt"], params, opt)
        return ({"params": new_params, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss.detach(), **om})

    return step


# --------------------------------------------------------------- collectives
class _ReplicatedParam(torch.autograd.Function):
    """The identity forward; the backward averages the gradient over the
    ranks of `group`. Each rank seeds the backward of the one replicated
    loss, and the differentiable all_reduce of the loss's psum sums those
    seeds, so each rank's share arrives P times: the mean over the ranks is
    the whole gradient, on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def spmd_gnn_prims(group, P: int, rank: int, device) -> Prims:
    """One shard per rank of a `torch.distributed` group, with gradients:
    `torch.distributed.nn.functional`'s all_to_all_single and all_reduce,
    and `replicate` averaging each parameter's gradient over the ranks."""
    import torch.distributed.nn.functional as dnn

    base = spmd_prims(group, P, rank, device)

    def exchange(x):
        inp = x[0].contiguous()
        out = dnn.all_to_all_single(torch.empty_like(inp), inp, group=group)
        return out[None]

    def psum(x):
        return dnn.all_reduce(x, group=group)

    return base._replace(exchange=exchange, psum=psum,
                         replicate=lambda t: _ReplicatedParam.apply(t, group))


# ------------------------------------------------------------------- batches
def partitioned_batch_shapes(n: int, m: int, p_shards: int, d_feat: int,
                             pad_multiple: int = 8, skew: float = 2.0) -> Dict:
    """Analytic ((shape), dtype) of each batch array (the dry run; no data)."""
    n_local = -(-n // p_shards)
    b = -(-int(skew * m / (p_shards * p_shards)) // pad_multiple) * pad_multiple
    return {
        "x": ((p_shards, n_local, d_feat), torch.float32),
        "send_src_local": ((p_shards, p_shards, b), torch.int32),
        "recv_dst_local": ((p_shards, p_shards * b), torch.int32),
        "labels": ((p_shards, n_local), torch.int32),
        "train_mask": ((p_shards, n_local), torch.bool),
        "log_deg_avg": ((), torch.float32),
    }


def partitioned_batch_from_graph(g: Graph, d_feat: int, n_classes: int,
                                 p_shards: int, seed: int = 0, device=None
                                 ) -> Tuple[Dict, np.ndarray, object]:
    """Host construction of the partitioned batch -> (batch on `device`,
    the features f32[n, d_feat], the partition). The features, labels and
    training mask are the reference's for the same seed."""
    dev = resolve_device(device)
    part = partition_graph(g, p_shards)
    rng = np.random.default_rng(seed)
    n_local = part.n_local
    x = np.zeros((p_shards, n_local, d_feat), np.float32)
    feats = rng.standard_normal((g.n, d_feat)).astype(np.float32)
    ids = np.arange(g.n)
    x[ids // n_local, ids % n_local] = feats
    labels = np.zeros((p_shards, n_local), np.int32)
    labels[ids // n_local, ids % n_local] = g.labels % n_classes
    mask = np.zeros((p_shards, n_local), bool)
    mask[ids // n_local, ids % n_local] = rng.random(g.n) < 0.5
    # arrival-order destination ids: undo the partition's sort permutation
    recv_dst_local = np.stack([
        part.recv_sorted_dst_local[p][_invert(part.recv_perm[p])]
        for p in range(p_shards)
    ]).astype(np.int32)
    deg = g.degrees()
    arrays = {"x": x, "send_src_local": part.send_src_local,
              "recv_dst_local": recv_dst_local, "labels": labels,
              "train_mask": mask}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in arrays.items()}
    batch["log_deg_avg"] = torch.tensor(
        np.float32(np.mean(np.log(deg + 1)) + 1e-6), device=dev)
    return batch, feats, part


def _invert(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv
