"""Cell builders: (arch x input shape) -> one step of the port with its
arguments and their logical specs (the JAX package's `launch/cells.py`).

Every cell is one of:
  lm train      `train/step.py`'s `build_train_step` over microbatched token
                batches (remat, grad accumulation; bf16 optimizer state for
                the largest config)
  lm prefill    `forward_hidden` + the last position's logits
  lm decode     one `serve/engine.py` decode step over the KV cache (a ring
                buffer when windowed)
  gnn train     the full-graph step (node and arc arrays padded to the chip
                count), the sampled-fanout step (graphsage) or the sampled
                subgraph step (the other GNNs) on minibatch_lg; with
                `distributed` set, PNA's step over the edge partition
                (`models/gnn_distributed.py`, the sim backend at P = chips)
  recsys train  the masked-item step; serve: top-k catalog scoring;
                retrieval: 1 user x 1M candidates

`build_cell(..., device="meta")` (the default) builds every argument on the
meta device, with the reference's shapes and dtypes and no storage: the dry
run. On a real device the same builder draws random weights from `seed`
and random inputs in their valid ranges (token ids below the vocabulary,
arc endpoints below n, the distributed cell's partition of an Erdos-Renyi
graph of the shape's size), so `cell()` runs the step there.

A cell's `fn` reads parameters from its arguments, not from the model it
was built with (`torch.func.functional_call`), as the reference's jitted
functions take them. A train cell consumes its state (`build_train_step`'s
donate=True), as the reference's train cells donate theirs, so the dry run
counts the new state once, over the old one's storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import get_arch
from repro_torch.configs.base import (GNN_CLASSES, GNNConfig, LMConfig,
                                      RecsysConfig, ShapeSpec)
from repro_torch.core.engine import Prims, sim_prims
from repro_torch.graph.structs import resolve_device
from repro_torch.launch.abstract import shardings_for
from repro_torch.models import common, gnn_distributed as gd
from repro_torch.models.bert4rec import Bert4Rec
from repro_torch.models.gnn import GNN
from repro_torch.models.transformer import Transformer, cache_specs
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import build_decode_step
from repro_torch.sharding import DEFAULT_RULES, ONE_CARD, MeshShape
from repro_torch.train.step import TrainConfig, build_train_step, init_state, param_tree

# per-arch training knobs, as the reference's
LM_TRAIN_MICROBATCHES = 8
LM_STATE_DTYPE = {"deepseek-v3-671b": "bfloat16"}
RECSYS_TRAIN_MICROBATCHES = 8
SERVE_TOP_K = 100


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_kind: str
    fn: Callable
    args: Tuple                 # trees of tensors (meta for the dry run)
    arg_specs: Tuple            # their logical specs
    mesh: MeshShape = ONE_CARD
    rules: Optional[Dict[str, object]] = None
    shards: int = 1             # shards this process runs (the sim backend)
    model_flops_fn: Optional[Callable[[], float]] = None
    note: str = ""
    # a step over collectives: the prims `fn` runs on, and `fn` rebuilt on
    # others (the counter's marked prims, `op_cost.counted_step`)
    prims: Optional[Prims] = None
    build_fn: Optional[Callable[[Prims], Callable]] = None

    @property
    def shardings(self):
        """The arguments' specs resolved on the cell's mesh."""
        return shardings_for(self.args, self.arg_specs, self.mesh, self.rules)

    def __call__(self):
        return self.fn(*self.args)


# ------------------------------------------------------------------ inputs
def _ints(shape, high, dev, gen, low=0, dtype=torch.int32):
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.randint(low, high, shape, generator=gen, device=dev, dtype=dtype)


def _floats(shape, dev, gen):
    if dev.type == "meta":
        return torch.empty(shape, device=dev)
    return torch.randn(shape, generator=gen, device=dev)


def _bools(shape, dev, gen):
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.bool, device=dev)
    return torch.rand(shape, generator=gen, device=dev) < 0.5


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


class _Method(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _with_params(model: nn.Module, fn: Callable) -> Callable:
    """fn(model, *args) as g(params, *args): the model's code on `params`,
    a tree of its parameters in the JAX layout (`param_tree`)."""
    wrapper = _Method(model, fn)
    paths = model.param_paths()

    def g(params, *args):
        flat = common.unnest(params, paths)
        return torch.func.functional_call(
            wrapper, {"model." + k: v for k, v in flat.items()}, args)

    return g


def _train_state(model: nn.Module, tc: TrainConfig):
    pspecs = model.param_specs()
    return init_state(model, tc), {"params": pspecs, "opt": adamw.state_specs(pspecs),
                                   "step": ()}


# ------------------------------------------------------------------ LM cells
def _lm_train_cell(arch, cfg: LMConfig, shape: ShapeSpec, dev, seed) -> Cell:
    k = cfg.train_microbatches or LM_TRAIN_MICROBATCHES
    gb, s = shape.global_batch, shape.seq_len
    mb = gb // k
    tc = TrainConfig(
        optimizer=AdamWConfig(state_dtype=LM_STATE_DTYPE.get(arch, "float32")),
        microbatches=k, pre_microbatched=True,
        remat=("dots" if cfg.remat_policy == "dots" else True))
    model = Transformer(cfg, device=dev, seed=seed)
    state, state_specs = _train_state(model, tc)
    gen = common.generator(dev, seed)
    batch = {"tokens": _ints((k, mb, s), cfg.vocab, dev, gen),
             "labels": _ints((k, mb, s), cfg.vocab, dev, gen)}
    batch_specs = {"tokens": (None, "batch", None), "labels": (None, "batch", None)}
    return Cell(arch=arch, shape=shape.name, step_kind="train_step",
                fn=build_train_step(model, tc, donate=True), args=(state, batch),
                arg_specs=(state_specs, batch_specs),
                model_flops_fn=lambda: 6.0 * cfg.n_active_params() * gb * s)


def _lm_prefill(model, tokens):
    h, _ = model.forward_hidden(tokens)
    return model.logits_from_hidden(h[:, -1:])[:, 0]


def _lm_prefill_cell(arch, cfg: LMConfig, shape: ShapeSpec, dev, seed) -> Cell:
    model = Transformer(cfg, device=dev, seed=seed)
    b, s = shape.global_batch, shape.seq_len
    tokens = _ints((b, s), cfg.vocab, dev, common.generator(dev, seed))
    return Cell(arch=arch, shape=shape.name, step_kind="prefill",
                fn=_with_params(model, _lm_prefill),
                args=(param_tree(model), tokens),
                arg_specs=(model.param_specs(), ("batch", None)),
                model_flops_fn=lambda: 2.0 * cfg.n_active_params() * b * s,
                note="no remat: the reference's remat=True recomputes nothing "
                     "without a backward")


def _lm_decode_cell(arch, cfg: LMConfig, shape: ShapeSpec, dev, seed) -> Cell:
    model = Transformer(cfg, device=dev, seed=seed)
    b, s = shape.global_batch, shape.seq_len
    tok = _ints((b,), cfg.vocab, dev, common.generator(dev, seed))

    def step(m, cache, token):
        return build_decode_step(m)(cache, token)

    moe = (" MoE layers dispatch dropless at the reference's static T rows an "
           "expert on meta, where the largest load cannot be read;"
           if cfg.moe and dev.type == "meta" else "")
    return Cell(arch=arch, shape=shape.name, step_kind="serve_step",
                fn=_with_params(model, step),
                args=(param_tree(model), model.init_cache(b, s), tok),
                arg_specs=(model.param_specs(), cache_specs(cfg), ("batch",)),
                model_flops_fn=lambda: 2.0 * cfg.n_active_params() * b,
                note="one new token against a KV cache of seq_len;" + moe
                     + " the cache's position is a host int")


# ----------------------------------------------------------------- GNN cells
def _gnn_graph_batch(n, m, shape: ShapeSpec, n_classes, dev, gen):
    batch = {
        "x": _floats((n, shape.d_feat), dev, gen),
        "src": _ints((m,), n, dev, gen),
        "dst": _ints((m,), n, dev, gen),
        "labels": _ints((n,), n_classes, dev, gen),
        "train_mask": _bools((n,), dev, gen),
        "log_deg_avg": torch.ones((), device=dev),
    }
    specs = {"x": ("nodes", None), "src": ("edges",), "dst": ("edges",),
             "labels": ("nodes",), "train_mask": ("nodes",), "log_deg_avg": ()}
    return batch, specs


def _gnn_sampled_batch(shape: ShapeSpec, n_classes, dev, gen):
    b, (f1, f2), d = shape.batch_nodes, shape.fanout, shape.d_feat
    batch = {"x_self": _floats((b, d), dev, gen),
             "x_nbr": _floats((b, f1, d), dev, gen),
             "x_nbr2": _floats((b, f1, f2, d), dev, gen),
             "labels": _ints((b,), n_classes, dev, gen)}
    specs = {"x_self": ("batch", None), "x_nbr": ("batch", None, None),
             "x_nbr2": ("batch", None, None, None), "labels": ("batch",)}
    return batch, specs


def _gnn_sizes(shape: ShapeSpec) -> Tuple[int, int]:
    if shape.name == "molecule":
        return shape.n_graphs * shape.n_nodes, shape.n_graphs * shape.n_edges * 2
    return shape.n_nodes, shape.n_edges


def _gnn_flops(cfg: GNNConfig, m, n) -> float:
    """Model FLOPs: per arc, d_hidden MACs a layer (an order of magnitude,
    the reference's), forward and backward."""
    dh = cfg.d_hidden
    return 2.0 * cfg.n_layers * (m * dh + n * dh * dh) * 3


def _partitioned_batch(n: int, m: int, P: int, shape: ShapeSpec, n_classes: int,
                      dev, seed: int) -> Dict:
    """The distributed cell's batch on a real device: an Erdos-Renyi graph
    of n vertices and about m arcs, partitioned into P shards, its buckets
    padded from the partition's B to the cell's analytic one."""
    from repro_torch.graph import generators as gen

    want = gd.partitioned_batch_shapes(n, m, P, shape.d_feat)
    g = gen.erdos_renyi_graph(n, m / n, seed=seed)
    batch, _, part = gd.partitioned_batch_from_graph(g, shape.d_feat, n_classes, P,
                                                     seed=seed, device=dev)
    b_cell = want["send_src_local"][0][2]
    if part.B > b_cell:
        raise ValueError(f"the partition's buckets ({part.B}) exceed the cell's ({b_cell})")
    pad = (0, b_cell - part.B)
    batch["send_src_local"] = torch.nn.functional.pad(
        batch["send_src_local"], pad, value=part.n_local)
    batch["recv_dst_local"] = torch.nn.functional.pad(
        batch["recv_dst_local"].view(P, P, part.B), pad,
        value=part.n_local).reshape(P, P * b_cell)
    return batch


def _gnn_distributed_cell(arch, cfg: GNNConfig, shape: ShapeSpec, chips, dev,
                          seed) -> Cell:
    """PNA over the engine's edge partition on the sim backend at P = chips:
    every shard in this process, one exchange a layer."""
    n_classes = GNN_CLASSES[shape.name]
    n, m = _gnn_sizes(shape)
    P = chips
    shapes = gd.partitioned_batch_shapes(n, m, P, shape.d_feat)
    n_local = shapes["x"][0][1]
    if dev.type == "meta":
        batch = {k: torch.empty(shp, dtype=dt, device=dev) for k, (shp, dt) in shapes.items()}
    else:
        batch = _partitioned_batch(n, m, P, shape, n_classes, dev, seed)
    batch_specs = {
        "x": ("part_shard", None, None), "send_src_local": ("part_shard", None, None),
        "recv_dst_local": ("part_shard", None), "labels": ("part_shard", None),
        "train_mask": ("part_shard", None), "log_deg_avg": (),
    }
    oc = AdamWConfig(weight_decay=0.0)
    model = GNN(cfg, shape.d_feat, n_classes, device=dev, seed=seed)
    params, pspecs = param_tree(model), model.param_specs()
    state = {"params": params, "opt": adamw.init_state(params, oc),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    state_specs = {"params": pspecs, "opt": adamw.state_specs(pspecs), "step": ()}
    prims = sim_prims(P, dev)

    def build_fn(prims):
        return gd.build_distributed_pna_step(cfg, prims, n_local, oc)

    return Cell(arch=arch, shape=shape.name, step_kind="train_step",
                fn=build_fn(prims), prims=prims, build_fn=build_fn,
                args=(state, batch), arg_specs=(state_specs, batch_specs),
                mesh=MeshShape(("shards",), (P,)),
                rules={**DEFAULT_RULES, "part_shard": ("shards",)}, shards=P,
                model_flops_fn=lambda: _gnn_flops(cfg, m, n),
                note="edge-partition message passing on the sim backend: "
                     f"{P} shards in one process, one exchange a layer")


def _gnn_train_cell(arch, cfg: GNNConfig, shape: ShapeSpec, chips, dev, seed) -> Cell:
    if (cfg.distributed and cfg.model == "pna"
            and shape.name in ("full_graph_sm", "ogb_products")):
        return _gnn_distributed_cell(arch, cfg, shape, chips, dev, seed)
    n_classes = GNN_CLASSES[shape.name]
    tc = TrainConfig(optimizer=AdamWConfig(weight_decay=0.0))
    gen = common.generator(dev, seed)
    if shape.name == "minibatch_lg" and cfg.model == "graphsage":
        batch, batch_specs = _gnn_sampled_batch(shape, n_classes, dev, gen)
        nn_ = shape.batch_nodes
        m = shape.batch_nodes * (shape.fanout[0] + shape.fanout[0] * shape.fanout[1])
    else:
        if shape.name == "minibatch_lg":  # block-diagonal sampled subgraph
            b, (f1, f2) = shape.batch_nodes, shape.fanout
            n, m = b * (1 + f1 + f1 * f2), b * f1 + b * f1 * f2
        else:
            n, m = _gnn_sizes(shape)
        nn_, m = _pad_to(n, chips), _pad_to(m, chips)
        batch, batch_specs = _gnn_graph_batch(nn_, m, shape, n_classes, dev, gen)
    model = GNN(cfg, shape.d_feat, n_classes, device=dev, seed=seed)
    state, state_specs = _train_state(model, tc)
    return Cell(arch=arch, shape=shape.name, step_kind="train_step",
                fn=build_train_step(model, tc, donate=True), args=(state, batch),
                arg_specs=(state_specs, batch_specs),
                model_flops_fn=lambda: _gnn_flops(cfg, m, nn_))


# -------------------------------------------------------------- recsys cells
def _recsys_per_token(cfg: RecsysConfig) -> int:
    return cfg.n_blocks * 12 * cfg.embed_dim ** 2


def _recsys_train_cell(arch, cfg: RecsysConfig, shape: ShapeSpec, dev, seed) -> Cell:
    k = RECSYS_TRAIN_MICROBATCHES
    mb = shape.batch // k
    tc = TrainConfig(optimizer=AdamWConfig(), microbatches=k, pre_microbatched=True)
    model = Bert4Rec(cfg, device=dev, seed=seed)
    state, state_specs = _train_state(model, tc)
    gen = common.generator(dev, seed)
    dims = (k, mb, cfg.seq_len)
    batch = {"items": _ints(dims, cfg.n_items + 2, dev, gen),
             "labels": _ints(dims, cfg.n_items + 2, dev, gen),
             "mlm_mask": _bools(dims, dev, gen)}
    batch_specs = {key: (None, "batch", None) for key in batch}
    # the head of the objective that runs: the full catalog or 1 + N
    # sampled candidates
    v_eff = (1 + cfg.n_negatives) if cfg.n_negatives else (cfg.n_items + 2)
    tokens = shape.batch * cfg.seq_len
    return Cell(arch=arch, shape=shape.name, step_kind="train_step",
                fn=build_train_step(model, tc, donate=True), args=(state, batch),
                arg_specs=(state_specs, batch_specs),
                model_flops_fn=lambda: 6.0 * tokens * (
                    _recsys_per_token(cfg) + cfg.embed_dim * v_eff))


def _recsys_serve(model, items):
    vals, ids = torch.topk(model.serve_scores(items), SERVE_TOP_K)
    return {"scores": vals, "ids": ids}


def _recsys_serve_cell(arch, cfg: RecsysConfig, shape: ShapeSpec, dev, seed) -> Cell:
    model = Bert4Rec(cfg, device=dev, seed=seed)
    b = shape.batch
    items = _ints((b, cfg.seq_len), cfg.n_items + 2, dev, common.generator(dev, seed))
    return Cell(arch=arch, shape=shape.name, step_kind="serve_step",
                fn=_with_params(model, _recsys_serve),
                args=(param_tree(model), items),
                arg_specs=(model.param_specs(), ("batch", None)),
                model_flops_fn=lambda: 2.0 * b * (
                    cfg.seq_len * _recsys_per_token(cfg)
                    + cfg.embed_dim * (cfg.n_items + 2)))


def _recsys_retrieval_cell(arch, cfg: RecsysConfig, shape: ShapeSpec, dev,
                           seed) -> Cell:
    model = Bert4Rec(cfg, device=dev, seed=seed)
    b, c = shape.batch, shape.n_candidates
    gen = common.generator(dev, seed)
    items = _ints((b, cfg.seq_len), cfg.n_items + 2, dev, gen)
    cands = _ints((c,), cfg.n_items + 1, dev, gen, low=1)
    return Cell(arch=arch, shape=shape.name, step_kind="retrieval",
                fn=_with_params(model, lambda m, i, cs: m.retrieval_scores(i, cs)),
                args=(param_tree(model), items, cands),
                arg_specs=(model.param_specs(), ("batch", None), ("candidates",)),
                model_flops_fn=lambda: 2.0 * (
                    b * cfg.seq_len * _recsys_per_token(cfg) + b * c * cfg.embed_dim))


# ------------------------------------------------------------------ dispatch
def build_cell(arch: str, shape_name: str, chips: int = 1,
               cfg_overrides: Optional[Dict[str, Any]] = None,
               shape_overrides: Optional[Dict[str, Any]] = None,
               device="meta", seed: int = 0) -> Optional[Cell]:
    """The cell of `arch` x `shape_name`, or None where the shape is marked
    skipped for the arch (`ShapeSpec.skip`). `chips` pads the full-graph
    GNN arrays and is the distributed cell's shard count. `cfg_overrides`
    (perf iterations) and `shape_overrides` (a cut, e.g. {"global_batch":
    1}) replace fields of the arch config and of the shape."""
    mod = get_arch(arch)
    cfg = mod.CONFIG
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = mod.SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    if shape.skip:
        return None
    dev = resolve_device(device)
    if isinstance(cfg, LMConfig):
        builder = {"train": _lm_train_cell, "prefill": _lm_prefill_cell,
                   "decode": _lm_decode_cell}.get(shape.step)
    elif isinstance(cfg, RecsysConfig):
        builder = {"train": _recsys_train_cell, "serve": _recsys_serve_cell,
                   "retrieval": _recsys_retrieval_cell}.get(shape.step)
    elif isinstance(cfg, GNNConfig):
        return _gnn_train_cell(arch, cfg, shape, chips, dev, seed)
    else:
        builder = None
    if builder is None:
        raise ValueError((arch, shape_name))
    return builder(arch, cfg, shape, dev, seed)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_ids(tree) -> set:
    """The identities of a tree's tensors."""
    return {id(t) for t in _tensors(tree)}


def tree_bytes(tree, skip=frozenset()) -> int:
    """Bytes of the tensors of a tree (their shapes and dtypes), leaving out
    those whose identity is in `skip`."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree) if id(t) not in skip)
