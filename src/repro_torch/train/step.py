"""The train step: loss -> grads (remat) -> microbatch accumulation ->
(optional) gradient compression -> AdamW, built by one function for the
three families (the JAX package's `train/step.py`).

The step is a function (state, batch) -> (state, metrics) that leaves its
inputs as they are, or, built with donate=True, overwrites the state it is
given (as the reference's train cells donate theirs). The state is a tree
of tensors with the reference's paths,

    {"params": <the model's JAX tree>, "opt": {"mu", "nu", "count"},
     "step": int32[] (, "ef": the error feedback with compress_grads)},

so `checkpoint/ckpt.py` writes and reads it in the format the JAX package
shares, and `load_jax_state` carries a reference state across. The model
module supplies the config and the forward code, as the reference's cfg
and model functions do; its own parameters are not read by the step, which
substitutes the state's (`torch.func.functional_call`) and differentiates
with respect to them.

Grad accumulation: the batch is reshaped to [K, micro, ...] (unless it
arrives so) and the K microbatches run one after another, their gradients
summed in f32 and divided by K, as the reference's scan does, so with K > 1
even bf16 parameters get f32 gradients; the loss is the mean over the
microbatches.

On a mesh (`mesh=`, a `launch/mesh.RankMesh` of (data, model) ranks; the LM
family), the state's leaves are this rank's blocks of the reference's specs
(`state_shardings`, `shard_state`), each microbatch [micro, ...] is split
over `data` as the reference's "batch" rule resolves it (replicated where
`data` does not divide micro), and the model runs on this rank's rows
(`transformer.MeshPlan`). A leaf's gradient ends up exactly as the leaf is
placed: summed over `data` when the batch is split there (reduce-scattered
by the FSDP gather's backward where the leaf is sharded on `data`,
all-reduced here where it is replicated), never summed over `model`, whose
ranks saw the same rows. AdamW then runs on the blocks, its global norm
summed over the mesh (`adamw.global_norm`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import sharding
from repro_torch.launch import abstract
from repro_torch.launch import mesh as rmesh
from repro_torch.models import bert4rec, gnn, transformer
from repro_torch.models.common import nest, unnest
from repro_torch.optim import adamw, compression, schedules
from repro_torch.optim.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1
    # True: batches arrive pre-shaped [K, micro, ...] from the data pipeline
    pre_microbatched: bool = False
    # False | True (full remat) | "dots" (save matmul outputs, recompute the
    # rest); LM only
    remat: object = False
    compress_grads: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000


def _loss_for(model: nn.Module) -> Callable:
    if isinstance(model, transformer.Transformer):
        return transformer.loss_fn
    if isinstance(model, gnn.GNN):
        return gnn.loss_fn
    if isinstance(model, bert4rec.Bert4Rec):
        return bert4rec.loss_fn
    raise TypeError(type(model))


def param_tree(model: nn.Module) -> Dict:
    """The model's parameters in the JAX package's tree (detached, sharing
    the module's storage)."""
    flat = {k: v.detach() for k, v in model.named_parameters()}
    return nest(flat, model.param_paths())


def init_state(model: nn.Module, tc: TrainConfig, mesh=None) -> Dict:
    """The train state of `model`'s current parameters: step 0, zero
    moments (and zero error feedback with compress_grads). With `mesh` (a
    `RankMesh`), this rank's blocks (`shard_state` of the global state),
    the moments made on the blocks alone."""
    params = param_tree(model)
    if mesh is not None:
        params = shard_state(params, state_shardings(model, tc, mesh)["params"], mesh)
    dev = leaves(params)[0].device
    state = {
        "params": params,
        "opt": adamw.init_state(params, tc.optimizer),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if tc.compress_grads:
        state["ef"] = compression.init_error_feedback(params)
    return state


def state_specs(model: nn.Module, tc: TrainConfig) -> Dict:
    """The state's logical sharding specs (the second value of the
    reference's `init_state`)."""
    pspecs = model.param_specs()
    specs = {"params": pspecs, "opt": adamw.state_specs(pspecs), "step": ()}
    if tc.compress_grads:
        specs["ef"] = pspecs
    return specs


def state_shardings(model: nn.Module, tc: TrainConfig, mesh) -> Dict:
    """The state's specs resolved against `mesh` (a `RankMesh` or a
    `MeshShape`) at the model's global shapes, with the divisibility guard
    (`launch/abstract.shardings_for`)."""
    shape = mesh.shape if isinstance(mesh, rmesh.RankMesh) else mesh
    params = param_tree(model)
    like = {"params": params, "opt": {"mu": params, "nu": params,
                                      "count": torch.zeros(())},
            "step": torch.zeros(())}
    if tc.compress_grads:
        like["ef"] = params
    return abstract.shardings_for(like, state_specs(model, tc), shape)


def shard_state(state: Mapping, shardings: Mapping, mesh) -> Dict:
    """This rank's blocks of a global state (`sharding.shard_tree`), each
    its own contiguous copy, so that the global leaves can be freed."""
    return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format),
                    sharding.shard_tree(state, shardings, mesh))


def _to_torch(x, like=None, device=None) -> torch.Tensor:
    a = np.asarray(x)
    dtype = like.dtype if like is not None else None
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through f32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    if like is not None and tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape {tuple(t.shape)}, expected {tuple(like.shape)}")
    return t.to(device=device if like is None else like.device,
                dtype=dtype if dtype is not None else t.dtype)


def load_jax_state(tree: Mapping, like: Mapping = None, device=None) -> Dict:
    """A reference train state (its tree, leaves as numpy arrays) as the
    port's. With `like` (a port state, e.g. `init_state`'s), the structure,
    shapes, dtypes and device are checked against it and taken from it;
    else each leaf keeps its dtype (bf16 as torch's) on `device`."""
    if like is None:
        return tree_map(lambda x: _to_torch(x, device=device), dict(tree))
    if set(tree) != set(like):
        raise ValueError(f"state keys {sorted(tree)}, expected {sorted(like)}")
    return tree_map(lambda l, x: _to_torch(x, like=l), dict(like), dict(tree))


class _Loss(nn.Module):
    """Calls `loss_fn(model, batch, **kw)` as a module, so that
    `functional_call` can substitute the state's tensors for the model's."""

    def __init__(self, model, loss_fn, kw):
        super().__init__()
        self.model, self.loss_fn, self.kw = model, loss_fn, kw

    def forward(self, batch, **more):
        return self.loss_fn(self.model, batch, **self.kw, **more)


def _microbatch(batch: Mapping, i: int) -> Dict:
    return {key: (v[i] if isinstance(v, torch.Tensor) else v)
            for key, v in batch.items()}


def build_train_step(model: nn.Module, tc: TrainConfig, donate: bool = False,
                     mesh=None) -> Callable:
    """step(state, batch) -> (new state, metrics {"loss", "lr_scale",
    "grad_norm"}) for `model`'s family (its config is `model.cfg`).

    donate=True consumes the state, as the reference's train cells donate
    theirs (`donate_argnums=(0,)`): AdamW overwrites its parameters and
    moments (`adamw.update(inplace=True)`), so a step holds one state, not
    the old and the new; the caller keeps only the returned one. The
    values are the same either way.

    With `mesh` (a `RankMesh`; LM only), every rank of the mesh calls the
    step with its blocks of the state (`shard_state`) and the same global
    batch; the loss and the metrics are the global ones on every rank."""
    kw = {"remat": tc.remat} if isinstance(model, transformer.Transformer) else {}
    wrapper = _Loss(model, _loss_for(model), kw)
    paths = model.param_paths()
    names = ["model." + k for k in paths]
    k = tc.microbatches
    if mesh is not None:
        if not isinstance(model, transformer.Transformer):
            raise NotImplementedError("the train step on a mesh is the LM's")
        if tc.compress_grads:
            # int8 with one scale per leaf: a block's scale is not the leaf's
            raise NotImplementedError("compress_grads on a mesh")
        pspecs = state_shardings(model, tc, mesh)["params"]
        flat_specs = unnest(pspecs, paths)
        # the leaves replicated over `data`
        data_free = {n: "data" not in flat_specs[n] for n in paths}
        plans = {}

    def local_rows(mb):
        """This data rank's rows of a microbatch -> (rows, batch split)."""
        spec = sharding.resolve_axis_spec(tuple(mb["tokens"].shape), ("batch",),
                                          mesh.shape)
        split = spec[0] is not None
        return ({key: (sharding.shard_leaf(v, spec[:1], mesh)
                       if isinstance(v, torch.Tensor) else v)
                 for key, v in mb.items()}, split)

    def value_and_grad(params, mb):
        named = unnest(params, paths)
        xs = [named[n[len("model."):]].detach().requires_grad_(True) for n in names]
        call_kw = {}
        if mesh is not None:
            mb, split = local_rows(mb)
            if split not in plans:
                plans[split] = transformer.MeshPlan(model, mesh, split)
            call_kw = {"plan": plans[split]}
        with torch.enable_grad():
            loss, _ = torch.func.functional_call(wrapper, dict(zip(names, xs)), (mb,),
                                                 call_kw)
            gs = torch.autograd.grad(loss, xs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
        loss = loss.detach()
        if mesh is not None and split:
            # the leaves replicated over `data`: their gradient summed there
            # (the FSDP gathers' backwards summed the others already)
            gs = [rmesh.all_reduce(g, mesh, "data") if data_free[n] else g
                  for n, g in zip(paths, gs)]
            loss = rmesh.all_reduce(loss, mesh, "data")
        return loss, nest(dict(zip(paths, gs)), paths)

    def train_step(state, batch):
        params = state["params"]
        if k > 1:
            if tc.pre_microbatched:
                micro = batch
            else:
                micro = {key: (v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
                               if isinstance(v, torch.Tensor) else v)
                         for key, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves(params)[0].device)
            # summed and divided in place: the f32 sums are this step's own
            for i in range(k):
                loss, g = value_and_grad(params, _microbatch(micro, i))
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                del g
                loss_sum = loss_sum + loss
            for acc in leaves(grads):
                acc.div_(k)
            loss = loss_sum / k
        else:
            loss, grads = value_and_grad(params, batch)

        new_state = dict(state)
        if tc.compress_grads:
            grads, new_state["ef"] = compression.compress_grads(grads, state["ef"])
        lr_scale = schedules.warmup_cosine(
            state["step"], warmup_steps=tc.warmup_steps, total_steps=tc.total_steps)
        new_params, new_opt, om = adamw.update(
            grads, state["opt"], params, tc.optimizer, lr_scale=lr_scale, inplace=donate,
            mesh=mesh, specs=None if mesh is None else pspecs)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        new_state["step"] = state["step"] + 1
        return new_state, {"loss": loss, "lr_scale": lr_scale, **om}

    return train_step
