"""AdamW with dtype-configurable state, decoupled weight decay and
global-norm clipping: the JAX package's `optim/adamw.py` as functions on
trees of tensors (`optim/tree.py`), not `torch.optim.AdamW`, so that the
clipping, the decay and the rounding of the state are the reference's.

The moments are kept in `state_dtype` ("float32" or "bfloat16") and updated
in f32; the bias corrections are f32 powers of the int32 step count. The
state's logical sharding specs (`state_specs`) are its parameters', as in
the reference (`sharding.py` resolves them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# elements of a leaf updated at once (`update`)
UPDATE_PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"   # "float32" | "bfloat16"


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares. On a
    mesh (`mesh`, a `launch/mesh.RankMesh`, with `specs` the leaves'
    resolved specs), the leaves are this rank's blocks: a leaf's sum of
    squares is summed over the mesh axes it is sharded on, and not over
    those it is replicated on, so a replicated leaf counts once."""
    sq = torch.stack([torch.sum(torch.square(x.float())) for x in leaves(tree)])
    if mesh is not None:
        from repro_torch.launch.mesh import all_reduce

        from repro_torch.sharding import is_spec_leaf

        flat = leaves(specs, is_leaf=is_spec_leaf)
        for axis in mesh.shape.axis_names:
            on = torch.tensor([axis in s for s in flat], device=sq.device)
            if mesh.size(axis) > 1 and bool(on.any()):
                sq = torch.where(on, all_reduce(sq, mesh, axis), sq)
    return torch.sqrt(torch.sum(sq))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def state_specs(param_specs) -> Dict:
    """The optimizer state shards exactly like its parameter."""
    return {"mu": param_specs, "nu": param_specs, "count": ()}


def init_state(params, cfg: AdamWConfig) -> Dict:
    if cfg.state_dtype not in STATE_DTYPES:
        raise ValueError(f"state_dtype must be one of {tuple(STATE_DTYPES)}")
    dt = STATE_DTYPES[cfg.state_dtype]
    device = leaves(params)[0].device
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0, inplace=False,
           mesh=None, specs=None):
    """Returns (new_params, new_state, metrics). The clipped gradient is
    `clip_by_global_norm`'s, formed a leaf at a time. The inputs are not
    modified, unless `inplace`: then each parameter and moment is
    overwritten with its new value (the reference's train step with its
    state donated), so that the old and the new state are never both
    held, and the returned trees are `params` and `state`'s own. On a mesh
    the leaves are this rank's blocks (`specs`, the parameters' resolved
    specs): the update is elementwise on them, in the reference's order of
    clip, decay and bias correction, with the norm of the whole gradient
    (`global_norm`)."""
    metrics = {}
    scale = None
    if cfg.clip_norm is not None:
        gnorm = global_norm(grads, mesh, specs)
        scale = _clip_scale(gnorm, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=count.device)

    def upd_piece(p, g, mu, nu):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
        step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr * (step + cfg.weight_decay * p32)
        return p_new, mu32, nu32

    def upd(p, g, mu, nu):
        outs = (p, mu, nu) if inplace else tuple(map(torch.empty_like, (p, mu, nu)))
        ts = (p, g, mu, nu) + outs
        if p.is_meta or not all(t.is_contiguous() for t in ts):
            for out, value in zip(outs, upd_piece(p, g, mu, nu)):
                out.copy_(value)
            return outs
        # elementwise, so a piece at a time: the f32 temporaries of a leaf
        # stacked over the layers stay near UPDATE_PIECE elements each (on
        # the meta device, which holds nothing, the whole leaf at once)
        flat = [t.view(-1) for t in ts]
        for s in range(0, p.numel(), UPDATE_PIECE):
            piece = [t[s:s + UPDATE_PIECE] for t in flat]
            for out, value in zip(piece[4:], upd_piece(*piece[:4])):
                out.copy_(value)
        return outs

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        leaves(params), leaves(grads), leaves(state["mu"]), leaves(state["nu"]))]
    new_params = unflatten(params, [o[0] for o in out])
    new_mu = unflatten(params, [o[1] for o in out])
    new_nu = unflatten(params, [o[2] for o in out])
    return new_params, {"mu": new_mu, "nu": new_nu, "count": count}, metrics
