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


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"   # "float32" | "bfloat16"


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
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
def update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics); the inputs are not
    modified."""
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=count.device)

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
        step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr * (step + cfg.weight_decay * p32)
        return p_new.to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        leaves(params), leaves(grads), leaves(state["mu"]), leaves(state["nu"]))]
    new_params = unflatten(params, [o[0] for o in out])
    new_mu = unflatten(params, [o[1] for o in out])
    new_nu = unflatten(params, [o[2] for o in out])
    return new_params, {"mu": new_mu, "nu": new_nu, "count": count}, metrics
