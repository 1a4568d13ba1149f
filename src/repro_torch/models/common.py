"""Shared model building blocks.

The JAX package draws weights from `jax.random` keys; the port draws them
from an explicit `torch.Generator`. The two give different numbers from the
same seed, so a comparison carries the JAX weights across (each model's
`load_jax_params`).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """f32 N(0, 1) / sqrt(d_in) weights in the JAX layout [d_in, d_out],
    drawn from `gen` on its device."""
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in))


def normal(gen: torch.Generator, shape, scale: float,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from `gen` on its device, cast to dtype."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def register_params(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
    """Register each tensor on `module` as a parameter that does not require
    grad, under its own name (names such as "items" that an
    `nn.ParameterDict` would refuse stay as they are)."""
    for k, v in tensors.items():
        module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX parameter tree as flat names: {"mlp": {"w1": a}, "blocks": [{"b":
    c}], "eps": e} -> {"mlp_w1": a, "blocks_0_b": c, "eps": e}."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (Mapping, list, tuple)):
            out.update(flatten_tree(v, f"{prefix}{k}_"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def load_flat(params: Mapping[str, torch.Tensor], tree) -> None:
    """Copy a JAX parameter tree (leaves as numpy arrays, any float dtype)
    into `params`, keyed by `flatten_tree` names; the names and shapes must
    match exactly, else nothing is copied and ValueError is raised."""
    flat = flatten_tree(tree)
    if set(flat) != set(params.keys()):
        raise ValueError(f"parameters {sorted(flat)} given, "
                         f"{sorted(params.keys())} expected")
    for k, v in flat.items():
        if tuple(v.shape) != tuple(params[k].shape):
            raise ValueError(f"{k}: shape {v.shape}, expected "
                             f"{tuple(params[k].shape)}")
    with torch.no_grad():
        for k, v in flat.items():
            params[k].copy_(torch.from_numpy(np.array(v, dtype=np.float32)))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32, cast back to x's dtype, then the gain (the JAX order)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Biased variance, in f32, cast back to x's dtype before gain and bias."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, D] with D even; positions: int[..., S] or int[S].

    Interleaved pairs: (x[2i], x[2i+1]) rotate by positions * freqs[i], as
    the JAX package does, not the two halves of HF's `rotate_half`."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [D/2]
    angles = positions[..., :, None].float() * freqs           # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, op for op as `jax.nn.gelu(approximate=True)`
    writes it, so a bf16 input rounds where the JAX one does (one fused
    `F.gelu` rounds once, up to a bf16 ulp away)."""
    sqrt_2_over_pi = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(sqrt_2_over_pi * (x + 0.044715 * (x ** 3))))
    return x * cdf


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
