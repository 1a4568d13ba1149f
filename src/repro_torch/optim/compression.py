"""Gradient compression with error feedback: int8 per-tensor-scale
quantization of each gradient, the residual carried to the next step (the
JAX package's `optim/compression.py`; Karimireddy et al., "Error Feedback
Fixes SignSGD", arXiv:1901.09847). `torch.round`, like `jnp.round`, rounds
half to even."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x32 = x.float()
    amax = torch.max(torch.abs(x32))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_grads(grads, ef):
    """Returns (the grads as every replica would see them after the int8
    round trip, the new error feedback)."""

    def one(g, e):
        corrected = g.float() + e
        q, scale = quantize_int8(corrected)
        deq = dequantize(q, scale)
        return deq.to(g.dtype), corrected - deq

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(ef))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
