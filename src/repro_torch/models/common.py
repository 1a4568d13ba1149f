"""Shared model building blocks.

The JAX package draws weights from `jax.random` keys; the port draws them
from an explicit `torch.Generator`. The two give different numbers from the
same seed, so a comparison carries the JAX weights across
(`GNN.load_jax_params`).
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """f32 N(0, 1) / sqrt(d_in) weights in the JAX layout [d_in, d_out],
    drawn from `gen` on the CPU."""
    return torch.randn((d_in, d_out), generator=gen) * (1.0 / math.sqrt(d_in))
