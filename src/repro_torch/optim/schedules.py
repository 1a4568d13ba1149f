"""LR schedules (functions of the int32 step), in f32 tensors as the JAX
package computes them."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_ratio. Returns an f32 scale in
    (0, 1] on the step's device."""
    step = _f32(step)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step, value: float = 1.0) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.tensor(value, dtype=torch.float32, device=device)
