"""Synthetic interaction sequences and Cloze masking for BERT4Rec (the JAX
package's `data/recsys.py`, same numpy draws, same arrays)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.graph.structs import resolve_device


class MaskedSequenceStream:
    """Deterministic (seed, step) -> masked-item batches.

    Sessions follow a random walk over a hidden item-item graph so the Cloze
    task is learnable. Item id 0 = padding; id n_items+1 = [MASK].
    `batch_at(step)` (or calling the stream) gives the batch on `device`
    (`cuda` unless the caller names one).
    """

    def __init__(self, n_items: int, batch: int, seq_len: int,
                 mask_prob: float = 0.2, seed: int = 0, device=None):
        self.n_items, self.batch, self.seq_len = n_items, batch, seq_len
        self.mask_prob, self.seed = mask_prob, seed
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        start = rng.integers(1, self.n_items + 1, size=(self.batch, 1))
        steps = rng.integers(1, 7, size=(self.batch, self.seq_len))
        items = ((start + np.cumsum(steps, axis=1) * 97) % self.n_items) + 1
        # truncate sessions to random lengths (pad with 0 on the left)
        lengths = rng.integers(self.seq_len // 4, self.seq_len + 1, size=self.batch)
        pos = np.arange(self.seq_len)[None, :]
        pad = pos < (self.seq_len - lengths[:, None])
        items = np.where(pad, 0, items)
        mlm = (rng.random((self.batch, self.seq_len)) < self.mask_prob) & ~pad
        masked = np.where(mlm, self.n_items + 1, items)
        return {k: torch.from_numpy(v).to(self.device) for k, v in (
            ("items", masked.astype(np.int32)), ("labels", items.astype(np.int32)),
            ("mlm_mask", mlm))}

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        return self.batch_at(step)
