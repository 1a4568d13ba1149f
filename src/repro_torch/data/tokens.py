"""Deterministic synthetic token streams (the JAX package's
`data/tokens.py`, same numpy draws, same arrays).

Each batch is a pure function of (seed, step). A Zipf-ish marginal and a
linear-congruential 'grammar' make the stream learnable: token t+1 follows
from token t 75% of the time.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.graph.structs import resolve_device


class SyntheticTokenStream:
    """`batch_at(step)` (or calling the stream) gives int32 tokens and labels
    [batch, seq_len] on `device` (`cuda` unless the caller names one)."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 device=None):
        self.vocab, self.batch, self.seq_len, self.seed = vocab, batch, seq_len, seed
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        # zipf-flavored unigram draw, then a deterministic bigram transform so
        # that token t+1 is predictable from t 75% of the time
        z = rng.zipf(1.3, size=(self.batch, self.seq_len)).astype(np.int64)
        toks = (z - 1) % self.vocab
        follow = (toks * 2654435761 + 12345) % self.vocab
        use_follow = rng.random((self.batch, self.seq_len)) < 0.75
        toks[:, 1:] = np.where(use_follow[:, 1:], follow[:, :-1], toks[:, 1:])
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        return {k: torch.from_numpy(v.astype(np.int32)).to(self.device)
                for k, v in (("tokens", toks), ("labels", labels))}

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        return self.batch_at(step)
