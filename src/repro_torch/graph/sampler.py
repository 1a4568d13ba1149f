"""Layered uniform neighbor sampler (GraphSAGE-style fanout sampling).

Host-side numpy over CSR, the JAX package's `graph/sampler.py` call for
call: the same generator draws in the same order, so the same seed gives the
same ids. Only the ids go to the device; `data/graphs.py` gathers features
there.

Block layout for L layers with fanouts (f_1 .. f_L), seed batch size S:
  layer 0 nodes: S seeds
  layer l nodes: S * f_1 * ... * f_l sampled endpoints (with replacement when
                 degree > 0; repeated nodes allowed, exactly like the original
                 GraphSAGE sampler), the parent's own id when degree == 0.
Child i at layer l connects to parent i // f_l at layer l-1, so aggregation
in the model is a reshape and a reduction over the fanout axis.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.graph.structs import Graph


class NeighborSampler:
    def __init__(self, g: Graph, fanouts: Sequence[int], seed: int = 0):
        self.fanouts = tuple(int(f) for f in fanouts)
        self.offsets, self.neighbors = g.csr()
        self.n = g.n
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> List[np.ndarray]:
        """Returns [layer0 nodes, layer1 nodes, ...]; layer l has S * prod(f_1..f_l) ids.

        Zero-degree nodes self-sample (their own id), which the models treat as a
        mean over a single self message — standard practice.
        """
        layers = [np.asarray(seeds, dtype=np.int32)]
        for f in self.fanouts:
            parents = layers[-1]
            deg = (self.offsets[parents + 1] - self.offsets[parents]).astype(np.int64)
            r = self.rng.integers(0, 1 << 62, size=(parents.shape[0], f))
            pick = np.where(deg[:, None] > 0, r % np.maximum(deg, 1)[:, None], 0)
            base = self.offsets[parents][:, None]
            idx = base + pick
            sampled = np.where(
                deg[:, None] > 0,
                self.neighbors[np.minimum(idx, self.neighbors.shape[0] - 1)],
                parents[:, None],
            ).astype(np.int32)
            layers.append(sampled.reshape(-1))
        return layers

    def sample_batch(self, batch_size: int) -> List[np.ndarray]:
        seeds = self.rng.integers(0, self.n, size=batch_size).astype(np.int32)
        return self.sample(seeds)
