"""Graph data pipelines: full-graph batches, block-diagonal molecule batches,
sampled GraphSAGE batches, and the paper-technique integration --
`PatternFilteredDataset` (pruning as a subgraph-selection stage before a
GNN).

The JAX package's `data/graphs.py`, with torch tensors on a device in place
of jnp arrays: the same seeds give the same values. Index arrays (src, dst,
labels) are int64, the type torch indexes with.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.pipeline import prune
from repro_torch.core.template import Template
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.graph.structs import Graph, resolve_device


def _log_deg_avg(deg: np.ndarray) -> float:
    return float(np.mean(np.log(deg + 1)) + 1e-6)


def full_graph_batch(g: Graph, d_feat: int, n_classes: int, seed: int = 0,
                     device=None) -> Dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g.n, d_feat))
    train_mask = rng.random(g.n) < 0.5
    return {
        "x": torch.from_numpy(x).float().to(dev),
        "src": torch.from_numpy(g.src.astype(np.int64)).to(dev),
        "dst": torch.from_numpy(g.dst.astype(np.int64)).to(dev),
        "labels": torch.from_numpy((g.labels % n_classes).astype(np.int64)).to(dev),
        "train_mask": torch.from_numpy(train_mask).to(dev),
        "log_deg_avg": _log_deg_avg(g.degrees()),
    }


def molecule_batch(n_graphs: int, nodes_per: int, edges_per: int, d_feat: int,
                   n_classes: int, seed: int = 0, device=None) -> Dict:
    """Batched small graphs, block-diagonal: one big disconnected graph."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for i in range(n_graphs):
        base = i * nodes_per
        pairs = rng.integers(0, nodes_per, size=(edges_per // 2, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        srcs.append(base + np.concatenate([pairs[:, 0], pairs[:, 1]]))
        dsts.append(base + np.concatenate([pairs[:, 1], pairs[:, 0]]))
    n = n_graphs * nodes_per
    src = np.concatenate(srcs).astype(np.int64)
    dst = np.concatenate(dsts).astype(np.int64)
    deg = np.bincount(src, minlength=n)
    x = rng.standard_normal((n, d_feat))
    labels = rng.integers(0, n_classes, n)
    return {
        "x": torch.from_numpy(x).float().to(dev),
        "src": torch.from_numpy(src).to(dev),
        "dst": torch.from_numpy(dst).to(dev),
        "labels": torch.from_numpy(labels.astype(np.int64)).to(dev),
        "graph_of": torch.from_numpy(
            np.repeat(np.arange(n_graphs, dtype=np.int64), nodes_per)).to(dev),
        "log_deg_avg": _log_deg_avg(deg),
    }


class SampledBatchStream:
    """GraphSAGE minibatch pipeline: neighbour sampling over CSR on the host,
    emitting static-shape dense fanout tensors (the minibatch_lg regime).

    The feature table and the labels stay resident on the device; per batch
    only the sampled ids cross from the host, and the features are gathered
    there. The values equal the JAX package's host gather."""

    def __init__(self, g: Graph, feats: np.ndarray, labels: np.ndarray,
                 fanouts: Sequence[int], batch: int, seed: int = 0,
                 device=None):
        if len(fanouts) != 2:
            raise ValueError("the sampled pipeline has 2 layers")
        dev = resolve_device(device)
        self.sampler = NeighborSampler(g, fanouts, seed=seed)
        self.feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
        self.labels = torch.as_tensor(np.asarray(labels, dtype=np.int64)).to(dev)
        self.fanouts, self.batch = tuple(fanouts), batch

    def sample_ids(self, step: int) -> List[np.ndarray]:
        """The host side of a batch: the sampled ids of each layer."""
        self.sampler.rng = np.random.default_rng(
            np.random.SeedSequence([self.sampler.n, step]))
        return self.sampler.sample_batch(self.batch)

    def gather(self, layers: List[np.ndarray]) -> Dict[str, torch.Tensor]:
        """The device side: move the ids over, gather features and labels."""
        dev = self.feats.device
        ids = [torch.from_numpy(layer.astype(np.int64)).to(dev)
               for layer in layers]
        f1, f2 = self.fanouts
        b = self.batch
        return {
            "x_self": self.feats[ids[0]],
            "x_nbr": self.feats[ids[1]].reshape(b, f1, -1),
            "x_nbr2": self.feats[ids[2]].reshape(b, f1, f2, -1),
            "labels": self.labels[ids[0]],
        }

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return self.gather(self.sample_ids(step))

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        return self.batch_at(step)


class PatternFilteredDataset:
    """Prune the background graph to the union of matches of a search
    template (the paper's engine, on `device`), then serve the pruned graph
    as GNN data, with the engine's per-vertex omega as extra features --
    'train on the subgraph where the pattern of interest occurs'."""

    def __init__(self, g: Graph, template: Template, d_feat: int, n_classes: int,
                 seed: int = 0, device=None):
        dev = resolve_device(device)
        res = prune(g, template, device=dev)
        self.prune_counts = res.counts()
        order = np.lexsort((g.src, g.dst))
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        emask = res.edge_mask[inv]  # back to g's arc order
        self.pruned = g.subgraph(res.vertex_mask, emask)
        self.omega = res.omega[res.vertex_mask]
        self._batch = full_graph_batch(self.pruned, d_feat, n_classes, seed, dev)
        self._batch["x"] = torch.cat(
            [self._batch["x"], torch.from_numpy(self.omega).float().to(dev)],
            dim=1)

    def batch_at(self, step: int) -> Dict:
        return self._batch

    def __call__(self, step: int) -> Dict:
        return self.batch_at(step)
