"""Synthetic graph generators used throughout the paper's evaluation.

- R-MAT (Graph500 / Chakrabarti / Uniform probability presets, §5.7 + Appendix A)
- Erdos-Renyi (the R-MAT uniform limit)
- pathological structures from Fig. 2 (unrolled cycles, tori) used to prove that
  local constraint checking alone is insufficient
- the paper's degree-based labeling  l(v) = ceil(log2(deg(v) + 1))  (§5 Datasets)

Numpy only. The same seeds give the same graphs as the JAX package's
generators; pair deduplication is a 1-D unique of `lo * n + hi` keys, which
yields the identical sorted pair set as a row-wise unique and is far faster
at R-MAT scale 20.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structs import Graph, _pair_keys, _sorted_unique

# R-MAT presets from Appendix A, Fig. 13.
RMAT_PRESETS = {
    "graph500": (0.57, 0.19, 0.19, 0.05),
    "chakrabarti": (0.45, 0.15, 0.15, 0.25),
    "uniform": (0.25, 0.25, 0.25, 0.25),
}


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    preset: str = "graph500",
    seed: int = 0,
    noise: float = 0.1,
) -> np.ndarray:
    """Generate directed R-MAT edge endpoints, Graph500-style, vectorized.

    Returns int64[(edge_factor << scale), 2]. Self-loops/duplicates retained here;
    `rmat_graph` dedups when building the undirected Graph.
    """
    rng = np.random.default_rng(seed)
    a, b, c, d = RMAT_PRESETS[preset]
    m = edge_factor << scale
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        # Per-level probability noise keeps the degree distribution from being
        # perfectly self-similar (standard Graph500 tweak).
        r = rng.random(m)
        jitter = 1.0 + noise * (rng.random(4) - 0.5) if noise else np.ones(4)
        aa, bb, cc, dd = a * jitter[0], b * jitter[1], c * jitter[2], d * jitter[3]
        norm = aa + bb + cc + dd
        aa, bb, cc = aa / norm, bb / norm, cc / norm
        ab, abc = aa + bb, aa + bb + cc
        right = r >= ab  # in quadrant c or d -> src high bit set? (row = src)
        low = (r >= aa) & (r < ab) | (r >= abc)  # quadrant b or d -> dst high bit
        src |= right.astype(np.int64) << bit
        dst |= low.astype(np.int64) << bit
    return np.stack([src, dst], axis=1)


def _unique_pairs(lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """Row-unique (lo, hi) pairs in lexicographic order, via 1-D keys."""
    keys = _sorted_unique(_pair_keys(lo, hi, n))
    return np.stack([keys // max(n, 1), keys % max(n, 1)], axis=1)


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    preset: str = "graph500",
    seed: int = 0,
    labeler: str = "degree",
    n_labels: int = 0,
) -> Graph:
    """Undirected R-MAT graph with paper-style labels."""
    pairs = rmat_edges(scale, edge_factor, preset, seed)
    n = 1 << scale
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    keep = lo != hi
    und = _unique_pairs(lo[keep], hi[keep], n)
    g = Graph.from_undirected_pairs(n, und, np.zeros(n, dtype=np.int32))
    if labeler == "degree":
        g.labels = degree_labels(g)
    elif labeler == "random":
        if n_labels <= 0:
            raise ValueError("random labels need n_labels > 0")
        g.labels = random_labels(n, n_labels, seed=seed + 1)
    return g


def erdos_renyi_graph(n: int, avg_degree: float, seed: int = 0, n_labels: int = 8) -> Graph:
    rng = np.random.default_rng(seed)
    m_target = int(n * avg_degree / 2)
    pairs = rng.integers(0, n, size=(int(m_target * 1.1), 2), dtype=np.int64)
    lo, hi = np.minimum(pairs[:, 0], pairs[:, 1]), np.maximum(pairs[:, 0], pairs[:, 1])
    keep = lo != hi
    und = _unique_pairs(lo[keep], hi[keep], n)[:m_target]
    return Graph.from_undirected_pairs(n, und, random_labels(n, n_labels, seed + 1))


def degree_labels(g: Graph) -> np.ndarray:
    """Paper's weak-scaling labeler: l(v) = ceil(log2(d(v)+1))."""
    deg = g.degrees()
    return np.ceil(np.log2(deg + 1)).astype(np.int32)


def random_labels(n: int, n_labels: int, seed: int = 0) -> np.ndarray:
    """Uniform random labels (paper's Twitter / UK Web labeling, §5.7)."""
    return np.random.default_rng(seed).integers(0, n_labels, size=n, dtype=np.int32)


def cycle_graph(length: int, labels) -> Graph:
    """A single cycle (e.g. the unrolled 3k-cycle of Fig. 2(a))."""
    labels = np.asarray(labels, dtype=np.int32)
    if labels.shape[0] != length:
        raise ValueError("one label per cycle vertex")
    idx = np.arange(length, dtype=np.int64)
    pairs = np.stack([idx, (idx + 1) % length], axis=1)
    return Graph.from_undirected_pairs(length, pairs, labels)


def path_graph(length: int, labels) -> Graph:
    """A simple path of `length` vertices."""
    labels = np.asarray(labels, dtype=np.int32)
    idx = np.arange(length - 1, dtype=np.int64)
    pairs = np.stack([idx, idx + 1], axis=1)
    return Graph.from_undirected_pairs(length, pairs, labels)


def torus_graph(rows: int, cols: int, labels) -> Graph:
    """Doubly-periodic grid (Fig. 2(c)'s 4x3 torus that defeats cycle checking)."""
    labels = np.asarray(labels, dtype=np.int32).reshape(rows * cols)
    vid = np.arange(rows * cols).reshape(rows, cols)
    pairs = []
    for r in range(rows):
        for c in range(cols):
            pairs.append((vid[r, c], vid[r, (c + 1) % cols]))
            pairs.append((vid[r, c], vid[(r + 1) % rows, c]))
    return Graph.from_undirected_pairs(rows * cols, np.asarray(pairs), labels)


def clique_graph(k: int, labels) -> Graph:
    """The complete graph on k vertices."""
    labels = np.asarray(labels, dtype=np.int32)
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    return Graph.from_undirected_pairs(k, np.asarray(pairs), labels)


def star_graph(n_leaves: int, center_label: int, leaf_label: int) -> Graph:
    labels = np.full(n_leaves + 1, leaf_label, dtype=np.int32)
    labels[0] = center_label
    pairs = np.stack(
        [np.zeros(n_leaves, dtype=np.int64), np.arange(1, n_leaves + 1, dtype=np.int64)],
        axis=1,
    )
    return Graph.from_undirected_pairs(n_leaves + 1, pairs, labels)


def planted_pattern_graph(
    background: Graph, pattern: Graph, n_copies: int, seed: int = 0
) -> Graph:
    """Plant `n_copies` disjoint copies of `pattern` into `background` (needle-in-haystack
    scenarios, §1(iii)). Pattern copies attach to random background vertices by one edge."""
    rng = np.random.default_rng(seed)
    n0 = background.n
    labels = [background.labels]
    extra = []
    for c in range(n_copies):
        base = n0 + c * pattern.n
        extra.extend(
            (base + int(s), base + int(d)) for s, d in zip(pattern.src, pattern.dst)
        )
        anchor = int(rng.integers(0, n0))
        extra.append((anchor, base))
        extra.append((base, anchor))
        labels.append(pattern.labels)
    src = np.concatenate([background.src, np.asarray([p[0] for p in extra], np.int32)])
    dst = np.concatenate([background.dst, np.asarray([p[1] for p in extra], np.int32)])
    return Graph(
        n=n0 + n_copies * pattern.n,
        src=src,
        dst=dst,
        labels=np.concatenate(labels),
    )
