"""The benchmark's graphs, made on the device.

A copy of the program's R-MAT recipe (Graph500 Kronecker edges with the
per-level probability noise, an undirected simple graph, the paper's degree
labels l(v) = ceil(log2(deg(v) + 1))), rewritten in PyTorch so that a
scale-22 graph is made on the card in a few large calls instead of on the
host. It does not reproduce numpy's random stream: a seed gives the same
graph on every run here, not the same graph as the program's generator.

The edges come from the configuration's fixed `graph_seed`; the run's
`--seed` draws a random permutation of the vertex ids, as Graph500's
generator permutes its vertices. So every seed serves the same graph in
another vertex order: the same work (the same candidates, matches and
sizes) on other inputs, and runs of different seeds spread no more than
runs of one seed.

The result is what the program's `DeviceGraph` holds: arcs sorted by
(destination, source), both arcs of every undirected edge, the dst-CSR
offsets, and the labels. The graph is frozen with the benchmark, so a
change to the program's generator cannot move the inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import spec

PRESETS = {
    "graph500": (0.57, 0.19, 0.19, 0.05),
    "chakrabarti": (0.45, 0.15, 0.15, 0.25),
    "uniform": (0.25, 0.25, 0.25, 0.25),
}

# a large odd constant that separates the graph's random stream from the
# traffic's, which is drawn from the same --seed
_GRAPH_STREAM = 0x5DEECE66D


@dataclasses.dataclass
class Arcs:
    """A labeled undirected graph as dst-sorted arcs on one device."""

    n: int
    src: torch.Tensor      # int32[m], sorted by (dst, src)
    dst: torch.Tensor      # int32[m]
    dst_ptr: torch.Tensor  # int64[n + 1]
    labels: torch.Tensor   # int32[n]

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + 1) ^ _GRAPH_STREAM)
    return g


def rmat_pairs(scale: int, edge_factor: int, preset: str, noise: float,
               gen: torch.Generator, device) -> tuple:
    """(src, dst) int64[edge_factor << scale] of directed R-MAT edges, self
    loops and duplicates kept, as the program's `rmat_edges` draws them:
    per level one uniform draw per edge and four jitters of the quadrant
    probabilities by noise * (U - 0.5)."""
    a, b, c, d = PRESETS[preset]
    m = edge_factor << scale
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        jitter = (1.0 + noise * (torch.rand(4, generator=gen, device=device,
                                            dtype=torch.float64) - 0.5)
                  ).tolist()
        aa, bb, cc, dd = a * jitter[0], b * jitter[1], c * jitter[2], d * jitter[3]
        norm = aa + bb + cc + dd
        aa, bb, cc = aa / norm, bb / norm, cc / norm
        ab, abc = aa + bb, aa + bb + cc
        src |= (r >= ab).to(torch.int64) << bit
        dst |= (((r >= aa) & (r < ab)) | (r >= abc)).to(torch.int64) << bit
        del r
    return src, dst


def degree_labels(deg: torch.Tensor) -> torch.Tensor:
    """ceil(log2(deg + 1)) in integers: the bit length of deg."""
    lab = torch.zeros_like(deg, dtype=torch.int32)
    top = int(deg.max()) if deg.numel() else 0
    k = 0
    while (1 << k) <= top:
        lab += (deg >= (1 << k)).to(torch.int32)
        k += 1
    return lab


def rmat_graph(scale: int, edge_factor: int = 16, preset: str = "graph500",
               noise: float = 0.1, labeler: str = "degree", seed: int = 0,
               device="cuda", permute_seed=None) -> Arcs:
    """The undirected R-MAT graph of `seed` on `device`, dst-sorted; with
    `permute_seed`, its vertex ids permuted by a permutation drawn from
    that seed."""
    if labeler != "degree":
        raise ValueError(f"unknown labeler {labeler!r}")
    dev = torch.device(device)
    gen = generator(seed, dev)
    n = 1 << scale
    s, d = rmat_pairs(scale, edge_factor, preset, noise, gen, dev)
    if permute_seed is not None:
        perm = torch.randperm(n, generator=generator(permute_seed, dev),
                              device=dev)
        s, d = perm[s], perm[d]
        del perm
    lo, hi = torch.minimum(s, d), torch.maximum(s, d)
    del s, d
    keep = lo != hi
    keys = torch.unique(lo[keep] * n + hi[keep])      # sorted, distinct pairs
    del lo, hi, keep
    lo, hi = keys // n, keys % n
    del keys
    # both arcs of each edge, sorted by (dst, src)
    arc_keys = torch.sort(torch.cat([hi * n + lo, lo * n + hi])).values
    del lo, hi
    dst = (arc_keys // n).to(torch.int32)
    src = (arc_keys % n).to(torch.int32)
    del arc_keys
    deg = torch.bincount(dst.long(), minlength=n)
    dst_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    dst_ptr[1:] = torch.cumsum(deg, 0)
    return Arcs(n=n, src=src, dst=dst, dst_ptr=dst_ptr,
                labels=degree_labels(deg))


def from_config(cfg: dict, seed: int, device, root=spec.ROOT) -> Arcs:
    """The graph a configuration's recipe names, its vertices permuted by
    the run's seed. The generator `rmat` is the recipe above; any other
    brings its maker as a file, `portbench/graphs/<generator>.py`, whose
    `make(cfg, seed, device) -> Arcs` owns its labels and keeps the rule
    that the seed only permutes the vertex ids."""
    if cfg["generator"] != "rmat":
        return spec.graph_maker(cfg["generator"], root).make(cfg, seed, device)
    return rmat_graph(scale=int(cfg["scale"]),
                      edge_factor=int(cfg["edge_factor"]),
                      preset=cfg["preset"], noise=float(cfg["noise"]),
                      labeler=cfg["labeler"], seed=int(cfg["graph_seed"]),
                      device=device, permute_seed=seed)
