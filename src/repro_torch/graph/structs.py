"""Graph data structures.

Host-side `Graph` is numpy (simple, undirected, vertex-labeled, stored as a
directed edge list with both (u,v) and (v,u) present, matching the paper's
"two directed edges represent each undirected edge" convention).

Device-side `DeviceGraph` holds torch tensors with arcs sorted by destination
(the same `np.lexsort((src, dst))` order as the JAX package), plus the
dst-CSR offsets `dst_ptr` that the bitset kernels walk: the in-arcs of vertex
v are the arcs `dst_ptr[v] .. dst_ptr[v+1]-1`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names one.
    Asking for CUDA where there is none raises -- nothing falls back to the
    CPU. `meta` builds shapes without data (the dry run's cells)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _pair_keys(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """int64 key a*n + b: sorting keys sorts (a, b) pairs lexicographically
    when 0 <= b < n, so a 1-D unique of keys equals a row-unique of pairs."""
    return a.astype(np.int64) * max(n, 1) + b.astype(np.int64)


def _sorted_unique(keys: np.ndarray) -> np.ndarray:
    """`np.unique(keys)` by a sort and a neighbour compare. NumPy 2.3's
    `np.unique` first builds a hash table of the values, which is slow for
    the tens of millions of distinct keys of an R-MAT scale-20 graph."""
    s = np.sort(keys, kind="stable")
    return s[np.concatenate(([True], s[1:] != s[:-1]))] if s.size else s


@dataclasses.dataclass
class Graph:
    """Host-side labeled graph. Directed edge list; undirected graphs store both arcs."""

    n: int
    src: np.ndarray  # int32[m]
    dst: np.ndarray  # int32[m]
    labels: np.ndarray  # int32[n]

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.labels = np.asarray(self.labels, dtype=np.int32)
        if self.labels.shape != (self.n,):
            raise ValueError(f"labels shape {self.labels.shape} != ({self.n},)")
        if self.src.shape != self.dst.shape:
            raise ValueError("src and dst differ in shape")

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_labels(self) -> int:
        return int(self.labels.max()) + 1 if self.n else 0

    @staticmethod
    def from_undirected_pairs(n: int, pairs, labels) -> "Graph":
        """Build from unique undirected pairs (u < v); adds both arcs, dedups, drops self-loops."""
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        both = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
        # 1-D unique of a*n+b: the same sorted pair set as a row-unique
        keys = _sorted_unique(_pair_keys(both[:, 0], both[:, 1], n))
        return Graph(n=n, src=keys // max(n, 1), dst=keys % max(n, 1),
                     labels=np.asarray(labels))

    def csr(self):
        """Return (offsets int64[n+1], neighbors int32[m]) sorted by (src, dst).

        A stable sort of the 1-D (src, dst) keys: the order of the
        reference's `np.lexsort((dst, src))`, and close to linear time on
        arcs already in that order, as `from_undirected_pairs` leaves them."""
        order = np.argsort(_pair_keys(self.src, self.dst, self.n), kind="stable")
        s, d = self.src[order], self.dst[order]
        offsets = np.zeros(self.n + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(np.bincount(s, minlength=self.n))
        return offsets, d

    def subgraph(self, vmask: np.ndarray, emask: Optional[np.ndarray] = None) -> "Graph":
        """Induced subgraph on active vertices (and optionally active edges), re-indexed."""
        vmask = np.asarray(vmask, dtype=bool)
        keep = vmask[self.src] & vmask[self.dst]
        if emask is not None:
            keep &= np.asarray(emask, dtype=bool)
        new_id = np.cumsum(vmask, dtype=np.int64) - 1
        return Graph(
            n=int(vmask.sum()),
            src=new_id[self.src[keep]],
            dst=new_id[self.dst[keep]],
            labels=self.labels[vmask],
        )

    def degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int64)

    def label_frequency(self) -> np.ndarray:
        """freq[l] = number of vertices with label l (paper's token-ordering heuristic input)."""
        return np.bincount(self.labels, minlength=self.n_labels)


@dataclasses.dataclass
class DeviceGraph:
    """Device-side graph in dst-sorted COO layout, its dst-CSR offsets, and
    labels, as torch tensors on one device."""

    n: int
    src: torch.Tensor      # int32[m] sorted by dst
    dst: torch.Tensor      # int32[m]
    dst_ptr: torch.Tensor  # int64[n+1] dst-CSR offsets into src/dst
    labels: torch.Tensor   # int32[n]
    # (reversed graph, perm), built by the first `reversed()` call and kept
    _rev: Optional[Tuple["DeviceGraph", torch.Tensor]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    @staticmethod
    def dst_sort_order(g: Graph) -> np.ndarray:
        """The arc permutation `from_host` applies: by (dst, src)."""
        return np.lexsort((g.src, g.dst))

    @staticmethod
    def from_host(g: Graph, device=None,
                  order: Optional[np.ndarray] = None) -> "DeviceGraph":
        """The graph on `device`, its arcs in `order` (`dst_sort_order(g)`
        unless the caller has it already: the sharded backends reuse one
        sort for the graph and their arc-slot map)."""
        dev = resolve_device(device)
        if order is None:
            order = DeviceGraph.dst_sort_order(g)
        src, dst = g.src[order], g.dst[order]
        dst_ptr = np.zeros(g.n + 1, dtype=np.int64)
        dst_ptr[1:] = np.cumsum(np.bincount(dst, minlength=g.n))
        return DeviceGraph(
            n=g.n,
            src=torch.from_numpy(np.ascontiguousarray(src)).to(dev),
            dst=torch.from_numpy(np.ascontiguousarray(dst)).to(dev),
            dst_ptr=torch.from_numpy(dst_ptr).to(dev),
            labels=torch.from_numpy(np.ascontiguousarray(g.labels)).to(dev),
        )

    def reversed(self) -> Tuple["DeviceGraph", torch.Tensor]:
        """The arcs reversed and sorted by their new destination (this
        graph's source), with its dst-CSR. Returns (the reversed graph,
        perm): its arc k is arc perm[k] here. Its in-arcs of u are the
        out-arcs of u here, with their heads in ascending order in `src`:
        OR-aggregating over it ORs along out-arcs. Built on the first call
        and kept: the edge-prune pass and every join context read this one
        copy (the arcs are never changed in place)."""
        if self._rev is None:
            perm = torch.sort(self.src, stable=True).indices
            dst_ptr = torch.zeros(self.n + 1, dtype=torch.int64,
                                  device=self.device)
            dst_ptr[1:] = torch.cumsum(
                torch.bincount(self.src.long(), minlength=self.n), 0)
            rev = DeviceGraph(n=self.n, src=self.dst[perm].contiguous(),
                              dst=self.src[perm].contiguous(), dst_ptr=dst_ptr,
                              labels=self.labels)
            self._rev = (rev, perm)
        return self._rev
