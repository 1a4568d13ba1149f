"""The plain reference: the exact solution subgraph of a template.

For a labeled template and a labeled graph, the solution subgraph is the
union of all matches (injective, label-preserving maps of the template's
vertices whose template edges all land on graph edges): the (vertex,
template vertex) pairs some match uses, the arcs some match uses in either
direction, and the number of matches. It is written from that definition
in plain PyTorch, imports nothing of the program, and runs on any device:

1. Candidates: vertex v may stand for template vertex q if their labels
   agree. The candidates are narrowed to arc consistency: v keeps q only if
   it has, for every template neighbour q' of q, a neighbour that is still a
   candidate for q'. Every match passes this test, so nothing a match uses
   is lost.
2. For an acyclic template whose labels are distinct, arc consistency is
   already the exact answer: on a tree every candidate left extends to a
   match through each of its template edges, and distinct labels make every
   such map injective. Every candidate and every arc between candidates of
   two adjacent template vertices is in the solution.
3. Otherwise every match is enumerated by a join over the narrowed graph,
   one template vertex at a time, in blocks of at most `block_rows` rows;
   each new vertex is checked against every template edge that closes on
   it and against the vertices already placed.

The returned keys are sorted int64 numpy arrays: omega pairs as
v * n0 + q, arcs as u * n + v.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Edges = Sequence[Tuple[int, int]]


@dataclasses.dataclass
class Solution:
    omega_keys: np.ndarray        # sorted int64: v * n0 + q
    arc_keys: np.ndarray          # sorted int64: u * n + v
    count: Optional[int]          # matches; None where step 2 gives the answer


class _Narrowed:
    """Candidates per template vertex and the arcs between candidates of
    adjacent template vertices, narrowed to arc consistency."""

    def __init__(self, n, src, dst, labels, t_labels, t_edges):
        self.n = n
        self.src, self.dst = src.long(), dst.long()
        self.n0 = len(t_labels)
        self.adj: Dict[int, List[int]] = {q: [] for q in range(self.n0)}
        for a, b in t_edges:
            self.adj[a].append(b)
            self.adj[b].append(a)
        self.cand = torch.stack([labels == int(l) for l in t_labels])
        # candidate arcs u -> v for each directed template edge (a, b)
        self.arcs: Dict[Tuple[int, int], torch.Tensor] = {}
        for a, b in t_edges:
            for x, y in ((a, b), (b, a)):
                self.arcs[(x, y)] = torch.nonzero(
                    self.cand[x][self.src] & self.cand[y][self.dst]).flatten()
        self._fixpoint()

    def _fixpoint(self):
        while True:
            before = int(self.cand.sum())
            for (a, b), idx in self.arcs.items():
                s, d = self.src[idx], self.dst[idx]
                idx = idx[self.cand[a][s] & self.cand[b][d]]
                self.arcs[(a, b)] = idx
                support = torch.zeros(self.n, dtype=torch.bool,
                                      device=self.cand.device)
                support[self.src[idx]] = True
                self.cand[a] &= support
            if int(self.cand.sum()) == before:
                break
        for key, idx in self.arcs.items():
            a, b = key
            self.arcs[key] = idx[self.cand[a][self.src[idx]]
                                 & self.cand[b][self.dst[idx]]]

    def arc_mask(self) -> torch.Tensor:
        """bool[m]: the arcs between candidates of adjacent template
        vertices."""
        mask = torch.zeros(self.src.shape[0], dtype=torch.bool,
                           device=self.src.device)
        for idx in self.arcs.values():
            mask[idx] = True
        return mask


def _keys_np(t: torch.Tensor) -> np.ndarray:
    return torch.unique(t).cpu().numpy().astype(np.int64)


def _is_acyclic(n0: int, edges: Edges) -> bool:
    parent = list(range(n0))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra == rb:
            return False
        parent[ra] = rb
    return True


def _order(nar: _Narrowed) -> List[Tuple[int, Optional[int]]]:
    """(template vertex, parent already placed) in join order: start at
    the fewest candidates, then always the placed-to-unplaced template edge
    with the fewest arcs per placed candidate."""
    sizes = nar.cand.sum(dim=1).tolist()
    start = min(range(nar.n0), key=lambda q: (sizes[q], q))
    order, placed = [(start, None)], {start}
    while len(placed) < nar.n0:
        best = None
        for p in placed:
            for q in nar.adj[p]:
                if q in placed:
                    continue
                fan = nar.arcs[(p, q)].numel() / max(sizes[p], 1)
                if best is None or (fan, q) < best[0]:
                    best = ((fan, q), q, p)
        if best is None:
            raise ValueError("the template is not connected")
        order.append((best[1], best[2]))
        placed.add(best[1])
    return order


def _enumerate(nar: _Narrowed, order, block_rows: int):
    """Yield blocks of matches, int64[R, n0] in template-vertex columns."""
    n, dev = nar.n, nar.cand.device
    # per join step: the arcs p -> q sorted by source, and the sorted keys
    # u * n + v of the arcs x -> q that close on q from placed x != p
    steps = []
    placed: List[int] = []
    for q, p in order:
        closing = []
        for x in placed:
            if x != p and x in nar.adj[q]:
                idx = nar.arcs[(x, q)]
                closing.append((x, torch.sort(nar.src[idx] * n
                                              + nar.dst[idx]).values))
        if p is None:
            steps.append((q, None, None, None, closing))
        else:
            idx = nar.arcs[(p, q)]
            s = nar.src[idx]
            srt = torch.sort(s)
            steps.append((q, p, srt.values, nar.dst[idx][srt.indices],
                          closing))
        placed.append(q)

    def place(rows, k):
        """Rows hold the vertices of order[:k] in columns 0..k-1."""
        if rows.shape[0] == 0:
            return
        if k == len(steps):
            yield rows
            return
        q, p, s_sorted, d_sorted, closing = steps[k]
        col = {o[0]: i for i, o in enumerate(order[:k])}
        if p is None:  # the first template vertex: its candidates
            yield from place(torch.nonzero(nar.cand[q]), 1)
            return
        u = rows[:, col[p]].contiguous()
        lo = torch.searchsorted(s_sorted, u)
        hi = torch.searchsorted(s_sorted, u, right=True)
        fan = hi - lo
        total = int(fan.sum())
        if total > block_rows and rows.shape[0] > 1:
            half = rows.shape[0] // 2  # expand each half on its own
            yield from place(rows[:half], k)
            yield from place(rows[half:], k)
            return
        rep = torch.repeat_interleave(torch.arange(rows.shape[0], device=dev),
                                      fan)
        first = torch.cumsum(fan, 0) - fan
        off = torch.arange(total, device=dev) - first[rep]
        v = d_sorted[lo[rep] + off]
        rows = torch.cat([rows[rep], v[:, None]], dim=1)
        rows = _filter(rows, k, closing, col, n)
        yield from place(rows, k + 1)

    start = torch.zeros((1, 0), dtype=torch.int64, device=dev)
    inv = [0] * nar.n0
    for i, (q, _) in enumerate(order):
        inv[q] = i
    for block in place(start, 0):
        yield block[:, inv]


def _filter(rows, k, closing, col, n):
    """Keep the rows whose new column k is a vertex not placed yet and is
    joined to every placed template neighbour through its closing arcs."""
    v = rows[:, k]
    keep = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    for j in range(k):
        keep &= rows[:, j] != v
    for x, keys in closing:
        key = rows[:, col[x]] * n + v
        pos = torch.searchsorted(keys, key).clamp(max=max(keys.numel() - 1, 0))
        keep &= (keys[pos] == key) if keys.numel() else torch.zeros_like(keep)
    return rows[keep]


def solution(n: int, src: torch.Tensor, dst: torch.Tensor,
             labels: torch.Tensor, t_labels: Sequence[int], t_edges: Edges,
             block_rows: int = 1 << 24) -> Solution:
    """The exact solution subgraph of the template (t_labels, t_edges) in
    the graph of arcs src -> dst (both arcs of every edge) and labels."""
    n0 = len(t_labels)
    t_edges = [tuple(int(x) for x in e) for e in t_edges]
    nar = _Narrowed(n, src, dst, labels, t_labels, t_edges)
    if _is_acyclic(n0, t_edges) and len(set(t_labels)) == n0:
        vq = torch.nonzero(nar.cand.T)                 # [(v, q)]
        arcs = torch.nonzero(nar.arc_mask()).flatten()
        return Solution(
            omega_keys=_keys_np(vq[:, 0] * n0 + vq[:, 1]),
            arc_keys=_keys_np(nar.src[arcs] * n + nar.dst[arcs]),
            count=None)
    omega = torch.zeros((n, n0), dtype=torch.bool, device=src.device)
    arcs, count = [], 0
    for rows in _enumerate(nar, _order(nar), block_rows):
        count += rows.shape[0]
        for q in range(n0):
            omega[rows[:, q], q] = True
        for a, b in t_edges:
            arcs.append(torch.unique(rows[:, a] * n + rows[:, b]))
            arcs.append(torch.unique(rows[:, b] * n + rows[:, a]))
        if sum(x.numel() for x in arcs) > block_rows:
            arcs = [torch.unique(torch.cat(arcs))]
    vq = torch.nonzero(omega)
    empty = torch.zeros(0, dtype=torch.int64, device=src.device)
    return Solution(
        omega_keys=_keys_np(vq[:, 0] * n0 + vq[:, 1]),
        arc_keys=_keys_np(torch.cat(arcs) if arcs else empty),
        count=count)


def narrowed(n: int, src: torch.Tensor, dst: torch.Tensor,
             labels: torch.Tensor, t_labels: Sequence[int], t_edges: Edges):
    """(candidates bool[n0, n], arcs bool[m]) after arc consistency: the
    candidacy and the arcs a local check leaves."""
    nar = _Narrowed(n, src, dst, labels, list(t_labels),
                    [tuple(int(x) for x in e) for e in t_edges])
    return nar.cand, nar.arc_mask()


def local_answer(n: int, src: torch.Tensor, dst: torch.Tensor,
                 labels: torch.Tensor, t_labels: Sequence[int],
                 t_edges: Edges, count: Optional[int] = None) -> Solution:
    """The control: arc consistency alone, with every arc between two of
    its vertices, put where the program's answer goes. It keeps the
    candidates a local check keeps and gives up the guarantee of the exact
    edge set (and, for a cyclic template, of the exact vertex set); its
    match count, where one is asked, is the exact one passed in."""
    n0 = len(t_labels)
    nar = _Narrowed(n, src, dst, labels, list(t_labels),
                    [tuple(int(x) for x in e) for e in t_edges])
    vq = torch.nonzero(nar.cand.T)
    live = nar.cand.any(dim=0)
    arcs = torch.nonzero(live[nar.src] & live[nar.dst]).flatten()
    return Solution(omega_keys=_keys_np(vq[:, 0] * n0 + vq[:, 1]),
                    arc_keys=_keys_np(nar.src[arcs] * n + nar.dst[arcs]),
                    count=count)
