"""Brute-force exact-matching oracle (tree-search in the Ullmann tradition).

The correctness oracle of the tests: the paper's central claim is 100%
precision AND 100% recall of the pruned solution subgraph, checked against
this enumerator's matches on small graphs. Host numpy only.
"""
from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

from repro_torch.graph.structs import Graph
from repro_torch.core.template import Template


def enumerate_matches_bruteforce(g: Graph, template: Template
                                 ) -> List[Tuple[int, ...]]:
    """All embeddings phi: V0 -> V (Def. 1 (i)+(ii)). Backtracking with
    label pruning and adjacency checks. Returns list of tuples (phi(q0..))."""
    offsets, neighbors = g.csr()
    nbr_sets = [set(neighbors[offsets[v]:offsets[v + 1]].tolist()) for v in range(g.n)]
    labels = g.labels
    t = template
    # order template vertices to keep partial assignments connected
    order = _connected_order(t)
    candidates = [np.flatnonzero(labels == t.labels[q]).tolist() for q in range(t.n0)]

    results: List[Tuple[int, ...]] = []
    assign = [-1] * t.n0
    used: Set[int] = set()

    def bt(i: int) -> None:
        if i == len(order):
            results.append(tuple(assign))
            return
        q = order[i]
        # anchored candidates: neighbors of an already-assigned template neighbor
        anchor = next((p for p in t.adj[q] if assign[p] >= 0), None)
        pool = candidates[q] if anchor is None else nbr_sets[assign[anchor]]
        for v in pool:
            if v in used or labels[v] != t.labels[q]:
                continue
            ok = True
            for p in t.adj[q]:
                if assign[p] >= 0 and assign[p] not in nbr_sets[v]:
                    ok = False
                    break
            if ok:
                assign[q] = v
                used.add(v)
                bt(i + 1)
                used.discard(v)
                assign[q] = -1

    bt(0)
    return results


def _connected_order(t: Template) -> List[int]:
    if t.n0 == 1:
        return [0]
    order, seen = [0], {0}
    frontier = list(t.adj[0])
    while len(order) < t.n0:
        nxt = next((q for q in frontier if q not in seen), None)
        if nxt is None:  # disconnected template would have raised earlier
            nxt = next(q for q in range(t.n0) if q not in seen)
        order.append(nxt)
        seen.add(nxt)
        frontier.extend(t.adj[nxt])
    return order


def solution_subgraph_oracle(g: Graph, template: Template):
    """(vertex mask, arc mask over g's arc list, omega bool[n, n0], the
    matches) of the union of all matches, from the brute-force
    enumeration."""
    matches = enumerate_matches_bruteforce(g, template)
    vmask = np.zeros(g.n, dtype=bool)
    ekeys: Set[int] = set()
    omega = np.zeros((g.n, template.n0), dtype=bool)
    for m in matches:
        for q, v in enumerate(m):
            vmask[v] = True
            omega[v, q] = True
        for a, b in template.edge_set:
            u, v = m[a], m[b]
            ekeys.add(u * g.n + v)
            ekeys.add(v * g.n + u)
    arc_keys = g.src.astype(np.int64) * g.n + g.dst
    emask = (np.isin(arc_keys, np.asarray(sorted(ekeys), dtype=np.int64)) if ekeys
             else np.zeros(g.m, bool))
    return vmask, emask, omega, matches
