"""Search templates and non-local constraint generation (paper §3, Table 2).

A `Template` is a small connected labeled graph (n0 <= 64 so candidate sets fit
two packed words). `generate_constraints` implements the Table-2 heuristic:

  1. vertex classification  — unique-label leaves are excluded from NLCC,
  2. cycle constraints (CC) — one per cycle-basis cycle,
  3. path constraints (PC)  — shortest path per same-label pair >= 3 hops apart,
                              skipped when fully covered by a cycle constraint,
  4. TDS constraints        — union-of-cycles walk (non-edge-monocyclic),
                              union-of-paths walk (repeated labels),
                              union of both, and — when precision must be
                              guaranteed — a complete walk covering every
                              template edge.

Constraint *ordering* follows §3: CC/PC before TDS, then increasing walk
length. Walks visit rare-label vertices first (token-ordering optimization);
label frequencies of the background graph are passed in when available.

Host-side pure Python/numpy. The graph routines the constraint generator
needs (connectivity, biconnected components, a fundamental cycle basis and
BFS shortest paths) are small implementations in `_AdjGraph` below. The
generator depends on the ORDER in which the cycle basis and the shortest
paths come out, so those two reproduce networkx 3.x's algorithms step for
step over the same insertion-ordered adjacency.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAX_TEMPLATE_VERTICES = 64


class _AdjGraph:
    """Undirected simple graph with insertion-ordered adjacency: nodes in
    insertion order, each node's neighbours in the order its edges were added
    (the layout of `networkx.Graph._adj`)."""

    def __init__(self, n: int, edges: Iterable[Tuple[int, int]]):
        self.adj: Dict[int, Dict[int, bool]] = {v: {} for v in range(n)}
        for u, v in edges:
            self.adj.setdefault(u, {})
            self.adj.setdefault(v, {})
            self.adj[u][v] = True
            self.adj[v][u] = True

    def number_of_edges(self) -> int:
        return sum(len(nb) for nb in self.adj.values()) // 2

    def is_connected(self) -> bool:
        if not self.adj:
            raise ValueError("connectivity is undefined for the null graph")
        start = next(iter(self.adj))
        seen = {start}
        stack = [start]
        while stack:
            for w in self.adj[stack.pop()]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == len(self.adj)

    def biconnected_component_edges(self) -> List[List[Tuple[int, int]]]:
        """Edge lists of the biconnected components (Tarjan's edge stack)."""
        disc: Dict[int, int] = {}
        low: Dict[int, int] = {}
        stack: List[Tuple[int, int]] = []
        comps: List[List[Tuple[int, int]]] = []

        def dfs(u: int, parent: Optional[int]):
            disc[u] = low[u] = len(disc)
            for v in self.adj[u]:
                if v == parent:
                    continue
                if v not in disc:
                    stack.append((u, v))
                    dfs(v, u)
                    low[u] = min(low[u], low[v])
                    if low[v] >= disc[u]:
                        comp = []
                        while True:
                            e = stack.pop()
                            comp.append(e)
                            if e == (u, v):
                                break
                        comps.append(comp)
                elif disc[v] < disc[u]:
                    stack.append((u, v))
                    low[u] = min(low[u], disc[v])

        for s in self.adj:
            if s not in disc:
                dfs(s, None)
        return comps

    def cycle_basis(self) -> List[List[int]]:
        """Paton's fundamental cycle basis, in networkx's traversal order."""
        gnodes = dict.fromkeys(self.adj)
        cycles: List[List[int]] = []
        root = None
        while gnodes:
            if root is None:
                root = gnodes.popitem()[0]
            stack = [root]
            pred = {root: root}
            used = {root: set()}
            while stack:
                z = stack.pop()
                zused = used[z]
                for nbr in self.adj[z]:
                    if nbr not in used:
                        pred[nbr] = z
                        stack.append(nbr)
                        used[nbr] = {z}
                    elif nbr == z:
                        cycles.append([z])
                    elif nbr not in zused:
                        pn = used[nbr]
                        cycle = [nbr, z]
                        p = pred[z]
                        while p not in pn:
                            cycle.append(p)
                            p = pred[p]
                        cycle.append(p)
                        cycles.append(cycle)
                        used[nbr].add(z)
            for node in pred:
                gnodes.pop(node, None)
            root = None
        return cycles

    def shortest_paths_from(self, source: int) -> Dict[int, List[int]]:
        """BFS shortest path to every reachable vertex, first-found per level."""
        paths = {source: [source]}
        nextlevel = [source]
        while nextlevel:
            thislevel, nextlevel = nextlevel, []
            for v in thislevel:
                for w in self.adj[v]:
                    if w not in paths:
                        paths[w] = paths[v] + [w]
                        nextlevel.append(w)
        return paths

    def all_pairs_shortest_path(self) -> Dict[int, Dict[int, List[int]]]:
        return {v: self.shortest_paths_from(v) for v in self.adj}


@dataclasses.dataclass(frozen=True)
class NonLocalConstraint:
    """A walk on the template to be verified by token passing (paper Alg. 5/6)."""

    kind: str  # "cycle" | "path" | "tds"
    walk: Tuple[int, ...]  # template vertex ids, consecutive pairs are template edges
    complete: bool = False  # covers every template edge (precision-guaranteeing TDS)

    @property
    def is_cyclic(self) -> bool:
        return self.walk[0] == self.walk[-1]

    @property
    def length(self) -> int:
        return len(self.walk) - 1

    def key(self) -> tuple:
        """Stable identity for work-reuse caches."""
        return (self.kind, self.walk, self.complete)


class Template:
    def __init__(self, labels: Sequence[int], edges: Sequence[Tuple[int, int]]):
        self.labels = np.asarray(labels, dtype=np.int32)
        self.n0 = int(self.labels.shape[0])
        if self.n0 > MAX_TEMPLATE_VERTICES:
            raise ValueError(f"template has {self.n0} > {MAX_TEMPLATE_VERTICES} vertices")
        es = set()
        for a, b in edges:
            a, b = int(a), int(b)
            if a == b:
                raise ValueError("self edges not allowed")
            es.add((min(a, b), max(a, b)))
        self.edge_set = frozenset(es)
        self.adj: List[List[int]] = [[] for _ in range(self.n0)]
        for a, b in sorted(es):
            self.adj[a].append(b)
            self.adj[b].append(a)
        self._g = _AdjGraph(self.n0, es)
        if self.n0 > 1 and not self._g.is_connected():
            raise ValueError("template must be connected (paper §2)")
        # lazily computed + cached symmetry data (automorphism group, GraphPi
        # restrictions) — enumeration/counting hit these on every call
        self._automorphisms: Optional[Tuple[Tuple[int, ...], ...]] = None
        self._restrictions: Optional[Tuple[Tuple[int, int], ...]] = None

    # ---------------------------------------------------------------- basics
    @property
    def m0(self) -> int:
        return len(self.edge_set)

    def adjacency_matrix(self) -> np.ndarray:
        A = np.zeros((self.n0, self.n0), dtype=bool)
        for a, b in self.edge_set:
            A[a, b] = A[b, a] = True
        return A

    def label_matrix(self, n_labels: int) -> np.ndarray:
        """one_hot[q, l] — used to initialize omega from background labels."""
        M = np.zeros((self.n0, n_labels), dtype=bool)
        for q in range(self.n0):
            if self.labels[q] < n_labels:
                M[q, self.labels[q]] = True
        return M

    def repeated_labels(self) -> bool:
        return len(set(self.labels.tolist())) < self.n0

    def is_edge_monocyclic(self) -> bool:
        """Cactus test: every biconnected component is a single edge or single cycle."""
        for comp in self._g.biconnected_component_edges():
            verts = {v for e in comp for v in e}
            if len(comp) > 1 and len(comp) != len(verts):
                return False
        return True

    def is_acyclic(self) -> bool:
        return self.m0 == self.n0 - 1

    def multiplicity_requirements(self) -> Dict[int, Dict[int, int]]:
        """req[q][label] = number of neighbors of q with that label (paper LCC's
        'minimum number of distinct active neighbors with the same label')."""
        out: Dict[int, Dict[int, int]] = {}
        for q in range(self.n0):
            counts: Dict[int, int] = {}
            for nb in self.adj[q]:
                counts[int(self.labels[nb])] = counts.get(int(self.labels[nb]), 0) + 1
            out[q] = counts
        return out

    # ------------------------------------------------------------- symmetry
    def automorphisms(self) -> Tuple[Tuple[int, ...], ...]:
        """All label-preserving graph automorphisms of the template, as
        permutation tuples (g[q] = image of q), by a backtracking search over
        invariant-refined candidate sets; cached on the instance."""
        if self._automorphisms is None:
            self._automorphisms = tuple(_automorphism_search(self))
        return self._automorphisms

    def automorphism_count(self) -> int:
        return len(self.automorphisms())

    def symmetry_restrictions(self) -> Tuple[Tuple[int, int], ...]:
        """GraphPi-style partial-order restrictions from an orbit/stabilizer
        chain of the automorphism group: a pair (a, b) means phi(a) < phi(b).
        Every embedding class under Aut(T) has exactly one member satisfying
        all of them, so restricted_count * |Aut| is the embedding count."""
        if self._restrictions is None:
            group = list(self.automorphisms())
            restr = []
            for q in range(self.n0):
                if len(group) == 1:
                    break
                orbit = sorted({g[q] for g in group})
                restr.extend((q, q2) for q2 in orbit if q2 != q)
                group = [g for g in group if g[q] == q]  # stabilizer of q
            self._restrictions = tuple(restr)
        return self._restrictions

    def edge_deletion_variants(self, k: int = 1) -> List["Template"]:
        """All connected templates obtained by removing k edges (exploratory search)."""
        out, seen = [], set()
        for combo in itertools.combinations(sorted(self.edge_set), k):
            remaining = self.edge_set - set(combo)
            key = frozenset(remaining)
            if key in seen:
                continue
            seen.add(key)
            g = _AdjGraph(self.n0, remaining)
            if self.n0 > 1 and (not g.is_connected() or g.number_of_edges() == 0):
                continue
            out.append(Template(self.labels, sorted(remaining)))
        return out

    def __repr__(self):
        return f"Template(n0={self.n0}, m0={self.m0}, labels={self.labels.tolist()})"


def _automorphism_search(t: "Template") -> List[Tuple[int, ...]]:
    """Backtracking search for all label-preserving automorphisms: candidate
    images pre-refined by the (label, degree, sorted neighbor-label multiset)
    invariant, images assigned in vertex order, adjacency and non-adjacency
    checked against every already-assigned vertex."""
    n0 = t.n0
    inv = []
    for q in range(n0):
        nb_labels = tuple(sorted(int(t.labels[p]) for p in t.adj[q]))
        inv.append((int(t.labels[q]), len(t.adj[q]), nb_labels))
    cand = [[p for p in range(n0) if inv[p] == inv[q]] for q in range(n0)]
    adj = t.adjacency_matrix()

    out: List[Tuple[int, ...]] = []
    img = [-1] * n0
    used = [False] * n0

    def bt(q: int):
        if q == n0:
            out.append(tuple(img))
            return
        for p in cand[q]:
            if used[p]:
                continue
            ok = True
            for q2 in range(q):
                if adj[q, q2] != adj[p, img[q2]]:
                    ok = False
                    break
            if ok:
                img[q] = p
                used[p] = True
                bt(q + 1)
                used[p] = False
                img[q] = -1

    bt(0)
    return out


# ------------------------------------------------------------- walk building
def _edge_cover_walk(
    vertices: set,
    edges: set,
    start: int,
    adj: Dict[int, List[int]],
    rank: Dict[int, float],
) -> Tuple[int, ...]:
    """DFS walk covering every edge of a connected subgraph, visiting
    rare-label neighbors first (paper's walk-orchestration optimization).
    Each edge is traversed at most twice (down + back up)."""
    walk = [start]
    seen = set()

    def dfs(u: int):
        for v in sorted(adj[u], key=lambda x: (rank.get(x, 0.0), x)):
            e = (min(u, v), max(u, v))
            if e in edges and e not in seen:
                seen.add(e)
                walk.append(v)
                dfs(v)
                walk.append(u)

    dfs(start)
    return tuple(walk)


def _subgraph_adj(edges: set) -> Dict[int, List[int]]:
    adj: Dict[int, List[int]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    return adj


def generate_constraints(
    template: Template,
    label_freq: Optional[np.ndarray] = None,
    guarantee_precision: bool = True,
) -> List[NonLocalConstraint]:
    """Table-2 heuristic. Returns constraints in verification order (§3 ordering)."""
    t = template
    freq = label_freq if label_freq is not None else np.ones(int(t.labels.max()) + 1)
    if len(freq) <= int(t.labels.max()):
        # template labels absent from the background graph have frequency 0
        freq = np.concatenate([freq, np.zeros(int(t.labels.max()) + 1 - len(freq))])
    rank = {q: float(freq[t.labels[q]]) for q in range(t.n0)}

    constraints: List[NonLocalConstraint] = []

    # cycle constraints, one per basis cycle
    basis = t._g.cycle_basis()
    cycle_edge_sets: List[set] = []
    for cyc in basis:
        # rotate so the rarest-label vertex leads (token generation heuristic)
        i = min(range(len(cyc)), key=lambda k: (rank[cyc[k]], cyc[k]))
        cyc = cyc[i:] + cyc[:i]
        walk = tuple(cyc) + (cyc[0],)
        constraints.append(NonLocalConstraint("cycle", walk))
        cycle_edge_sets.append(
            {(min(a, b), max(a, b)) for a, b in zip(walk[:-1], walk[1:])}
        )
    all_cycle_edges = set().union(*cycle_edge_sets) if cycle_edge_sets else set()

    # path constraints for same-label pairs >= 3 hops apart
    sp = t._g.all_pairs_shortest_path()
    path_edge_sets: List[set] = []
    path_vertices: set = set()
    for a in range(t.n0):
        for b in range(a + 1, t.n0):
            if t.labels[a] != t.labels[b]:
                continue
            path = sp[a].get(b)
            if path is None or len(path) - 1 < 3:
                continue
            pedges = {(min(x, y), max(x, y)) for x, y in zip(path[:-1], path[1:])}
            if pedges <= all_cycle_edges:
                continue  # optimization (ii): covered by cycle constraints
            constraints.append(NonLocalConstraint("path", tuple(path)))
            path_edge_sets.append(pedges)
            path_vertices |= set(path)

    # TDS constraints
    tds: List[NonLocalConstraint] = []
    union_cyc: set = set()
    if not t.is_edge_monocyclic():
        # union of edge-sharing cycle groups
        groups: List[set] = []
        for ce in cycle_edge_sets:
            merged = False
            for grp in groups:
                if grp & ce:
                    grp |= ce
                    merged = True
                    break
            if not merged:
                groups.append(set(ce))
        # merge transitively
        changed = True
        while changed:
            changed = False
            for i in range(len(groups)):
                for j in range(i + 1, len(groups)):
                    if groups[i] & groups[j]:
                        groups[i] |= groups[j]
                        del groups[j]
                        changed = True
                        break
                if changed:
                    break
        for grp in groups:
            if len(grp) <= 3:
                continue
            verts = {v for e in grp for v in e}
            start = min(verts, key=lambda q: (rank[q], q))
            walk = _edge_cover_walk(verts, grp, start, _subgraph_adj(grp), rank)
            union_cyc |= grp
            tds.append(NonLocalConstraint("tds", walk))
    union_path: set = set()
    if t.repeated_labels() and path_edge_sets:
        union_path = set().union(*path_edge_sets)
        verts = {v for e in union_path for v in e}
        start = min(verts, key=lambda q: (rank[q], q))
        walk = _edge_cover_walk(verts, union_path, start, _subgraph_adj(union_path), rank)
        tds.append(NonLocalConstraint("tds", walk))
    if union_cyc and union_path:
        both = union_cyc | union_path
        verts = {v for e in both for v in e}
        start = min(verts, key=lambda q: (rank[q], q))
        walk = _edge_cover_walk(verts, both, start, _subgraph_adj(both), rank)
        tds.append(NonLocalConstraint("tds", walk))

    # Zero-false-positive guarantee: the complete walk for any cyclic or
    # repeated-label template (the output contract is the exact edge set too);
    # acyclic unique-label templates are exact after LCC alone.
    needs_complete = (not t.is_acyclic()) or t.repeated_labels()
    if guarantee_precision and needs_complete and t.m0 > 0:
        start = min(range(t.n0), key=lambda q: (rank[q], q))
        walk = _edge_cover_walk(
            set(range(t.n0)), set(t.edge_set), start,
            {q: list(t.adj[q]) for q in range(t.n0)}, rank,
        )
        tds.append(NonLocalConstraint("tds", walk, complete=True))

    # drop partial TDS walks identical to the complete one; dedup
    seen_keys = set()
    uniq: List[NonLocalConstraint] = []
    for c in constraints + tds:
        if c.key() in seen_keys:
            continue
        seen_keys.add(c.key())
        uniq.append(c)

    # §3 ordering: CC/PC first, then TDS; within class by increasing walk
    # length, tie-broken by the Tripoul et al. 2018 cost estimate
    kind_order = {"cycle": 0, "path": 0, "tds": 1}
    total = max(float(np.sum(freq)), 1.0)
    uniq.sort(key=lambda c: (
        kind_order[c.kind], c.complete, c.length,
        estimate_walk_cost(t, c, freq, total),
    ))
    return uniq


def estimate_walk_cost(
    template: Template,
    constraint: NonLocalConstraint,
    label_freq: np.ndarray,
    total_vertices: Optional[float] = None,
) -> float:
    """A-priori cost of verifying a walk constraint ([Tripoul et al. 2018]):
    the expected number of token-forwarding messages, with the frontier after
    hop r scaling as the product of the walk's normalized label frequencies."""
    total = total_vertices if total_vertices is not None else max(
        float(np.sum(label_freq)), 1.0)

    def f(q: int) -> float:
        l = int(template.labels[q])
        return float(label_freq[l]) / total if l < len(label_freq) else 0.0

    cost = 0.0
    level = f(constraint.walk[0]) * total  # tokens issued
    for q in constraint.walk[1:]:
        cost += level
        level = level * f(q)
    return cost


def estimate_constraint_selectivity(
    template: Template,
    constraint: NonLocalConstraint,
    label_freq: np.ndarray,
) -> float:
    """Expected fraction of token sources the constraint ELIMINATES
    ([Tripoul et al. 2018]'s selectivity primitive): the probability that a
    random walk of this label sequence fails to close, modelled as
    1 - prod(freq ratios) -- rarer interior labels eliminate more sources."""
    total = max(float(np.sum(label_freq)), 1.0)
    p = 1.0
    for q in constraint.walk[1:]:
        l = int(template.labels[q])
        p *= float(label_freq[l]) / total if l < len(label_freq) else 0.0
    return 1.0 - min(p, 1.0)
