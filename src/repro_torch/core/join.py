"""Match-enumeration join over the pruned solution subgraph (§4).

`HostJoin` is the numpy row-table join over the compacted active subgraph:
expand the frontier column along active arcs; filter by omega-candidacy,
injectivity, revisit-edge existence and GraphPi-style symmetry restrictions
(the `core/tds.py` step primitives underneath). The device-resident join is
not ported yet.

`walk_steps` attaches each symmetry restriction phi(a) < phi(b) to the join
step that assigns the later of the two vertices, so restricted counting
needs no post-hoc dedup: restricted_count * |Aut| == the embedding count.

`stream_join` is the bounded-memory emitter: a depth-first walk over row
blocks, splitting each block before expansion so no step's output exceeds
the row budget; enumeration falls back to it when a single source overflows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.template import Template
from repro_torch.core import tds as tds_mod
from repro_torch.core.tds import ActiveSubgraph, TdsOverflow


@dataclasses.dataclass(frozen=True)
class JoinStep:
    kind: str  # "expand" | "revisit"
    c_prev: int  # row column holding the frontier vertex
    c_tgt: int  # expand: the new column's index; revisit: the target column
    q_next: int  # template vertex this step lands on
    n_cols: int  # columns assigned before this step (injectivity scope)
    restr: Tuple[Tuple[int, str], ...] = ()  # (col, "gt"/"lt") checks vs new vertex


def walk_steps(
    walk: Sequence[int],
    restrictions: Tuple[Tuple[int, int], ...] = (),
) -> Tuple[List[JoinStep], List[int]]:
    """Per-step join metadata for a walk. Each restriction pair (a, b) —
    phi(a) < phi(b) — is checked at the step that assigns the LATER of the
    two vertices. Returns (steps, seen_q = template vertices in first-visit
    order)."""
    seen: List[int] = [walk[0]]
    steps: List[JoinStep] = []
    for r in range(1, len(walk)):
        q_prev, q_next = walk[r - 1], walk[r]
        c_prev = seen.index(q_prev)
        if q_next in seen:
            steps.append(JoinStep("revisit", c_prev, seen.index(q_next),
                                  q_next, len(seen)))
        else:
            checks = []
            for a, b in restrictions:
                if q_next == b and a in seen:
                    checks.append((seen.index(a), "gt"))
                elif q_next == a and b in seen:
                    checks.append((seen.index(b), "lt"))
            steps.append(JoinStep("expand", c_prev, len(seen), q_next,
                                  len(seen), tuple(checks)))
            seen.append(q_next)
    return steps, seen


class HostJoin:
    """The numpy row-table join over the compacted active subgraph."""

    route = "host"

    def __init__(self, sub: ActiveSubgraph, template: Template,
                 walk: Sequence[int], max_rows: int,
                 symmetry_break: bool = False,
                 stats: Optional[Dict] = None):
        restr = template.symmetry_restrictions() if symmetry_break else ()
        self.steps, self.seen_q = walk_steps(walk, restr)
        self.sub = sub
        self.template = template
        self.max_rows = max_rows
        self.stats = stats
        self.walk0 = walk[0]

    def sources(self) -> np.ndarray:
        return np.flatnonzero(self.sub.omega[:, self.walk0])

    def seed(self, ids: np.ndarray) -> np.ndarray:
        return np.asarray(ids).astype(np.int32).reshape(-1, 1)

    def nrows(self, rows) -> int:
        return int(rows.shape[0])

    def step(self, rows, r: int, enforce: bool = True):
        s = self.steps[r - 1]
        if s.kind == "revisit":
            return tds_mod.revisit_rows(self.sub, rows, s.c_prev, s.c_tgt)
        rows = tds_mod.expand_rows(self.sub, rows, s.c_prev, s.q_next,
                                   s.n_cols, s.restr)
        if enforce and rows.shape[0] > self.max_rows:
            raise TdsOverflow(
                f"join rows {rows.shape[0]} > max_rows={self.max_rows} "
                f"at step {r}")
        if self.stats is not None:
            self.stats["join_rows_max"] = max(
                self.stats.get("join_rows_max", 0), int(rows.shape[0]))
        return rows

    def split(self, rows, r: int, budget: int) -> List:
        s = self.steps[r - 1]
        if s.kind == "revisit" or rows.shape[0] <= 1:
            return [rows]
        cap = tds_mod.expand_capacity(self.sub, rows, s.c_prev)
        return _split_by_capacity(rows, cap, budget)

    def emit(self, rows) -> np.ndarray:
        perm = [self.seen_q.index(q) for q in range(self.template.n0)]
        return np.asarray(rows)[:, perm].astype(np.int32)

    def count(self, rows) -> int:
        return int(rows.shape[0])


def _split_by_capacity(rows, cap: np.ndarray, budget: int) -> List:
    """Partition a row block so each piece's expansion capacity stays within
    `budget` (a lone row whose fan-out exceeds the budget stays whole)."""
    cum = np.cumsum(cap, dtype=np.int64)
    if cum.size == 0 or cum[-1] <= budget:
        return [rows]
    pieces = []
    start, base = 0, 0
    n = int(cum.shape[0])
    while start < n:
        end = int(np.searchsorted(cum, base + budget, side="right"))
        end = min(max(end, start + 1), n)
        pieces.append(rows[start:end])
        base = int(cum[end - 1])
        start = end
    return pieces


def stream_join(engine, sources: np.ndarray, chunk: int,
                budget: int) -> Iterator[np.ndarray]:
    """Bounded-memory streaming enumeration: source chunks walked
    depth-first, row blocks split before each expansion; completed blocks
    (template-vertex column order) are yielded as they finish."""

    def dfs(rows, r: int) -> Iterator[np.ndarray]:
        if engine.nrows(rows) == 0:
            return
        if r > len(engine.steps):
            yield engine.emit(rows)
            return
        for piece in engine.split(rows, r, budget):
            yield from dfs(engine.step(piece, r, enforce=False), r + 1)

    sources = np.asarray(sources)
    for off in range(0, sources.size, chunk):
        yield from dfs(engine.seed(sources[off: off + chunk]), 1)
