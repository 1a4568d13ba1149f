"""Match-enumeration join over the pruned solution subgraph (§4).

Two engines run the same constrained-walk join: expand the frontier column
along active arcs; filter by omega-candidacy, injectivity, revisit-edge
existence and GraphPi-style symmetry restrictions.

  HostJoin    the numpy row-table join over the compacted active subgraph
              (the `core/tds.py` step primitives underneath).
  DeviceJoin  the device-resident join: the row table lives on the graph's
              device, and the host reads two scalars per step (the
              expansion capacity and the kept-row count). It is the JAX
              package's local device join, whose shard-exchange programs
              are the identity at one shard.

Both lay out expansion slots the same way -- per parent row, its frontier
vertex's out-arcs in ascending head order -- so their row tables agree row
for row.

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
import torch

from repro_torch.graph.structs import DeviceGraph
from repro_torch.core.state import PruneState
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


_INT32_MAX = 2**31 - 1


def _guard_int32(count: int, what: str) -> None:
    """Slot counts past int32 fail loudly, as in the JAX package, whose
    device-side slot indices are int32, instead of returning a table that
    the other route could not build."""
    if count > _INT32_MAX:
        raise NotImplementedError(
            f"{what} = {count} exceeds int32; lower max_rows or the "
            "streaming budget")


class LocalJoinContext:
    """The static layout of the device join on one device: the arcs sorted
    by (src, dst) with their CSR offsets, heads, (src, dst) keys and active
    flags, gathered on the device from the pruned state."""

    def __init__(self, dg: DeviceGraph, state: PruneState):
        rev, perm = dg.reversed()
        n = dg.n
        self.n = n
        self.csr_off = rev.dst_ptr                     # int64[n+1]
        self.deg = self.csr_off[1:] - self.csr_off[:-1]  # int64[n]
        self.arc_dst = rev.src.long()                  # int64[A], head per arc
        self.arc_key = rev.dst.long() * n + self.arc_dst  # ascending
        self.arc_active = state.edge_active[perm]
        self._omega = state.omega

    def cols(self, qs: Tuple[int, ...]) -> torch.Tensor:
        """bool[len(qs), n]: the omega candidacy columns of `qs`."""
        return torch.stack([self._omega[:, q] for q in qs], dim=0)


class DeviceJoin:
    """The device-resident join over a LocalJoinContext. Rows are int64
    [k, columns] tensors on the graph's device, in first-visit column
    order; in count mode they never leave it."""

    route = "device"

    def __init__(self, ctx: LocalJoinContext, template: Template,
                 walk: Sequence[int], max_rows: int,
                 symmetry_break: bool = False,
                 stats: Optional[Dict] = None):
        restr = template.symmetry_restrictions() if symmetry_break else ()
        self.steps, self.seen_q = walk_steps(walk, restr)
        self.ctx = ctx
        self.template = template
        self.max_rows = max_rows
        self.stats = stats
        self.cand = ctx.cols(tuple(self.seen_q))  # bool[n_seen, n]

    def sources(self) -> np.ndarray:
        return np.flatnonzero(self.cand[0].cpu().numpy())

    def seed(self, ids: np.ndarray) -> torch.Tensor:
        ids = np.asarray(ids).astype(np.int64).reshape(-1, 1)
        return torch.from_numpy(ids).to(self.cand.device)

    def nrows(self, rows: torch.Tensor) -> int:
        return int(rows.shape[0])

    def step(self, rows: torch.Tensor, r: int, enforce: bool = True
             ) -> torch.Tensor:
        s = self.steps[r - 1]
        ctx = self.ctx
        if s.kind == "revisit":
            # the revisit arc (frontier -> target) exists and is active
            if ctx.arc_key.numel() == 0:
                return rows[:0]
            key = rows[:, s.c_prev] * ctx.n + rows[:, s.c_tgt]
            pos = torch.searchsorted(ctx.arc_key, key).clamp(
                max=ctx.arc_key.numel() - 1)
            keep = (ctx.arc_key[pos] == key) & ctx.arc_active[pos]
            return self._kept(rows[keep], enforce)
        # expansion slots: per parent row, one slot per out-arc of its
        # frontier vertex; the capacity is the one scalar read here
        up = rows[:, s.c_prev]
        deg = ctx.deg[up]
        cum = torch.cumsum(deg, 0)
        T = int(cum[-1]) if cum.numel() else 0
        if enforce and T > self.max_rows:
            raise TdsOverflow(
                f"join capacity {T} > max_rows={self.max_rows} at step {r}")
        _guard_int32(T, f"join expansion capacity at step {r}")
        if self.stats is not None:
            self.stats["join_expansions"] = (
                self.stats.get("join_expansions", 0) + T)
        t = torch.arange(T, device=rows.device)
        parent = torch.searchsorted(cum, t, right=True)
        j = t - (cum - deg)[parent]
        prow = rows[parent]
        idx = ctx.csr_off[prow[:, s.c_prev]] + j
        v = ctx.arc_dst[idx]
        ok = ctx.arc_active[idx] & self.cand[s.c_tgt][v]
        for c in range(s.n_cols):  # injectivity against every assigned column
            ok &= v != prow[:, c]
        for col, op in s.restr:  # symmetry restrictions, in flight
            ok &= (v > prow[:, col]) if op == "gt" else (v < prow[:, col])
        return self._kept(torch.cat([prow[ok], v[ok, None]], dim=1), enforce)

    def _kept(self, rows: torch.Tensor, enforce: bool) -> torch.Tensor:
        k = int(rows.shape[0])
        if enforce and k > self.max_rows:
            raise TdsOverflow(f"join rows {k} > max_rows={self.max_rows}")
        if self.stats is not None:
            self.stats["join_rows_max"] = max(
                self.stats.get("join_rows_max", 0), k)
        return rows

    def split(self, rows: torch.Tensor, r: int, budget: int) -> List:
        s = self.steps[r - 1]
        if s.kind == "revisit" or rows.shape[0] <= 1:
            return [rows]
        cap = self.ctx.deg[rows[:, s.c_prev]].cpu().numpy()
        return _split_by_capacity(rows, cap, budget)

    def emit(self, rows: torch.Tensor) -> np.ndarray:
        perm = [self.seen_q.index(q) for q in range(self.template.n0)]
        return rows[:, perm].cpu().numpy().astype(np.int32)

    def count(self, rows: torch.Tensor) -> int:
        return int(rows.shape[0])


def _split_by_capacity(rows, cap: np.ndarray, budget: int) -> List:
    """Partition a row block so each piece's expansion capacity stays within
    `budget` (a lone row whose fan-out exceeds the budget stays whole)."""
    cum, total = tds_mod.expansion_slots(cap)
    if total <= budget:
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
