"""Template-Driven Search: constrained walks with history (paper §3 + Alg. 6).

TDS verifies walks whose tokens carry the ordered list of visited vertices,
so that revisits and bijectivity (distinct template vertices -> distinct
background vertices) are enforced -- the part of Def. 1 that bitset
frontiers cannot express.

By the time TDS runs, LCC/CC/PC have pruned the graph, so TDS compacts the
active subgraph onto the host and runs a vectorized multi-source numpy join:

  rows = partial assignments  int32[K, n_seen]
  step r: expand the frontier column along active CSR edges, filter by
          omega-candidacy + injectivity, or check the revisit edge when
          walk[r] was already assigned,
  then work-aggregate: np.unique(rows) (Alg. 6's tau(v) dedup set).

Sources are processed in chunks; a chunk aborts with `TdsOverflow` if rows
exceed `max_rows`, and the caller retries with a smaller chunk (the paper's
token-rate control). The same step primitives power match enumeration
(core/join.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.graph.structs import DeviceGraph
from repro_torch.core.state import PruneState
from repro_torch.core.template import NonLocalConstraint


class TdsOverflow(RuntimeError):
    pass


@dataclasses.dataclass
class ActiveSubgraph:
    """Host-side compacted view of the current solution subgraph G*."""

    n: int  # original vertex count (ids are NOT re-numbered; keeps omega alignment)
    offsets: np.ndarray  # int64[n+1] CSR over active arcs
    neighbors: np.ndarray  # int32[#active arcs]
    omega: np.ndarray  # bool[n, n0]
    edge_keys: np.ndarray  # sorted int64 keys src*n+dst of active arcs


def compact_active(dg: DeviceGraph, state: PruneState) -> ActiveSubgraph:
    with tracing.read("tds.compact_active"):
        omega = state.omega.cpu().numpy()
        vact = state.omega.any(dim=1)
        keep = state.edge_active & vact[dg.src.long()] & vact[dg.dst.long()]
        s = dg.src[keep].cpu().numpy()
        d = dg.dst[keep].cpu().numpy()
    order = np.lexsort((d, s))
    s, d = s[order], d[order]
    n = dg.n
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(s, minlength=n))
    keys = s.astype(np.int64) * n + d
    return ActiveSubgraph(n=n, offsets=offsets, neighbors=d, omega=omega,
                          edge_keys=np.sort(keys))


def _ragged_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], starts[i]+counts[i]) ranges — vectorized."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    reset = np.repeat(starts - np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    return np.arange(total, dtype=np.int64) + reset


def _has_edge(sub: ActiveSubgraph, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    keys = u.astype(np.int64) * sub.n + v
    pos = np.searchsorted(sub.edge_keys, keys)
    pos = np.minimum(pos, sub.edge_keys.shape[0] - 1)
    return (sub.edge_keys.shape[0] > 0) & (sub.edge_keys[pos] == keys)


# ------------------------------------------------------- join step primitives
# One constrained-walk step over a row table (partial assignments), shared by
# `tds_walk` and the enumeration join. `restr` holds GraphPi-style partial-
# order checks ((col, op) with op "gt"/"lt") on the newly assigned vertex.
def expand_rows(
    sub: ActiveSubgraph,
    rows: np.ndarray,
    c_prev: int,
    q_next: int,
    n_cols: int,
    restr: Tuple[Tuple[int, str], ...] = (),
) -> np.ndarray:
    """Expand the frontier column along active CSR arcs, filter by
    omega-candidacy + injectivity (+ optional symmetry restrictions), and
    append the new assignment column."""
    cur = rows[:, c_prev]
    starts = sub.offsets[cur]
    counts = (sub.offsets[cur + 1] - starts).astype(np.int64)
    flat = _ragged_ranges(starts, counts)
    rep = np.repeat(np.arange(rows.shape[0], dtype=np.int64), counts)
    nbr = sub.neighbors[flat]
    keep = sub.omega[nbr, q_next]
    # injectivity: new vertex differs from every assigned one
    for c in range(n_cols):
        keep &= nbr != rows[rep, c]
    for col, op in restr:
        ref = rows[rep, col]
        keep &= (nbr > ref) if op == "gt" else (nbr < ref)
    return np.concatenate(
        [rows[rep[keep]], nbr[keep, None].astype(np.int32)], axis=1
    )


def revisit_rows(sub: ActiveSubgraph, rows: np.ndarray, c_prev: int,
                 c_tgt: int) -> np.ndarray:
    """Keep rows whose revisit edge (frontier -> already-assigned target)
    exists in the active subgraph."""
    keep = _has_edge(sub, rows[:, c_prev], rows[:, c_tgt])
    return rows[keep]


def expand_capacity(sub: ActiveSubgraph, rows: np.ndarray,
                    c_prev: int) -> np.ndarray:
    """Per-row expansion fan-out (active CSR degree of the frontier vertex)."""
    cur = rows[:, c_prev]
    return (sub.offsets[cur + 1] - sub.offsets[cur]).astype(np.int64)


def expansion_slots(deg: np.ndarray) -> Tuple[np.ndarray, int]:
    """Slot layout of one expansion step from per-row degrees: the int64
    inclusive running capacity and the total slot count."""
    cum = np.cumsum(np.asarray(deg, np.int64))
    return cum, (int(cum[-1]) if cum.size else 0)


def tds_walk(
    sub: ActiveSubgraph,
    walk: Sequence[int],
    sources: np.ndarray,
    max_rows: int = 2_000_000,
    collect_rows: bool = False,
    stats: Optional[Dict] = None,
    dedup: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray], List[int]]:
    """Run one TDS walk from the given sources.

    Returns (survived mask over `sources`, completed rows or None, seen_q order).
    Rows columns follow `seen_q` = template vertices in order of first visit.
    """
    walk = list(walk)
    q0 = walk[0]
    seen_q: List[int] = [q0]
    src_ok = sub.omega[sources, q0]
    rows = sources[src_ok].astype(np.int32).reshape(-1, 1)

    for r in range(1, len(walk)):
        if rows.shape[0] == 0:
            break
        q_prev, q_next = walk[r - 1], walk[r]
        c_prev = seen_q.index(q_prev)
        if q_next in seen_q:
            rows = revisit_rows(sub, rows, c_prev, seen_q.index(q_next))
        else:
            rows = expand_rows(sub, rows, c_prev, q_next, len(seen_q))
            seen_q.append(q_next)
            if rows.shape[0] > max_rows:
                raise TdsOverflow(
                    f"TDS frontier {rows.shape[0]} > max_rows={max_rows} at step {r}"
                )
        # work aggregation: dedup identical partial assignments
        if dedup and rows.shape[0] > 1:
            before = rows.shape[0]
            rows = np.unique(rows, axis=0)
            if stats is not None:
                stats["tds_dedup_dropped"] = stats.get("tds_dedup_dropped", 0) + (
                    before - rows.shape[0]
                )
        if stats is not None:
            stats["tds_rows_max"] = max(stats.get("tds_rows_max", 0), int(rows.shape[0]))
            stats["tds_expansions"] = stats.get("tds_expansions", 0) + int(rows.shape[0])

    survived_src = np.unique(rows[:, 0]) if rows.shape[0] else np.zeros(0, np.int32)
    survived = np.isin(sources, survived_src)
    return survived, (rows if collect_rows else None), seen_q


@tracing.traced("tds.join")
def verify_tds_constraint(
    dg: DeviceGraph,
    state: PruneState,
    constraint: NonLocalConstraint,
    chunk: int = 4096,
    max_rows: int = 2_000_000,
    stats: Optional[Dict] = None,
    annotate: bool = False,
    dedup: bool = True,
) -> PruneState:
    """Alg. 5 with a TDS walk: prune head candidacy of failing sources.

    With annotate=True (complete walks only) omega is *replaced* by the exact
    set of (v, q) pairs participating in completed walks, and the arcs by
    the exact set of match edges -- the paper's zero-false-positive output.
    """
    if annotate and not constraint.complete:
        raise ValueError("annotate requires a complete walk")
    sub = compact_active(dg, state)
    q0 = constraint.walk[0]
    sources = np.flatnonzero(sub.omega[:, q0])
    survived_all = np.zeros(sub.n, dtype=bool)
    confirmed = np.zeros_like(sub.omega) if annotate else None
    confirmed_arc_keys: list = []

    walk_pairs = sorted({(min(a, b), max(a, b))
                         for a, b in zip(constraint.walk[:-1], constraint.walk[1:])})

    off = 0
    cur_chunk = chunk
    while off < sources.size:
        ids = sources[off: off + cur_chunk]
        try:
            surv, rows, seen_q = tds_walk(
                sub, constraint.walk, ids, max_rows=max_rows,
                collect_rows=annotate, stats=stats, dedup=dedup,
            )
        except TdsOverflow:
            if cur_chunk == 1:
                raise
            cur_chunk = max(1, cur_chunk // 4)  # paper's rate control
            continue
        survived_all[ids[surv]] = True
        if annotate and rows is not None and rows.shape[0]:
            col = {q: c for c, q in enumerate(seen_q)}
            for c, q in enumerate(seen_q):
                confirmed[rows[:, c], q] = True
            # confirmed edges: every template edge of every completed walk
            for a, b in walk_pairs:
                u, v = rows[:, col[a]].astype(np.int64), rows[:, col[b]].astype(np.int64)
                confirmed_arc_keys.append(np.unique(u * sub.n + v))
                confirmed_arc_keys.append(np.unique(v * sub.n + u))
        off += ids.size
    dev = state.omega.device
    if not annotate:
        omega = sub.omega.copy()
        omega[:, q0] &= survived_all
        return PruneState(omega=torch.from_numpy(omega).to(dev),
                          edge_active=state.edge_active)
    omega = confirmed & sub.omega
    # exact edge set (paper: the output G* contains only edges of matches),
    # matched against every arc on the device: the arc list stays there
    keys = (np.unique(np.concatenate(confirmed_arc_keys))
            if confirmed_arc_keys else np.zeros(0, np.int64))
    arc_keys = dg.src.long() * sub.n + dg.dst.long()
    exact = torch.isin(arc_keys, torch.from_numpy(keys).to(dev))
    return PruneState(omega=torch.from_numpy(omega).to(dev),
                      edge_active=state.edge_active & exact)
