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
  ReplicatedJoin, RowShardedJoin
              the two flavors of the device join on a sharded prune's
              shard arrays (see "sharded joins" below).

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


# ---------------------------------------------------------- sharded joins
# The JAX package's two sharded flavors of the device join (core/join.py
# there), over a sharded backend's `Prims`. Every program runs over a
# leading axis of the Pl shards this process holds (all P under `sim`, one
# under `spmd`):
#
#   replicated  the row table is on every shard; each expansion slot is
#               produced by the owner of its frontier vertex, which reads the
#               arc from its shard-local CSR, and the per-slot results are
#               psum-combined (`ReplicatedJoin`).
#   rowsharded  a row lives on the shard that owns its next frontier vertex,
#               so expansion is shard-local; one `exchange_rows` per step
#               routes the survivors to their next owners in buckets sized
#               from one host read of a [P, 2, P] count matrix
#               (`RowShardedJoin`).
#
# Both lay out slots from the static degrees, per parent row its frontier
# vertex's arcs in (src, dst) order, as the local joins do: the counts and
# the row sets equal theirs on every shard count (only placement, hence
# emission order, differs). The candidacy columns of the walk are the only
# replicated state (`ShardedJoinContext.cols`, one all-gather).


def _pow2(x: int) -> int:
    b = 1
    while b < x:
        b <<= 1
    return b


class ShardedJoinContext:
    """The partition's join plan (`EdgePartition.join_plan`) on the device,
    for the shards this process holds, with the arcs' active bits read from
    the backend's shard arrays in place: the reduced subgraph is never
    gathered."""

    def __init__(self, backend):
        part = backend.part
        plan = part.join_plan()
        dev = part.join_plan_dev(backend.dg.device)
        sh = backend.sa.shards
        self.prims = backend.prims
        self.P, self.n_local, self.n_pad, self.A = (
            part.P, part.n_local, plan.n_pad, plan.A)
        self.Pl = int(sh.shape[0])
        self.p = sh                                            # int64[Pl]
        self.csr_off = dev["csr_off"].index_select(0, sh)      # [Pl, nl+1]
        self.arc_dst = dev["arc_dst"].index_select(0, sh)      # [Pl, A]
        self.deg = dev["deg"]                                  # [n_pad+1]
        self.arc_active = torch.gather(
            backend.ea_all.reshape(self.Pl, self.A), 1,
            dev["perm"].index_select(0, sh))
        # (src_local, dst) keys of the sorted arcs, ascending per shard
        # (pads last): a revisit probe is one searchsorted
        src_lo = torch.searchsorted(
            self.csr_off, torch.arange(self.A, device=sh.device).expand(
                self.Pl, self.A).contiguous(), right=True) - 1
        self.arc_key = src_lo * (self.n_pad + 1) + self.arc_dst
        self.row_plan = part.row_plan()
        self._omega = backend.omega_all

    def cols(self, qs: Tuple[int, ...]) -> torch.Tensor:
        """bool[len(qs), n_pad + 1]: the omega candidacy columns of `qs` in
        the padded global id space (last entry the sink), on every shard."""
        nl = self.n_local
        loc = torch.stack([((self._omega[:, :nl, q // 32] >> (q % 32)) & 1)
                           for q in qs], dim=1).to(torch.bool)  # [Pl, Q, nl]
        full = self.prims.gather(loc).permute(1, 0, 2).reshape(len(qs), -1)
        return torch.cat([full, full.new_zeros((len(qs), 1))], dim=1)

    def owned(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global vertex ids u (any shape) -> (bool[Pl, ...] this shard owns
        u, the local row, n_local where not owned)."""
        p = self.p.view((self.Pl,) + (1,) * u.dim())
        own = torch.div(u, self.n_local, rounding_mode="floor")[None] == p
        return own, torch.where(own, torch.remainder(u, self.n_local)[None],
                                self.n_local)

    def probe(self, u_lo: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """bool[Pl, R]: the arc (local u_lo -> global v) exists on the shard
        and is active (u_lo = n_local finds nothing)."""
        key = (u_lo * (self.n_pad + 1) + v).contiguous()
        pos = torch.searchsorted(self.arc_key, key).clamp(max=self.A - 1)
        return ((torch.gather(self.arc_key, 1, pos) == key)
                & (u_lo < self.n_local)
                & torch.gather(self.arc_active, 1, pos))

    def arcs(self, u_lo: torch.Tensor, j: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Arc j of local vertex u_lo on each shard, [Pl, T] -> (its head,
        its active bit); j past the arcs reads a clamped slot the caller
        rejects by degree."""
        idx = (torch.gather(self.csr_off, 1, u_lo) + j).clamp(max=self.A - 1)
        return (torch.gather(self.arc_dst, 1, idx),
                torch.gather(self.arc_active, 1, idx))


def _filter(ok, v, prow_col, s: JoinStep, cand_col, n_pad: int):
    """The expansion filters of step `s` on candidate heads v: candidacy,
    injectivity against every assigned column, symmetry restrictions.
    `prow_col(c)` is column c of each slot's parent row."""
    ok = ok & cand_col[v.clamp(max=n_pad)]
    for c in range(s.n_cols):
        ok &= v != prow_col(c)
    for col, op in s.restr:
        ref = prow_col(col)
        ok &= (v > ref) if op == "gt" else (v < ref)
    return ok


class ReplicatedJoin:
    """The replicated flavor: the row table (int64 [k, columns]) is on every
    shard; the frontier vertex's owner produces each slot and the slots are
    psum-combined. The host reads the expansion capacity and the kept-row
    count per step."""

    route = "device"
    engine = "replicated"

    def __init__(self, ctx: ShardedJoinContext, template: Template,
                 walk: Sequence[int], max_rows: int,
                 symmetry_break: bool = False,
                 stats: Optional[Dict] = None):
        restr = template.symmetry_restrictions() if symmetry_break else ()
        self.steps, self.seen_q = walk_steps(walk, restr)
        self.ctx = ctx
        self.template = template
        self.max_rows = max_rows
        self.stats = stats
        self.cand = ctx.cols(tuple(self.seen_q))  # bool[n_seen, n_pad+1]

    def sources(self) -> np.ndarray:
        return np.flatnonzero(self.cand[0][:-1].cpu().numpy())

    def seed(self, ids: np.ndarray) -> torch.Tensor:
        ids = np.asarray(ids).astype(np.int64).reshape(-1, 1)
        return torch.from_numpy(ids).to(self.cand.device)

    def nrows(self, rows: torch.Tensor) -> int:
        return int(rows.shape[0])

    count = nrows

    def step(self, rows: torch.Tensor, r: int, enforce: bool = True
             ) -> torch.Tensor:
        s = self.steps[r - 1]
        ctx = self.ctx
        if s.kind == "revisit":
            _, u_lo = ctx.owned(rows[:, s.c_prev])
            found = ctx.probe(u_lo, rows[:, s.c_tgt].expand(ctx.Pl, -1))
            keep = ctx.prims.psum(found.to(torch.int32))[0] > 0
            return self._kept(rows[keep], enforce)
        # slots from the static degrees; the capacity is the host read
        deg_h = ctx.deg[rows[:, s.c_prev]].cpu().numpy()
        cum_h, T = tds_mod.expansion_slots(deg_h)
        if enforce and T > self.max_rows:
            raise TdsOverflow(
                f"join capacity {T} > max_rows={self.max_rows} at step {r}")
        _guard_int32(T, f"join expansion capacity at step {r}")
        if T == 0:
            return rows.new_zeros((0, s.n_cols + 1))
        dev = rows.device
        cum = torch.from_numpy(np.asarray(cum_h, np.int64)).to(dev)
        deg = torch.from_numpy(deg_h.astype(np.int64)).to(dev)
        t = torch.arange(T, device=dev)
        parent = torch.searchsorted(cum, t, right=True).clamp(
            max=rows.shape[0] - 1)
        j = t - (cum - deg)[parent]
        up = rows[parent, s.c_prev]
        own, u_lo = ctx.owned(up)
        v, active = ctx.arcs(u_lo, j.expand(ctx.Pl, -1))
        ok = own & (j < ctx.deg[up]) & active
        ok = _filter(ok, v, lambda c: rows[parent, c], s, self.cand[s.c_tgt],
                     ctx.n_pad)
        newv = ctx.prims.psum(torch.where(ok, v, 0))[0]
        keep = ctx.prims.psum(ok.to(torch.int32))[0] > 0
        if self.stats is not None:
            self.stats["join_expansions"] = (
                self.stats.get("join_expansions", 0) + T)
        return self._kept(torch.cat([rows[parent[keep]], newv[keep, None]],
                                    dim=1), enforce)

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


class ShardedRowBlock:
    """The distributed row table: device data int64[Pl, Rb, C] (per-shard
    blocks padded to a power of two; rows past a shard's count are sink
    rows, every column n_pad) and host per-shard counts int64[P]. `cap` is
    each shard's expansion capacity for the next step (summed static
    degrees), read in the same host read that sized this block."""

    __slots__ = ("data", "counts", "cap")

    def __init__(self, data, counts: np.ndarray, cap=None):
        self.data = data
        self.counts = np.asarray(counts, np.int64)
        self.cap = (np.zeros(self.counts.shape[0], np.int64)
                    if cap is None else np.asarray(cap, np.int64))

    @property
    def k(self) -> int:
        return int(self.counts.sum())


def _first_set(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Per shard, the positions of the first `size` true entries of mask
    [Pl, N] in order, then N (the sink) for the rest -> int64[Pl, size]."""
    Pl, N = mask.shape
    pos = torch.arange(N, device=mask.device).expand(Pl, N)
    key = torch.where(mask, pos, N)
    if size > N:
        key = torch.cat([key, key.new_full((Pl, size - N), N)], dim=1)
    return torch.sort(key, dim=1).values[:, :size]


def _take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [Pl, R, C] at per-shard row indices idx [Pl, K] -> [Pl, K, C]."""
    return torch.gather(rows, 1, idx[..., None].expand(-1, -1, rows.shape[2]))


class RowShardedJoin:
    """The distributed-rows flavor over a ShardedJoinContext.

    Every real row lives on the shard that owns its next frontier vertex,
    so each expansion and revisit probe is shard-local. Per step the host
    reads one [P, 2, P] matrix (one all-gather under spmd): the rows each
    shard sends to each owner, which size `exchange_rows`, and the next
    frontier column's capacity per owner, which sizes the next step's
    slots. Buckets pad, never drop."""

    route = "device"
    engine = "rowsharded"

    def __init__(self, ctx: ShardedJoinContext, template: Template,
                 walk: Sequence[int], max_rows: int,
                 symmetry_break: bool = False,
                 stats: Optional[Dict] = None):
        if not hasattr(ctx, "row_plan"):
            raise ValueError(
                "RowShardedJoin needs a ShardedJoinContext (a row-ownership "
                "plan); the local backend has no rows to distribute")
        restr = template.symmetry_restrictions() if symmetry_break else ()
        self.steps, self.seen_q = walk_steps(walk, restr)
        self.ctx = ctx
        self.template = template
        self.max_rows = max_rows
        self.stats = stats
        self.cand = ctx.cols(tuple(self.seen_q))  # the one replicated state
        self.P, self.n_local, self.n_pad = ctx.P, ctx.n_local, ctx.n_pad
        self.rp = ctx.row_plan
        self._deg_max = int(self.rp.deg.max()) if self.rp.deg.size else 0

    # -- step metadata ------------------------------------------------------
    def _next_owner_col(self, r: int) -> Optional[int]:
        """Column (after step r) holding step r+1's frontier vertex, the
        routing key; None after the last step."""
        if r >= len(self.steps):
            return None
        return self.steps[r].c_prev

    def _stat_max(self, key: str, val) -> None:
        if self.stats is not None:
            self.stats[key] = max(self.stats.get(key, 0), val)

    def _record_block(self, counts: np.ndarray, resident: int) -> None:
        total = int(counts.sum())
        self._stat_max("join_rows_max", total)
        self._stat_max("rowshard_resident_rows_max", resident)
        self._stat_max("rowshard_peak_shard_rows", int(counts.max()))
        if self.stats is not None and total:
            frac = float(counts.max()) / float(total)
            self.stats["rowshard_owner_frac_max"] = max(
                self.stats.get("rowshard_owner_frac_max", 0.0), frac)

    def _shard_host_rows(self, rows_np: np.ndarray,
                         owner_col: int) -> ShardedRowBlock:
        data, counts = self.rp.shard_rows(rows_np, owner_col, _pow2)
        self._record_block(counts, data.shape[1])
        fcol = rows_np[:, owner_col].astype(np.int64)  # host rows are real
        cap = np.bincount(fcol // self.n_local,
                          weights=self.rp.deg[fcol].astype(np.float64),
                          minlength=self.P).astype(np.int64)
        mine = data[self.ctx.p.cpu().numpy()].astype(np.int64)
        return ShardedRowBlock(torch.from_numpy(mine).to(self.cand.device),
                               counts, cap)

    def _owner_stats(self, vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """int64[Pl, 2, P] per next-owner shard: surviving rows (the next
        exchange's bucket sizes) and the summed degree of their next
        frontier vertex (the next expansion's capacity)."""
        P = self.P
        owner = torch.where(ok, torch.div(vals, self.n_local,
                                          rounding_mode="floor"), P)
        oh = (owner[..., None] == torch.arange(P, device=vals.device)
              ).to(torch.int64)
        dw = self.ctx.deg[torch.where(ok, vals, 0)] * ok
        return torch.stack([oh.sum(dim=1), (oh * dw[..., None]).sum(dim=1)],
                           dim=1)

    # -- engine API ---------------------------------------------------------
    def sources(self) -> np.ndarray:
        return np.flatnonzero(self.cand[0][:-1].cpu().numpy())

    def seed(self, ids: np.ndarray) -> ShardedRowBlock:
        # step 1's frontier is column 0: seeds go straight to their owner
        return self._shard_host_rows(np.asarray(ids, np.int32).reshape(-1, 1), 0)

    def nrows(self, rows: ShardedRowBlock) -> int:
        return rows.k

    count = nrows

    def _empty(self, width: int) -> ShardedRowBlock:
        data = torch.full((self.ctx.Pl, 1, width), self.n_pad,
                          dtype=torch.int64, device=self.cand.device)
        return ShardedRowBlock(data, np.zeros(self.P, np.int64))

    def step(self, rows: ShardedRowBlock, r: int,
             enforce: bool = True) -> ShardedRowBlock:
        s = self.steps[r - 1]
        ctx = self.ctx
        oc = self._next_owner_col(r)
        expand = s.kind == "expand"
        width = s.n_cols + (1 if expand else 0)
        data = rows.data
        if expand:
            # the capacity came with the previous step's host read
            cap_p = rows.cap
            T = int(cap_p.sum())
            if enforce and T > self.max_rows:
                raise TdsOverflow(
                    f"join capacity {T} > max_rows={self.max_rows} "
                    f"at step {r}")
            _guard_int32(int(cap_p.max()) if cap_p.size else 0,
                         f"per-shard join expansion capacity at step {r}")
            if T == 0:
                return self._empty(width)
            if oc is not None:
                _guard_int32(int(cap_p.max()) * max(self._deg_max, 1),
                             f"device capacity partial sums at step {r}")
            Tb = _pow2(max(int(cap_p.max()), 1))
            Rb = data.shape[1]
            # slot layout on the device from the static degrees
            degrow = ctx.deg[data[:, :, s.c_prev]]             # sink rows -> 0
            cum = torch.cumsum(degrow, dim=1)
            t = torch.arange(Tb, device=data.device).expand(ctx.Pl, Tb)
            parent = torch.searchsorted(cum, t.contiguous(), right=True).clamp(
                max=Rb - 1)
            j = t - torch.gather(cum - degrow, 1, parent)
            prow = _take_rows(data, parent)                    # [Pl, Tb, C]
            up = prow[:, :, s.c_prev]
            u_lo = (up - ctx.p[:, None] * self.n_local).clamp(0, self.n_local)
            v, active = ctx.arcs(u_lo, j)
            ok = (j < ctx.deg[up]) & active
            ok = _filter(ok, v, lambda c: prow[:, :, c], s,
                         self.cand[s.c_tgt], self.n_pad)
            newv = torch.where(ok, v, 0)
            cand_rows = torch.cat([prow, newv[..., None]], dim=2)
            if self.stats is not None:
                self.stats["join_expansions"] = (
                    self.stats.get("join_expansions", 0) + T)
        else:
            if oc is not None:
                _guard_int32(int(rows.counts.max()) * max(self._deg_max, 1),
                             f"device capacity partial sums at step {r}")
            u = data[:, :, s.c_prev]
            u_lo = (u - ctx.p[:, None] * self.n_local).clamp(0, self.n_local)
            ok = ctx.probe(u_lo, data[:, :, s.c_tgt])  # sink rows: u_lo = n_local
            cand_rows = data
        if oc is None:
            cm = ok.sum(dim=1, keepdim=True)                   # [Pl, 1]
        else:
            cm = self._owner_stats(cand_rows[:, :, oc], ok)    # [Pl, 2, P]

        # the one host read of this step: counts and next capacity together
        cm = ctx.prims.gather(cm).cpu().numpy().astype(np.int64)
        if self.stats is not None:
            self.stats["rowshard_host_syncs"] = (
                self.stats.get("rowshard_host_syncs", 0) + 1)
        if oc is None:
            cnt, cap_next = cm, None                           # [P, 1]
        else:
            cnt = cm[:, 0, :]                                  # sender x owner
            cap_next = cm[:, 1, :].sum(axis=0)                 # per owner
        k_total = int(cnt.sum())
        if enforce and k_total > self.max_rows:
            raise TdsOverflow(
                f"join rows {k_total} > max_rows={self.max_rows}")
        if k_total == 0:
            return self._empty(width)

        if oc is None:  # last step: per-shard compaction, no exchange
            k_p = cnt[:, 0]
            Kp = _pow2(max(int(k_p.max()), 1))
            sink = torch.full_like(cand_rows[:, :1], self.n_pad)
            out = _take_rows(torch.cat([cand_rows, sink], dim=1),
                             _first_set(ok, Kp))
            self._record_block(k_p, Kp)
            return ShardedRowBlock(out, k_p)

        # buckets sized from the count matrix: Br bounds every (sender,
        # owner) bucket, Rb2 every shard's received total -- rows are padded
        # into place, never dropped
        k_in = cnt.sum(axis=0)
        Br = _pow2(max(int(cnt.max()), 1))
        Rb2 = _pow2(max(int(k_in.max()), 1))
        _guard_int32(self.P * Br, f"exchange bucket slots at step {r}")
        out = self._route(cand_rows, ok, cnt, Br, Rb2, oc)
        self._record_block(k_in, Rb2)
        if self.stats is not None:
            off_shard = k_total - int(np.trace(cnt))
            self.stats["rowshard_exchanged_rows"] = (
                self.stats.get("rowshard_exchanged_rows", 0) + off_shard)
            self._stat_max("rowshard_bucket_cap", Br)
            self._stat_max("rowshard_bucket_occupancy_max", int(cnt.max()))
        return ShardedRowBlock(out, k_in, cap_next)

    def _route(self, cand_rows, ok, cnt: np.ndarray, Br: int, Rb2: int,
               oc: int) -> torch.Tensor:
        """Route the surviving rows to their next owners: a stable sort of
        the slots by owner, [P, Br] buckets laid out from the host count
        matrix, one `exchange_rows`, and the received buckets compacted
        into [Pl, Rb2, C] (sink rows past the count)."""
        ctx, P = self.ctx, self.P
        Pl, T, Cw = cand_rows.shape
        dev = cand_rows.device
        owner = torch.where(ok, torch.div(cand_rows[:, :, oc], self.n_local,
                                          rounding_mode="floor"), P)
        order = torch.sort(owner, dim=1, stable=True).indices
        cnt_t = torch.from_numpy(cnt).to(dev)
        cnt_out = cnt_t[ctx.p]                                 # [Pl, P]
        start = torch.cumsum(cnt_out, dim=1) - cnt_out
        b = torch.arange(Br, device=dev)
        src = (start[..., None] + b).clamp(max=T - 1)          # [Pl, P, Br]
        valid = b < cnt_out[..., None]
        idx = torch.gather(order, 1, src.reshape(Pl, -1))
        send = _take_rows(cand_rows, idx).view(Pl, P, Br, Cw)
        send = torch.where(valid[..., None], send, self.n_pad)
        recv = ctx.prims.exchange_rows(send)     # slice q = from shard q
        cnt_in = cnt_t[:, ctx.p].T                             # [Pl, P]
        mask = (b < cnt_in[..., None]).reshape(Pl, P * Br)
        flat = torch.cat([recv.reshape(Pl, P * Br, Cw),
                          recv.new_full((Pl, 1, Cw), self.n_pad)], dim=1)
        return _take_rows(flat, _first_set(mask, Rb2))

    def split(self, rows: ShardedRowBlock, r: int,
              budget: int) -> List[ShardedRowBlock]:
        s = self.steps[r - 1]
        if s.kind == "revisit" or rows.k <= 1:
            return [rows]
        # streaming reads each block on the host anyway: gather, split by
        # capacity, re-shard each piece by its owner column
        host = self._gather(rows)
        cap = self.rp.deg[host[:, s.c_prev]]
        return [self._shard_host_rows(piece, s.c_prev)
                for piece in _split_by_capacity(host, cap, budget)]

    def _gather(self, rows: ShardedRowBlock) -> np.ndarray:
        d = self.ctx.prims.gather(rows.data).cpu().numpy()
        return np.concatenate(
            [d[p, :int(c)] for p, c in enumerate(rows.counts)], axis=0)

    def emit(self, rows: ShardedRowBlock) -> np.ndarray:
        perm = [self.seen_q.index(q) for q in range(self.template.n0)]
        return self._gather(rows)[:, perm].astype(np.int32)


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
