"""Template-batched execution: B same-bucket queries against one graph.

Many analysts hold many search templates against one resident background
graph. This module stacks B same-bucket templates along a leading lane
dimension and runs the prune pipeline for all of them in lockstep. On one
device (`BatchedEngine`, the JAX package's P = 1 batch):

  - state: omega bool[B, n, n0p] (templates padded to the widest, n0p
    columns; a padded column starts empty and stays empty) and the arc
    masks bool[B, m], each lane's in the `DeviceGraph`'s dst-sorted arc
    order, the order the kernels read;
  - LCC: one sweep covers every lane that has not converged. Its
    OR-aggregation is one `bitset_spmm` launch per live lane over that
    lane's arc mask; the per-vertex and per-arc eliminations run once on
    the lane-stacked tensors; one host read per sweep says which lanes
    changed. The sweep is the shard program's (`_sweep`), on the lagged
    schedule of the reference's batched fixpoint: a lane stops one sweep
    after its first unchanged sweep, so a call that changes nothing counts
    2 iterations, and a call counts the largest lane's;
  - NLCC: the lockstep phase runs phase k of every lane together, sized by
    one stacked readback of the head columns. On one device the jobs run
    one after another anyway, so each lane runs `nlcc.verify_constraint`
    on its own state (`bitset_wave` on the fused route, `bitset_spmm` hops
    on the packed route: frontiers are read through the dst-sorted arcs
    inside the kernels and no per-arc message plane exists), and the
    phase counts waves, tokens and padded jobs as the reference's lockstep
    rounds do;
  - TDS constraints run per lane on the host, through a lane gather and
    scatter;
  - a deadline cancels a lane at the next phase boundary by zeroing its
    state, which every later sweep and wave leaves as it is.

On a partitioned graph (`ShardedBatchedEngine`, `partition=` on the sim
prims or `mesh=` on a process group) the lanes stand beside the shard axis
and run the sharded backends' shard programs; see its docstring.

Each lane's omega, arc mask and match count equal those of `prune` of its
template alone (tests/test_torch_batch.py). Routes resolve `prune.nlcc`
under the batched bucket key (`registry.batch_bucket`, for example
"b8xp1x1048576x1024"), so batched routes tune apart from single queries.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.graph.structs import Graph, DeviceGraph
from repro_torch.core.state import (PruneState, as_int32_bits, pack_bits,
                                    unpack_bits)
from repro_torch.core.lcc import TemplateDev
from repro_torch.core.template import (Template, NonLocalConstraint,
                                       generate_constraints)
from repro_torch.core import nlcc as nlcc_mod
from repro_torch.core import planner as planner_mod
from repro_torch.core import tds as tds_mod
from repro_torch.core.engine import (_pad_row, _state_changed,
                                     counted_label_bits, counts_meet,
                                     lcc_shard_iteration, sharded_nlcc_route,
                                     sharded_wave_frontier, sharded_wave_keep,
                                     side_words, sweep_vertex_test)
from repro_torch.core.pipeline import PruneResult
from repro_torch.kernels import registry

STATUS_OK = "ok"
STATUS_DEADLINE_MISSED = "deadline_missed"
# the reference's cap on the sweeps of one batched LCC call
LCC_MAX_ITERS = 1000


def _stack_template_consts(tdevs: Sequence[TemplateDev], n0p: int,
                           device: torch.device):
    """Per-lane template constants zero-padded to n0p columns:
    (adj0 f32[B, n0p, n0p], req int32[B, n0p, C], vhcl f32[B, n0p, C],
    lanes that need multiplicity counts). A lane without counts keeps
    all-zero requirements, which every count meets."""
    B = len(tdevs)
    C = max(int(td.req.shape[1]) for td in tdevs)
    adj0 = torch.zeros((B, n0p, n0p), dtype=torch.float32, device=device)
    req = torch.zeros((B, n0p, C), dtype=torch.int32, device=device)
    vhcl = torch.zeros((B, n0p, C), dtype=torch.float32, device=device)
    for i, td in enumerate(tdevs):
        adj0[i, :td.n0, :td.n0] = td.adj0_f
        if td.needs_counts:
            ci = int(td.req.shape[1])
            req[i, :td.n0, :ci] = td.req
            vhcl[i, :td.n0, :ci] = td.vertex_has_counted_label
    counted = [i for i, td in enumerate(tdevs) if td.needs_counts]
    return adj0, req, vhcl, counted


def _check_batch(graph, templates) -> None:
    if not templates:
        raise ValueError("prune_batch needs at least one template")
    if not isinstance(graph, Graph):
        raise TypeError("prune_batch needs the host Graph")
    buckets = {registry.shape_bucket(t.n0) for t in templates}
    if len(buckets) != 1:
        raise ValueError(
            f"templates span shape buckets {sorted(buckets)}; a batch "
            "must be same-bucket (the serving batcher groups by bucket)")
    if any(t.n0 < 2 for t in templates):
        raise ValueError("n0 == 1 templates are LCC-only degenerate "
                         "cases; run them through prune()")


class _LaneBridge:
    """What both batched engines share: the TDS lane bridge (a lane's
    global state through the host row join) and the device sync."""

    def tds_lane(self, lane: int, c: NonLocalConstraint,
                 cstats: Optional[Dict] = None) -> bool:
        state = self.gather_lane(lane)
        new = tds_mod.verify_tds_constraint(
            self.dg, state, c, chunk=self.tds_chunk,
            max_rows=self.tds_max_rows, stats=cstats,
            annotate=(c.complete and self.guarantee_precision),
            dedup=self.work_aggregation)
        with tracing.read("batch.tds_changed"):
            changed = bool(_state_changed(state, new))
        if changed:
            self.scatter_lane(lane, new)
        if cstats is not None:
            cstats["tds_gather_bridge"] = cstats.get("tds_gather_bridge", 0) + 1
        return changed

    def sync(self) -> None:
        if self.dg.device.type == "cuda":
            torch.cuda.synchronize(self.dg.device)


class BatchedEngine(_LaneBridge):
    """Lane-stacked state and programs of B same-bucket templates over one
    `DeviceGraph`."""

    def __init__(self, graph: Graph, templates: Sequence[Template], *,
                 wave: int = 1024,
                 tds_chunk: int = 4096, tds_max_rows: int = 2_000_000,
                 work_aggregation: bool = True,
                 guarantee_precision: bool = True, device=None,
                 dg: Optional[DeviceGraph] = None):
        _check_batch(graph, templates)
        if dg is None:
            dg = DeviceGraph.from_host(graph, device)
        elif (dg.n, dg.m) != (graph.n, graph.m):
            raise ValueError(f"dg has n={dg.n} m={dg.m}, the graph n="
                             f"{graph.n} m={graph.m}")
        elif device is not None and torch.device(device).type != dg.device.type:
            raise ValueError(f"dg lives on {dg.device}, device={device}")
        self.dg = dg
        # an undirected graph holds both arcs of every edge: arc k of the
        # reversed graph is arc k here, so its index here is k's twin
        _, twin = dg.reversed()
        with tracing.read("batch.twins"):
            undirected = (torch.equal(dg.src[twin], dg.dst)
                          and torch.equal(dg.dst[twin], dg.src))
        if not undirected:
            raise ValueError("graph is not undirected (missing twin arcs)")
        self.twin = twin
        self.templates = list(templates)
        self.Bq = len(self.templates)
        self.P = 1
        self.wave = wave
        self.tds_chunk = tds_chunk
        self.tds_max_rows = tds_max_rows
        self.work_aggregation = work_aggregation
        self.guarantee_precision = guarantee_precision
        self.n0p = max(t.n0 for t in self.templates)
        (self.adj0_b, self.req_b, self.vhcl_b,
         self.counted) = _stack_template_consts(
            [TemplateDev(t, dg.device) for t in self.templates], self.n0p,
            dg.device)
        self.deg_pos_b = self.adj0_b.sum(dim=2) > 0.5          # bool[B, n0p]
        self.omega_b: Optional[torch.Tensor] = None            # bool[B, n, n0p]
        self.ea_b: Optional[torch.Tensor] = None               # bool[B, m]
        self._routes_taken: set = set()
        self.name = "local"

    # -- state --------------------------------------------------------------
    def init(self, stats: Optional[Dict] = None) -> None:
        """Each lane's omega from label candidacy planes shared across the
        batch: one plane per distinct template label, and every lane's
        column q is the plane of its label (the same column as
        `init_state` builds)."""
        labels = self.dg.labels
        planes: Dict[int, torch.Tensor] = {}

        def plane(label: int) -> torch.Tensor:
            if label not in planes:
                planes[label] = labels == label
            return planes[label]

        zero = torch.zeros_like(labels, dtype=torch.bool)
        lanes = []
        for t in self.templates:
            cols = [plane(int(t.labels[q])) for q in range(t.n0)]
            cols += [zero] * (self.n0p - t.n0)
            lanes.append(torch.stack(cols, dim=1))
        if stats is not None:
            stats["shared_candidacy_planes"] = {
                "distinct": len(planes),
                "lane_columns": int(sum(t.n0 for t in self.templates)),
            }
        self.omega_b = torch.stack(lanes)
        self.ea_b = torch.ones((self.Bq, self.dg.m), dtype=torch.bool,
                               device=self.dg.device)

    def gather_lane(self, lane: int) -> PruneState:
        """One lane's state, in its template's own width (a copy)."""
        n0 = self.templates[lane].n0
        return PruneState(omega=self.omega_b[lane, :, :n0].clone(),
                          edge_active=self.ea_b[lane].clone())

    def scatter_lane(self, lane: int, state: PruneState) -> None:
        n0 = self.templates[lane].n0
        self.omega_b[lane, :, :n0] = state.omega
        self.omega_b[lane, :, n0:] = False
        self.ea_b[lane] = state.edge_active

    def cancel_lane(self, lane: int) -> None:
        """Deadline cancellation masks the lane inert: a zero state is left
        as it is by every sweep and wave, so the lane rides the rest of the
        batch as a no-op."""
        self.omega_b[lane] = False
        self.ea_b[lane] = False

    # -- batched LCC ---------------------------------------------------------
    def _sweep(self, live: List[int]) -> torch.Tensor:
        """One LCC sweep of the lanes `live`, in place -> changed bool[len].

        The shard program's sweep (the reference's batched path runs it even
        on one shard), through the shard programs' own sweep math
        (`engine.sweep_vertex_test`, `counts_meet`, `side_words`) over the
        lane axis: vertex q of v needs every template neighbour of q covered
        over v's active in-arcs (and the multiplicity counts), and v some
        covered neighbour at all if q has any; arc u -> v needs it and its
        twin active and a template arc between omega(u) and omega(v), both
        as the sweep found them."""
        from repro_torch.kernels import ops as kops

        dg, n0p = self.dg, self.n0p
        idx = torch.tensor(live, dtype=torch.long, device=dg.device)
        om, ea = self.omega_b[idx], self.ea_b[idx]
        adj0 = self.adj0_b[idx]
        words = pack_bits(om)                                   # int32[Bl, n, W]
        M = torch.stack([
            unpack_bits(kops.bitset_or_aggregate(words[j], dg, ea[j]), n0p)
            for j in range(len(live))])                          # bool[Bl, n, n0p]
        new = sweep_vertex_test(om, M, adj0, self.deg_pos_b[idx][:, None, :])
        cj = [j for j, b in enumerate(live) if b in self.counted]
        if cj:
            jc = torch.tensor(cj, dtype=torch.long, device=dg.device)
            cidx = idx[jc]
            vind = counted_label_bits(om[jc], self.vhcl_b[cidx])
            ind = vind.index_select(1, dg.src) & ea[jc][..., None]
            cnt = _segment_sum_lanes(ind.to(torch.int32), dg.dst, dg.n)
            new[jc] &= counts_meet(cnt, self.req_b[cidx])
        compat = (side_words(om, adj0).index_select(1, dg.src)
                  & words.index_select(1, dg.dst)).ne(0).any(dim=2)
        ea_new = ea & ea.index_select(1, self.twin) & compat
        changed = (new != om).flatten(1).any(dim=1) | (ea_new != ea).any(dim=1)
        self.omega_b[idx] = new
        self.ea_b[idx] = ea_new
        return changed

    def lcc(self, stats: Optional[Dict] = None,
            lanes: Optional[Sequence[int]] = None) -> None:
        """LCC to a fixpoint in every lane (or in `lanes`: the others are
        known to sit at theirs, so their sweeps would change nothing).
        Counts iterations as the reference's lagged batched while-loop: a
        lane runs one sweep past its first unchanged one, and the call
        counts its longest lane's sweeps, at least 2. The loop is not the
        shard programs' lagged `overlap`: that one runs every shard to the
        end, while this one drops a lane at its first unchanged sweep (the
        sweep past it changes nothing) and adds that sweep to the count."""
        live = list(range(self.Bq)) if lanes is None else [int(b) for b in lanes]
        it = 0
        while live and it < LCC_MAX_ITERS:
            with tracing.span("lcc.sweep"):
                changed = self._sweep(live)
                with tracing.read("batch.sweep"):
                    changed = changed.tolist()
            it += 1
            live = [b for b, ch in zip(live, changed) if ch]
        iters = LCC_MAX_ITERS if live else min(max(it, 1) + 1, LCC_MAX_ITERS)
        if stats is not None:
            stats["lcc_calls"] = stats.get("lcc_calls", 0) + 1
            stats["lcc_iterations"] = stats.get("lcc_iterations", 0) + iters

    # -- batched NLCC waves ---------------------------------------------------
    def route_bucket(self):
        return registry.batch_bucket(
            self.Bq, registry.shard_bucket(self.P, self.dg.n, self.wave))

    def nlcc_phase(self, lane_constraints: Sequence[
            Tuple[int, NonLocalConstraint, str]],
            cstats: Optional[Dict] = None) -> torch.Tensor:
        """One lockstep phase of cycle and path constraints, one (lane,
        constraint, direction) entry per lane. Every walk runs against the
        phase-entry omega. Returns which lanes changed, bool[B] on the
        device: the caller's one host read of the phase.

        Each lane runs `nlcc.verify_constraint` on its own state, on the
        route resolved under the batched bucket and with its head columns
        taken from the phase's one stacked readback. The lockstep counters
        are the reference's: jobs are (lane, walk) pairs grouped by (walk
        length, cyclicity), a group runs as many wave rounds as its longest
        job has wave batches, and a job whose sources ran dry counts as
        padded in every later round of its group (the reference runs it on
        all-pad ids, which seed nothing and keep nothing; here it runs no
        wave)."""
        dg = self.dg
        route = nlcc_mod.nlcc_resolved_route(
            dg.n, self.wave, dg.device.type, m=dg.m,
            bucket=self.route_bucket())
        self._routes_taken.add(route)
        walks = [nlcc_mod.expand_walks(c, direction)
                 for _, c, direction in lane_constraints]
        head = torch.stack(
            [self.omega_b[lane, :, w[0]]
             for (lane, _, _), ws in zip(lane_constraints, walks) for w in ws])
        with tracing.read("batch.heads"):
            head = head.cpu().numpy()                          # bool[jobs, n]
        sources = np.array([np.count_nonzero(h) for h in head])
        rounds = -(-sources // self.wave)                      # per job
        groups: Dict[Tuple[int, bool], List[int]] = {}
        for ji, w in enumerate(w for ws in walks for w in ws):
            groups.setdefault((len(w) - 1, w[0] == w[-1]), []).append(ji)
        n_waves = n_padded = 0
        for members in groups.values():
            r = rounds[members]
            n_waves += int(r.max())
            n_padded += int((r.max() - r).sum())

        changed = torch.zeros(self.Bq, dtype=torch.bool, device=dg.device)
        j0 = 0
        for (lane, c, direction), ws in zip(lane_constraints, walks):
            n0 = self.templates[lane].n0
            state = PruneState(self.omega_b[lane, :, :n0], self.ea_b[lane])
            new = nlcc_mod.verify_constraint(
                dg, state, c, wave=self.wave, route=route,
                direction=direction, head_cols=head[j0:j0 + len(ws)].T)
            j0 += len(ws)
            changed[lane] = (new.omega != state.omega).any()
            self.omega_b[lane, :, :n0] = new.omega
        if cstats is not None:
            cstats["nlcc_waves"] = cstats.get("nlcc_waves", 0) + n_waves
            cstats["nlcc_tokens"] = (cstats.get("nlcc_tokens", 0)
                                     + int(sources.sum()))
            cstats["nlcc_lockstep_padded"] = (
                cstats.get("nlcc_lockstep_padded", 0) + n_padded)
            cstats["nlcc_constraints"] = (
                cstats.get("nlcc_constraints", 0) + len(lane_constraints))
            cstats["nlcc_host_syncs"] = cstats.get("nlcc_host_syncs", 0) + 1
        return changed

    # -- TDS lane bridge: _LaneBridge ---------------------------------------
    def agree(self, flags: List[bool]) -> List[bool]:
        """Host decisions every rank takes alike: one process here."""
        return flags


# the share of the card's free memory one lockstep group of NLCC jobs may
# hold (its frontiers, send messages and receive buffers); on the CPU a fixed
# budget
LOCKSTEP_MEMORY_FRACTION = 0.25
LOCKSTEP_CPU_BUDGET = 1 << 30


def lockstep_job_bytes(Pl: int, P: int, B: int, n_local: int, wave: int,
                       packed: bool = True) -> int:
    """Device bytes one NLCC job adds to a lockstep group of the sharded
    batch: its frontier and the next hop's and their aggregate, its words in
    the send buffer and in the received buffer (a plane of Pl*P*B slots
    each), its copy of its lane's arc flags and its send index (int32,
    gathered and transposed)."""
    S = Pl * P * B
    row = (wave // 32) * 4 if packed else wave
    return 3 * Pl * (n_local + 1) * row + 2 * S * row + 9 * S


class _LaneTemplate:
    """One lane's template constants at the batch's padded width n0p, in the
    shape the shard programs read (`TemplateDev`'s fields)."""

    def __init__(self, n0p, adj0_f, req, vhcl, needs_counts):
        self.n0 = n0p
        self.adj0_f = adj0_f
        self.deg_pos = adj0_f.sum(dim=1) > 0.5
        self.req = req
        self.vertex_has_counted_label = vhcl
        self.needs_counts = needs_counts


class ShardedBatchedEngine(_LaneBridge):
    """The batched engine on a partitioned graph (the JAX package's
    `BatchedEngine` at P > 1): lane-stacked shard arrays beside the shard
    axis, run by the sharded backends' shard programs (`core/engine.py`)
    under the `sim` prims (`partition=`) or the `spmd` prims (`mesh=`).

      - state: omega int32[Bq, Pl, n_local+1, W] and edge_active bool[Bq,
        Pl, P, B], each lane in the sharded backend's layout at the
        batch's padded width;
      - LCC: each sweep runs every live lane's shard sweep (one
        `bitset_segment_or` launch per lane), and one reduction of the
        lanes' change flags per sweep, read one sweep late as the sharded
        fixpoint reads its flag (the reference's lagged count);
      - NLCC: the jobs (lane, walk) of a phase run in lockstep wave rounds,
        grouped by (walk length, cyclicity); a round's jobs run in groups
        whose frontiers and message planes fit `group_budget()`, each group
        one wave of the sharded backends' `sharded_wave_frontier` and
        `sharded_wave_keep` over its job axis (a hop: one send buffer, one
        exchange and one `bitset_segment_or` launch over all of the group's
        words; the survivor counts reduced once). Results do not depend on
        the grouping;
      - TDS: per lane on the gathered global state, as the sharded backends'
        bridge.
    """

    def __init__(self, graph: Graph, templates: Sequence[Template], *,
                 partition=None, mesh=None, wave: int = 1024,
                 tds_chunk: int = 4096, tds_max_rows: int = 2_000_000,
                 work_aggregation: bool = True,
                 guarantee_precision: bool = True, device=None,
                 dg: Optional[DeviceGraph] = None):
        from repro_torch.core import engine as engine_mod

        _check_batch(graph, templates)
        if device is None and dg is not None:
            device = dg.device
        # the shard arrays, prims, staged graph and arc-slot map of a
        # sharded backend over this partition
        self.base = engine_mod.make_backend(
            graph, templates[0], device=device, mesh=mesh, partition=partition,
            dg=dg, wave=wave)
        be = self.base
        self.dg, self.part, self.sa, self.prims = be.dg, be.part, be.sa, be.prims
        self.mesh = mesh
        self.P, self.B, self.n_local = be.P, be.B, be.n_local
        self.templates = list(templates)
        self.Bq = len(self.templates)
        self.wave = wave
        self.tds_chunk = tds_chunk
        self.tds_max_rows = tds_max_rows
        self.work_aggregation = work_aggregation
        self.guarantee_precision = guarantee_precision
        self.n0p = max(t.n0 for t in self.templates)
        dev = self.dg.device
        adj0, req, vhcl, counted = _stack_template_consts(
            [TemplateDev(t, dev) for t in self.templates], self.n0p, dev)
        self.lane_tm = [_LaneTemplate(self.n0p, adj0[i], req[i], vhcl[i],
                                      i in counted)
                        for i in range(self.Bq)]
        self.omega_b: Optional[torch.Tensor] = None  # int32[Bq, Pl, nl+1, W]
        self.ea_b: Optional[torch.Tensor] = None     # bool[Bq, Pl, P, B]
        self._routes_taken: set = set()
        self.name = be.name
        self.group_stats: Dict = {}

    # -- state --------------------------------------------------------------
    def init(self, stats: Optional[Dict] = None) -> None:
        """Each lane's omega from label candidacy planes shared across the
        batch (one plane per distinct template label, the backend's
        `init_sharded_state` column by column)."""
        sa = self.sa
        planes: Dict[int, torch.Tensor] = {}

        def plane(label: int) -> torch.Tensor:
            if label not in planes:
                planes[label] = (sa.labels_local == label) & sa.vertex_valid
            return planes[label]

        zero = torch.zeros_like(sa.vertex_valid)
        lanes = []
        for t in self.templates:
            cols = [plane(int(t.labels[q])) for q in range(t.n0)]
            cols += [zero] * (self.n0p - t.n0)
            lanes.append(_pad_row(pack_bits(torch.stack(cols, dim=-1))))
        if stats is not None:
            stats["shared_candidacy_planes"] = {
                "distinct": len(planes),
                "lane_columns": int(sum(t.n0 for t in self.templates)),
            }
        self.omega_b = torch.stack(lanes)
        self.ea_b = sa.send_live[None].repeat(self.Bq, 1, 1, 1)

    def gather_lane(self, lane: int) -> PruneState:
        """One lane's global state in its template's own width."""
        return self.base.gather_arrays(self.omega_b[lane], self.ea_b[lane],
                                       self.templates[lane].n0)

    def scatter_lane(self, lane: int, state: PruneState) -> None:
        om, ea = self.base.scatter_state(state, width=self.n0p)
        self.omega_b[lane] = om
        self.ea_b[lane] = ea

    def cancel_lane(self, lane: int) -> None:
        """Deadline cancellation: a zero lane is left as it is by every
        sweep and wave."""
        self.omega_b[lane] = 0
        self.ea_b[lane] = False

    def agree(self, flags: List[bool]) -> List[bool]:
        """Host decisions every rank must take alike (deadline
        cancellations): rank 0's, broadcast over the group under spmd."""
        if self.mesh is None:
            return flags
        import torch.distributed as dist

        t = torch.tensor([bool(f) for f in flags], dtype=torch.uint8,
                         device=self.dg.device)
        dist.broadcast(t, src=dist.get_process_group_ranks(self.mesh)[0],
                       group=self.mesh)
        return [bool(x) for x in t.cpu().tolist()]

    # -- batched LCC ---------------------------------------------------------
    def lcc(self, stats: Optional[Dict] = None,
            lanes: Optional[Sequence[int]] = None) -> None:
        """LCC to a fixpoint in every lane (or in `lanes`; the others sit at
        theirs). A lane's change flag is read after its next sweep is
        queued, and it stops one sweep past its first unchanged one, as the
        reference's sharded while-loop under its lane vmap; the call counts
        its longest lane's sweeps."""
        live = list(range(self.Bq)) if lanes is None else [int(b) for b in lanes]
        pending, it = None, 0
        while live and it < LCC_MAX_ITERS:
            flags = []
            for b in live:
                om, ea, ch = lcc_shard_iteration(
                    self.omega_b[b], self.ea_b[b], self.sa, self.lane_tm[b],
                    self.prims)
                self.omega_b[b], self.ea_b[b] = om, ea
                flags.append(ch)
            it += 1
            if pending is not None:
                # one reduction of every live lane's previous flag
                go = (self.prims.psum(pending.to(torch.int32))[0] > 0).tolist()
                keep = [j for j, g in enumerate(go) if g]
                live = [live[j] for j in keep]
                flags = [flags[j] for j in keep]
            pending = torch.stack(flags, dim=1) if flags else None
        if stats is not None:
            # lanes at their fixpoint count the sweep past it: at least 2
            stats["lcc_calls"] = stats.get("lcc_calls", 0) + 1
            stats["lcc_iterations"] = (stats.get("lcc_iterations", 0)
                                       + (it if live else max(it, 2)))

    # -- batched NLCC waves ---------------------------------------------------
    def route_bucket(self):
        return registry.batch_bucket(
            self.Bq, registry.shard_bucket(self.P, self.n_local, self.wave))

    def _route(self, L: int) -> str:
        return sharded_nlcc_route(self.route_bucket(), self.sa.Pl, self.P,
                                  self.B, self.n_local, self.wave, L,
                                  self.dg.device.type)

    def _column(self, lane: int, q: int) -> torch.Tensor:
        """bool[Pl, n_local]: lane's candidacy of template vertex q."""
        w, b = q // 32, q % 32
        return ((self.omega_b[lane, :, :self.n_local, w] >> b) & 1).to(torch.bool)

    def job_bytes(self, packed: bool) -> int:
        return lockstep_job_bytes(self.sa.Pl, self.P, self.B, self.n_local,
                                  self.wave, packed)

    def group_budget(self) -> int:
        """Bytes a lockstep group may hold: LOCKSTEP_MEMORY_FRACTION of the
        card's free memory, LOCKSTEP_CPU_BUDGET on the CPU."""
        if self.dg.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.dg.device)
            return int(free * LOCKSTEP_MEMORY_FRACTION)
        return LOCKSTEP_CPU_BUDGET

    def _group_size(self, packed: bool) -> int:
        size = max(self.group_budget() // self.job_bytes(packed), 1)
        if self.mesh is not None:
            # free memory differs by rank: the smallest group decides
            import torch.distributed as dist

            t = torch.tensor([size], dtype=torch.int64, device=self.dg.device)
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.mesh)
            size = int(t.item())
        return size

    def nlcc_phase(self, lane_constraints: Sequence[
            Tuple[int, NonLocalConstraint, str]],
            cstats: Optional[Dict] = None) -> torch.Tensor:
        """One lockstep phase of cycle and path constraints, one (lane,
        constraint, direction) entry per lane, every walk against the
        phase-entry omega. Returns which lanes changed, bool[Bq] on the
        device (the caller's one host read)."""
        jobs: List[Tuple[int, Tuple[int, ...]]] = []
        for lane, c, direction in lane_constraints:
            jobs.extend((lane, w) for w in nlcc_mod.expand_walks(c, direction))
        lanes = sorted({lane for lane, _ in jobs})
        before = {b: self.omega_b[b].clone() for b in lanes}
        # one stacked readback of every job's head column sizes the rounds
        heads = torch.stack([self._column(lane, w[0]) for lane, w in jobs], 1)
        head = self.prims.gather(heads).cpu().numpy()          # [P, J, nl]
        head_global = head.transpose(1, 0, 2).reshape(len(jobs), -1)[
            :, :self.part.n]
        groups: Dict[Tuple[int, bool], List[int]] = {}
        for ji, (_, w) in enumerate(jobs):
            groups.setdefault((len(w) - 1, w[0] == w[-1]), []).append(ji)
        dev = self.dg.device
        keep = torch.zeros((len(jobs), self.sa.Pl, self.n_local + 1),
                           dtype=torch.int32, device=dev)
        n_waves = n_tokens = n_padded = 0
        for (L, is_cyclic), members in groups.items():
            route = self._route(L)
            self._routes_taken.add(route)
            packed = route != registry.ROUTE_UNPACKED
            batches = [list(nlcc_mod.wave_batches(
                np.flatnonzero(head_global[ji]), self.wave)) for ji in members]
            n_rounds = max((len(b) for b in batches), default=0)
            size = self._group_size(packed)
            self.group_stats = {"jobs_per_group": size,
                                "job_bytes": self.job_bytes(packed)}
            cand = {ji: torch.stack([self._column(jobs[ji][0], q)
                                     for q in jobs[ji][1]], dim=1)
                    for ji in members}                     # [Pl, L+1, nl]
            for r in range(n_rounds):
                live = [(ji, b[r]) for ji, b in zip(members, batches)
                        if r < len(b)]
                n_waves += 1
                n_tokens += sum(n_real for _, (_, n_real) in live)
                n_padded += len(members) - len(live)
                for g0 in range(0, len(live), size):
                    part = live[g0:g0 + size]
                    sel = torch.tensor([ji for ji, _ in part], device=dev)
                    lanes_g = torch.tensor([jobs[ji][0] for ji, _ in part],
                                           device=dev)
                    ids = torch.from_numpy(np.stack(
                        [idsp for _, (idsp, _) in part]).astype(np.int64)).to(dev)
                    f = sharded_wave_frontier(
                        torch.stack([cand[ji] for ji, _ in part]), ids,
                        self.ea_b[lanes_g], self.sa, self.prims, packed)
                    keep[sel] = sharded_wave_keep(f, ids, keep[sel],
                                                  self.n_local, is_cyclic,
                                                  self.prims)
                    del f
        # head eliminations (Alg. 5 line 8), each job on its own lane
        for ji, (lane, w) in enumerate(jobs):
            wd, b = w[0] // 32, w[0] % 32
            clear = int(as_int32_bits(torch.tensor(0xFFFFFFFF ^ (1 << b))))
            word = self.omega_b[lane, ..., wd]
            self.omega_b[lane, ..., wd] = torch.where(keep[ji] > 0, word,
                                                      word & clear)
        changed = torch.zeros((self.sa.Pl, self.Bq), dtype=torch.int32,
                              device=dev)
        for b in lanes:
            changed[:, b] = (self.omega_b[b] != before[b]).flatten(1).any(1)
        if cstats is not None:
            cstats["nlcc_waves"] = cstats.get("nlcc_waves", 0) + n_waves
            cstats["nlcc_tokens"] = cstats.get("nlcc_tokens", 0) + n_tokens
            cstats["nlcc_lockstep_padded"] = (
                cstats.get("nlcc_lockstep_padded", 0) + n_padded)
            cstats["nlcc_constraints"] = (
                cstats.get("nlcc_constraints", 0) + len(lane_constraints))
            cstats["nlcc_host_syncs"] = cstats.get("nlcc_host_syncs", 0) + 1
        return self.prims.psum(changed)[0] > 0


def _segment_sum_lanes(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """[B, m, C] values summed by segment along m -> [B, num_segments, C]."""
    from repro_torch.graph import segment_ops

    B, m, C = values.shape
    flat = values.permute(1, 0, 2).reshape(m, B * C)
    out = segment_ops.segment_sum(flat, segment_ids, num_segments)
    return out.reshape(num_segments, B, C).permute(1, 0, 2)


@dataclasses.dataclass
class BatchedPruneResult:
    """Per-lane results of one batched run: `results[i]` is the
    `PruneResult` of templates[i] and `status[i]` is "ok" or
    "deadline_missed" (a cancelled lane's state is all-zero)."""

    results: List[PruneResult]
    status: List[str]
    stats: Dict

    @property
    def n_lanes(self) -> int:
        return len(self.results)


def prune_batch(
    graph: Graph,
    templates: Sequence[Template],
    *,
    partition=None,
    mesh=None,
    wave: int = 1024,
    guarantee_precision: bool = True,
    work_aggregation: bool = True,
    tds_chunk: int = 4096,
    tds_max_rows: int = 2_000_000,
    label_freq: Optional[np.ndarray] = None,
    deadlines: Optional[Sequence[Optional[float]]] = None,
    clock: Optional[Callable[[], float]] = None,
    device=None,
    dg: Optional[DeviceGraph] = None,
) -> BatchedPruneResult:
    """Prune B same-bucket templates against one graph in one batched run.

    `device` defaults to `cuda`; `device="cpu"` runs the kernels' plain
    versions. `dg` is the graph already staged on the device
    (`DeviceGraph.from_host(graph)`), which a serving engine builds once.
    `partition=` (a shard count or an `EdgePartition`) runs the batch on the
    sim prims, `mesh=` (a process group) on the spmd prims, every rank with
    the same arguments (`ShardedBatchedEngine`), the NLCC jobs of a phase
    in lockstep groups of as many as `LOCKSTEP_MEMORY_FRACTION` of the free
    device memory holds.
    `deadlines[i]` is an absolute `clock()` time after which lane i is
    cancelled at the next phase boundary (masked inert, never a batch
    abort; under `mesh=` rank 0's clock decides); `clock` defaults to
    time.monotonic."""
    with tracing.span("batch.init") as init_span:
        common = dict(wave=wave, tds_chunk=tds_chunk,
                      tds_max_rows=tds_max_rows,
                      work_aggregation=work_aggregation,
                      guarantee_precision=guarantee_precision, device=device,
                      dg=dg)
        if partition is not None or mesh is not None:
            eng = ShardedBatchedEngine(graph, templates, partition=partition,
                                       mesh=mesh, **common)
        else:
            eng = BatchedEngine(graph, templates, **common)
        if label_freq is None:
            label_freq = graph.label_frequency()
        cons = [generate_constraints(t, label_freq=label_freq,
                                     guarantee_precision=guarantee_precision)
                for t in templates]
        # per-lane plans: a tuned plan reorders a lane's phases; with no
        # plans in the active policy every lane runs the heuristic order
        phase_lists: List[List[planner_mod.PlanPhase]] = []
        plan_sources: List[str] = []
        policy = registry.get_policy()
        if policy is not None and policy.plans:
            from repro_torch.graph.stats import collect_graph_stats

            gstat = collect_graph_stats(graph)
            for t, cs in zip(templates, cons):
                qp = planner_mod.resolve_query_plan(
                    t, cs, gstat, backend=eng.dg.device.type)
                if qp is None:
                    qp = planner_mod.heuristic_plan(cs)
                phase_lists.append(qp.phases)
                plan_sources.append(qp.source)
        else:
            for cs in cons:
                phase_lists.append(planner_mod.heuristic_plan(cs).phases)
                plan_sources.append("heuristic")
        if deadlines is not None and len(deadlines) != len(templates):
            raise ValueError("deadlines must align with templates")
        clock = clock or time.monotonic
        status = [STATUS_OK] * eng.Bq
        stats: Dict = {
            "n_constraints": [len(c) for c in cons],
            "plan": {"sources": plan_sources},
            "batched": {
                "B": eng.Bq, "P": eng.P, "backend": eng.name,
                "bucket": registry.bucket_key(eng.route_bucket()),
            },
        }
        t0 = time.perf_counter()
        init_span.at(end=t0)

    def cancel_expired():
        if deadlines is None:
            return
        now = clock()
        expired = eng.agree([dl is not None and status[i] == STATUS_OK
                             and now > dl for i, dl in enumerate(deadlines)])
        for i, gone in enumerate(expired):
            if gone:
                status[i] = STATUS_DEADLINE_MISSED
                eng.cancel_lane(i)
                stats["deadline_cancelled"] = (
                    stats.get("deadline_cancelled", 0) + 1)

    with tracing.span("batch.lcc"):
        eng.init(stats)
        cancel_expired()
        eng.lcc(stats)
    # lockstep over the planned phase lists: lane i's phase k is
    # phase_lists[i][k], so differently ordered lanes share one batch
    for k in range(max((len(pl) for pl in phase_lists), default=0)):
        cancel_expired()
        wave_lanes, tds_lanes = [], []
        for i, pl in enumerate(phase_lists):
            if status[i] != STATUS_OK or k >= len(pl):
                continue
            p = pl[k]
            if p.engine == planner_mod.ENGINE_NLCC:
                wave_lanes.append((i, p.constraint, p.direction))
            else:
                tds_lanes.append((i, p.constraint))
        changed = np.zeros(eng.Bq, dtype=bool)
        if wave_lanes:  # the phase's one host read: which lanes changed
            with tracing.span("batch.nlcc"):
                flags = eng.nlcc_phase(wave_lanes, stats)
                with tracing.read("batch.changed"):
                    changed |= flags.cpu().numpy()
        for i, c in tds_lanes:
            with tracing.span("batch.tds", lane=i):
                changed[i] |= eng.tds_lane(i, c, stats)
        if changed.any():
            # the lanes the phase left unchanged sit at their fixpoint
            with tracing.span("batch.lcc"):
                eng.lcc(stats, lanes=np.flatnonzero(changed))
    eng.sync()
    stats["batched"]["seconds"] = time.perf_counter() - t0
    if isinstance(eng, ShardedBatchedEngine) and eng.group_stats:
        stats["batched"]["lockstep"] = dict(eng.group_stats)
    stats["dispatch_routes"] = {
        nlcc_mod.NLCC_ROUTE: ("+".join(sorted(eng._routes_taken))
                              if eng._routes_taken else "none")}

    results = []
    for i, t in enumerate(templates):
        results.append(PruneResult(
            state=eng.gather_lane(i), template=t, dg=eng.dg, phases=[],
            stats=dict(stats, lane=i, lane_status=status[i])))
    return BatchedPruneResult(results=results, status=status, stats=stats)
