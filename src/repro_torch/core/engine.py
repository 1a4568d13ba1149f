"""Execution backends of the pruning pipeline.

One set of LCC-sweep and NLCC-hop programs is written against a small
collective interface (`Prims`: `exchange`, the bucketed all-to-all;
`all_reduce_or` and `psum`, the convergence and survivor reductions;
`axis_index`, which shards this process holds; `exchange_rows`, the keyed row
exchange of the sharded join; `overlap`, the lagged fixpoint schedule;
`gather`, every shard's block on every process). Three backends run them:

  local   the single-device path over one `DeviceGraph`: the LCC fixpoint,
          the NLCC waves and TDS joins of core/{lcc,nlcc,tds}, through the
          `bitset_spmm` and `bitset_wave` kernels.
  sim     `partition=`: every shard in one process. Each shard program is
          written once, over a leading axis of the shards the process holds
          (all P here), so the exchange is a transpose of the [P_src, P_dst,
          B, W] buckets and the reductions reduce over that axis.
  spmd    `mesh=`: a `torch.distributed` process group of P ranks (see
          `launch/mesh.py`), rank r holding shard r; the exchange is
          `all_to_all_single` on the [P*B, W] buffer and the flags reduce by
          `all_reduce` (MAX on uint8, SUM on int32; nothing is sent as bool).
          Every rank runs `prune` on the same host graph, and every host
          decision comes from a replicated value, so the ranks never
          diverge.

The sharded backends are the JAX package's (src/repro/core/engine.py), on
its `EdgePartition` (graph/partition.py): every arc lives on its source's
shard, in buckets by destination shard. A sweep gathers the senders' words
into the buckets, exchanges them, and ORs the received words into each
shard's vertices along the static dst-sorted receive arc list with the
`bitset_spmm` kernel (`ops.bitset_segment_or`; under `sim` one launch covers
every shard). Their LCC runs on the lagged schedule (`overlap`): a sweep's
change flag is read after the next sweep is queued, and the fixpoint counts
the one sweep past its first unchanged one, as the reference's sharded
while-loop does at every P. NLCC waves take one of three routes per
shard-local shape bucket (`registry.shard_bucket`): fused (seed and hops in
one program, the next wave's hops queued with the previous wave's survivor
reduction), packed (a program per hop), unpacked (boolean planes, sent as
uint8). TDS and the frontier edge-prune pass run on the gathered global
state, the same on every rank, and each shard takes its part back.

Every backend carries the resilience seam of `core/resilience.py`: with an
`injector`, `_fire` reports the host dispatch points (LCC, NLCC and TDS
entry, each sharded wave before it is dispatched) and `instrument_prims`
wraps the collectives; `snapshot` and `restore_snapshot` copy the state,
which the programs may write in place, for the ladder's in-place retry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.graph.structs import Graph, DeviceGraph, resolve_device
from repro_torch.graph.partition import EdgePartition, partition_graph
from repro_torch.graph import segment_ops
from repro_torch.core.state import (PruneState, init_state, pack_bits,
                                    unpack_bits, as_int32_bits)
from repro_torch.core.lcc import LCC_ROUTE, TemplateDev, lcc_resolved_route
from repro_torch.core.nlcc import (NLCC_ROUTE, UNPACKED_PLANE_BYTES,
                                   nlcc_resolved_route)
from repro_torch.core.template import Template, NonLocalConstraint
from repro_torch.kernels import registry


class LocalBackend:
    """The single-device path over one `DeviceGraph`."""

    name = "local"

    def __init__(
        self,
        dg: DeviceGraph,
        template: Template,
        *,
        wave: int = 1024,
        lcc_route: Optional[str] = None,
        nlcc_route: Optional[str] = None,
        edge_elimination: bool = True,
        collect_stats: bool = False,
        nlcc_edge_prune: bool = False,
        tds_chunk: int = 4096,
        tds_max_rows: int = 2_000_000,
        work_aggregation: bool = True,
        guarantee_precision: bool = True,
        injector=None,
    ):
        self.dg = dg
        self.template = template
        self.tdev = TemplateDev(template, dg.device)
        self.wave = wave
        self.injector = injector
        self.edge_elimination = edge_elimination
        self.collect_stats = collect_stats
        self.nlcc_edge_prune = nlcc_edge_prune
        self.tds_chunk = tds_chunk
        self.tds_max_rows = tds_max_rows
        self.work_aggregation = work_aggregation
        self.guarantee_precision = guarantee_precision
        # the Fig-6a ablation (_lcc_no_edge_elim) always runs boolean planes
        self.lcc_route = (
            registry.ROUTE_UNPACKED if not edge_elimination else
            lcc_resolved_route(self.tdev, dg, collect_stats=collect_stats,
                               route=lcc_route))
        self.nlcc_route = nlcc_resolved_route(
            dg.n, wave, dg.device.type, m=dg.m, count_messages=collect_stats,
            route=nlcc_route)
        self.state: Optional[PruneState] = None

    # -- state
    def init(self, initial_state: Optional[PruneState]) -> None:
        self.state = initial_state if initial_state is not None else init_state(
            self.dg, self.template)

    def final_state(self) -> PruneState:
        return self.state

    # -- resilience seam
    def snapshot(self) -> PruneState:
        """The phase-entry state for the ladder's in-place retry: a copy
        (the phases may write tensors in place, so references alone could
        hand a retry the faulted state)."""
        return PruneState(omega=self.state.omega.clone(),
                          edge_active=self.state.edge_active.clone())

    def restore_snapshot(self, snap: PruneState) -> None:
        self.state = PruneState(omega=snap.omega.clone(),
                                edge_active=snap.edge_active.clone())

    def _fire(self, site: str, **ctx) -> None:
        """A fault-injection seam: report the event to the injector."""
        if self.injector is not None:
            self.injector.event(site, **ctx)

    # -- reporting
    def record_routes(self, stats: Dict) -> None:
        stats["dispatch_routes"] = {LCC_ROUTE: self.lcc_route,
                                    NLCC_ROUTE: self.nlcc_route}

    def counts_dev(self) -> torch.Tensor:
        """[active_vertices, active_edges, omega_bits] as one device vector,
        so phase snapshots need no host sync."""
        om, ea = self.state.omega, self.state.edge_active
        return torch.stack([
            torch.sum(torch.any(om, dim=1)),
            torch.sum(ea),
            torch.sum(om),
        ])

    def counts_host(self) -> Dict[str, int]:
        return self.state.counts()

    def finalize_stats(self, stats: Dict) -> None:
        """The local routes are resolved up front: nothing to amend."""

    def sync(self) -> None:
        """Wait for the device: phase wall times include their device work."""
        if self.dg.device.type == "cuda":
            torch.cuda.synchronize(self.dg.device)

    # -- phases
    def lcc(self, stats: Dict) -> None:
        from repro_torch.core.lcc import lcc_fixpoint, lcc_iteration

        self._fire("lcc")
        if not self.edge_elimination:
            self.state = self._lcc_no_edge_elim(stats)
            return
        if self.collect_stats:
            # python loop to count per-iteration messages (active arcs at send time)
            state, it = self.state, 0
            while True:
                with tracing.span("lcc.sweep"):
                    with tracing.read("lcc.messages"):
                        n_msgs = int(torch.sum(state.edge_active))
                    stats["lcc_messages"] = stats.get("lcc_messages", 0) + n_msgs
                    state, changed = lcc_iteration(self.dg, self.tdev, state)
                    with tracing.read("lcc.sweep"):
                        changed = bool(changed)
                it += 1
                if not changed or it > 1000:
                    break
            stats["lcc_iterations"] = stats.get("lcc_iterations", 0) + it
            self.state = state
            return
        self.state = lcc_fixpoint(self.dg, self.tdev, self.state, stats=stats,
                                  route=self.lcc_route)

    def _lcc_no_edge_elim(self, stats: Dict) -> PruneState:
        """Vertex-elimination-only LCC (Fig. 6a baseline): edges stay active
        while both endpoints are active, regardless of label compatibility."""
        from repro_torch.core.lcc import lcc_iteration

        dg, state, it = self.dg, self.state, 0
        while True:
            with tracing.span("lcc.sweep"):
                new_state, _ = lcc_iteration(dg, self.tdev, state)
                vact = torch.any(new_state.omega, dim=1)
                ea = vact[dg.src.long()] & vact[dg.dst.long()]
                new_state = PruneState(omega=new_state.omega, edge_active=ea)
                changed = _state_changed(state, new_state)
                state = new_state
                with tracing.read("lcc.messages"):
                    stats["lcc_messages"] = (stats.get("lcc_messages", 0)
                                             + int(torch.sum(ea)))
                with tracing.read("lcc.sweep"):
                    changed = bool(changed)
            it += 1
            if not changed or it > 1000:
                break
        stats["lcc_iterations"] = stats.get("lcc_iterations", 0) + it
        return state

    def nlcc(self, c: NonLocalConstraint, cstats: Dict,
             direction: str = "default") -> torch.Tensor:
        from repro_torch.core import nlcc as nlcc_mod

        self._fire("nlcc")
        before = self.state
        self.state = nlcc_mod.verify_constraint(
            self.dg, before, c, wave=self.wave, stats=cstats,
            count_messages=self.collect_stats, route=self.nlcc_route,
            direction=direction, edge_prune=self.nlcc_edge_prune,
            template=self.template)
        return _state_changed(before, self.state)

    def tds(self, c: NonLocalConstraint, cstats: Dict) -> torch.Tensor:
        from repro_torch.core import tds as tds_mod

        self._fire("tds")
        before = self.state
        self.state = tds_mod.verify_tds_constraint(
            self.dg, before, c, chunk=self.tds_chunk,
            max_rows=self.tds_max_rows, stats=cstats,
            annotate=(c.complete and self.guarantee_precision),
            dedup=self.work_aggregation,
        )
        return _state_changed(before, self.state)


def _state_changed(before: PruneState, after: PruneState) -> torch.Tensor:
    """Device-side change flag: omega and edge bits only ever clear, so a
    bitwise compare says whether anything was eliminated."""
    return torch.any(before.omega != after.omega) | torch.any(
        before.edge_active != after.edge_active)




# ---------------------------------------------------------------------------
# The collective interface every sharded program is written against
# ---------------------------------------------------------------------------
class Prims(NamedTuple):
    """The collectives of one sharded backend. A program's tensors carry a
    leading axis of the Pl shards this process holds (Pl = P under `sim`,
    1 under `spmd`)."""

    # [Pl, P, ...] send buckets (bucket q goes to shard q) -> [Pl, P, ...]
    # received buckets (slice q = what shard q sent here)
    exchange: Callable
    # bool[Pl] -> bool scalar tensor: OR over all shards, the same on every
    # rank (a host decision may read it)
    all_reduce_or: Callable
    # [Pl, ...] int -> [Pl, ...]: the sum over all shards, in every slot
    psum: Callable
    # () -> int64[Pl]: the shards this process holds
    axis_index: Callable
    # [Pl, P, Br, C] keyed row buckets -> received buckets, as `exchange`
    exchange_rows: Callable
    # overlap(step, carry, max_iters) -> (carry, iters): the lagged
    # fixpoint, `step: carry -> (carry, changed bool[Pl])`
    overlap: Callable
    # [Pl, ...] -> [P, ...]: every shard's block, on every rank
    gather: Callable
    # a value every rank holds alike (a parameter) -> this rank's use of it:
    # the identity, whose backward reduces the gradient over the ranks (the
    # transpose of a replicated shard_map input); None where all shards are
    # in this process and autograd sums their uses itself
    replicate: Optional[Callable] = None


def _overlap_lagged(all_reduce_or: Callable) -> Callable:
    """The reference's pipelined fixpoint: sweep i's change flag is read on
    the host only after sweep i + 1 has been queued, so the reduction and
    the read overlap the next sweep. It runs one sweep past the first
    unchanged one (a no-op: the sweeps are monotone) and counts it, so a
    call that changes nothing counts 2 iterations."""

    def overlap(step: Callable, carry, max_iters: int = 1000):
        it, pending = 0, None
        while it < max_iters:
            carry, ch = step(carry)
            it += 1
            if pending is not None and not bool(all_reduce_or(pending)):
                break
            pending = ch
        return carry, it

    return overlap


def sim_prims(P: int, device) -> Prims:
    """All P shards in this process: the exchange is a transpose of the
    leading two axes, the reductions reduce over the shard axis."""
    ids = torch.arange(P, dtype=torch.int64, device=device)

    def exchange(x):
        return x.transpose(0, 1).contiguous()

    def psum(x):
        return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x)

    all_reduce_or = lambda f: f.any()  # noqa: E731
    return Prims(exchange=exchange, all_reduce_or=all_reduce_or, psum=psum,
                 axis_index=lambda: ids, exchange_rows=exchange,
                 overlap=_overlap_lagged(all_reduce_or),
                 gather=lambda x: x)


def spmd_prims(group, P: int, rank: int, device) -> Prims:
    """One shard per rank of a `torch.distributed` group. Bools travel as
    uint8 (no collective carries bool)."""
    import torch.distributed as dist

    ids = torch.tensor([rank], dtype=torch.int64, device=device)

    def exchange(x):
        inp = x[0].contiguous()
        wire = inp.to(torch.uint8) if inp.dtype == torch.bool else inp
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=group)
        return (out.to(torch.bool) if inp.dtype == torch.bool else out)[None]

    def all_reduce_or(f):
        t = f.any().to(torch.uint8).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t[0].to(torch.bool)

    def psum(x):
        t = x.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def gather(x):
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in range(P)]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts, dim=0)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    return Prims(exchange=exchange, all_reduce_or=all_reduce_or, psum=psum,
                 axis_index=lambda: ids, exchange_rows=exchange,
                 overlap=_overlap_lagged(all_reduce_or), gather=gather)


# ---------------------------------------------------------------------------
# Static shard arrays
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardArrays:
    """The static partition arrays of the shards this process holds, on the
    device, with the flat int32 indices the programs gather by (built once,
    so no sweep makes an index copy)."""

    P: int
    B: int
    n_local: int
    shards: torch.Tensor          # int64[Pl]
    send_live: torch.Tensor       # bool[Pl, P, B]: not a pad slot
    send_flat: torch.Tensor       # int32[Pl*P*B]: row of [Pl*(n_local+1), W]
    sink_flat: torch.Tensor       # int32[Pl*P*B]: the slot's shard's zero row
    twin_flat: torch.Tensor       # int32[Pl*P*B]: row of [Pl*(P*B+1), W]
    recv_perm_flat: torch.Tensor  # int32[Pl*P*B]: row of [Pl*P*B, W]
    recv_seg: torch.Tensor        # int32[Pl*P*B]: segment of [Pl*(n_local+1)]
    labels_local: torch.Tensor    # int32[Pl, n_local]
    vertex_valid: torch.Tensor    # bool[Pl, n_local]
    rx_src: torch.Tensor          # int32[M]: row of the stacked receive buffers
    rx_dst: torch.Tensor          # int32[M]: row of [Pl*n_local, W]
    rx_ptr: torch.Tensor          # int64[Pl*n_local + 1]

    @property
    def Pl(self) -> int:
        return int(self.shards.shape[0])

    @staticmethod
    def build(part: EdgePartition, shards: Sequence[int], device) -> "ShardArrays":
        d = part.device_arrays(device)
        P, B, nl = part.P, part.B, part.n_local
        S = P * B
        sh = torch.tensor(list(shards), dtype=torch.int64, device=device)
        Pl = int(sh.shape[0])
        loc = torch.arange(Pl, dtype=torch.int32, device=device)

        def take(name):
            return d[name] if Pl == P else d[name].index_select(0, sh)

        def flat(x, row_len):
            return (x + (loc * row_len).view((Pl,) + (1,) * (x.dim() - 1))
                    ).reshape(-1)

        rsd = take("recv_sorted_dst_local")
        if Pl == P:
            rx_src, rx_dst, rx_ptr = d["rx_src"], d["rx_dst"], d["rx_ptr"]
        else:
            # one shard's run of the all-shards receive list, renumbered
            ptr = d["rx_ptr"]
            r = int(shards[0])
            lo, hi = int(ptr[r * nl]), int(ptr[(r + 1) * nl])
            rx_src = d["rx_src"][lo:hi] - r * S
            rx_dst = d["rx_dst"][lo:hi] - r * nl
            rx_ptr = ptr[r * nl: (r + 1) * nl + 1] - lo
        return ShardArrays(
            P=P, B=B, n_local=nl, shards=sh,
            send_live=~take("send_pad"),
            send_flat=flat(take("send_src_local"), nl + 1),
            sink_flat=flat(torch.full_like(take("send_src_local"), nl), nl + 1),
            twin_flat=flat(take("twin_recv_flat"), S + 1),
            recv_perm_flat=flat(take("recv_perm"), S),
            recv_seg=flat(torch.clamp(rsd, max=nl), nl + 1),
            labels_local=take("labels_local"),
            vertex_valid=take("vertex_valid"),
            rx_src=rx_src, rx_dst=rx_dst, rx_ptr=rx_ptr)


def _rows(x: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Rows of a [Pl, R, W] tensor (R rows per shard) at flat indices into
    its [Pl*R, W] view."""
    return x.reshape(-1, x.shape[-1]).index_select(0, flat_idx)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """[Pl, n, W] -> [Pl, n+1, W] with a zero padding-sink row."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)


# ---------------------------------------------------------------------------
# Shard programs
# ---------------------------------------------------------------------------
def _aggregate_or(recv: torch.Tensor, sa: ShardArrays) -> torch.Tensor:
    """OR the received [Pl, P, B, W] messages into [Pl, n_local, W] along
    the static dst-sorted receive arc list: `bitset_spmm` for packed words
    (one launch for every shard held), a segment OR for boolean planes."""
    from repro_torch.kernels import ops as kops

    Pl, W, nl = sa.Pl, recv.shape[-1], sa.n_local
    flat = recv.reshape(-1, W)
    if flat.dtype == torch.bool:
        out = segment_ops.segment_or_bool(
            flat.index_select(0, sa.rx_src), sa.rx_dst, Pl * nl)
    else:
        out = kops.bitset_segment_or(flat, sa.rx_src, sa.rx_dst, sa.rx_ptr,
                                     Pl * nl)
    return out.view(Pl, nl, W)


def _send_index(send_mask: torch.Tensor, sa: ShardArrays) -> torch.Tensor:
    """int32[Pl*P*B]: the row each send slot gathers, its shard's zero
    padding row where the arc is inactive (so no pass zeroes the
    messages)."""
    return torch.where(send_mask.reshape(-1), sa.send_flat, sa.sink_flat)


def _send(words: torch.Tensor, send_mask: torch.Tensor, sa: ShardArrays,
          prims: Prims) -> torch.Tensor:
    """Gather each shard's words (zero for inactive arcs) into its send
    buckets and exchange: [Pl, n_local+1, W] -> received [Pl, P, B, W]."""
    msgs = _rows(words, _send_index(send_mask, sa))
    return prims.exchange(msgs.view(sa.Pl, sa.P, sa.B, words.shape[-1]))


def lcc_shard_iteration(omega: torch.Tensor, edge_active: torch.Tensor,
                        sa: ShardArrays, tm: TemplateDev, prims: Prims
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LCC sweep: gather the senders' omega words (int32[Pl, n_local+1,
    W]) over the send buckets, masked by the per-arc active bits
    (bool[Pl, P, B]), one exchange, then the receive-side OR.
    -> (omega, edge_active, changed bool[Pl])."""
    send_mask = edge_active & sa.send_live
    recv = _send(omega, send_mask, sa, prims)
    return _lcc_from_recv(omega, edge_active, recv, sa, tm)


def lcc_shard_fixpoint(omega, edge_active, sa: ShardArrays, tm: TemplateDev,
                       prims: Prims, max_iters: int = 1000):
    """The LCC do-while on the backend's `overlap` schedule (lagged)."""

    def step(c):
        om, ea = c
        om2, ea2, ch = lcc_shard_iteration(om, ea, sa, tm, prims)
        return (om2, ea2), ch

    (om, ea), it = prims.overlap(step, (omega, edge_active), max_iters)
    return om, ea, it


def sweep_vertex_test(om_bits: torch.Tensor, M: torch.Tensor,
                      adj0_f: torch.Tensor, deg_pos: torch.Tensor
                      ) -> torch.Tensor:
    """The LCC sweep's vertex test, over a leading axis of shards (the
    shard programs) or of lanes (`core/batch.py`): q stays in omega(v)
    (om_bits bool[.., n, n0]) if every template neighbour of q is covered
    in M[v] (the OR of the words v received), and, if q has a template
    neighbour at all (deg_pos), v has some covered neighbour. adj0_f
    f32[(..,) n0, n0] and deg_pos bool[.., n0] broadcast over the axis."""
    covered = torch.matmul((~M).to(torch.float32),
                           adj0_f.transpose(-1, -2)) < 0.5
    return om_bits & covered & (~deg_pos | M.any(dim=-1, keepdim=True))


def counted_label_bits(bits: torch.Tensor, has_label: torch.Tensor
                       ) -> torch.Tensor:
    """bool[.., C]: a neighbour counts toward counted label c iff its word
    (bits bool[.., n0]) meets the template vertices carrying c (has_label
    f32[(..,) n0, C])."""
    return torch.matmul(bits.to(torch.float32), has_label) > 0.5


def counts_meet(cnt: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """The multiplicity test: cnt int32[.., n, C] neighbours of v per
    counted label against req int32[(..,) n0, C] -> bool[.., n, n0]."""
    return torch.all(cnt[..., :, None, :] >= req[..., None, :, :], dim=-1)


def side_words(om_bits: torch.Tensor, adj0_f: torch.Tensor) -> torch.Tensor:
    """The sweep's arc test, sender side: the template vertices adjacent to
    some q in omega(u), packed -> int32[.., n, W]. Arc u -> v stays if its
    side word meets the word of v that the sweep found (and both it and its
    twin are active)."""
    return pack_bits(torch.matmul(om_bits.to(torch.float32), adj0_f) > 0.5)


def _lcc_from_recv(omega, edge_active, recv, sa: ShardArrays, tm: TemplateDev):
    """The sweep's eliminations from the received messages
    (`sweep_vertex_test`, with the multiplicity counts over the received
    words); arc u -> v needs a template arc between omega(u) and its twin's
    received word, which is zero unless the twin is active: both as the
    sweep found them. The twin's word comes out of the same receive buffer
    (`twin_flat`): no other collective."""
    Pl, nl, W, n0 = sa.Pl, sa.n_local, omega.shape[-1], tm.n0
    send_mask = edge_active & sa.send_live
    M = unpack_bits(_aggregate_or(recv, sa), n0)           # bool[Pl, nl, n0]
    om_bits = unpack_bits(omega[:, :nl], n0)
    new_bits = sweep_vertex_test(om_bits, M, tm.adj0_f, tm.deg_pos)
    if tm.needs_counts:
        rbits = unpack_bits(_rows(recv.reshape(Pl, -1, W), sa.recv_perm_flat), n0)
        ind = counted_label_bits(rbits, tm.vertex_has_counted_label)
        cnt = segment_ops.segment_sum(ind.to(torch.int32), sa.recv_seg,
                                      Pl * (nl + 1)).view(Pl, nl + 1, -1)[:, :nl]
        new_bits &= counts_meet(cnt, tm.req)
    new_bits &= sa.vertex_valid[..., None]
    ea_new = _twin_test(om_bits, recv, send_mask, sa, tm)
    omega_new = _pad_row(pack_bits(new_bits))
    changed = ((omega_new != omega).flatten(1).any(dim=1)
               | (ea_new != edge_active).flatten(1).any(dim=1))
    return omega_new, ea_new, changed


def _twin_test(om_bits: torch.Tensor, recv: torch.Tensor,
               send_mask: torch.Tensor, sa: ShardArrays, tm: TemplateDev
               ) -> torch.Tensor:
    """The sweep's arc test -> edge_active bool[Pl, P, B]: arc u -> v stays
    if active and its side word (`side_words` of om_bits bool[Pl, n_local,
    n0], the sender's) meets the word its twin v -> u brought in `recv`
    (zero unless the twin is active)."""
    Pl, W = sa.Pl, recv.shape[-1]
    side = _pad_row(side_words(om_bits, tm.adj0_f))
    recv_sink = torch.cat([recv.reshape(Pl, -1, W),
                           recv.new_zeros((Pl, 1, W))], dim=1)
    twin_words = _rows(recv_sink, sa.twin_flat)
    compat = (_rows(side, sa.send_flat) & twin_words).ne(0).any(dim=-1)
    return send_mask & compat.view(Pl, sa.P, sa.B)


def frontier_shard_hop(frontier: torch.Tensor, edge_active: torch.Tensor,
                       sa: ShardArrays, cand_next: torch.Tensor,
                       prims: Prims) -> torch.Tensor:
    """One NLCC token hop (paper Alg. 6 forward) of J jobs at once: each
    job's frontier[j] (int32[Pl, n_local+1, S/32] packed multi-source words,
    or bool[Pl, n_local+1, S] boolean planes, 32x the exchange bytes) goes
    over its own active arcs edge_active[j] (bool[Pl, P, B]) and is masked
    by cand_next[j] (bool[Pl, n_local]), the next walk vertex's candidacy.
    The jobs' words share one send buffer ([slots, J, R]), one exchange and
    one receive OR (one `bitset_spmm` launch for packed words)."""
    J, Pl, rows, R = frontier.shape
    nl = sa.n_local
    idx = torch.where((edge_active & sa.send_live).reshape(J, -1),
                      sa.send_flat, sa.sink_flat)
    if J > 1:
        idx = idx + (torch.arange(J, device=idx.device, dtype=idx.dtype)
                     * (Pl * rows))[:, None]
    msgs = frontier.reshape(J * Pl * rows, R).index_select(0, idx.t().reshape(-1))
    recv = prims.exchange(msgs.view(Pl, sa.P, sa.B, J * R))
    del msgs
    agg = _aggregate_or(recv, sa).view(Pl, nl, J, R)
    del recv
    agg.masked_fill_(~cand_next.permute(1, 2, 0)[..., None], 0)
    out = frontier.new_zeros((J, Pl, rows, R))
    out[:, :, :nl] = agg.permute(2, 0, 1, 3)
    return out


def sharded_wave_frontier(cand: torch.Tensor, source_ids: torch.Tensor,
                          edge_active: torch.Tensor, sa: ShardArrays,
                          prims: Prims, packed: bool) -> torch.Tensor:
    """Seed and L hops of one wave of J jobs: cand bool[J, Pl, L+1,
    n_local] (each job's walk candidacy), source_ids int64[J, S] and
    edge_active bool[J, Pl, P, B] -> the hop-L frontiers [J, Pl,
    n_local+1, R] (packed words, or boolean planes)."""
    f = _seed_frontier(cand[:, :, 0], source_ids, sa.n_local,
                       prims.axis_index(), packed)
    for r in range(1, cand.shape[2]):
        f = frontier_shard_hop(f, edge_active, sa, cand[:, :, r], prims)
    return f


def init_sharded_state(part: EdgePartition, template: Template,
                       sa: ShardArrays) -> Tuple[torch.Tensor, torch.Tensor]:
    """(omega int32[Pl, n_local+1, W] from labels, the last row the padding
    sink; edge_active bool[Pl, P, B], every real arc active)."""
    n_labels = int(max(template.labels.max() + 1, part.labels_local.max() + 1))
    lm = torch.from_numpy(template.label_matrix(n_labels)).to(sa.shards.device)
    bits = lm.T[sa.labels_local.long()] & sa.vertex_valid[..., None]
    return _pad_row(pack_bits(bits)), sa.send_live.clone()


# ---------------------------------------------------------------------------
# Sharded NLCC wave helpers
# ---------------------------------------------------------------------------
def _owner_local(source_ids: torch.Tensor, n_local: int, p: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global wave-source ids int64[J, S] -> (local rows int64[J, Pl, S],
    valid bool[J, S]): sources a shard does not own, and pads (-1), land on
    its padding-sink row n_local."""
    valid = source_ids >= 0
    owner = torch.where(valid, torch.div(source_ids, n_local, rounding_mode="floor"), -1)
    local = torch.where(owner[:, None, :] == p[None, :, None],
                        torch.remainder(source_ids, n_local)[:, None, :], n_local)
    return local, valid


def _seed_frontier(cand0: torch.Tensor, source_ids: torch.Tensor, n_local: int,
                   p: torch.Tensor, packed: bool) -> torch.Tensor:
    """F_0 of J jobs (cand0 bool[J, Pl, n_local], source_ids int64[J, S]):
    one token per wave source, seeded at candidate sources on their owner
    shard: packed words int32[J, Pl, n_local+1, S/32] or boolean planes
    bool[J, Pl, n_local+1, S]."""
    J, Pl, S = cand0.shape[0], cand0.shape[1], source_ids.shape[1]
    dev = cand0.device
    local, valid = _owner_local(source_ids, n_local, p)
    cand0x = torch.cat([cand0, cand0.new_zeros((J, Pl, 1))], dim=2)
    seed = valid[:, None, :] & torch.gather(cand0x, 2, local)     # [J, Pl, S]
    row = (torch.arange(J * Pl, device=dev).view(J, Pl, 1) * (n_local + 1)
           + local)
    s = torch.arange(S, device=dev).expand(J, Pl, S)
    rows = J * Pl * (n_local + 1)
    if not packed:
        f = torch.zeros((rows, S), dtype=torch.bool, device=dev)
        f[row[seed], s[seed]] = True
        return f.view(J, Pl, n_local + 1, S)
    Wf = S // 32
    f = torch.zeros(rows * Wf, dtype=torch.int32, device=dev)
    bit = as_int32_bits(torch.ones(S, dtype=torch.int64, device=dev)
                        << (torch.arange(S, device=dev) % 32))
    # sources are distinct vertices: each (row, word) takes at most one bit
    f[(row * Wf + s // 32)[seed]] = bit.expand(J, Pl, S)[seed]
    return f.view(J, Pl, n_local + 1, Wf)


def _source_bits(f: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """int32[J, Pl, S]: source s's bit in row local[j, :, s] of job j's
    hop-L frontier (packed words or boolean planes); the padding-sink row
    reads 0."""
    J, Pl, S = local.shape
    j = torch.arange(J, device=f.device)[:, None, None]
    p = torch.arange(Pl, device=f.device)[None, :, None]
    s = torch.arange(S, device=f.device)
    if f.dtype == torch.bool:
        return f[j, p, local, s].to(torch.int32)
    return (f[j, p, local, s // 32] >> (s % 32)) & 1


def _column_counts(f: torch.Tensor, S: int) -> torch.Tensor:
    """int32[J, Pl, S]: per job and source s, the real rows of a hop-L
    frontier that hold its bit."""
    body = f[:, :, :-1]
    if body.dtype == torch.bool:
        return body.sum(dim=2, dtype=torch.int32)
    per_bit = [((body >> b) & 1).sum(dim=2, dtype=torch.int32)
               for b in range(32)]                           # each [J, Pl, Wf]
    return torch.stack(per_bit, dim=-1).reshape(f.shape[0], f.shape[1], -1)[..., :S]


def sharded_wave_keep(f: torch.Tensor, source_ids: torch.Tensor,
                      keep: torch.Tensor, n_local: int, is_cyclic: bool,
                      prims: Prims) -> torch.Tensor:
    """The survivor decisions of a finished wave of J jobs (hop-L frontiers
    f [J, Pl, n_local+1, R], source_ids int64[J, S]), ORed into their keep
    columns keep int32[J, Pl, n_local+1] in place -> keep. CC: the token
    returned to its source. PC: the paper's `ack`, the token reached a
    vertex other than its source. The per-shard partials of every job are
    psum-combined in one reduction, so the decision is the same on every
    shard; pads and sources owned elsewhere hit the padding-sink row (amax
    cannot unset a bit)."""
    local, valid = _owner_local(source_ids, n_local, prims.axis_index())
    parts = [_source_bits(f, local)]
    if not is_cyclic:
        parts.append(_column_counts(f, source_ids.shape[1]))
    tot = prims.psum(torch.stack(parts).permute(2, 0, 1, 3))  # [Pl, k, J, S]
    self_tot = tot[:, 0].transpose(0, 1)                       # [J, Pl, S]
    if is_cyclic:
        survived = self_tot > 0
    else:
        cnt_tot = tot[:, 1].transpose(0, 1)
        survived = (cnt_tot > 0) & (cnt_tot > self_tot)
    survived &= valid[:, None, :]
    return keep.scatter_reduce_(2, local, survived.to(torch.int32), "amax",
                                include_self=True)


# The JAX package's gate of its fused wave (`BITSET_WAVE_VMEM_BUDGET`,
# src/repro/kernels/ops.py:95, the TPU kernel's VMEM budget), kept as the
# reference's number so the port resolves the same routes at the same
# shapes. It has nothing to do with the card's memory.
SHARDED_FUSED_BUDGET = 12 * 1024 * 1024


def sharded_fused_resident_bytes(n_local: int, Pn: int, B: int, wave: int, L: int) -> int:
    """Per-shard resident working set of the fused wave, as the reference
    counts it: the frontier in and out and the aggregate words, the receive
    buffer, and the candidacy stack."""
    Wf = max(wave // 32, 1)
    return (
        3 * (n_local + 1) * Wf * 4  # frontier in/out + aggregate
        + Pn * B * Wf * 4           # exchange receive buffer
        + (L + 1) * n_local         # candidacy stack (bool)
    )


def sharded_fused_eligible(n_local: int, Pn: int, B: int, wave: int, L: int) -> bool:
    """The reference's fused-route gate on shard-local shapes."""
    return sharded_fused_resident_bytes(n_local, Pn, B, wave, L) <= SHARDED_FUSED_BUDGET


def sharded_nlcc_route(bucket, Pl: int, Pn: int, B: int, n_local: int,
                       wave: int, L: int, backend: str) -> str:
    """The NLCC route of a sharded wave of L hops, for the single sharded
    prune (`bucket` its shard bucket) and the sharded batch (its batch
    bucket) alike: the policy's route under the bucket, fused by default
    where the reference's gate admits it, else packed; a fused choice the
    gate refuses runs packed. On the card a policy's unpacked choice runs
    only where one job's boolean message plane (Pl*P*B slots x wave) fits
    `nlcc.UNPACKED_PLANE_BYTES`; past it the packed route runs."""
    if wave % 32 != 0:
        return registry.ROUTE_UNPACKED
    eligible = sharded_fused_eligible(n_local, Pn, B, wave, L)
    route = registry.resolve_route(
        NLCC_ROUTE, bucket,
        default=registry.ROUTE_FUSED if eligible else registry.ROUTE_PACKED,
        backend=backend, allowed=registry.NLCC_ROUTES)
    if route == registry.ROUTE_FUSED and not eligible:
        route = registry.ROUTE_PACKED
    if (route == registry.ROUTE_UNPACKED and backend == "cuda"
            and Pl * Pn * B * wave > UNPACKED_PLANE_BYTES):
        route = registry.ROUTE_PACKED
    return route


# ---------------------------------------------------------------------------
# Sharded backends
# ---------------------------------------------------------------------------
class _ShardedBackend:
    """What the sim and spmd backends share: the state layout, the gather
    and scatter bridge, the LCC fixpoint and the wave executor. A subclass
    supplies its `Prims` and the shards it holds."""

    name = "sharded"

    def __init__(self, graph: Graph, dg: DeviceGraph, template: Template,
                 part: EdgePartition, *, prims: Prims, shards: Sequence[int],
                 wave: int = 1024, collect_stats: bool = False,
                 nlcc_edge_prune: bool = False, tds_chunk: int = 4096,
                 tds_max_rows: int = 2_000_000, work_aggregation: bool = True,
                 guarantee_precision: bool = True,
                 edge_elimination: bool = True,
                 arc_order: Optional[np.ndarray] = None,
                 injector=None):
        if not edge_elimination:
            raise ValueError(
                "edge_elimination=False (the Fig-6a ablation) is a "
                "local-backend-only mode; run it without mesh=/partition=")
        if part.arc_flat_slot is None:
            raise ValueError("EdgePartition lacks arc_flat_slot; rebuild it")
        if part.P * part.P * part.B >= 2**31:
            # the arc-slot map below is int32: refuse rather than wrap
            raise NotImplementedError(
                f"bucket tensor has {part.P * part.P * part.B} >= 2^31 slots;"
                " the int32 edge gather/scatter map would overflow; shard"
                " the graph coarser or add a 64-bit map")
        self.dg = dg
        self.template = template
        self.tdev = TemplateDev(template, dg.device)
        self.part = part
        self.P, self.B, self.n_local = part.P, part.B, part.n_local
        self.wave = wave
        self.collect_stats = collect_stats
        self.nlcc_edge_prune = nlcc_edge_prune
        self.tds_chunk = tds_chunk
        self.tds_max_rows = tds_max_rows
        self.work_aggregation = work_aggregation
        self.guarantee_precision = guarantee_precision
        self.injector = injector
        if injector is not None:
            from repro_torch.core.resilience import instrument_prims

            prims = instrument_prims(prims, injector)
        self.prims = prims
        self.sa = ShardArrays.build(part, shards, dg.device)
        # slot of each of the DeviceGraph's dst-sorted arcs in the flat
        # [P, P, B] buckets: the edge_active gather/scatter map
        order = (arc_order if arc_order is not None
                 else DeviceGraph.dst_sort_order(graph))
        self._arc_slot = torch.from_numpy(
            part.arc_flat_slot[order].astype(np.int32)).to(dg.device)
        self._nlcc_routes_taken: set = set()
        self.omega_all: Optional[torch.Tensor] = None   # int32[Pl, n_local+1, W]
        self.ea_all: Optional[torch.Tensor] = None      # bool[Pl, P, B]

    # -- state --------------------------------------------------------------
    def init(self, initial_state: Optional[PruneState]) -> None:
        if initial_state is None:
            self.omega_all, self.ea_all = init_sharded_state(
                self.part, self.template, self.sa)
        else:
            self.omega_all, self.ea_all = self.scatter_state(initial_state)

    def gather_state(self) -> PruneState:
        """The global PruneState (dst-sorted DeviceGraph arc order) of the
        sharded arrays, on every rank: the bridge TDS, the edge-prune pass
        and the final result use."""
        return self.gather_arrays(self.omega_all, self.ea_all, self.tdev.n0)

    def gather_arrays(self, omega_all: torch.Tensor, ea_all: torch.Tensor,
                      n0: int) -> PruneState:
        """`gather_state` of any shard arrays of this layout (the batched
        engine's lanes), omega cut to n0 columns."""
        om = self.prims.gather(omega_all)[:, :self.n_local]
        omega = unpack_bits(om.reshape(self.P * self.n_local, -1),
                            n0)[:self.part.n]
        ea = self.prims.gather(ea_all).reshape(-1)[self._arc_slot]
        return PruneState(omega=omega, edge_active=ea)

    def scatter_state(self, state: PruneState, width: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The inverse of gather_state: the shards this process holds of a
        global PruneState, omega padded to `width` columns (the template's
        n0 unless given)."""
        n, P, nl = self.part.n, self.P, self.n_local
        dev = self.dg.device
        n0 = state.omega.shape[1]
        bits = torch.zeros((P * nl, width or self.tdev.n0), dtype=torch.bool,
                           device=dev)
        bits[:n, :n0] = state.omega.to(dev)
        omega = _pad_row(pack_bits(bits).view(P, nl, -1))
        ea = torch.zeros(P * P * self.B, dtype=torch.bool, device=dev)
        ea[self._arc_slot.long()] = state.edge_active.to(dev)
        ea = ea.view(P, P, self.B)
        sh = self.sa.shards
        return omega.index_select(0, sh), ea.index_select(0, sh)

    def final_state(self) -> PruneState:
        return self.gather_state()

    # -- resilience seam ----------------------------------------------------
    def snapshot(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The phase-entry shard arrays for the ladder's in-place retry, as
        copies (see `LocalBackend.snapshot`)."""
        return self.omega_all.clone(), self.ea_all.clone()

    def restore_snapshot(self, snap) -> None:
        self.omega_all, self.ea_all = snap[0].clone(), snap[1].clone()

    def _fire(self, site: str, **ctx) -> None:
        """A fault-injection seam between device dispatches, where a lost
        rank would surface."""
        if self.injector is not None:
            self.injector.event(site, **ctx)

    # -- reporting ----------------------------------------------------------
    def record_routes(self, stats: Dict) -> None:
        """prune.lcc is packed words by construction; prune.nlcc starts as
        the estimate for a 3-hop wave and `finalize_stats` replaces it with
        the routes taken."""
        stats["dispatch_routes"] = {LCC_ROUTE: registry.ROUTE_PACKED,
                                    NLCC_ROUTE: self._nlcc_route()}
        stats["dispatch_policy_active"] = registry.get_policy() is not None
        stats["sharded"] = {
            "backend": self.name, "P": self.P,
            "bucket": registry.bucket_key(
                registry.shard_bucket(self.P, self.n_local, self.wave)),
        }

    def _shard_counts(self) -> torch.Tensor:
        """int64[Pl, 3]: per shard held, active vertices, active arcs, omega
        bits."""
        om = self.omega_all[:, :self.n_local]
        bits = unpack_bits(om, self.tdev.n0)
        return torch.stack([bits.any(dim=-1).sum(dim=-1),
                            self.ea_all.flatten(1).sum(dim=-1),
                            bits.flatten(1).sum(dim=-1)], dim=-1)

    def counts_dev(self) -> torch.Tensor:
        """[active_vertices, active_edges, omega_bits] over all shards."""
        return self.prims.psum(self._shard_counts())[0]

    def shard_counts_dev(self) -> torch.Tensor:
        """int64[P, 2] per shard: active vertices and active arcs, computed
        shard-locally (every arc lives at its source's shard)."""
        return self.prims.gather(self._shard_counts()[:, :2])

    def counts_host(self) -> Dict[str, int]:
        c = self.counts_dev().cpu().numpy()
        return {"active_vertices": int(c[0]), "active_edges": int(c[1]),
                "omega_bits": int(c[2])}

    def sync(self) -> None:
        if self.dg.device.type == "cuda":
            torch.cuda.synchronize(self.dg.device)

    def finalize_stats(self, stats: Dict) -> None:
        """The routes the wave executor took ("fused+packed" when several),
        "none" when no wave ran."""
        if "dispatch_routes" in stats:
            stats["dispatch_routes"][NLCC_ROUTE] = (
                "+".join(sorted(self._nlcc_routes_taken))
                if self._nlcc_routes_taken else "none")

    # -- LCC ----------------------------------------------------------------
    def lcc(self, stats: Dict) -> None:
        self._fire("lcc")
        self.omega_all, self.ea_all, it = lcc_shard_fixpoint(
            self.omega_all, self.ea_all, self.sa, self.tdev, self.prims)
        if stats is not None:
            stats["lcc_iterations"] = stats.get("lcc_iterations", 0) + it
            stats["lcc_calls"] = stats.get("lcc_calls", 0) + 1

    # -- NLCC cycle/path ----------------------------------------------------
    def _nlcc_route(self, length: int = 3) -> str:
        return sharded_nlcc_route(
            registry.shard_bucket(self.P, self.n_local, self.wave),
            self.sa.Pl, self.P, self.B, self.n_local, self.wave, length,
            self.dg.device.type)

    def _omega_column(self, q: int) -> torch.Tensor:
        """bool[Pl, n_local] candidacy of template vertex q."""
        w, b = q // 32, q % 32
        return ((self.omega_all[:, :self.n_local, w] >> b) & 1).to(torch.bool)

    def _cand_stack(self, walk: Sequence[int]) -> torch.Tensor:
        return torch.stack([self._omega_column(q) for q in walk], dim=1)  # [Pl, L+1, nl]

    def nlcc(self, c: NonLocalConstraint, cstats: Dict,
             direction: str = "default") -> torch.Tensor:
        from repro_torch.core import nlcc as nlcc_mod

        self._fire("nlcc")
        # taken before the edge-prune bridge: its eliminations count toward
        # the change flag that triggers the LCC re-run
        omega_before, ea_before = self.omega_all, self.ea_all
        if self.nlcc_edge_prune:
            state = self.gather_state()
            new = nlcc_mod._edge_prune_pass(
                self.dg, state, c, self.template, self.wave, cstats)
            if new is not state:
                self.omega_all, self.ea_all = self.scatter_state(new)

        walks = nlcc_mod.expand_walks(c, direction)
        heads = [w[0] for w in walks]
        L = len(walks[0]) - 1
        route = self._nlcc_route(L)
        self._nlcc_routes_taken.add(route)
        wave_stat = {
            registry.ROUTE_FUSED: "nlcc_fused_waves",
            registry.ROUTE_PACKED: "nlcc_packed_waves",
            registry.ROUTE_UNPACKED: "nlcc_plane_waves",
        }[route]
        # one host read per constraint: the head-candidacy planes of every
        # shard (one all-gather under spmd) size the wave loops
        heads_local = torch.stack([self._omega_column(q) for q in heads], dim=1)
        head_planes = self.prims.gather(heads_local).cpu().numpy()  # [P, H, nl]
        head_global = head_planes.transpose(1, 0, 2).reshape(
            len(heads), -1)[:, :self.part.n]
        dev = self.dg.device
        keep_cols = [torch.zeros((self.sa.Pl, self.n_local + 1),
                                 dtype=torch.int32, device=dev) for _ in walks]
        n_waves = n_tokens = n_overlapped = 0
        for wi, walk in enumerate(walks):
            cand = self._cand_stack(walk)
            is_cyclic = walk[0] == walk[-1]
            sources = np.flatnonzero(head_global[wi])
            # one wave deep: a wave's survivor reduction (its only psum) is
            # queued after the next wave's hops; flushed at the walk's end
            pending = None
            for idsp, n_real in nlcc_mod.wave_batches(sources, self.wave):
                # wave k fires before it is dispatched, numbered across the
                # constraint's walks
                self._fire("wave", wave=n_waves)
                ids_dev = torch.from_numpy(idsp.astype(np.int64)).to(dev)
                if route == registry.ROUTE_FUSED and pending is not None:
                    keep_cols[wi], f = self._wave_overlapped(
                        L, is_cyclic, cand, keep_cols[wi],
                        pending[0], pending[1], ids_dev)
                    n_overlapped += 1
                else:
                    f = self._wave_frontier(route, L, cand, ids_dev)
                    if pending is not None:
                        keep_cols[wi] = self._wave_finish(
                            is_cyclic, pending[0], keep_cols[wi], pending[1])
                        n_overlapped += 1
                pending = (f, ids_dev)
                n_waves += 1
                n_tokens += n_real
            if pending is not None:
                keep_cols[wi] = self._wave_finish(
                    is_cyclic, pending[0], keep_cols[wi], pending[1])
        # remove head candidacy from failing sources (Alg. 5 line 8), on device
        omega = self.omega_all.clone()
        for wi, q0 in enumerate(heads):
            w, b = q0 // 32, q0 % 32
            clear = int(as_int32_bits(torch.tensor(0xFFFFFFFF ^ (1 << b))))
            word = omega[..., w]
            omega[..., w] = torch.where(keep_cols[wi] > 0, word, word & clear)
        self.omega_all = omega
        if cstats is not None:
            cstats["nlcc_tokens"] = cstats.get("nlcc_tokens", 0) + n_tokens
            cstats[wave_stat] = cstats.get(wave_stat, 0) + n_waves
            cstats["nlcc_constraints"] = cstats.get("nlcc_constraints", 0) + 1
            cstats["nlcc_waves"] = cstats.get("nlcc_waves", 0) + n_waves
            cstats["nlcc_overlapped_waves"] = (
                cstats.get("nlcc_overlapped_waves", 0) + n_overlapped)
            cstats["nlcc_host_syncs"] = cstats.get("nlcc_host_syncs", 0) + 1
        changed = ((omega_before != self.omega_all).flatten(1).any(dim=1)
                   | (ea_before != self.ea_all).flatten(1).any(dim=1))
        return self.prims.all_reduce_or(changed)

    # -- wave stages ----------------------------------------------------------
    def _wave_frontier(self, route: str, L: int, cand: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
        """Seed and L hops of one wave -> the hop-L frontier [1, Pl,
        n_local+1, R] (packed words, or boolean planes on the unpacked
        route). The fused route runs them as one program, the packed and
        unpacked routes a program per hop: the same hops."""
        return sharded_wave_frontier(
            cand[None], ids[None], self.ea_all[None], self.sa, self.prims,
            packed=route != registry.ROUTE_UNPACKED)

    def _wave_finish(self, is_cyclic: bool, f: torch.Tensor,
                     keep: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """A finished wave's survivor decision and keep-column scatter."""
        return sharded_wave_keep(f, ids[None], keep[None], self.n_local,
                                 is_cyclic, self.prims)[0]

    def _wave_overlapped(self, L, is_cyclic, cand, keep, f_prev, ids_prev,
                         ids_cur):
        """Fused route, steady state: wave i's hops are queued before wave
        i-1's survivor reduction, which touches other state, so the
        reduction (a collective under spmd) overlaps the hops' exchanges."""
        f_cur = self._wave_frontier(registry.ROUTE_FUSED, L, cand, ids_cur)
        return self._wave_finish(is_cyclic, f_prev, keep, ids_prev), f_cur

    # -- enumeration join -----------------------------------------------------
    def join_context(self):
        """Context of the sharded enumeration join (core/join.py): it reads
        the shard arrays in place; the reduced subgraph is never gathered."""
        from repro_torch.core import join as join_mod

        return join_mod.ShardedJoinContext(self)

    # -- TDS (gather bridge) ------------------------------------------------
    def tds(self, c: NonLocalConstraint, cstats: Dict) -> bool:
        from repro_torch.core import tds as tds_mod

        self._fire("tds")
        state = self.gather_state()
        new = tds_mod.verify_tds_constraint(
            self.dg, state, c, chunk=self.tds_chunk,
            max_rows=self.tds_max_rows, stats=cstats,
            annotate=(c.complete and self.guarantee_precision),
            dedup=self.work_aggregation,
        )
        # the bridge reads the host anyway: skip the scatter for a no-op
        changed = bool(_state_changed(state, new))
        if changed:
            self.omega_all, self.ea_all = self.scatter_state(new)
        if cstats is not None:
            cstats["tds_gather_bridge"] = cstats.get("tds_gather_bridge", 0) + 1
        return changed


class SimBackend(_ShardedBackend):
    """Every shard in this process: the shard programs run over all P
    shards at once, the exchange a transpose."""

    name = "sim"

    def __init__(self, graph, dg, template, part, **kw):
        super().__init__(graph, dg, template, part,
                         prims=sim_prims(part.P, dg.device),
                         shards=range(part.P), **kw)


class SpmdBackend(_ShardedBackend):
    """One shard per rank of a `torch.distributed` process group: rank r
    holds shard r, and every rank returns the same gathered result."""

    name = "spmd"

    def __init__(self, graph, dg, template, part, *, mesh, **kw):
        import torch.distributed as dist

        size = dist.get_world_size(mesh)
        if size != part.P:
            raise ValueError(f"mesh has {size} devices but the partition has "
                             f"P={part.P} shards")
        rank = dist.get_rank(mesh)
        self.mesh = mesh
        super().__init__(graph, dg, template, part,
                         prims=spmd_prims(mesh, part.P, rank, dg.device),
                         shards=[rank], **kw)


def _group_device(group, device):
    """The device a rank of `group` runs on: `cuda:<local rank>` under NCCL
    unless named; gloo carries CPU tensors only, so a CUDA device raises
    there (nothing is copied to the host behind the caller's back)."""
    import os
    import torch.distributed as dist

    kind = dist.get_backend(group)
    if kind == "nccl":
        if device is None:
            rank = dist.get_rank(group)
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % max(torch.cuda.device_count(), 1)))
            device = f"cuda:{local}"
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"an nccl group needs a CUDA device, got {dev}")
        return dev
    dev = resolve_device(device)
    if kind == "gloo" and dev.type != "cpu":
        raise ValueError("a gloo group carries CPU tensors: pass device='cpu' "
                         "(or use an nccl group on the card)")
    return dev


def make_backend(graph, template: Template, *, device=None, mesh=None,
                 partition=None, dg: Optional[DeviceGraph] = None, **kw):
    """Build the execution backend `prune` drives.

    mesh=None, partition=None   -> local (one device; a `DeviceGraph` keeps
                                   its own)
    partition=EdgePartition|int -> sim (every shard in this process)
    mesh=ProcessGroup           -> spmd (a shard per rank; partition= must
                                   have as many shards as the group ranks)

    A sharded backend takes `dg`, the host graph already staged
    (`DeviceGraph.from_host(graph)`), instead of staging it again; `injector`
    (a `resilience.FaultInjector`) arms the fault seams.
    """
    if mesh is None and partition is None:
        if not isinstance(graph, Graph):
            dg = graph
        elif dg is None:
            dg = DeviceGraph.from_host(graph, device)
        return LocalBackend(dg, template, **kw)

    if not isinstance(graph, Graph):
        raise TypeError(
            "sharded prune (mesh=/partition=) needs the host Graph: the edge "
            "partition is built from host arrays")
    # the local backend's route pins mean nothing on the sharded backends
    for k in ("lcc_route", "nlcc_route"):
        if kw.pop(k, None) is not None:
            raise ValueError(
                f"{k}= composes with the local backend only; the sharded "
                "engine routes by shard-local shape buckets instead")
    if mesh is not None:
        import torch.distributed as dist

        device = _group_device(mesh, device)
        if partition is None:
            partition = dist.get_world_size(mesh)
    if isinstance(partition, int):
        partition = partition_graph(graph, partition)
    # one dst-sort serves the DeviceGraph and the backend's arc-slot map
    # (the partition's own, when it was built from this graph)
    order = partition.dst_order(graph)
    if dg is None:
        dg = DeviceGraph.from_host(graph, device, order=order)
    elif (dg.n, dg.m) != (graph.n, graph.m) or (
            device is not None
            and resolve_device(device).type != dg.device.type):
        raise ValueError(f"dg (n={dg.n}, m={dg.m}, {dg.device}) is not the "
                         f"graph (n={graph.n}, m={graph.m}) on {device}")
    kw["arc_order"] = order
    if mesh is None:
        return SimBackend(graph, dg, template, partition, **kw)
    return SpmdBackend(graph, dg, template, partition, mesh=mesh, **kw)
