"""Non-local Constraint Checking for cycle and path constraints (Alg. 5 + 6).

Token passing as a multi-source boolean frontier F_r[v, s] = "a token that
originated at source s sits at v after r hops". One hop is the same edge
sweep as LCC (gather over arcs, OR by destination), masked per hop by the
candidacy of the walk's r-th template vertex. The OR absorbs duplicate
tokens, so work aggregation (Alg. 6 line 14) is implicit and maximal.

Sources are processed in fixed-size waves (`wave` bits), bounding frontier
state at n x wave bits per hop.

Cycle constraints: token must return to its source after |C0| hops
  -> survivor s iff F_L[source_s, s].
Path constraints: token must reach a *different* vertex with the same label
  -> survivor s iff exists v != source_s with F_L[v, s] (the paper's `ack`).

`verify_constraint` runs every walk of a constraint (all rotations of a
cycle, both directions of a path) against one candidacy stack built from the
constraint-entry omega, accumulates per-wave survivors into a device-side
`keep` plane, and applies the head-column eliminations on the device. A
walk's source ids go to the device in one copy, which its waves slice.
Three routes execute a wave: `unpacked` boolean planes, `packed` per-hop
`bitset_spmm` launches, and `fused` (`bitset_wave`: all hops in one wrapper
call). The packed routes build the packed int32 frontier directly from the
wave's source ids and read the survivors from packed words, so no [n, wave]
boolean plane exists on them.

`verify_constraint(edge_prune=True)` first runs the forward-backward
frontier edge-prune pass (`_edge_prune_pass`): forward and backward packed
frontiers, one `bitset_wave` hop at a time, mark the active arcs that lie
on a completing walk, and the others lose the constraint's template arcs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.graph.structs import DeviceGraph
from repro_torch.graph import segment_ops
from repro_torch.core.template import NonLocalConstraint
from repro_torch.core.state import PruneState, seeded_frontier, source_bits
from repro_torch.kernels import registry

NLCC_ROUTE = "prune.nlcc"
# bytes the boolean [m, wave] message plane of one unpacked wave may take on
# the card (at R-MAT scale 20 the plane is 31.3 M x 1024 bools, 32 GB)
UNPACKED_PLANE_BYTES = 1 << 30


def wave_batches(sources: np.ndarray, wave: int):
    """Pad wave-source ids into fixed-width batches (-1 = pad)."""
    for off in range(0, sources.size, wave):
        ids = sources[off: off + wave]
        pad = wave - ids.size
        idsp = (np.concatenate([ids, np.full(pad, -1, np.int64)])
                if pad else ids)
        yield idsp.astype(np.int32), int(ids.size)


def expand_walks(constraint: NonLocalConstraint, direction: str = "default"):
    """The walk set a direction choice executes. "default" is the paper's
    expansion: every rotation of a cycle, both directions of a path."""
    if constraint.is_cyclic:
        base = constraint.walk[:-1]
        if direction == "default":
            # a cycle constraint prunes the head only; verify every rotation
            return [
                tuple(base[i:] + base[:i]) + (base[i],)
                for i in range(len(base))
            ]
        if direction == "rev":
            rb = tuple(reversed(base))
            return [rb + (rb[0],)]
        return [tuple(base) + (base[0],)]  # "head"/"fwd": stored rotation only
    if direction in ("fwd", "head"):
        return [constraint.walk]
    if direction == "rev":
        return [tuple(reversed(constraint.walk))]
    return [constraint.walk, tuple(reversed(constraint.walk))]


def nlcc_route_bucket(n: int, wave: int):
    """Shape bucket of the NLCC wave route: the vertex count and the wave
    width set a hop's cost (each hop moves n x wave frontier bits)."""
    return registry.shape_bucket(n, wave)


def nlcc_resolved_route(n: int, wave: int, backend: str, *, m: int = 0,
                        count_messages: bool = False,
                        route: Optional[str] = None, bucket=None) -> str:
    """The route CC/PC waves take. Packed and fused waves need a word-aligned
    wave and no message counting (the packed OR absorbs duplicates before
    they can be counted); then the pinned route, then the tuned policy for
    `bucket` (this shape's `nlcc_route_bucket` unless given), fused by
    default. On the card a policy's unpacked choice runs only where the
    boolean [m, wave] message plane of one wave fits UNPACKED_PLANE_BYTES;
    past it the packed route (the same survivors) runs in its place."""
    if count_messages or wave % 32 != 0:
        return registry.ROUTE_UNPACKED
    if route is not None:
        return registry.check_route(route, registry.NLCC_ROUTES)
    choice = registry.resolve_route(
        NLCC_ROUTE, nlcc_route_bucket(n, wave) if bucket is None else bucket,
        default=registry.ROUTE_FUSED, backend=backend,
        allowed=registry.NLCC_ROUTES)
    if (choice == registry.ROUTE_UNPACKED and backend == "cuda"
            and m * wave > UNPACKED_PLANE_BYTES):
        return registry.ROUTE_PACKED
    return choice


# --------------------------------------------------------- boolean planes
def _initial_frontier(
    n: int,
    cand0: torch.Tensor,       # bool[n] candidacy of the walk head
    source_ids: torch.Tensor,  # int64[S], -1 = pad
    safe_src: torch.Tensor,    # int64[S] = clip(source_ids, 0, n-1)
) -> torch.Tensor:
    """F_0: one token plane per wave source, seeded at candidate sources."""
    S = source_ids.shape[0]
    frontier = torch.zeros((n, S), dtype=torch.bool, device=cand0.device)
    cols = torch.arange(S, device=cand0.device)
    frontier[safe_src, cols] = (source_ids >= 0) & cand0[safe_src]
    return frontier


def _wave_survivors(frontier, source_ids, safe_src, is_cyclic: bool):
    """CC: token returned to its source. PC: the paper's `ack` -- token
    reached some vertex other than its source."""
    S = source_ids.shape[0]
    arrived_self = frontier[safe_src, torch.arange(S, device=frontier.device)]
    if is_cyclic:
        survived = arrived_self
    else:
        arrived_any = torch.any(frontier, dim=0)
        arrived_elsewhere = (
            torch.sum(frontier, dim=0) > arrived_self.to(torch.int64))
        survived = arrived_any & arrived_elsewhere
    return survived & (source_ids >= 0)


def check_walk_constraint(
    dg: DeviceGraph,
    state: PruneState,
    walk_candidacy: torch.Tensor,  # bool[L+1, n] candidacy per walk position
    is_cyclic: bool,
    source_ids: torch.Tensor,      # int64[S], -1 = pad
    count_messages: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One CC/PC wave on boolean planes -> (survived bool[S], message count
    as a device scalar, 0 unless `count_messages`)."""
    n = state.omega.shape[0]
    safe_src = source_ids.clamp(0, n - 1)
    frontier = _initial_frontier(n, walk_candidacy[0], source_ids, safe_src)
    total = torch.zeros((), dtype=torch.int64, device=frontier.device)
    src = dg.src.long()
    for r in range(1, walk_candidacy.shape[0]):
        msgs = frontier[src] & state.edge_active[:, None]
        if count_messages:
            total += torch.sum(msgs)
        frontier = (segment_ops.segment_or_bool(msgs, dg.dst, n)
                    & walk_candidacy[r][:, None])
    return _wave_survivors(frontier, source_ids, safe_src, is_cyclic), total


# ------------------------------------------------------------ packed words
def hop_words(walk_candidacy: torch.Tensor) -> torch.Tensor:
    """The wave kernels' candidacy words of hops 1..L, int32[L, n] of 0 /
    -1, from bool[L+1, n]."""
    return -walk_candidacy[1:].to(torch.int32)


def _column_any(packed: torch.Tensor) -> torch.Tensor:
    """bool[S]: column j (bit j % 32 of word j // 32) is set in some row."""
    planes = [((packed >> b) & 1).any(dim=0) for b in range(32)]
    return torch.stack(planes, dim=1).reshape(-1)


def _wave_survivors_packed(packed, source_ids, safe_src, is_cyclic: bool):
    """`_wave_survivors` read straight from the packed hop-L frontier."""
    cols = torch.arange(source_ids.shape[0], device=packed.device)
    word = packed[safe_src, cols // 32]
    arrived_self = ((word >> (cols % 32).to(torch.int32)) & 1).to(torch.bool)
    if is_cyclic:
        survived = arrived_self
    else:
        # clear every source's own bit, then ask whether any row still has it
        own = source_bits(packed.shape[0], safe_src, arrived_self)
        survived = _column_any(packed ^ own)
    return survived & (source_ids >= 0)


def check_walk_constraint_packed(
    dg: DeviceGraph,
    state: PruneState,
    walk_candidacy: torch.Tensor,  # bool[L+1, n]
    is_cyclic: bool,
    source_ids: torch.Tensor,      # int64[S], -1 = pad; S % 32 == 0
    fused: bool,
    *,
    hops: Optional[torch.Tensor] = None,   # hop_words(walk_candidacy)
) -> torch.Tensor:
    """One CC/PC wave on packed words -> survived bool[S]. `fused` runs all
    hops in one `bitset_wave` call; otherwise each hop is a `bitset_spmm`
    launch followed by the candidacy mask. A caller running many waves of
    one walk may pass the fused route's candidacy words, made once."""
    from repro_torch.kernels import ops as kops

    n = state.omega.shape[0]
    if source_ids.shape[0] % 32:
        raise ValueError("packed frontier needs a word-aligned wave size")
    safe_src = source_ids.clamp(0, n - 1)
    packed = seeded_frontier(source_ids, walk_candidacy[0], n)
    if fused:
        packed = kops.bitset_wave(
            packed, dg, state.edge_active,
            hop_words(walk_candidacy) if hops is None else hops)
    else:
        for r in range(1, walk_candidacy.shape[0]):
            agg = kops.bitset_or_aggregate(packed, dg, state.edge_active)
            packed = torch.where(walk_candidacy[r][:, None], agg, 0)
    return _wave_survivors_packed(packed, source_ids, safe_src, is_cyclic)


# ------------------------------------------------- frontier edge pruning
# Words of one gathered [arcs, W] operand of `_arcs_meet`; arcs are taken in
# chunks of this many words, so the gathers never grow with m.
ARC_GATHER_WORDS = 1 << 25
# Bytes the L+1 forward frontiers of one edge-prune batch may hold; a batch
# takes fewer sources than `wave` when they would not fit. A source's
# survival and the arcs its walks use do not depend on the other sources of
# its batch, so the pass's result does not depend on the batch size.
EDGE_PRUNE_PLANE_BYTES = 1 << 29


def _arcs_meet(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor,
               ib: torch.Tensor) -> torch.Tensor:
    """bool[k]: a[ia[k]] and b[ib[k]] (packed [n, W] planes) share a bit."""
    k = ia.shape[0]
    step = max(1, ARC_GATHER_WORDS // a.shape[1])
    out = torch.empty(k, dtype=torch.bool, device=a.device)
    for off in range(0, k, step):
        sl = slice(off, off + step)
        both = a.index_select(0, ia[sl]) & b.index_select(0, ib[sl])
        out[sl] = (both != 0).any(dim=1)
    return out


def _wave_live_arcs(dg, rev, edge_active, edge_active_rev, walk_candidacy,
                    is_cyclic, source_ids, arcs):
    """One wave of the forward-backward pass on packed words (S % 32 == 0).

    F_r[v, s]: a token from source s sits at v after r hops (a prefix
    exists). B_r[v, s]: from v a suffix of length L - r completes for a
    surviving source s, intersected with F_r. Returns (survived bool[S],
    fwd_live bool[L, k], rev_live bool[L, k]) over the k arcs `arcs` (the
    active ones: an inactive arc is never live): row r - 1 holds the arcs
    u -> v used at hop r by a full walk (F_{r-1}[u] & B_r[v]), and their
    twin use (F_{r-1}[v] & B_r[u]).

    Every hop is a one-hop `bitset_wave` call, which costs what the hop's
    candidates cost (a `bitset_spmm` sweep walks every in-arc of every
    vertex): forward over `dg` with the walk's candidacy, backward over
    `rev` (out-arcs: `src` is not sorted) with the vertices where F_{r-1}
    is nonzero as candidates, then AND F_{r-1} word by word."""
    from repro_torch.kernels import ops as kops

    n = dg.n
    L = walk_candidacy.shape[0] - 1
    safe_src = source_ids.clamp(0, n - 1)
    cand = hop_words(walk_candidacy)
    fwd = [seeded_frontier(source_ids, walk_candidacy[0], n)]
    for r in range(1, L + 1):
        fwd.append(kops.bitset_wave(fwd[-1], dg, edge_active, cand[r - 1: r]))
    survived = _wave_survivors_packed(fwd[L], source_ids, safe_src, is_cyclic)
    if is_cyclic:
        # the walk must end at its own source
        B = source_bits(n, safe_src, survived)
    else:
        # at a surviving source's columns, and never at the source itself
        keep = source_bits(1, torch.zeros_like(safe_src), survived)
        own = source_bits(n, safe_src, torch.ones_like(survived))
        B = fwd[L] & keep & ~own
    src, dst = dg.src[arcs], dg.dst[arcs]
    fwd_live = torch.empty((L, arcs.shape[0]), dtype=torch.bool,
                           device=arcs.device)
    rev_live = torch.empty_like(fwd_live)
    for r in range(L, 0, -1):
        fwd.pop()  # F_r: no hop below r reads it
        f = fwd[r - 1]
        fwd_live[r - 1] = _arcs_meet(f, src, B, dst)
        rev_live[r - 1] = _arcs_meet(f, dst, B, src)
        if r > 1:
            # B_{r-1}[u] = OR over active out-arcs (u -> v) of B_r[v], & F_{r-1}
            live_u = torch.where((f != 0).any(dim=1), -1, 0).to(torch.int32)
            B = kops.bitset_wave(B, rev, edge_active_rev, live_u[None]) & f
    return survived, fwd_live, rev_live


def _upload_sources(sources: np.ndarray, wave: int,
                    device: torch.device) -> torch.Tensor:
    """A walk's source ids padded with -1 to whole waves, on `device` in one
    copy: int64[waves * wave], wave k at [k * wave, (k + 1) * wave). On the
    card the copy leaves from pinned memory and does not wait for the
    stream, so the host queues the walk's waves while earlier work runs."""
    pad = -sources.size % wave
    ids = torch.from_numpy(np.concatenate(
        [sources.astype(np.int64), np.full(pad, -1, np.int64)]))
    tracing.count("nlcc.source_uploads")
    if device.type == "cuda":
        return ids.pin_memory().to(device, non_blocking=True)
    return ids.to(device)


def _pad_sources(source_ids: torch.Tensor) -> torch.Tensor:
    """Source ids padded with -1 to a whole number of packed words."""
    pad = -source_ids.shape[0] % 32
    if pad == 0:
        return source_ids
    return torch.cat([source_ids, source_ids.new_full((pad,), -1)])


def walk_frontiers_and_edges(
    dg: DeviceGraph,
    state: PruneState,
    walk_candidacy: torch.Tensor,  # bool[L+1, n]
    is_cyclic: bool,
    source_ids: torch.Tensor,      # int[S], -1 = pad
):
    """Forward + backward frontiers for one wave (beyond-paper edge pruning).

    Returns (survived bool[S], fwd_live bool[L, m], rev_live bool[L, m]):
    row r - 1 holds the arcs used at hop r by a walk that completes for a
    surviving source, and the twin-direction use of the same arcs. The
    frontiers are packed words; S is padded to a word multiple inside."""
    S = source_ids.shape[0]
    ids = _pad_sources(source_ids.long())
    rev, perm = dg.reversed()
    ea = state.edge_active
    arcs = torch.nonzero(ea).squeeze(1)
    survived, fl, rl = _wave_live_arcs(dg, rev, ea, ea[perm], walk_candidacy,
                                       is_cyclic, ids, arcs)
    L = walk_candidacy.shape[0] - 1
    fwd_live = torch.zeros((L, dg.m), dtype=torch.bool, device=ea.device)
    rev_live = torch.zeros_like(fwd_live)
    fwd_live[:, arcs], rev_live[:, arcs] = fl, rl
    return survived[:S], fwd_live, rev_live


def _edge_prune_batch(n: int, L: int, wave: int) -> int:
    """Sources per edge-prune batch: `wave`, cut so that the L + 1 forward
    frontiers fit EDGE_PRUNE_PLANE_BYTES, in whole words."""
    words = max(1, EDGE_PRUNE_PLANE_BYTES // (4 * max(n, 1) * (L + 1)))
    return 32 * max(1, min(-(-wave // 32), words))


def _edge_prune_pass(
    dg: DeviceGraph,
    state: PruneState,
    constraint: NonLocalConstraint,
    template,
    wave: int,
    stats: Optional[Dict],
) -> PruneState:
    """Forward-backward frontier edge elimination for one CC/PC constraint.

    An arc stays when some template arc (qa, qb) admits it: qa in omega(u)
    and qb in omega(v), and, for a template arc that the constraint's walk
    covers, the arc lies on a completing walk at a hop that uses (qa, qb).
    A live arc already meets the omega test of its template arc (F_{r-1} and
    B_r are nonzero only at candidates of walk[r-1] and walk[r]), so the
    support is the OR of the live arcs and of the omega test of the
    uncovered template arcs, all on the device."""
    walk = list(constraint.walk)
    L = len(walk) - 1
    omega = state.omega
    with tracing.read("nlcc.edge_prune"):
        sources = np.flatnonzero(omega[:, walk[0]].cpu().numpy())
    if sources.size == 0:
        return state
    ea = state.edge_active
    cand = torch.stack([omega[:, q] for q in walk], dim=0)
    rev, perm = dg.reversed()
    ea_rev = ea[perm]
    arcs = torch.nonzero(ea).squeeze(1)
    live = torch.zeros(arcs.shape[0], dtype=torch.bool, device=ea.device)
    for idsp, _ in wave_batches(sources, _edge_prune_batch(dg.n, L, wave)):
        ids = torch.from_numpy(idsp.astype(np.int64)).to(ea.device)
        _, fl, rl = _wave_live_arcs(dg, rev, ea, ea_rev, cand,
                                    constraint.is_cyclic, ids, arcs)
        live |= (fl | rl).any(dim=0)
    support = torch.zeros_like(ea)
    support[arcs] = live
    covered = set(zip(walk[:-1], walk[1:])) | set(zip(walk[1:], walk[:-1]))
    for qa in range(template.n0):
        for qb in template.adj[qa]:
            if (qa, qb) not in covered:
                support |= (omega[:, qa].index_select(0, dg.src)
                            & omega[:, qb].index_select(0, dg.dst))
    new_ea = ea & support
    if stats is not None:
        with tracing.read("nlcc.edges_pruned"):
            stats["nlcc_edges_pruned"] = stats.get(
                "nlcc_edges_pruned", 0) + int(ea.sum() - new_ea.sum())
    return PruneState(omega=omega, edge_active=new_ea)


# ---------------------------------------------------------- wave executor
def verify_constraint(
    dg: DeviceGraph,
    state: PruneState,
    constraint: NonLocalConstraint,
    wave: int = 1024,
    stats: Optional[Dict] = None,
    count_messages: bool = False,
    route: Optional[str] = None,
    direction: str = "default",
    edge_prune: bool = False,
    template=None,
    head_cols: Optional[np.ndarray] = None,
) -> PruneState:
    """Alg. 5 for CC/PC (+ each rotation for cycles): eliminate the head
    template vertex from omega of every failing token source.

    edge_prune=True (requires `template`) first removes the arcs that lie on
    no completing walk for the template arcs this constraint covers
    (`_edge_prune_pass`): sound, since a true match realizes every hop of
    the walk.

    `head_cols` (bool[n, walks]) are the head columns of the walks that
    `expand_walks(constraint, direction)` gives, where the caller has read
    them back already; no host read is made for them then.

    All walks of the constraint run against the constraint-entry omega;
    survivors accumulate in a device-side `keep` plane; the head columns are
    cleared on the device at the end. One host read per constraint (the
    head-candidacy columns that size the wave loop), plus one message-count
    read under `count_messages`."""
    if edge_prune and template is not None:
        state = _edge_prune_pass(dg, state, constraint, template, wave, stats)
    walks = expand_walks(constraint, direction)
    route = nlcc_resolved_route(state.omega.shape[0], wave,
                                state.omega.device.type, m=dg.m,
                                count_messages=count_messages, route=route)
    wave_stat = {
        registry.ROUTE_FUSED: "nlcc_fused_waves",
        registry.ROUTE_PACKED: "nlcc_packed_waves",
        registry.ROUTE_UNPACKED: "nlcc_plane_waves",
    }[route]
    omega = state.omega
    n = omega.shape[0]
    dev = omega.device
    heads = [w[0] for w in walks]
    host_syncs = 0
    if head_cols is None:
        # read as rows, so that each walk's column below is contiguous: a
        # strided column of n bools costs np.flatnonzero a copy of it
        with tracing.read("nlcc.heads"):
            head_cols = omega[:, heads].T.contiguous().cpu().numpy().T
        host_syncs = 1
    # amax scatter: pads clip onto vertex 0 with survived=False, so repeated
    # indices can only ever leave a set bit set
    keep = torch.zeros((len(walks), n), dtype=torch.int32, device=dev)
    fused = route == registry.ROUTE_FUSED
    hops = None
    total_msgs = 0
    n_waves = 0
    for wi, walk in enumerate(walks):
        sources = np.flatnonzero(head_cols[:, wi])
        if sources.size == 0:
            continue
        cand = torch.stack([omega[:, q] for q in walk], dim=0)  # bool[L+1, n]
        is_cyclic = walk[0] == walk[-1]
        if fused:
            hops = hop_words(cand)  # the same for every wave of the walk
        ids_walk = _upload_sources(sources, wave, dev)
        for off in range(0, sources.size, wave):
            ids_dev = ids_walk[off: off + wave]
            n_real = min(wave, sources.size - off)
            if route == registry.ROUTE_UNPACKED:
                survived, n_msgs = check_walk_constraint(
                    dg, state, cand, is_cyclic, ids_dev,
                    count_messages=count_messages)
                total_msgs += n_msgs
            else:
                survived = check_walk_constraint_packed(
                    dg, state, cand, is_cyclic, ids_dev, fused=fused,
                    hops=hops)
            keep[wi].scatter_reduce_(0, ids_dev.clamp(0, n - 1),
                                     survived.to(torch.int32), "amax",
                                     include_self=True)
            n_waves += 1
            if stats is not None:
                stats["nlcc_tokens"] = stats.get("nlcc_tokens", 0) + n_real
                stats[wave_stat] = stats.get(wave_stat, 0) + 1
    # remove head candidacy from failing sources (Alg. 5 line 8), on device
    omega = omega.clone()
    for wi, q0 in enumerate(heads):
        omega[:, q0] &= keep[wi] > 0
    if stats is not None:
        if count_messages:
            with tracing.read("nlcc.messages"):
                stats["nlcc_messages"] = (stats.get("nlcc_messages", 0)
                                          + int(total_msgs))
            host_syncs += 1
        stats["nlcc_constraints"] = stats.get("nlcc_constraints", 0) + 1
        stats["nlcc_waves"] = stats.get("nlcc_waves", 0) + n_waves
        stats["nlcc_host_syncs"] = stats.get("nlcc_host_syncs", 0) + host_syncs
    return PruneState(omega=omega, edge_active=state.edge_active)
