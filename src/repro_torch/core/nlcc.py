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
`keep` plane, and applies the head-column eliminations on the device. Three
routes execute a wave: `unpacked` boolean planes, `packed` per-hop
`bitset_spmm` launches, and `fused` (`bitset_wave`: all hops in one wrapper
call). The packed routes build the packed frontier directly and read the
survivors from packed words, so no [n, wave] boolean plane exists on them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.structs import DeviceGraph
from repro_torch.graph import segment_ops
from repro_torch.core.template import NonLocalConstraint
from repro_torch.core.state import PruneState, as_int32_bits
from repro_torch.kernels import registry

NLCC_ROUTE = "prune.nlcc"


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


def nlcc_resolved_route(wave: int, *, count_messages: bool = False,
                        route: Optional[str] = None) -> str:
    """The route CC/PC waves take. Packed and fused waves need a word-aligned
    wave and no message counting (the packed OR absorbs duplicates before
    they can be counted); otherwise the pinned route, fused by default."""
    if count_messages or wave % 32 != 0:
        return registry.ROUTE_UNPACKED
    if route is None:
        return registry.ROUTE_FUSED
    return registry.check_route(route, registry.NLCC_ROUTES)


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
def _bit_values(cols: torch.Tensor) -> torch.Tensor:
    """int64 value of bit (col % 32) of a packed word."""
    return torch.ones_like(cols) << (cols % 32)


def _initial_frontier_packed(n, cand0, source_ids, safe_src) -> torch.Tensor:
    """F_0 in packed words int32[n, S/32]: bit j of row safe_src[j] set for
    every seeded source. Distinct (row, column) bits sum to their OR."""
    S = source_ids.shape[0]
    W = S // 32
    dev = cand0.device
    cols = torch.arange(S, device=dev)
    seed = ((source_ids >= 0) & cand0[safe_src]).to(torch.int64)
    words = torch.zeros(n * W, dtype=torch.int64, device=dev)
    words.scatter_add_(0, safe_src * W + cols // 32, seed * _bit_values(cols))
    return as_int32_bits(words).reshape(n, W)


def _column_any(packed: torch.Tensor) -> torch.Tensor:
    """bool[S]: column j (bit j % 32 of word j // 32) is set in some row."""
    planes = [((packed >> b) & 1).any(dim=0) for b in range(32)]
    return torch.stack(planes, dim=1).reshape(-1)


def _wave_survivors_packed(packed, source_ids, safe_src, is_cyclic: bool):
    """`_wave_survivors` read straight from the packed hop-L frontier."""
    S = source_ids.shape[0]
    W = S // 32
    cols = torch.arange(S, device=packed.device)
    word = packed[safe_src, cols // 32]
    arrived_self = ((word >> (cols % 32).to(torch.int32)) & 1).to(torch.bool)
    if is_cyclic:
        survived = arrived_self
    else:
        # clear every source's own bit, then ask whether any row still has it
        own = torch.zeros(packed.numel(), dtype=torch.int64, device=packed.device)
        own.scatter_add_(0, safe_src * W + cols // 32,
                         arrived_self.to(torch.int64) * _bit_values(cols))
        elsewhere = packed ^ as_int32_bits(own).reshape(packed.shape)
        survived = _column_any(elsewhere)
    return survived & (source_ids >= 0)


def check_walk_constraint_packed(
    dg: DeviceGraph,
    state: PruneState,
    walk_candidacy: torch.Tensor,  # bool[L+1, n]
    is_cyclic: bool,
    source_ids: torch.Tensor,      # int64[S], -1 = pad; S % 32 == 0
    fused: bool,
) -> torch.Tensor:
    """One CC/PC wave on packed words -> survived bool[S]. `fused` runs all
    hops in one `bitset_wave` call; otherwise each hop is a `bitset_spmm`
    launch followed by the candidacy mask."""
    from repro_torch.kernels import ops as kops

    n = state.omega.shape[0]
    if source_ids.shape[0] % 32:
        raise ValueError("packed frontier needs a word-aligned wave size")
    safe_src = source_ids.clamp(0, n - 1)
    packed = _initial_frontier_packed(n, walk_candidacy[0], source_ids, safe_src)
    if fused:
        cand = torch.where(walk_candidacy[1:], -1, 0).to(torch.int32)
        packed = kops.bitset_wave(packed, dg, state.edge_active, cand)
    else:
        for r in range(1, walk_candidacy.shape[0]):
            agg = kops.bitset_or_aggregate(packed, dg, state.edge_active)
            packed = torch.where(walk_candidacy[r][:, None], agg, 0)
    return _wave_survivors_packed(packed, source_ids, safe_src, is_cyclic)


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
) -> PruneState:
    """Alg. 5 for CC/PC (+ each rotation for cycles): eliminate the head
    template vertex from omega of every failing token source.

    All walks of the constraint run against the constraint-entry omega;
    survivors accumulate in a device-side `keep` plane; the head columns are
    cleared on the device at the end. One host read per constraint (the
    head-candidacy columns that size the wave loop), plus one message-count
    read under `count_messages`."""
    walks = expand_walks(constraint, direction)
    route = nlcc_resolved_route(wave, count_messages=count_messages, route=route)
    wave_stat = {
        registry.ROUTE_FUSED: "nlcc_fused_waves",
        registry.ROUTE_PACKED: "nlcc_packed_waves",
        registry.ROUTE_UNPACKED: "nlcc_plane_waves",
    }[route]
    omega = state.omega
    n = omega.shape[0]
    dev = omega.device
    heads = [w[0] for w in walks]
    head_cols = omega[:, heads].cpu().numpy()
    host_syncs = 1
    # amax scatter: pads clip onto vertex 0 with survived=False, so repeated
    # indices can only ever leave a set bit set
    keep = torch.zeros((len(walks), n), dtype=torch.int32, device=dev)
    total_msgs = 0
    n_waves = 0
    for wi, walk in enumerate(walks):
        sources = np.flatnonzero(head_cols[:, wi])
        if sources.size == 0:
            continue
        cand = torch.stack([omega[:, q] for q in walk], dim=0)  # bool[L+1, n]
        is_cyclic = walk[0] == walk[-1]
        for ids_padded, n_real in wave_batches(sources, wave):
            ids_dev = torch.from_numpy(ids_padded.astype(np.int64)).to(dev)
            if route == registry.ROUTE_UNPACKED:
                survived, n_msgs = check_walk_constraint(
                    dg, state, cand, is_cyclic, ids_dev,
                    count_messages=count_messages)
                total_msgs += n_msgs
            else:
                survived = check_walk_constraint_packed(
                    dg, state, cand, is_cyclic, ids_dev,
                    fused=(route == registry.ROUTE_FUSED))
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
            stats["nlcc_messages"] = stats.get("nlcc_messages", 0) + int(total_msgs)
            host_syncs += 1
        stats["nlcc_constraints"] = stats.get("nlcc_constraints", 0) + 1
        stats["nlcc_waves"] = stats.get("nlcc_waves", 0) + n_waves
        stats["nlcc_host_syncs"] = stats.get("nlcc_host_syncs", 0) + host_syncs
    return PruneState(omega=omega, edge_active=state.edge_active)
