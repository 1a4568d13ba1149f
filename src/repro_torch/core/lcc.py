"""Local Constraint Checking (paper §3/§4, Alg. 3 + 4).

One iteration is a dense edge sweep:

  1. messages:   each active arc (u -> v) carries omega(u),
  2. aggregate:  M[v, q'] = OR over active in-arcs of omega(u)[q']
                 C[v, c]  = # active in-arcs whose omega(u) meets counted
                            label c (only for templates with same-label
                            multiplicity),
  3. vertex elim: keep q in omega(v) iff every template neighbor q' of q is
                 covered by M[v] and per-label distinct-neighbor counts meet
                 the template's multiplicity (Alg. 3 line 16),
  4. edge elim:  arc stays iff some template edge (qi, qj) has qi in
                 omega(u), qj in omega(v) (Alg. 3 line 9).

Two routes compute step 2's OR: `unpacked` boolean planes (with the counts)
and `packed` words through the `bitset_spmm` kernel. `lcc_fixpoint` iterates
either to a fixpoint (Alg. 3's do-while) and counts iterations exactly as the
JAX package's device while-loop does.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.graph.structs import DeviceGraph
from repro_torch.graph import segment_ops
from repro_torch.core.template import Template
from repro_torch.core.state import PruneState, pack_bits, unpack_bits
from repro_torch.kernels import registry

LCC_ROUTE = "prune.lcc"


class TemplateDev:
    """Template constants staged to the device once per pipeline run."""

    def __init__(self, template: Template, device: torch.device):
        self.n0 = template.n0
        adj0 = template.adjacency_matrix()
        self.adj0 = torch.from_numpy(adj0).to(device)            # bool[n0, n0]
        self.adj0_f = self.adj0.to(torch.float32)
        self.deg_pos = self.adj0.any(dim=1)                      # bool[n0]
        # multiplicity: req[q, c] over the template's distinct neighbor labels
        mult = template.multiplicity_requirements()
        counted = sorted({l for c in mult.values() for l, k in c.items() if k >= 1})
        req = np.zeros((template.n0, max(len(counted), 1)), dtype=np.int32)
        has = np.zeros((template.n0, max(len(counted), 1)), dtype=np.float32)
        for q in range(template.n0):
            for li, l in enumerate(counted):
                req[q, li] = mult[q].get(l, 0)
                has[q, li] = float(int(template.labels[q]) == l)
        self.req = torch.from_numpy(req).to(device)              # int32[n0, C]
        # template vertex q carries counted label c
        self.vertex_has_counted_label = torch.from_numpy(has).to(device)
        self.needs_counts = bool(
            any(k >= 2 for c in mult.values() for k in c.values()))


def _eliminate(dg: DeviceGraph, tdev: TemplateDev, state: PruneState,
               M: torch.Tensor, ok: Optional[torch.Tensor] = None
               ) -> Tuple[PruneState, torch.Tensor]:
    """Steps 3-4 from the neighbour coverage M[v, q'] -> (state, changed)."""
    src, dst = dg.src.long(), dg.dst.long()
    # missing[v, q] = exists q' with adj0[q, q'] and not M[v, q']
    missing = (~M).to(torch.float32) @ tdev.adj0_f.T
    keep = missing < 0.5
    if ok is not None:
        keep &= ok
    omega = state.omega & keep
    # some template arc (qi -> qj) with qi in omega(u), qj in omega(v)
    side = (omega.to(torch.float32) @ tdev.adj0_f) > 0.5          # [n, n0]
    compat = torch.any(side[src] & omega[dst], dim=-1)
    edge_active = state.edge_active & compat
    # a vertex with no active in-arc cannot match any q with degree >= 1
    has_edge = segment_ops.segment_or_bool(edge_active[:, None], dg.dst, dg.n)[:, 0]
    omega = omega & (~tdev.deg_pos[None, :] | has_edge[:, None])
    changed = torch.any(omega != state.omega) | torch.any(
        edge_active != state.edge_active)
    return PruneState(omega=omega, edge_active=edge_active), changed


def lcc_iteration(dg: DeviceGraph, tdev: TemplateDev, state: PruneState
                  ) -> Tuple[PruneState, torch.Tensor]:
    """One LCC sweep on boolean planes. Returns (new_state, changed)."""
    msgs = state.omega[dg.src.long()] & state.edge_active[:, None]
    M = segment_ops.segment_or_bool(msgs, dg.dst, dg.n)     # bool[n, n0]
    ok = None
    if tdev.needs_counts:
        # neighbor u counts toward label c iff omega(u) meets the template
        # vertices carrying label c
        ind = (msgs.to(torch.float32) @ tdev.vertex_has_counted_label) > 0.5
        cnt = segment_ops.segment_sum(ind.to(torch.int32), dg.dst, dg.n)
        ok = torch.all(cnt[:, None, :] >= tdev.req[None, :, :], dim=-1)
    return _eliminate(dg, tdev, state, M, ok)


def lcc_iteration_packed(dg: DeviceGraph, tdev: TemplateDev, state: PruneState
                         ) -> Tuple[PruneState, torch.Tensor]:
    """One LCC sweep through packed words and the `bitset_spmm` kernel.
    Templates needing multiplicity counts take the boolean planes (the OR
    kernel carries no counts)."""
    from repro_torch.kernels import ops as kops

    if tdev.needs_counts:
        return lcc_iteration(dg, tdev, state)
    agg = kops.bitset_or_aggregate(pack_bits(state.omega), dg, state.edge_active)
    return _eliminate(dg, tdev, state, unpack_bits(agg, tdev.n0))


def _fixpoint(iter_fn: Callable, state: PruneState, max_iters: int,
              stats: Optional[dict], extra_stat: Optional[str] = None
              ) -> PruneState:
    """Alg. 3's do-while. Counts iterations as the JAX package's
    `lax.while_loop` does: every sweep run counts, the last (unchanged) one
    included."""
    changed, it = True, 0
    while changed and it < max_iters:
        with tracing.span("lcc.sweep"):
            state, ch = iter_fn(state)
            with tracing.read("lcc.sweep"):
                changed = bool(ch)
        it += 1
    if stats is not None:
        stats["lcc_iterations"] = stats.get("lcc_iterations", 0) + it
        stats["lcc_calls"] = stats.get("lcc_calls", 0) + 1
        if extra_stat is not None:
            stats[extra_stat] = stats.get(extra_stat, 0) + 1
    return state


def lcc_route_bucket(dg: DeviceGraph):
    """Shape bucket of the packed-vs-unpacked LCC decision: the vertex and
    arc counts set a sweep's cost (the packed width, ceil(n0 / 32) words,
    hardly varies)."""
    return registry.shape_bucket(dg.n, dg.m)


def lcc_resolved_route(tdev: TemplateDev, dg: DeviceGraph, *,
                       collect_stats: bool = False,
                       route: Optional[str] = None) -> str:
    """The route the LCC fixpoint takes. Capability gates come first
    (per-iteration message counting or multiplicity counts need the boolean
    planes), then the pinned route, then the tuned policy for this shape
    bucket, packed by default."""
    if collect_stats or tdev.needs_counts:
        return registry.ROUTE_UNPACKED
    if route is not None:
        return registry.check_route(route, registry.LCC_ROUTES)
    return registry.resolve_route(
        LCC_ROUTE, lcc_route_bucket(dg), default=registry.ROUTE_PACKED,
        backend=dg.device.type, allowed=registry.LCC_ROUTES)


def lcc_fixpoint(
    dg: DeviceGraph,
    tdev: TemplateDev,
    state: PruneState,
    max_iters: int = 1000,
    stats: Optional[dict] = None,
    route: str = registry.ROUTE_UNPACKED,
) -> PruneState:
    """Iterate LCC to fixpoint on the given route (Alg. 3 do-while)."""
    if route == registry.ROUTE_PACKED:
        return _fixpoint(lambda st: lcc_iteration_packed(dg, tdev, st),
                         state, max_iters, stats, extra_stat="lcc_packed_calls")
    return _fixpoint(lambda st: lcc_iteration(dg, tdev, st),
                     state, max_iters, stats)
