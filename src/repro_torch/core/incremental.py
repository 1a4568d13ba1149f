"""Interactive incremental search (paper §5.4).

Two enablers from the paper:

  *candidate set*: a superset of the matches of every template obtainable
  from the initial template by edge deletions, computed with local
  constraints only. It is a relaxed LCC fixpoint: a vertex keeps candidacy
  for q if its label matches and at least one template neighbour of q is
  covered among its neighbours (>= 1 instead of all: every connected
  edge-deleted sub-template still requires each non-isolated vertex to have
  a matching neighbour, so this is a sound superset). Searches then run
  inside the candidate set (PJI-X).

  *work reuse*: non-local constraint outcomes are cached per constraint
  key. A source that once satisfied constraint C on a smaller active state
  still satisfies it on any superset state (walks only gain feasibility), so
  cached passes skip verification and only unknown sources are checked
  (PJI-Y).

On the device, the candidate set's OR-aggregation is a `bitset_spmm`
launch on packed omega, and cycle and path constraints run as fused
`bitset_wave` waves over the unknown sources: no [m, wave] boolean plane
exists on either (at R-MAT scale 20 one would be 32 GB).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.structs import Graph, DeviceGraph
from repro_torch.core.template import Template, generate_constraints, NonLocalConstraint
from repro_torch.core.state import PruneState, init_state, pack_bits, unpack_bits
from repro_torch.core.lcc import TemplateDev, lcc_fixpoint, lcc_resolved_route
from repro_torch.core.engine import _state_changed
from repro_torch.core import nlcc as nlcc_mod
from repro_torch.core import tds as tds_mod


def candidate_set(dg: DeviceGraph, template: Template,
                  max_iters: int = 100) -> PruneState:
    """Relaxed-LCC fixpoint: the paper's candidate set (the union over
    edge-deleted sub-templates, local constraints only)."""
    from repro_torch.kernels import ops as kops

    tdev = TemplateDev(template, dg.device)
    state = init_state(dg, template)
    changed, it = True, 0
    while changed and it < max_iters:
        om, ea = state.omega, state.edge_active
        M = unpack_bits(kops.bitset_or_aggregate(pack_bits(om), dg, ea),
                        tdev.n0)
        # >= 1 covered template neighbour (the relaxation)
        omega = om & ((M.to(torch.float32) @ tdev.adj0_f.T) > 0.5)
        side = pack_bits((omega.to(torch.float32) @ tdev.adj0_f) > 0.5)
        compat = (side.index_select(0, dg.src)
                  & pack_bits(omega).index_select(0, dg.dst)).ne(0).any(dim=1)
        new = PruneState(omega=omega, edge_active=ea & compat)
        changed = bool(_state_changed(state, new))
        state = new
        it += 1
    return state


@dataclasses.dataclass
class QueryStat:
    template_edges: int
    seconds: float
    matched_vertices: int
    constraints_checked: int
    constraints_reused: int


class IncrementalSession:
    """Holds the graph on its device (the card unless `device="cpu"`), the
    candidate set and the non-local work-reuse cache."""

    def __init__(
        self,
        graph: Graph,
        base_template: Template,
        use_candidate_set: bool = True,
        use_work_reuse: bool = True,
        wave: int = 1024,
        device=None,
    ):
        if wave % 32:
            raise ValueError("the packed waves need a wave of whole words "
                             f"(a multiple of 32), not {wave}")
        self.graph = graph
        self.dg = DeviceGraph.from_host(graph, device)
        self.label_freq = graph.label_frequency()
        self.base = base_template
        self.use_candidate_set = use_candidate_set
        self.use_work_reuse = use_work_reuse
        self.wave = wave
        self._cand: Optional[PruneState] = (
            candidate_set(self.dg, base_template) if use_candidate_set else None
        )
        # constraint key -> sources known to pass (sound under state growth)
        self._pass_cache: Dict[tuple, np.ndarray] = {}
        self.history: List[QueryStat] = []

    def _verify_with_reuse(
        self, state: PruneState, c: NonLocalConstraint, template: Template
    ) -> Tuple[PruneState, bool]:
        """Verify one constraint, skipping cached-pass sources. Returns
        (state, reused?)."""
        dg, dev = self.dg, self.dg.device
        key = c.key()
        cached = self._pass_cache.get(key) if self.use_work_reuse else None
        q0 = c.walk[0]
        sources = np.flatnonzero(state.omega[:, q0].cpu().numpy())
        unknown = sources if cached is None else sources[~np.isin(sources, cached)]
        reused = cached is not None and unknown.size < sources.size

        passed = np.zeros(dg.n, dtype=bool)
        if cached is not None:
            passed[cached[np.isin(cached, sources)]] = True
        if unknown.size:
            if c.kind in ("cycle", "path"):
                # tokens start at the unknown sources only
                cand = torch.stack([state.omega[:, q] for q in c.walk], dim=0)
                for ids, n_real in nlcc_mod.wave_batches(unknown, self.wave):
                    ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
                    surv = nlcc_mod.check_walk_constraint_packed(
                        dg, state, cand, c.is_cyclic, ids_dev, fused=True)
                    surv = surv[:n_real].cpu().numpy()
                    passed[ids[:n_real][surv]] = True
            else:
                sub = tds_mod.compact_active(dg, state)
                surv, _, _ = tds_mod.tds_walk(sub, c.walk, unknown)
                passed[unknown[surv]] = True
        if self.use_work_reuse:
            prev = self._pass_cache.get(key, np.zeros(0, np.int64))
            self._pass_cache[key] = np.union1d(prev, np.flatnonzero(passed))
        omega = state.omega.clone()
        omega[:, q0] &= torch.from_numpy(passed).to(dev)
        return PruneState(omega=omega, edge_active=state.edge_active), reused

    def search(self, template: Template) -> Tuple[PruneState, QueryStat]:
        """Prune for the (revised) template, reusing the candidate set and
        the cache."""
        t0 = time.perf_counter()
        dg = self.dg
        tdev = TemplateDev(template, dg.device)
        if self._cand is not None and template.n0 == self.base.n0:
            # the paper's restriction: revisions add or remove edges over
            # the same vertex set, so candidate-set omega columns align
            state = PruneState(
                omega=self._cand.omega & init_state(dg, template).omega,
                edge_active=self._cand.edge_active,
            )
        else:
            state = init_state(dg, template)
        route = lcc_resolved_route(tdev, dg)
        state = lcc_fixpoint(dg, tdev, state, route=route)
        constraints = generate_constraints(
            template, label_freq=self.label_freq, guarantee_precision=False
        )
        reused_n = 0
        for c in constraints:
            new, reused = self._verify_with_reuse(state, c, template)
            reused_n += int(reused)
            if bool(_state_changed(state, new)):
                new = lcc_fixpoint(dg, tdev, new, route=route)
            state = new
        if dg.device.type == "cuda":
            torch.cuda.synchronize(dg.device)
        stat = QueryStat(
            template_edges=template.m0,
            seconds=time.perf_counter() - t0,
            matched_vertices=int(torch.any(state.omega, dim=1).sum()),
            constraints_checked=len(constraints),
            constraints_reused=reused_n,
        )
        self.history.append(stat)
        return state, stat
