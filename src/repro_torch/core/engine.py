"""Execution backends of the pruning pipeline.

This port has the single-device `local` backend: LCC fixpoints, NLCC waves
and TDS joins on one device's state. The sharded backends (`mesh=`,
`partition=`) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.graph.structs import Graph, DeviceGraph
from repro_torch.core.state import PruneState, init_state
from repro_torch.core.lcc import LCC_ROUTE, TemplateDev, lcc_resolved_route
from repro_torch.core.nlcc import NLCC_ROUTE, nlcc_resolved_route
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
    ):
        self.dg = dg
        self.template = template
        self.tdev = TemplateDev(template, dg.device)
        self.wave = wave
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

    def sync(self) -> None:
        """Wait for the device: phase wall times include their device work."""
        if self.dg.device.type == "cuda":
            torch.cuda.synchronize(self.dg.device)

    # -- phases
    def lcc(self, stats: Dict) -> None:
        from repro_torch.core.lcc import lcc_fixpoint, lcc_iteration

        if not self.edge_elimination:
            self.state = self._lcc_no_edge_elim(stats)
            return
        if self.collect_stats:
            # python loop to count per-iteration messages (active arcs at send time)
            state, it = self.state, 0
            while True:
                stats["lcc_messages"] = stats.get("lcc_messages", 0) + int(
                    torch.sum(state.edge_active))
                state, changed = lcc_iteration(self.dg, self.tdev, state)
                it += 1
                if not bool(changed) or it > 1000:
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
            new_state, _ = lcc_iteration(dg, self.tdev, state)
            vact = torch.any(new_state.omega, dim=1)
            ea = vact[dg.src.long()] & vact[dg.dst.long()]
            new_state = PruneState(omega=new_state.omega, edge_active=ea)
            changed = _state_changed(state, new_state)
            state = new_state
            it += 1
            stats["lcc_messages"] = stats.get("lcc_messages", 0) + int(torch.sum(ea))
            if not bool(changed) or it > 1000:
                break
        stats["lcc_iterations"] = stats.get("lcc_iterations", 0) + it
        return state

    def nlcc(self, c: NonLocalConstraint, cstats: Dict,
             direction: str = "default") -> torch.Tensor:
        from repro_torch.core import nlcc as nlcc_mod

        before = self.state
        self.state = nlcc_mod.verify_constraint(
            self.dg, before, c, wave=self.wave, stats=cstats,
            count_messages=self.collect_stats, route=self.nlcc_route,
            direction=direction, edge_prune=self.nlcc_edge_prune,
            template=self.template)
        return _state_changed(before, self.state)

    def tds(self, c: NonLocalConstraint, cstats: Dict) -> torch.Tensor:
        from repro_torch.core import tds as tds_mod

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


def make_backend(graph, template: Template, *, device=None, mesh=None,
                 partition=None, **kw) -> LocalBackend:
    """Build the execution backend `prune` drives: the local backend on the
    given device (a `DeviceGraph` keeps its own)."""
    if mesh is not None or partition is not None:
        raise NotImplementedError(
            "sharded execution (mesh=/partition=) is not ported yet")
    if isinstance(graph, Graph):
        dg = DeviceGraph.from_host(graph, device)
    else:
        dg = graph
    return LocalBackend(dg, template, **kw)
