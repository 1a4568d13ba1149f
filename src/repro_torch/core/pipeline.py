"""The main pruning loop (paper Alg. 1).

    G* <- LCC(G, G0)
    for C0 in K0 (ordered: CC/PC by length, then TDS):
        G* <- NLCC(G*, G0, C0)
        if anything was eliminated: G* <- LCC(G*, G0)

Phase 0 is the initial LCC; phase k is constraint k plus its conditional LCC
re-run. The phase loop reads one device bool per constraint to decide the
re-run; phase counts stay on the device and are read once at the end
(eagerly under `collect_stats=True`).

Flags expose the paper's ablations:
  edge_elimination=False  — vertex-elimination-only baseline (Fig. 6a)
  work_aggregation=False  — TDS token dedup off (Fig. 6b)
  guarantee_precision     — generate + annotate the complete-walk TDS
                            constraint (zero false positives, Def. 1)
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.graph.structs import Graph, DeviceGraph
from repro_torch.core.template import Template, generate_constraints, NonLocalConstraint
from repro_torch.core.state import PruneState
from repro_torch.core import engine as engine_mod
from repro_torch.core import planner as planner_mod


@dataclasses.dataclass
class PhaseStat:
    phase: str
    constraint: Optional[str]
    seconds: float
    active_vertices: int
    active_edges: int
    omega_bits: int
    extra: Dict


@dataclasses.dataclass
class PruneResult:
    state: PruneState
    template: Template
    dg: DeviceGraph
    phases: List[PhaseStat]
    stats: Dict
    # the backend that ran the prune: a sharded result hands its shard
    # arrays to the enumeration join, which never gathers the reduced graph
    backend: Optional[object] = None

    # host copies, computed once
    @functools.cached_property
    def vertex_mask(self) -> np.ndarray:
        return self.omega.any(axis=1)

    @functools.cached_property
    def edge_mask(self) -> np.ndarray:
        """Arc mask in the dst-sorted DeviceGraph order, endpoint-consistent."""
        vm = self.vertex_mask
        ea = self.state.edge_active.cpu().numpy()
        return ea & vm[self.dg.src.cpu().numpy()] & vm[self.dg.dst.cpu().numpy()]

    @functools.cached_property
    def omega(self) -> np.ndarray:
        return self.state.omega.cpu().numpy()

    def counts(self):
        return {
            "V*": int(self.vertex_mask.sum()),
            "E*": int(self.edge_mask.sum()),
        }


def prune(
    graph: Union[Graph, DeviceGraph],
    template: Template,
    *,
    device=None,
    guarantee_precision: bool = True,
    edge_elimination: bool = True,
    work_aggregation: bool = True,
    nlcc_edge_prune: bool = False,
    wave: int = 1024,
    tds_chunk: int = 4096,
    tds_max_rows: int = 2_000_000,
    label_freq: Optional[np.ndarray] = None,
    constraints: Optional[List[NonLocalConstraint]] = None,
    plan: Optional[planner_mod.QueryPlan] = None,
    initial_state: Optional[PruneState] = None,
    collect_stats: bool = False,
    lcc_route: Optional[str] = None,
    nlcc_route: Optional[str] = None,
    mesh=None,
    partition=None,
    resilience=None,
) -> PruneResult:
    """Run the full pruning pipeline.

    `device` defaults to `cuda` (a `DeviceGraph` keeps its own device);
    `device="cpu"` runs the plain PyTorch versions of the kernels.
    `partition=` (a shard count or a `graph.partition.EdgePartition`) runs
    the `sim` backend, every shard in this process; `mesh=` (a
    `torch.distributed` process group, `launch.mesh.make_shard_group`) runs
    the `spmd` backend, a shard per rank: every rank calls `prune` on the
    same host graph and gets the same result. Both take the host `Graph`
    and give the gathered global state, which `enumerate_matches` takes
    (through the sharded joins). `stats["backend"]` names the backend.
    `lcc_route` ("packed" | "unpacked") and `nlcc_route` ("fused" | "packed"
    | "unpacked") pin the local backend's routes; unpinned, the tuned dispatch policy
    (`kernels/registry.py`) picks them per shape bucket, and untuned LCC
    takes the packed `bitset_spmm` sweep and NLCC the fused `bitset_wave`
    wave wherever the capability gates allow. The routes taken land in
    `stats["dispatch_routes"]`.

    `nlcc_edge_prune=True` runs the forward-backward frontier edge pruning
    before each CC/PC constraint (`nlcc._edge_prune_pass`). With no `plan`
    and no `constraints` given, a plan cached in the active policy for this
    template and graph-stats bucket is used (`planner.resolve_query_plan`);
    otherwise the paper's heuristic order."""
    if resilience is not None:
        raise NotImplementedError("resilience= is not ported yet")
    if isinstance(graph, Graph) and label_freq is None:
        label_freq = graph.label_frequency()
    if isinstance(graph, DeviceGraph) and device is not None:
        want = torch.device(device)
        if want.type != graph.device.type or (
                want.index is not None and want.index != graph.device.index):
            raise ValueError(f"graph lives on {graph.device}, device={device}")

    backend = engine_mod.make_backend(
        graph, template, device=device, mesh=mesh, partition=partition,
        wave=wave, lcc_route=lcc_route, nlcc_route=nlcc_route,
        edge_elimination=edge_elimination, collect_stats=collect_stats,
        nlcc_edge_prune=nlcc_edge_prune,
        tds_chunk=tds_chunk, tds_max_rows=tds_max_rows,
        work_aggregation=work_aggregation,
        guarantee_precision=guarantee_precision)
    dg = backend.dg
    stats: Dict = {"edge_elimination": edge_elimination,
                   "work_aggregation": work_aggregation,
                   "backend": backend.name}

    backend.init(initial_state)
    if template.n0 == 1:
        return PruneResult(backend.final_state(), template, dg, [], stats,
                           backend=backend)

    backend.record_routes(stats)
    # Beyond-paper fast path: with forward-backward frontier edge pruning,
    # CC alone yields the exact edge set for unique-label edge-monocyclic
    # templates (every surviving edge lies on a completing label cycle, and
    # unique labels make any such cycle a true match), so the complete-walk
    # TDS is not generated.
    skip_complete = (
        nlcc_edge_prune and guarantee_precision
        and not template.is_acyclic()
        and template.is_edge_monocyclic() and not template.repeated_labels())
    if skip_complete:
        stats["tds_skipped_via_frontier_edge_prune"] = True
    if constraints is None:
        constraints = generate_constraints(
            template, label_freq=label_freq,
            guarantee_precision=guarantee_precision and not skip_complete)
        if plan is None:
            plan = _maybe_resolve_plan(graph, dg, template, constraints,
                                       label_freq)
    if plan is not None:
        _check_plan(plan, constraints)
        constraints = plan.constraints()
    else:
        plan = planner_mod.heuristic_plan(constraints)
    stats["n_constraints"] = len(constraints)
    stats["plan"] = {
        "source": plan.source,
        "phases": [
            {"sig": p.signature, "engine": p.engine,
             "direction": p.direction,
             "predicted_s": (plan.per_phase_s[i] if plan.per_phase_s
                             else None),
             "actual_s": None}
            for i, p in enumerate(plan.phases)
        ],
    }

    driver = _Driver(backend=backend, stats=stats, plan=plan,
                     collect_stats=collect_stats)
    driver.run()
    return driver.finish(template, dg)


def _maybe_resolve_plan(graph, dg, template, constraints, label_freq):
    """The policy's cached plan for this run, or None. Graph statistics are
    collected only when the active policy holds plans, so an untuned run
    never computes them."""
    from repro_torch.kernels import registry

    policy = registry.get_policy()
    if policy is None or not policy.plans:
        return None
    from repro_torch.graph import stats as gstats

    if isinstance(graph, Graph):
        st = gstats.collect_graph_stats(graph)
    else:
        nl = (len(label_freq) if label_freq is not None
              else int(dg.labels.max()) + 1)
        st = gstats.collect_graph_stats(dg, n_labels=nl)
    return planner_mod.resolve_query_plan(template, constraints, st,
                                          backend=dg.device.type)


def _check_plan(plan, constraints):
    """An explicit plan must cover exactly the constraints this run
    generates — same multiset of signatures."""
    want = sorted(planner_mod.constraint_signature(c) for c in constraints)
    got = sorted(plan.signatures())
    if want != got:
        raise ValueError(
            f"query plan does not match generated constraints: plan phases "
            f"{got} != constraints {want}")


class _Driver:
    """The phase loop. Phase 0 = initial LCC; phase k (1..K) = constraint k
    + conditional LCC."""

    def __init__(self, *, backend, stats, plan, collect_stats):
        self.backend = backend
        self.stats = stats
        self.phases = plan.phases
        self.collect_stats = collect_stats
        self.raw: List[tuple] = []

    def _phase_initial(self):
        t0 = time.perf_counter()
        self.backend.lcc(self.stats)
        self._snap("LCC", None, t0, {})

    def _phase_constraint(self, k: int):
        p = self.phases[k - 1]
        c = p.constraint
        t0 = time.perf_counter()
        cstats: Dict = {}
        if p.engine == planner_mod.ENGINE_NLCC:
            changed = self.backend.nlcc(c, cstats, direction=p.direction)
        else:
            changed = self.backend.tds(c, cstats)
        self._snap(f"NLCC-{c.kind}", str(c.walk), t0, cstats)
        self.stats["plan"]["phases"][k - 1]["actual_s"] = (
            time.perf_counter() - t0)
        # ONE device bool decides the re-run
        if bool(changed):
            t0 = time.perf_counter()
            self.backend.lcc(self.stats)
            self._snap("LCC", None, t0, {})

    def _snap(self, phase, cname, t0, extra):
        # the phase's wall time includes its device work
        self.backend.sync()
        secs = time.perf_counter() - t0
        counts = (self.backend.counts_host() if self.collect_stats
                  else self.backend.counts_dev())
        self.raw.append((phase, cname, secs, extra, counts))

    def run(self):
        self._phase_initial()
        for k in range(1, len(self.phases) + 1):
            self._phase_constraint(k)

    def finish(self, template: Template, dg: DeviceGraph) -> PruneResult:
        self.backend.finalize_stats(self.stats)
        return PruneResult(self.backend.final_state(), template, dg,
                           _materialize(self.raw), self.stats,
                           backend=self.backend)


def _materialize(raw_phases: List[tuple]) -> List[PhaseStat]:
    """Turn accumulated snapshots into PhaseStats; deferred device counts
    are stacked and read in one host transfer."""
    deferred = [c for *_, c in raw_phases if not isinstance(c, dict)]
    if deferred:
        mat = iter(torch.stack(deferred).cpu().numpy())
    phases: List[PhaseStat] = []
    for phase, cname, secs, extra, counts in raw_phases:
        if isinstance(counts, dict):
            av, ae, ob = (counts["active_vertices"], counts["active_edges"],
                          counts["omega_bits"])
        else:
            av, ae, ob = (int(x) for x in next(mat))
        phases.append(PhaseStat(
            phase=phase, constraint=cname, seconds=secs,
            active_vertices=av, active_edges=ae, omega_bits=ob, extra=extra))
    return phases
