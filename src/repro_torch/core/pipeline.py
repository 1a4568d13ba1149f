"""The main pruning loop (paper Alg. 1).

    G* <- LCC(G, G0)
    for C0 in K0 (ordered: CC/PC by length, then TDS):
        G* <- NLCC(G*, G0, C0)
        if anything was eliminated: G* <- LCC(G*, G0)

Phase 0 is the initial LCC; phase k is constraint k plus its conditional LCC
re-run. The phase loop reads one device bool per constraint to decide the
re-run; phase counts stay on the device and are read once at the end
(eagerly under `collect_stats=True`).

The loop is re-enterable, as the JAX package's driver: pruning is monotone,
so phase boundaries are consistency points. With `resilience=`
(core/resilience.py) the driver checkpoints the state there
(`repro_torch.checkpoint`), runs each phase under the degradation ladder
(retry -> the kernels' plain versions -> chunk back-off -> raise), and on a
shard loss restores the last valid checkpoint, possibly onto fewer shards
through `loadbalance.elastic_handoff` (the paper's LB-16 / LB-1 recovery onto
a smaller deployment). The same compact-and-reshuffle runs at a phase
boundary without a fault when the per-shard device counts show skew.
Checkpoints and results are in the original graph's coordinates, so a
recovered run equals a fault-free one bit for bit
(tests/test_torch_resilience.py). Informational counters (lcc_iterations,
nlcc_tokens, ...) add up over retried attempts; the phase trajectory
commits only successful attempts.

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
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.graph.structs import Graph, DeviceGraph
from repro_torch.core.template import Template, generate_constraints, NonLocalConstraint
from repro_torch.core.state import PruneState
from repro_torch.core import engine as engine_mod
from repro_torch.core import loadbalance
from repro_torch.core import planner as planner_mod
from repro_torch.core import resilience as resilience_mod
from repro_torch.kernels import registry


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
    # arrays to the enumeration join, which never gathers the reduced graph.
    # A run that was compacted and reshuffled (an elastic restart or a
    # rebalance) finished on another graph: its result is in this graph's
    # coordinates, with no backend, and enumeration takes the local joins
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


@tracing.traced("pipeline.prune")
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
    resilience: Optional[resilience_mod.ResilienceConfig] = None,
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
    otherwise the paper's heuristic order.

    `resilience=` (a `resilience.ResilienceConfig`) turns on phase-boundary
    checkpoints, the degradation ladder, fault injection (when the config
    carries a `FaultInjector`) and elastic restart and rebalance; what they
    did lands in `stats["resilience"]`. Under `mesh=` every rank passes the
    same config, and rank 0 of the group writes the checkpoints."""
    if resilience is not None and not isinstance(
            resilience, resilience_mod.ResilienceConfig):
        raise TypeError(f"resilience= takes a resilience.ResilienceConfig, "
                        f"got {type(resilience).__name__}")
    if isinstance(graph, Graph) and label_freq is None:
        label_freq = graph.label_frequency()
    if isinstance(graph, DeviceGraph) and device is not None:
        want = torch.device(device)
        if want.type != graph.device.type or (
                want.index is not None and want.index != graph.device.index):
            raise ValueError(f"graph lives on {graph.device}, device={device}")

    backend_kw = dict(
        wave=wave, edge_elimination=edge_elimination,
        collect_stats=collect_stats, nlcc_edge_prune=nlcc_edge_prune,
        tds_chunk=tds_chunk, tds_max_rows=tds_max_rows,
        work_aggregation=work_aggregation,
        guarantee_precision=guarantee_precision)
    if lcc_route is not None or nlcc_route is not None:
        backend_kw.update(lcc_route=lcc_route, nlcc_route=nlcc_route)
    if resilience is not None and resilience.injector is not None:
        backend_kw["injector"] = resilience.injector
    backend = engine_mod.make_backend(
        graph, template, device=device, mesh=mesh, partition=partition,
        **backend_kw)
    dg = backend.dg
    # a restart or rebalance builds its backend on the same device
    backend_kw["device"] = dg.device
    stats: Dict = {"edge_elimination": edge_elimination,
                   "work_aggregation": work_aggregation,
                   "backend": backend.name}
    if resilience is not None:
        stats["resilience"] = {
            "checkpoints": 0, "checkpoint_seconds": [],
            "checkpoint_bytes": [], "restarts": [], "rebalances": [],
            "ladder": [], "recovery_seconds": 0.0, "plain_calls": {},
        }

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

    driver = _Driver(
        graph=graph, template=template, backend=backend, dg=dg, stats=stats,
        plan=plan, res=resilience, collect_stats=collect_stats, mesh=mesh,
        backend_kw=backend_kw, initial_state=initial_state)
    driver.run()
    return driver.finish()


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
    """The re-enterable phase loop. Phase 0 = initial LCC; phase k (1..K) =
    constraint k + conditional LCC. `completed` is the last committed phase;
    a fault rolls it back to the restored checkpoint's phase and the loop
    enters again. A phase's trajectory entries are staged per attempt and
    committed on success, so a retried or replayed phase never adds
    entries twice."""

    def __init__(self, *, graph, template, backend, dg, stats, plan, res,
                 collect_stats, mesh, backend_kw, initial_state):
        self.graph = graph
        self.template = template
        self.backend = backend
        self.dg = dg  # the original graph: result and checkpoint coordinates
        self.stats = stats
        self.phases = plan.phases
        # phase identity by signature, engine and direction (not position):
        # checkpoints of one plan never resume under another
        self.plan_sigs = plan.identities()
        self.res = res
        self.inj = res.injector if res is not None else None
        self.collect_stats = collect_stats
        self.mesh = mesh  # the group the run started on (spmd), else None
        self.backend_kw = backend_kw
        self.initial_state = initial_state
        self.K = len(self.phases)
        self.completed = -1
        self.committed: List[Tuple[int, tuple]] = []  # (phase, raw entry)
        self._stage: List[tuple] = []
        # the map back to the original graph after a compact-and-reshuffle;
        # None while the run is in the original coordinates
        self.remap = None
        self.restarts = 0
        self._recovery_t0: Optional[float] = None
        # spmd: the group shrank (a restart or rebalance onto fewer ranks),
        # and this rank is outside it: it takes the result by broadcast
        self.shrunk = False
        self.spectator = False
        self._plain0 = registry.plain_counts()

    # -- phase bodies -------------------------------------------------------
    def _phase_lcc(self):
        """Phase 0, and a constraint's conditional LCC re-run."""
        with tracing.span("prune.lcc") as sp:
            t0 = time.perf_counter()
            self.backend.lcc(self.stats)
            sp.at(t0, self._snap("LCC", None, t0, {}))

    def _phase_constraint(self, k: int):
        p = self.phases[k - 1]
        c = p.constraint
        nlcc = p.engine == planner_mod.ENGINE_NLCC
        with tracing.span("prune.nlcc" if nlcc else "prune.tds") as sp:
            t0 = time.perf_counter()
            cstats: Dict = {}
            if nlcc:
                changed = self.backend.nlcc(c, cstats, direction=p.direction)
            else:
                changed = self.backend.tds(c, cstats)
            sp.at(t0, self._snap(f"NLCC-{c.kind}", str(c.walk), t0, cstats))
        # assigned, not added: a replayed phase records its committed attempt
        self.stats["plan"]["phases"][k - 1]["actual_s"] = (
            time.perf_counter() - t0)
        # ONE device bool decides the re-run
        with tracing.read("pipeline.changed"):
            changed = bool(changed)
        if changed:
            self._phase_lcc()

    def _snap(self, phase, cname, t0, extra) -> float:
        """Stage the phase's entry; -> the clock read that ends its
        seconds."""
        # the phase's wall time includes its device work
        self.backend.sync()
        t1 = time.perf_counter()
        counts = (self.backend.counts_host() if self.collect_stats
                  else self.backend.counts_dev())
        self._stage.append((phase, cname, t1 - t0, extra, counts))
        return t1

    # -- driver loop --------------------------------------------------------
    def run(self):
        if self.inj is None:
            return self._loop()
        # every kernel wrapper call of the run reports to the injector
        with registry.dispatch_hook(self.inj.on_dispatch):
            return self._loop()

    def _loop(self):
        while not self.spectator:
            try:
                while self.completed < self.K and not self.spectator:
                    k = self.completed + 1
                    self._run_phase(k)
                    self._after_phase(k)
                return
            except (resilience_mod.ShardLost,
                    resilience_mod.PhaseFailed) as e:
                self._recover(e)

    def _run_phase(self, k: int):
        if self.inj is not None:
            self.inj.begin_phase(k)
        if k == 0:
            body = self._phase_lcc
        else:
            body = functools.partial(self._phase_constraint, k)

        def attempt():
            self._stage = []
            body()

        if self.res is None:
            attempt()
        else:
            resilience_mod.run_phase_with_ladder(
                attempt,
                snapshot=self.backend.snapshot,
                restore=self.backend.restore_snapshot,
                retry=self.res.retry,
                injector=self.inj,
                on_chunk_backoff=self._chunk_backoff,
                ladder_log=self.stats["resilience"]["ladder"],
            )
        self.committed.extend((k, entry) for entry in self._stage)
        self._stage = []
        self.completed = k

    def _chunk_backoff(self, factor: int):
        # on the live backend and for any later restart
        self.backend.tds_chunk = max(1, self.backend.tds_chunk // factor)
        self.backend_kw["tds_chunk"] = self.backend.tds_chunk

    def _after_phase(self, k: int):
        res = self.res
        if res is None:
            return
        every = max(res.checkpoint_every, 1)
        if res.checkpoint_dir is not None and k % every == 0:
            self._checkpoint(k)
        el = res.elastic
        if (el is not None and el.imbalance_trigger is not None
                and k < self.K and self._sharded()):
            # per-shard device counts: one [P, 2] readback, the same on
            # every rank, so every rank takes the same branch
            counts = self.backend.shard_counts_dev().cpu().numpy()
            bs = loadbalance.imbalance_stats_from_counts(
                counts[:, 0], counts[:, 1])
            if (counts[:, 1].sum() > 0
                    and bs.max_over_mean_edges > el.imbalance_trigger):
                self._rebalance(k, bs)

    def _sharded(self) -> bool:
        return isinstance(self.backend, engine_mod._ShardedBackend)

    def _freeze_committed(self):
        """Read the committed phases' device counts to the host before the
        backend is replaced."""
        frozen = []
        for k, (phase, cname, secs, extra, counts) in self.committed:
            if not isinstance(counts, dict):
                c = counts.cpu().numpy()
                counts = {"active_vertices": int(c[0]),
                          "active_edges": int(c[1]),
                          "omega_bits": int(c[2])}
            frozen.append((k, (phase, cname, secs, extra, counts)))
        self.committed = frozen

    # -- checkpointing ------------------------------------------------------
    def _state_np_original(self) -> Tuple[np.ndarray, np.ndarray]:
        """(omega, edge_active) as host arrays in the original coordinates
        (a gather under spmd: every rank calls it)."""
        state = self.backend.final_state()
        omega = state.omega.cpu().numpy()
        ea = state.edge_active.cpu().numpy()
        if self.remap is not None:
            st = loadbalance.remap_state_to_original(
                PruneState(omega=omega, edge_active=ea), self.remap,
                self.template.n0)
            omega, ea = st.omega, st.edge_active
        return omega, ea

    def _group(self):
        """The process group the backend runs on (spmd), else None."""
        return getattr(self.backend, "mesh", None)

    def _barrier(self):
        """Under spmd, wait until every rank of the backend's group is here
        (rank 0's checkpoint has landed before any rank reads it)."""
        group = self._group()
        if group is None:
            return
        import torch.distributed as dist

        t = torch.zeros(1, device=self.backend.dg.device)
        dist.all_reduce(t, group=group)
        t.cpu()  # the host waits for the collective

    def _checkpoint(self, k: int):
        from repro_torch.checkpoint import ckpt

        t0 = time.perf_counter()
        omega, ea = self._state_np_original()
        meta = {"phase": int(k), "backend": self.backend.name,
                "P": int(getattr(self.backend, "P", 1)),
                "n": int(self.dg.n), "m": int(ea.size),
                "n0": int(self.template.n0),
                "phase_sig": self._phase_sig(k),
                "plan_sigs": list(self.plan_sigs)}
        part = getattr(self.backend, "part", None)
        if part is not None:
            meta["partition"] = part.meta()
        group = self._group()
        if group is None or _rank(group) == 0:
            ckpt.save_checkpoint(
                self.res.checkpoint_dir, k,
                {"omega": omega, "edge_active": ea},
                extra_meta=meta, keep=self.res.keep)
        self._barrier()
        rs = self.stats["resilience"]
        rs["checkpoints"] += 1
        rs["checkpoint_seconds"].append(time.perf_counter() - t0)
        rs["checkpoint_bytes"].append(int(omega.nbytes + ea.nbytes))

    def _phase_sig(self, k: int) -> str:
        """Identity of phase k: the initial LCC for k = 0, else the planned
        phase's signature, engine and direction."""
        return "lcc:init" if k == 0 else self.plan_sigs[k - 1]

    def _check_ckpt_plan(self, meta: Dict, phase0: int):
        """Refuse to resume a checkpoint written under another plan; one
        without the plan field falls back to the positional identity."""
        stored = meta.get("plan_sigs")
        if stored is not None and list(stored) != list(self.plan_sigs):
            raise resilience_mod.PlanMismatch(
                f"checkpoint at phase {phase0} was written under plan "
                f"{list(stored)} but this run executes {list(self.plan_sigs)}"
                ": phases are keyed by constraint signature; delete the "
                "checkpoint or re-run under the original plan")
        stored_sig = meta.get("phase_sig")
        if (stored_sig is not None and 0 <= phase0 <= len(self.plan_sigs)
                and str(stored_sig) != self._phase_sig(phase0)):
            raise resilience_mod.PlanMismatch(
                f"checkpoint phase {phase0} is {stored_sig!r} but this "
                f"run's phase {phase0} is {self._phase_sig(phase0)!r}")

    # -- recovery -----------------------------------------------------------
    def _recover(self, cause: BaseException):
        from repro_torch.checkpoint import ckpt

        res = self.res
        if res.checkpoint_dir is None:
            raise resilience_mod.ResilienceExhausted(
                "phase failed and no checkpoint_dir is configured: cannot "
                "recover") from cause
        if self.restarts >= res.max_restarts:
            raise resilience_mod.ResilienceExhausted(
                f"restart budget exhausted after {self.restarts} "
                "restarts") from cause
        self.restarts += 1
        t0 = time.perf_counter()
        if self._recovery_t0 is None:
            self._recovery_t0 = t0
        n, m, n0 = int(self.dg.n), int(self.dg.m), self.template.n0
        # only the shapes are read
        like = {"omega": np.broadcast_to(False, (n, n0)),
                "edge_active": np.broadcast_to(False, (m,))}
        try:
            # torn or corrupt checkpoint directories are skipped inside
            tree, meta = ckpt.restore_checkpoint(res.checkpoint_dir, like)
            state0 = PruneState(omega=tree["omega"].astype(bool),
                                edge_active=tree["edge_active"].astype(bool))
            phase0 = int(meta["phase"])
            self._check_ckpt_plan(meta, phase0)
        except FileNotFoundError:
            state0, phase0 = None, -1  # nothing saved yet: prune afresh
        restore_s = time.perf_counter() - t0
        P_old = int(getattr(self.backend, "P", 1))
        P_new = P_old
        if res.elastic is not None and res.elastic.restart_P:
            P_new = int(res.elastic.restart_P)
        handoff = self._switch_backend(state0, P_new)
        # the phases past the checkpoint run again: drop their entries
        self.committed = [(k, e) for k, e in self.committed if k <= phase0]
        self.completed = phase0
        self.stats["resilience"]["restarts"].append({
            "cause": type(cause).__name__,
            "restored_phase": phase0,
            "from_P": P_old, "to_P": P_new,
            "seconds": time.perf_counter() - t0,
            "restore_seconds": restore_s,
            "handoff": handoff,
        })

    def _switch_backend(self, state0: Optional[PruneState], P_new: int
                        ) -> Dict:
        """Rebuild the backend after a fatal fault: compact the restored
        original-coordinate snapshot onto P_new shards (elastic), or, when
        nothing was saved yet, the active subgraph is degenerate or the
        backend is local, start again on the original graph. -> the
        handoff's timings and sizes ({} without one)."""
        self._freeze_committed()
        was_sharded = self._sharded()
        seed = self.res.elastic.seed if self.res.elastic is not None else 0
        handoff, timings = None, {}
        if was_sharded and isinstance(self.graph, Graph) and state0 is not None:
            handoff = loadbalance.elastic_handoff(
                self.graph, self.dg, state0, P_new, seed=seed,
                timings=timings)
        if handoff is not None:
            # the skew the lost run had, on the host (its device is gone)
            t0 = time.perf_counter()
            before = loadbalance.imbalance_stats(
                self.graph, state0, int(self.backend.P), self.dg)
            timings.update(max_over_mean_before=before.max_over_mean_edges,
                           gini_before=before.gini_edges,
                           skew_s=time.perf_counter() - t0)
            g_new, part_new, state_new, remap = handoff
            self._install(g_new, part_new, state_new)
            self.remap = remap
        else:
            part = P_new if was_sharded else None
            start = state0 if state0 is not None else self.initial_state
            self._install(self.graph if was_sharded else self.dg, part, start,
                          dg=self.dg)
            self.remap = None
            timings = {}
        return timings

    def _install(self, graph, part, state, dg=None):
        """A new backend over `graph` (a partition or shard count, None for
        the local backend), initialised with `state` (host or device
        arrays, None for the label candidacy). Without a mesh one shard
        runs the local backend; under a mesh a smaller shard count runs on
        a group of the first ranks, and the others stand by."""
        P_new = part if isinstance(part, int) else getattr(part, "P", 1)
        kw = dict(self.backend_kw)
        group = None
        if self.mesh is not None:
            group = self._group_for(P_new)
            if group is None:
                self.backend, self.spectator = None, True
                return
        elif part is not None and P_new == 1:
            part = None  # LB-1: the rest of the run on one device
            if isinstance(graph, Graph) and dg is not None and (
                    dg.n, dg.m) != (graph.n, graph.m):
                dg = None
        self.backend = engine_mod.make_backend(
            graph, self.template, mesh=group, partition=part, dg=dg, **kw)
        if state is not None:
            state = PruneState(
                omega=_as_tensor(state.omega, self.backend.dg.device),
                edge_active=_as_tensor(state.edge_active,
                                       self.backend.dg.device))
        self.backend.init(state)
        self.backend.record_routes(self.stats)

    def _group_for(self, P_new: int):
        """The group a restarted spmd backend runs on: the current one when
        the shard count holds, else the first P_new ranks of the original
        group (None on the ranks outside it). A group shrinks once."""
        group = self._group() or self.mesh
        if _size(group) == P_new:
            return group
        if self.shrunk:
            raise resilience_mod.ResilienceExhausted(
                f"the spmd group already shrank to {_size(group)} ranks; a "
                f"second shrink to {P_new} is not supported")
        from repro_torch.launch.mesh import sub_group

        self.shrunk = True
        return sub_group(self.mesh, P_new)

    # -- imbalance-triggered rebalance (no fault) ---------------------------
    def _rebalance(self, k: int, bs):
        if not isinstance(self.graph, Graph):
            return
        el = self.res.elastic
        t0 = time.perf_counter()
        omega, ea = self._state_np_original()
        P_old = int(self.backend.P)
        P_new = int(el.rebalance_P) if el.rebalance_P else P_old
        timings: Dict = {}
        handoff = loadbalance.elastic_handoff(
            self.graph, self.dg, PruneState(omega=omega, edge_active=ea),
            P_new, seed=el.seed, timings=timings)
        if handoff is None:
            return  # degenerate active subgraph: nothing to balance
        self._freeze_committed()
        g_new, part_new, state_new, remap = handoff
        self._install(g_new, part_new, state_new)
        self.remap = remap
        self.stats["resilience"]["rebalances"].append({
            "phase": k, "from_P": P_old, "to_P": P_new,
            "max_over_mean_before": float(bs.max_over_mean_edges),
            "gini_before": float(bs.gini_edges),
            "seconds": time.perf_counter() - t0,
            "handoff": timings,
        })

    # -- finalization -------------------------------------------------------
    def finish(self) -> PruneResult:
        if self.res is not None:
            if self._recovery_t0 is not None:
                self.stats["resilience"]["recovery_seconds"] = (
                    time.perf_counter() - self._recovery_t0)
            now = registry.plain_counts()
            self.stats["resilience"]["plain_calls"] = {
                name: now[name] - self._plain0[name] for name in now}
        result_backend, state, phases = None, None, None
        if not self.spectator:
            self.backend.finalize_stats(self.stats)
            phases = _materialize([entry for _, entry in self.committed])
            if self.remap is None:
                state = self.backend.final_state()
                result_backend = self.backend
            else:
                # finished on a compacted graph: the state in the original
                # coordinates (equal to the fault-free run's by
                # monotonicity), and no backend, whose shard arrays no
                # longer describe `dg`
                omega, ea = self._state_np_original()
                state = PruneState(omega=_as_tensor(omega, self.dg.device),
                                   edge_active=_as_tensor(ea, self.dg.device))
        if self.shrunk:
            # ranks outside the smaller group take rank 0's result
            import torch.distributed as dist

            payload = [None]
            if not self.spectator and _rank(self.mesh) == 0:
                payload = [(state.omega.cpu().numpy(),
                            state.edge_active.cpu().numpy(), phases,
                            self.stats)]
            dist.broadcast_object_list(
                payload, src=dist.get_process_group_ranks(self.mesh)[0],
                group=self.mesh)
            if self.spectator:
                omega, ea, phases, stats = payload[0]
                self.stats.clear()
                self.stats.update(stats)
                state = PruneState(omega=_as_tensor(omega, self.dg.device),
                                   edge_active=_as_tensor(ea, self.dg.device))
        return PruneResult(state, self.template, self.dg, phases, self.stats,
                           backend=result_backend)


def _rank(group) -> int:
    import torch.distributed as dist

    return dist.get_rank(group)


def _size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


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
