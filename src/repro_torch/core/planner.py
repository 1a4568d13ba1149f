"""Plan-level query optimizer: cost-modelled constraint ordering per
(template, graph-stats) bucket.

The paper runs constraints in one fixed heuristic order (`template.py`, §3).
The order in which constraints eliminate vertices sets the prune's cost: an
early selective walk shrinks the frontier before the expensive cycles send
a token. This module enumerates candidate plans -- a permutation of the
constraint list, a walk-direction choice per CC/PC constraint, and a TDS or
NLCC engine where both are sound -- costs each with a calibrated model and
picks the cheapest. Chosen plans persist in the dispatch policy's plan table
(`kernels/registry.py`) keyed by (template signature, graph-stats bucket);
an untuned run executes the paper's order unchanged.

Soundness. Every phase is reductive and monotone: omega and edge bits only
clear, and only when no true match uses them. So any order ends at a sound
superset of the exact match state, but not necessarily the same one. With
`guarantee_precision`, the complete edge-cover TDS walk (annotate mode)
maps any sound superset to the exact match set, and the conditional LCC
after it makes the edge mask a function of the final omega. Hence the gate:
a plan may permute constraints, weaken walk directions or swap engines only
when the constraint list ends in a complete TDS phase, which stays last.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.template import (
    Template,
    NonLocalConstraint,
    generate_constraints,
    estimate_constraint_selectivity,
)
from repro_torch.core import nlcc as nlcc_mod
from repro_torch.graph.stats import GraphStats
from repro_torch.kernels import registry

ENGINE_NLCC = "nlcc"
ENGINE_TDS = "tds"

# permute at most this many distinct cost classes exhaustively (6! = 720
# orders); beyond it one greedy cheapest-rank order
MAX_ENUM_CLASSES = 6


# ----------------------------------------------------------------- signatures
def constraint_signature(c: NonLocalConstraint) -> str:
    """Stable string identity of one constraint: kind, walk, completeness."""
    sig = f"{c.kind}:{','.join(str(q) for q in c.walk)}"
    return sig + ":complete" if c.complete else sig


def template_signature(t: Template) -> str:
    """Stable string identity of a template (labels and edge set): the
    template half of the plan bucket."""
    labels = ".".join(str(int(l)) for l in t.labels)
    edges = ".".join(f"{a}-{b}" for a, b in sorted(t.edge_set))
    return f"l{labels}_e{edges}"


def plan_bucket(template: Template, stats: GraphStats) -> Tuple[str, str]:
    """The (template-sig, stats-bucket) plan cache bucket."""
    return (template_signature(template), stats.bucket())


# ----------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class PlanPhase:
    """One planned pipeline phase: which constraint, on which engine, with
    which walk-direction choice (nlcc engine only; see `nlcc.expand_walks`)."""

    constraint: NonLocalConstraint
    engine: str = ENGINE_NLCC  # "nlcc" | "tds"
    direction: str = "default"

    @property
    def signature(self) -> str:
        return constraint_signature(self.constraint)

    @property
    def identity(self) -> str:
        """Constraint signature, engine and direction: two phases of equal
        identity compute the same state transition."""
        return f"{self.signature}@{self.engine}.{self.direction}"

    def is_default(self) -> bool:
        return (self.engine == default_engine(self.constraint)
                and self.direction == "default")


@dataclasses.dataclass
class QueryPlan:
    phases: List[PlanPhase]
    predicted_s: float = 0.0
    # "heuristic" (the paper's order), "planner" (the cost model chose it)
    # or "policy" (read from the plan cache)
    source: str = "heuristic"
    # per-phase predictions (seconds) aligned with `phases`, reported beside
    # the measured seconds in stats["plan"]
    per_phase_s: Optional[List[float]] = None

    def signatures(self) -> List[str]:
        return [p.signature for p in self.phases]

    def identities(self) -> List[str]:
        return [p.identity for p in self.phases]

    def constraints(self) -> List[NonLocalConstraint]:
        return [p.constraint for p in self.phases]

    def is_heuristic(self) -> bool:
        return all(p.is_default() for p in self.phases)


def default_engine(c: NonLocalConstraint) -> str:
    """The engine an unplanned prune runs this constraint on."""
    return ENGINE_NLCC if c.kind in ("cycle", "path") else ENGINE_TDS


def heuristic_plan(constraints: Sequence[NonLocalConstraint]) -> QueryPlan:
    """The paper's §3 order with default engines and directions."""
    return QueryPlan(
        phases=[PlanPhase(c, default_engine(c), "default")
                for c in constraints],
        source="heuristic",
    )


def reorder_is_sound(constraints: Sequence[NonLocalConstraint]) -> bool:
    """A plan may leave the heuristic order only when a complete edge-cover
    TDS phase comes last to restore exactness (module docstring)."""
    return bool(constraints) and constraints[-1].complete


# ----------------------------------------------------------------- cost model
# nominal single-device rates of the static term: only the relative size of
# plans' costs matters, and every plan shares them
NOMINAL_OPS_PER_S = 1e12
NOMINAL_BYTES_PER_S = 1e11


@functools.lru_cache(maxsize=None)
def static_dispatch_seconds(backend: str, wave: int, m_bucket: int) -> float:
    """Static cost of one token-forward hop at `wave` width over `m_bucket`
    arcs, counted from the hop itself at nominal rates: the int32 `src` and
    `dst` of every arc read, a wave-wide frontier read, gathered per arc and
    scatter-maxed into a zeroed output (read and written per arc), one max
    per arc. The JAX package costs the same hop from its compiled HLO; the
    term is the fixed part the model adds per wave. `backend` keys the cache
    only: the count is the same on every device."""
    m = max(int(m_bucket), 1)
    w = max(int(wave), 1)
    nbytes = 8 * m + 3 * m + 2 * w
    secs = m / NOMINAL_OPS_PER_S + nbytes / NOMINAL_BYTES_PER_S
    return max(float(secs), 1e-7)


def measured_wave_seconds(policy, backend: str, n: int, wave: int
                          ) -> Optional[float]:
    """Per-wave seconds measured by the policy's NLCC route entry for this
    (n, wave) bucket -- the calibrated term of the cost model -- or None when
    the policy never measured the bucket."""
    if policy is None:
        return None
    entry = policy.route_entry_for(
        nlcc_mod.NLCC_ROUTE, backend, nlcc_mod.nlcc_route_bucket(n, wave))
    if entry is None or not entry.measured_s:
        return None
    return min(float(v) for v in entry.measured_s.values())


class _CostModel:
    """Predicted seconds per phase. Calibration: the policy's measured
    per-wave seconds when it has them (taken to time a walk of REF_HOPS
    hops), else the static term; frontier survival is estimated from the
    label histogram and the average degree, and updated after each phase by
    the constraint's selectivity -- which rewards running selective
    constraints first."""

    REF_HOPS = 4.0  # measured NLCC route entries time about 4-hop walks
    TDS_FACTOR = 2.0  # row joins move more bytes per token than bit planes

    def __init__(self, template: Template, stats: GraphStats, *,
                 backend: str, wave: int, policy=None):
        self.t = template
        self.stats = stats
        self.wave = max(int(wave), 1)
        freq = np.asarray(stats.label_hist, dtype=np.float64)
        need = int(template.labels.max()) + 1
        if freq.size < need:
            freq = np.concatenate([freq, np.zeros(need - freq.size)])
        self.freq = freq
        self.total = max(float(stats.n), 1.0)
        self.avg_deg = max(float(stats.avg_degree), 1.0)
        ws = measured_wave_seconds(policy, backend, stats.n, wave)
        static = static_dispatch_seconds(
            backend, wave, 1 << max(int(stats.m), 1).bit_length())
        self.hop_s = (ws / self.REF_HOPS) if ws is not None else static
        self.dispatch_s = static

    def _f(self, q: int) -> float:
        return float(self.freq[int(self.t.labels[q])]) / self.total

    def phase_seconds(self, phase: PlanPhase, survival: float) -> float:
        c = phase.constraint
        if phase.engine == ENGINE_NLCC:
            total = 0.0
            for walk in nlcc_mod.expand_walks(c, phase.direction):
                src_est = self._f(walk[0]) * self.total * survival
                n_waves = max(1.0, math.ceil(src_est / self.wave))
                total += n_waves * (len(walk) * self.hop_s + self.dispatch_s)
            return total
        # TDS row join: rows grow along the walk; the total row volume
        # stands for the token messages, at the heavier per-row constant
        rows = self._f(c.walk[0]) * self.total * survival
        volume = 0.0
        for q in c.walk[1:]:
            volume += rows
            rows = rows * self.avg_deg * self._f(q)
        n_chunks = max(1.0, volume / self.wave)
        return self.TDS_FACTOR * n_chunks * self.hop_s + self.dispatch_s

    def survival_after(self, phase: PlanPhase, survival: float) -> float:
        c = phase.constraint
        sel = estimate_constraint_selectivity(self.t, c, self.freq)
        if phase.engine == ENGINE_NLCC:
            ran = len(nlcc_mod.expand_walks(c, phase.direction))
            full = len(nlcc_mod.expand_walks(c, "default"))
            sel *= ran / max(full, 1)  # fewer walk checks eliminate less
        return max(survival * (1.0 - sel), 0.01)

    def plan_seconds(self, phases: Sequence[PlanPhase]
                     ) -> Tuple[float, List[float]]:
        survival, total, per = 1.0, 0.0, []
        for p in phases:
            s = self.phase_seconds(p, survival)
            per.append(s)
            total += s
            survival = self.survival_after(p, survival)
        return total, per


# ---------------------------------------------------------------- enumeration
def _phase_variants(c: NonLocalConstraint) -> List[PlanPhase]:
    """Sound (engine, direction) variants of one constraint: a subset of the
    default walk checks (weaker, sound) or a row join at least as strong as
    token passing; the pinned complete phase restores exactness."""
    if c.complete:
        return [PlanPhase(c, ENGINE_TDS, "default")]
    if c.kind in ("cycle", "path"):
        variants = [PlanPhase(c, ENGINE_NLCC, "default")]
        if c.is_cyclic:
            variants.append(PlanPhase(c, ENGINE_NLCC, "head"))
        else:
            variants.append(PlanPhase(c, ENGINE_NLCC, "fwd"))
            variants.append(PlanPhase(c, ENGINE_NLCC, "rev"))
        return variants
    # partial TDS: the row join is the default, token passing over the same
    # walk the cheap relaxation
    return [PlanPhase(c, ENGINE_TDS, "default"),
            PlanPhase(c, ENGINE_NLCC, "default")]


def enumerate_orders(model: _CostModel,
                     constraints: Sequence[NonLocalConstraint]
                     ) -> List[List[NonLocalConstraint]]:
    """Candidate orders of the non-complete prefix. Constraints of equal
    (cost, selectivity) estimates are interchangeable, so only orders of
    those classes are enumerated; beyond MAX_ENUM_CLASSES classes, one
    greedy order by ascending cost per unit of selectivity."""
    prefix = list(constraints)
    if not prefix:
        return [[]]
    key_of = {}
    for c in prefix:
        base = model.phase_seconds(
            PlanPhase(c, default_engine(c), "default"), 1.0)
        sel = estimate_constraint_selectivity(model.t, c, model.freq)
        key_of[constraint_signature(c)] = (round(base, 9), round(sel, 9))
    classes: Dict[tuple, List[NonLocalConstraint]] = {}
    for c in prefix:
        classes.setdefault(key_of[constraint_signature(c)], []).append(c)
    keys = list(classes)
    if len(keys) > MAX_ENUM_CLASSES:
        ranked = sorted(keys, key=lambda k: (k[0] / max(k[1], 1e-9), k))
        return [[c for k in ranked for c in classes[k]]]
    return [[c for k in perm for c in classes[k]]
            for perm in itertools.permutations(keys)]


def _greedy_variants(model: _CostModel, order: Sequence[NonLocalConstraint],
                     last: PlanPhase) -> Tuple[List[PlanPhase], float]:
    """The (engine, direction) variant per phase of a fixed order, greedy
    with one step of lookahead: a variant scores its own cost plus the
    default cost of everything after it, scaled by the survival it leaves,
    so a cheap weak variant that barely shrinks the frontier loses where it
    should."""
    rem_default: List[float] = []
    acc = model.phase_seconds(last, 1.0)
    for c in reversed(order):
        rem_default.append(acc)
        acc += model.phase_seconds(
            PlanPhase(c, default_engine(c), "default"), 1.0)
    rem_default.reverse()
    survival, phases, cost = 1.0, [], 0.0
    for i, c in enumerate(order):
        best = None
        for p in _phase_variants(c):
            pc = model.phase_seconds(p, survival)
            sa = model.survival_after(p, survival)
            score = pc + sa * rem_default[i]
            if best is None or score < best[0]:
                best = (score, p, pc, sa)
        _, p, pc, sa = best
        phases.append(p)
        cost += pc
        survival = sa
    phases.append(last)
    cost += model.phase_seconds(last, survival)
    return phases, cost


def plan_query(
    template: Template,
    stats: GraphStats,
    *,
    backend: str,
    wave: int = 1024,
    policy=None,
    guarantee_precision: bool = True,
    label_freq: Optional[np.ndarray] = None,
    constraints: Optional[List[NonLocalConstraint]] = None,
) -> QueryPlan:
    """Enumerate sound plans, cost each, return the cheapest.

    Where reordering is unsound (no complete phase last) the heuristic plan
    comes back with its predictions, `source == "heuristic"`. The variant
    per phase is chosen greedily under the running survival estimate; the
    order is searched over all orders of the cost classes. `backend` (the
    device type) selects the policy's measurements."""
    if constraints is None:
        constraints = generate_constraints(
            template,
            label_freq=(label_freq if label_freq is not None
                        else stats.label_hist),
            guarantee_precision=guarantee_precision,
        )
    base = heuristic_plan(constraints)
    model = _CostModel(template, stats, backend=backend, wave=wave,
                       policy=policy)
    if not reorder_is_sound(constraints):
        base.predicted_s, base.per_phase_s = model.plan_seconds(base.phases)
        return base
    last = PlanPhase(constraints[-1], ENGINE_TDS, "default")
    best_phases, best_cost = base.phases, None
    for order in enumerate_orders(model, constraints[:-1]):
        phases, cost = _greedy_variants(model, order, last)
        if best_cost is None or cost < best_cost:
            best_phases, best_cost = phases, cost
    heur_cost, heur_per = model.plan_seconds(base.phases)
    if best_cost is None or heur_cost <= best_cost:
        base.predicted_s, base.per_phase_s = heur_cost, heur_per
        return base
    total, per = model.plan_seconds(best_phases)
    return QueryPlan(phases=best_phases, predicted_s=float(total),
                     source="planner", per_phase_s=per)


# --------------------------------------------------------- policy round trip
def plan_to_entry(plan: QueryPlan, *,
                  measured_s: Optional[Dict[str, float]] = None
                  ) -> registry.PlanEntry:
    per = plan.per_phase_s or [0.0] * len(plan.phases)
    return registry.PlanEntry(
        phases=[{"sig": p.signature, "engine": p.engine,
                 "direction": p.direction, "predicted_s": float(s)}
                for p, s in zip(plan.phases, per)],
        predicted_s=float(plan.predicted_s),
        measured_s=dict(measured_s or {}),
    )


def entry_to_plan(entry: registry.PlanEntry,
                  constraints: Sequence[NonLocalConstraint]) -> QueryPlan:
    """A cached plan against the constraints the template generates now;
    the caller has checked that the signatures match
    (`registry.resolve_plan`)."""
    by_sig = {constraint_signature(c): c for c in constraints}
    phases = [
        PlanPhase(by_sig[str(p["sig"])],
                  str(p.get("engine", ENGINE_NLCC)),
                  str(p.get("direction", "default")))
        for p in entry.phases
    ]
    return QueryPlan(
        phases=phases, predicted_s=float(entry.predicted_s), source="policy",
        per_phase_s=[float(p.get("predicted_s", 0.0)) for p in entry.phases])


def record_plan(policy: registry.DispatchPolicy, template: Template,
                stats: GraphStats, plan: QueryPlan, *, backend: str,
                measured_s: Optional[Dict[str, float]] = None) -> None:
    """Write `plan` into the policy's plan table (the caller persists)."""
    policy.set_plan(backend, plan_bucket(template, stats),
                    plan_to_entry(plan, measured_s=measured_s))


def resolve_query_plan(
    template: Template,
    constraints: Sequence[NonLocalConstraint],
    stats: GraphStats,
    *,
    backend: str,
) -> Optional[QueryPlan]:
    """The active policy's cached plan for this (template, stats) bucket,
    checked against the current constraint signatures and the soundness
    gate; None: run the heuristic order."""
    entry = registry.resolve_plan(
        plan_bucket(template, stats),
        [constraint_signature(c) for c in constraints],
        backend=backend,
    )
    if entry is None:
        return None
    plan = entry_to_plan(entry, constraints)
    if plan.is_heuristic():
        return plan
    if not (plan.phases and plan.phases[-1].constraint.complete):
        # a non-default plan is sound only with the complete phase last
        return None
    return plan
