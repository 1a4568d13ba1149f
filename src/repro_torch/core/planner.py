"""Query plans: the phase list `prune` executes.

A plan is a sequence of phases, each a constraint with an engine ("nlcc"
token passing for cycle/path constraints, "tds" row joins) and a walk
direction (see `nlcc.expand_walks`). This module carries the plan types and
the paper's heuristic plan; the cost-modelled planner is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.template import NonLocalConstraint

ENGINE_NLCC = "nlcc"
ENGINE_TDS = "tds"


def constraint_signature(c: NonLocalConstraint) -> str:
    """Stable string identity of one constraint: kind, walk, completeness."""
    sig = f"{c.kind}:{','.join(str(q) for q in c.walk)}"
    return sig + ":complete" if c.complete else sig


@dataclasses.dataclass(frozen=True)
class PlanPhase:
    """One planned pipeline phase: which constraint, on which engine, with
    which walk-direction choice (nlcc engine only)."""

    constraint: NonLocalConstraint
    engine: str = ENGINE_NLCC  # "nlcc" | "tds"
    direction: str = "default"

    @property
    def signature(self) -> str:
        return constraint_signature(self.constraint)


@dataclasses.dataclass
class QueryPlan:
    phases: List[PlanPhase]
    source: str = "heuristic"

    def signatures(self) -> List[str]:
        return [p.signature for p in self.phases]

    def constraints(self) -> List[NonLocalConstraint]:
        return [p.constraint for p in self.phases]


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
