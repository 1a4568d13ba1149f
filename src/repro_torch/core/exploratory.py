"""Exploratory search (paper §5.4, Fig. 10): start from an over-constrained
template and relax it by removing edges until matches appear.

Level k searches every connected k-edge-deleted variant; the result is the
union of matches at the first level with any match. The variants share the
candidate set and the non-local work-reuse cache of one
`IncrementalSession` (the same constraint walks recur across variants: the
paper's key enabler).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.graph.structs import Graph
from repro_torch.core.template import Template
from repro_torch.core.incremental import IncrementalSession


@dataclasses.dataclass
class LevelStat:
    k: int
    n_variants: int
    matched_vertices: int
    seconds: float
    avg_seconds_per_variant: float


@dataclasses.dataclass
class ExploratoryResult:
    found_level: Optional[int]
    vertex_mask: np.ndarray
    levels: List[LevelStat]
    candidate_vertices: int


def exploratory_search(
    graph: Graph,
    template: Template,
    max_removals: Optional[int] = None,
    max_variants_per_level: int = 4096,
    device=None,
) -> ExploratoryResult:
    """Relax `template` level by level on `device` (the card unless
    `device="cpu"`) until some variant matches."""
    session = IncrementalSession(graph, template, device=device)
    cand_v = int(torch.any(session._cand.omega, dim=1).sum())
    if max_removals is None:
        max_removals = template.m0 - max(template.n0 - 1, 1)

    levels: List[LevelStat] = []
    # level 0: the original template
    for k in range(0, max_removals + 1):
        t0 = time.perf_counter()
        variants = [template] if k == 0 else template.edge_deletion_variants(k)
        variants = variants[:max_variants_per_level]
        union = np.zeros(graph.n, dtype=bool)
        for var in variants:
            state, _ = session.search(var)
            union |= torch.any(state.omega, dim=1).cpu().numpy()
        secs = time.perf_counter() - t0
        levels.append(
            LevelStat(
                k=k, n_variants=len(variants),
                matched_vertices=int(union.sum()), seconds=secs,
                avg_seconds_per_variant=secs / max(len(variants), 1),
            )
        )
        if union.any():
            return ExploratoryResult(
                found_level=k, vertex_mask=union, levels=levels,
                candidate_vertices=cand_v,
            )
    return ExploratoryResult(
        found_level=None, vertex_mask=np.zeros(graph.n, bool), levels=levels,
        candidate_vertices=cand_v,
    )
