"""Pseudo-dynamic load balancing (paper §4 + §5.3), the JAX package's
`core/loadbalance.py` on numpy.

The paper checkpoints the pruned state (active vertices and edges, omega),
reshuffles the vertex-to-processor assignment so that the active workload
spreads evenly, and resumes, possibly on a smaller deployment (LB-16 /
LB-1). Here:

  - `imbalance_stats` quantifies the skew the paper describes ("half of
    the matching edges reside on only 20 of 2,304 partitions");
  - `compact_and_repartition` and `elastic_handoff` rebuild a balanced
    `EdgePartition` over the active subgraph alone, for the same or another
    shard count P, with the map back to the original coordinates.

`balanced_shuffle` draws its permutation with the JAX package's generator
calls, so the same seed gives the same permutation, and the handoff the
same sub-graph and partition, in both packages. States may hold torch
tensors or numpy arrays; what this module returns is numpy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.graph.structs import Graph, DeviceGraph
from repro_torch.graph.partition import EdgePartition, partition_graph
from repro_torch.core.state import PruneState


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class BalanceStats:
    P: int
    edges_per_shard: np.ndarray
    vertices_per_shard: np.ndarray
    max_over_mean_edges: float
    gini_edges: float
    shards_holding_half: int  # fewest shards holding half the active arcs


def _gini(x: np.ndarray) -> float:
    x = np.sort(x.astype(np.float64))
    n = x.size
    if n == 0 or x.sum() == 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def imbalance_stats_from_counts(vertices_per_shard: np.ndarray,
                                edges_per_shard: np.ndarray) -> BalanceStats:
    """BalanceStats from per-shard active counts alone, the device path.

    The sharded backends count these shard by shard on the device
    (`backend.shard_counts_dev()`, a [P, 2] readback, no gather of the
    state), so the phase-boundary trigger costs one small transfer. After an
    LCC fixpoint an active arc has both endpoints active, so the device
    counts equal `imbalance_stats`'s endpoint-masked ones at every phase
    boundary (tests/test_torch_resilience.py)."""
    e_shard = np.asarray(_np(edges_per_shard), np.int64)
    v_shard = np.asarray(_np(vertices_per_shard), np.int64)
    P = int(e_shard.size)
    order = np.sort(e_shard)[::-1]
    cum = np.cumsum(order)
    half = (int(np.searchsorted(cum, cum[-1] * 0.5) + 1)
            if cum.size and cum[-1] > 0 else 0)
    return BalanceStats(
        P=P,
        edges_per_shard=e_shard,
        vertices_per_shard=v_shard,
        max_over_mean_edges=float(e_shard.max() / max(e_shard.mean(), 1e-9)),
        gini_edges=_gini(e_shard),
        shards_holding_half=half,
    )


def imbalance_stats(g: Graph, state: Optional[PruneState], P: int,
                    dg: Optional[DeviceGraph] = None) -> BalanceStats:
    """The host oracle: active arcs (endpoint-masked) and active vertices
    per block shard of P."""
    n_local = (g.n + P - 1) // P
    if state is not None:
        assert dg is not None
        ea = _np(state.edge_active).astype(bool)
        vact = _np(state.omega).any(axis=1)
        src, dst = _np(dg.src), _np(dg.dst)
        keep = ea & vact[src] & vact[dst]
        src = src[keep]
        verts = np.flatnonzero(vact)
    else:
        src = g.src
        verts = np.arange(g.n)
    e_shard = np.bincount(src // n_local, minlength=P)
    v_shard = np.bincount(verts // n_local, minlength=P)
    return imbalance_stats_from_counts(v_shard, e_shard)


def _active_subgraph(g: Graph, dg: DeviceGraph, omega: np.ndarray,
                     ea: np.ndarray):
    """(sub-graph of the endpoint-consistent active arcs, old ids of its
    vertices, the kept arcs' mask in dst-sorted order)."""
    vact = omega.any(axis=1)
    src, dst = _np(dg.src), _np(dg.dst)
    keep = ea & vact[src] & vact[dst]
    old_ids = np.flatnonzero(vact)
    new_of_old = np.full(g.n, -1, np.int64)
    new_of_old[old_ids] = np.arange(old_ids.size)
    sub = Graph(n=old_ids.size, src=new_of_old[src[keep]],
                dst=new_of_old[dst[keep]], labels=g.labels[old_ids])
    return sub, old_ids, keep


def compact_active_graph(g: Graph, dg: DeviceGraph, state: PruneState
                         ) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """The solution subgraph as a fresh Graph -> (graph, old_of_new vertex
    ids, omega over the new ids)."""
    omega = _np(state.omega).astype(bool)
    sub, old_ids, _ = _active_subgraph(
        g, dg, omega, _np(state.edge_active).astype(bool))
    return sub, old_ids, omega[old_ids]


def balanced_shuffle(sub: Graph, seed: int = 0) -> Tuple[Graph, np.ndarray]:
    """A random vertex re-id (the paper's reshuffle), which breaks the
    skewed locality so that block partitioning comes out even -> (shuffled
    graph, perm) with perm[new_id] = old_id."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(sub.n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(sub.n)
    g2 = Graph(n=sub.n, src=inv[sub.src], dst=inv[sub.dst],
               labels=sub.labels[perm])
    return g2, perm


def compact_and_repartition(
    g: Graph, dg: DeviceGraph, state: PruneState, P: int, seed: int = 0
) -> Tuple[Graph, Optional[EdgePartition], Dict]:
    """Checkpoint-and-reshuffle onto P shards (any P)."""
    sub, old_ids, omega_new = compact_active_graph(g, dg, state)
    before = imbalance_stats(sub, None, P)
    shuffled, perm = balanced_shuffle(sub, seed)
    after = imbalance_stats(shuffled, None, P)
    part = partition_graph(shuffled, P) if shuffled.m else None
    return shuffled, part, {
        "old_ids": old_ids[perm],
        "omega": omega_new[perm],
        "imbalance_before": before,
        "imbalance_after": after,
    }


# --------------------------------------------------------------- elastic map
@dataclasses.dataclass
class ElasticRemap:
    """The map from a compacted and reshuffled graph back to the original
    one, so that a run that restarted elastically still reports (and
    checkpoints) its state in the original ids, which makes its recovery
    checkable bit for bit against a fault-free run.

    old_of_new[v]  original vertex id of current vertex v
    arc_pos[i]     current dst-sorted arc index of original dst-sorted arc
                   i, or -1 if the arc was inactive at the handoff (it stays
                   inactive in the original coordinates: monotonicity)
    """

    old_of_new: np.ndarray  # int64[n_new]
    arc_pos: np.ndarray     # int64[m_orig]
    n_orig: int
    m_orig: int


def remap_state_to_original(state: PruneState, remap: ElasticRemap,
                            n0: int) -> PruneState:
    """A current-coordinate state in original coordinates (numpy arrays).
    Vertices and arcs dropped at the handoff are inactive by
    monotonicity."""
    omega_cur = _np(state.omega).astype(bool)
    ea_cur = _np(state.edge_active).astype(bool)
    omega = np.zeros((remap.n_orig, n0), bool)
    omega[remap.old_of_new] = omega_cur
    ea = np.zeros(remap.m_orig, bool)
    kept = remap.arc_pos >= 0
    ea[kept] = ea_cur[remap.arc_pos[kept]]
    return PruneState(omega=omega, edge_active=ea)


def elastic_handoff(
    g: Graph, dg: DeviceGraph, state: PruneState, P: int, seed: int = 0,
    timings: Optional[Dict] = None,
) -> Optional[Tuple[Graph, EdgePartition, PruneState, ElasticRemap]]:
    """The elastic handoff: compact the active subgraph of an
    original-coordinate phase snapshot, reshuffle it, partition it onto P
    shards, and return (graph, partition, state, map back).

    Continuing the pipeline on the compacted subgraph is exact: an inactive
    vertex or arc contributes nothing to any LCC sweep, NLCC wave or TDS
    join (its bits are zero and the sweeps are monotone), so the remaining
    phases land on the restriction of the fault-free fixpoint, which
    `remap_state_to_original` maps back bit for bit.

    None when the active subgraph is degenerate (no active vertex or arc):
    the caller repartitions the original graph instead, which is always
    correct. `timings`, when given, receives the seconds of the compaction,
    the shuffle and the partition build, the new graph's n, m and B, and
    the max-over-mean and Gini of its arcs over the P shards."""
    t0 = time.perf_counter()
    omega = _np(state.omega).astype(bool)
    ea = _np(state.edge_active).astype(bool)
    sub, old_ids, keep = _active_subgraph(g, dg, omega, ea)
    if old_ids.size == 0 or not keep.any():
        return None
    t1 = time.perf_counter()
    shuffled, perm = balanced_shuffle(sub, seed)
    old_of_new = old_ids[perm]
    t2 = time.perf_counter()
    part = partition_graph(shuffled, P)
    if timings is not None:
        t3 = time.perf_counter()
        after = imbalance_stats(shuffled, None, P)
        timings.update(compact_s=t1 - t0, shuffle_s=t2 - t1,
                       partition_s=t3 - t2, n=shuffled.n, m=shuffled.m,
                       B=int(part.B),
                       max_over_mean_after=after.max_over_mean_edges,
                       gini_after=after.gini_edges)
    # arc i of the original dst-sorted order survives as the j-th arc of the
    # compacted host graph (the shuffle re-ids vertices, not arcs); the new
    # DeviceGraph dst-sorts those arcs, so host arc j sits at the inverse of
    # that sort
    kept_idx = np.flatnonzero(keep)
    order2 = part.dst_order(shuffled)
    inv_order2 = np.empty_like(order2)
    inv_order2[order2] = np.arange(order2.size)
    arc_pos = np.full(ea.size, -1, np.int64)
    arc_pos[kept_idx] = inv_order2
    state_new = PruneState(omega=omega[old_of_new],
                           edge_active=np.ones(shuffled.m, bool))
    remap = ElasticRemap(old_of_new=old_of_new.astype(np.int64),
                         arc_pos=arc_pos, n_orig=g.n, m_orig=int(ea.size))
    return shuffled, part, state_new, remap
