"""Graph-query serving: admission, shape-bucket batching, deadlines and
streamed emission, the multi-tenant front end of `prune_batch`.

One resident background graph, many analysts submitting search templates.
Queries enter an admission queue; a shape-bucket batcher groups compatible
queries (same power-of-two template bucket, same plan group) and launches
one template-batched prune (core/batch.py) when the group is full
(`max_batch`) or its oldest query has waited `max_wait_s`. A query whose
deadline passes while queued is emitted as deadline_missed without device
time; one that expires inside a batch is zeroed at the next phase boundary
of the batched run, never a batch abort. Matches stream out block by block
through `stream_matches`, so the whole row table never exists at once.

The engine stages the graph on its device once (`DeviceGraph`), and on a
sharded graph (`partition=`, a shard count or an `EdgePartition`, run on
the sim prims; `mesh=`, a process group, on the spmd prims) builds its
`EdgePartition` once too; it owns no other device state: queueing,
batching, deadlines and emission run on the host. It is synchronous and
single-threaded: `submit()` enqueues, `pump()` launches every due batch,
`drain()` runs the queue dry. Under an injected clock its admission,
batching and deadline decisions are deterministic. Under `mesh=` every
rank runs the engine with the same submissions, and rank 0 decides which
queries expire, which batch runs next and which lanes a deadline cancels
(each rank has its own clock): the decisions are broadcast before any rank
dispatches a batch.

Routing follows the dispatch policy from startup on: pass `policy=` (a path
or a `DispatchPolicy`) and every batched prune resolves its wave route
under batched bucket keys ("b8xp1x..."), a batch of one falling back to the
unbatched entry.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch import tracing
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.structs import DeviceGraph, Graph
from repro_torch.core.template import Template
from repro_torch.core.batch import (prune_batch, BatchedPruneResult,
                                    STATUS_OK, STATUS_DEADLINE_MISSED)
from repro_torch.core.enumerate import count_matches, stream_matches
from repro_torch.core.pipeline import PruneResult
from repro_torch.kernels import registry

MODE_PRUNE = "prune"    # deliver the pruned solution subgraph only
MODE_COUNT = "count"    # also count matches (symmetry-broken)
MODE_STREAM = "stream"  # prune now, caller pulls embedding blocks later


@dataclasses.dataclass
class GraphQuery:
    """One admitted query: a template and its serving metadata."""
    query_id: int
    template: Template
    mode: str
    deadline: Optional[float]  # absolute clock() time, None = no deadline
    submitted_at: float
    bucket: tuple
    # the plan identity resolved at admission: a batch holds queries of one
    # plan group; "heuristic" when the policy holds no tuned plan for this
    # (template, graph-stats) bucket
    plan_group: str = "heuristic"
    # admission on the span recorder's clock, None while it is off
    traced_at: Optional[int] = None


@dataclasses.dataclass
class QueryResult:
    query_id: int
    status: str  # STATUS_OK | STATUS_DEADLINE_MISSED
    mode: str
    result: Optional[PruneResult]  # None for queries cancelled while queued
    n_embeddings: Optional[int]  # filled for MODE_COUNT ok queries
    batch_id: Optional[int]  # None if never launched
    batch_size: int
    wait_s: float
    seconds: float  # batched prune wall time (shared by the batch)


class GraphQueryEngine:
    """The serving front end: one resident graph, a queue of template
    queries, shape-bucketed batched execution on `device` (the card unless
    `device="cpu"`; under an NCCL `mesh=` the rank's card)."""

    def __init__(self, graph: Graph, *, partition=None, mesh=None,
                 wave: int = 1024, max_batch: int = 8,
                 max_wait_s: float = 0.05,
                 policy: Union[None, str, registry.DispatchPolicy] = None,
                 clock=time.monotonic, device=None, **prune_kw):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.graph = graph
        self.mesh = mesh
        if mesh is not None:
            import torch.distributed as dist
            from repro_torch.core.engine import _group_device

            device = _group_device(mesh, device)
            if partition is None:
                partition = dist.get_world_size(mesh)
        if isinstance(partition, int):
            partition = partition_graph(graph, partition)
        # built once per engine: every batch shares the partition (and its
        # device arrays) and the staged graph
        self.partition = partition
        with tracing.span("engine.stage"):
            self.dg = DeviceGraph.from_host(
                graph, device, order=(partition.dst_order(graph)
                                      if partition is not None else None))
            self._label_freq = graph.label_frequency()
        self.wave = wave
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.clock = clock
        self.prune_kw = prune_kw
        self._gstats = None  # graph stats, computed once iff plans are tuned
        self._queue: deque = deque()
        self._done: Dict[int, QueryResult] = {}
        self._ids = itertools.count()
        self._batch_ids = itertools.count()
        self.stats: Dict = {"n_submitted": 0, "n_batches": 0,
                            "n_completed": 0, "n_deadline_missed": 0}
        if policy is not None:  # tuned route decisions from startup on
            if isinstance(policy, (str, bytes)):
                policy = registry.DispatchPolicy.load(policy)
            registry.set_policy(policy)
            self.stats["policy_active"] = True

    # ------------------------------------------------------------- admission
    def submit(self, template: Template, *, mode: str = MODE_COUNT,
               timeout_s: Optional[float] = None) -> int:
        """Admit one query; returns its query_id. `timeout_s` is a serving
        deadline relative to now: a query that cannot finish by then is
        cancelled (masked), never silently dropped."""
        if mode not in (MODE_PRUNE, MODE_COUNT, MODE_STREAM):
            raise ValueError(f"unknown query mode {mode!r}")
        if template.n0 < 2:
            raise ValueError("single-vertex templates are a label filter, "
                             "not a pattern query")
        now = self.clock()
        q = GraphQuery(
            query_id=next(self._ids), template=template, mode=mode,
            deadline=(now + timeout_s) if timeout_s is not None else None,
            submitted_at=now, bucket=registry.shape_bucket(template.n0),
            plan_group=self._plan_group(template), traced_at=tracing.stamp())
        self._queue.append(q)
        self.stats["n_submitted"] += 1
        return q.query_id

    def _plan_group(self, template: Template) -> str:
        """The planned phase order at admission names the batch group; with
        no plans in the active policy every query is "heuristic", and
        batches group by shape bucket alone."""
        policy = registry.get_policy()
        if policy is None or not policy.plans:
            return "heuristic"
        from repro_torch.core import planner
        from repro_torch.core.template import generate_constraints
        from repro_torch.graph.stats import collect_graph_stats

        if self._gstats is None:
            self._gstats = collect_graph_stats(self.graph)
        cs = generate_constraints(
            template, label_freq=self._label_freq,
            guarantee_precision=self.prune_kw.get(
                "guarantee_precision", True))
        qp = planner.resolve_query_plan(template, cs, self._gstats,
                                        backend=self.dg.device.type)
        if qp is None or qp.is_heuristic():
            return "heuristic"
        return ";".join(qp.identities())

    @property
    def n_pending(self) -> int:
        return len(self._queue)

    def result(self, query_id: int) -> Optional[QueryResult]:
        return self._done.get(query_id)

    # ------------------------------------------------------------- batching
    def _agree(self, decision):
        """A host decision every rank must take alike: rank 0's under
        `mesh=`, broadcast before anything is dispatched."""
        if self.mesh is None:
            return decision
        import torch.distributed as dist

        box = [decision]
        dist.broadcast_object_list(
            box, src=dist.get_process_group_ranks(self.mesh)[0],
            group=self.mesh)
        return box[0]

    def _expire_queued(self) -> List[QueryResult]:
        now = self.clock()
        gone = set(self._agree([q.query_id for q in self._queue
                                if q.deadline is not None
                                and now > q.deadline]))
        live = deque()
        expired = []
        for q in self._queue:
            if q.query_id in gone:
                expired.append(self._finish_cancelled(q))
            else:
                live.append(q)
        self._queue = live
        return expired

    def _ready_bucket(self, force: bool):
        """The batcher's launch decision: a group is due when it holds
        max_batch queries or its oldest query has waited max_wait_s (or the
        caller is draining)."""
        now = self.clock()
        groups: Dict[tuple, List[GraphQuery]] = {}
        for q in self._queue:  # FIFO within a group by construction
            groups.setdefault((q.bucket, q.plan_group), []).append(q)
        for bucket, qs in groups.items():
            full = len(qs) >= self.max_batch
            overdue = (now - qs[0].submitted_at) >= self.max_wait_s
            if full or overdue or force:
                return bucket, qs[:self.max_batch]
        return None

    def pump(self, *, force: bool = False) -> List[QueryResult]:
        """Launch every due batch; returns the results it completed. With
        force=True, waiting policies are bypassed (drain semantics)."""
        out: List[QueryResult] = []
        while True:
            out.extend(self._expire_queued())
            due = self._ready_bucket(force)
            ids = self._agree(None if due is None
                              else [q.query_id for q in due[1]])
            if ids is None:
                break
            by_id = {q.query_id: q for q in self._queue}
            batch = [by_id[i] for i in ids]
            for q in batch:
                self._queue.remove(q)
            out.extend(self._execute(batch))
        return out

    def drain(self) -> List[QueryResult]:
        """Run the queue dry (no max-wait idling); returns all results."""
        out: List[QueryResult] = []
        while self._queue:
            out.extend(self.pump(force=True))
        return out

    # ------------------------------------------------------------- execution
    def _execute(self, batch: Sequence[GraphQuery]) -> List[QueryResult]:
        batch_id = next(self._batch_ids)
        now = self.clock()
        attrs = {}
        launch = tracing.stamp()
        if launch is not None:  # each query's wait, from submit to here
            for q in batch:
                if q.traced_at is not None:
                    tracing.record("serve.queue", q.traced_at, launch,
                                   f"query/{q.query_id}", query_id=q.query_id)
            attrs = {"batch_id": batch_id,
                     "query_ids": [q.query_id for q in batch]}
        with tracing.span("serve.batch", **attrs):
            bres: BatchedPruneResult = prune_batch(
                self.graph, [q.template for q in batch],
                partition=self.partition, mesh=self.mesh, wave=self.wave,
                label_freq=self._label_freq,
                deadlines=[q.deadline for q in batch], clock=self.clock,
                dg=self.dg, **self.prune_kw)
            seconds = bres.stats["batched"]["seconds"]
            self.stats["n_batches"] += 1
            self.stats.setdefault("batches", []).append({
                "batch_id": batch_id, "B": len(batch),
                "bucket": bres.stats["batched"]["bucket"], "seconds": seconds,
                "query_ids": [q.query_id for q in batch],
                "status": list(bres.status)})
            out = []
            for q, lane_res, status in zip(batch, bres.results, bres.status):
                n_emb = None
                if status == STATUS_OK and q.mode == MODE_COUNT:
                    n_emb = int(count_matches(
                        lane_res.dg, lane_res.state, q.template,
                        label_freq=self._label_freq).n_embeddings)
                qr = QueryResult(
                    query_id=q.query_id, status=status, mode=q.mode,
                    result=lane_res if status == STATUS_OK else None,
                    n_embeddings=n_emb, batch_id=batch_id,
                    batch_size=len(batch), wait_s=now - q.submitted_at,
                    seconds=seconds)
                self._finish(qr)
                out.append(qr)
        return out

    def _finish_cancelled(self, q: GraphQuery) -> QueryResult:
        qr = QueryResult(
            query_id=q.query_id, status=STATUS_DEADLINE_MISSED, mode=q.mode,
            result=None, n_embeddings=None, batch_id=None, batch_size=0,
            wait_s=self.clock() - q.submitted_at, seconds=0.0)
        self._finish(qr)
        return qr

    def _finish(self, qr: QueryResult) -> None:
        self._done[qr.query_id] = qr
        if qr.status == STATUS_DEADLINE_MISSED:
            self.stats["n_deadline_missed"] += 1
        else:
            self.stats["n_completed"] += 1

    # ------------------------------------------------------------- emission
    def stream(self, query_id: int, *, chunk: int = 4096,
               max_rows: int = 1_000_000) -> Iterator[np.ndarray]:
        """Stream a completed query's embeddings block by block
        (`stream_matches` over the lane's pruned subgraph). A deadline-missed
        query streams nothing."""
        qr = self._done.get(query_id)
        if qr is None:
            raise KeyError(f"query {query_id} has no result yet")
        if qr.status != STATUS_OK:
            return iter(())
        return stream_matches(qr.result, label_freq=self._label_freq,
                              chunk=chunk, max_rows=max_rows)


def example_workload(n: int, seed: int = 0,
                     labels_max: int = 7) -> List[Template]:
    """A mixed cyclic / path / counted template workload (all in the pow2-4
    shape bucket) for demos, the chip run and the serving tests."""
    shapes = [
        ([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),  # square
        ([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3)]),          # path
        ([0, 1, 2], [(0, 1), (1, 2), (2, 0)]),             # triangle
        ([0, 0, 1], [(0, 1), (1, 2), (2, 0)]),             # counted triangle
    ]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        labels, edges = shapes[i % len(shapes)]
        base = int(rng.integers(0, max(labels_max - 3, 1)))
        out.append(Template([min(base + l, labels_max) for l in labels],
                            edges))
    return out
