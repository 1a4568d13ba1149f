"""The port's graph-query serving engine (serve/graph_query.py) against the
JAX package's, under one fake clock.

The nine cases of tests/test_graph_serving.py: waiting for max_wait,
launching a full batch at once, grouping by shape bucket, cancelling in the
queue, count mode, stream mode, a deadline-missed stream, the 32-query
drain and the policy given at startup. In each, the port and the
reference take the same submissions at the same fake times, and their
serving decisions (query ids, statuses, batch ids, batch sizes, waits,
match counts) must be identical; the lanes' omegas equal the reference's.
Also: the batched route keys and the batch-size-1 fallback of
`DispatchPolicy.route_entry_for`, against the reference's lookup.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.core import count_matches as rcount  # noqa: E402
from repro.core import enumerate_matches as renumerate  # noqa: E402
from repro.core import prune as rprune  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro.kernels import registry as rregistry  # noqa: E402
from repro.serve import GraphQueryEngine as RGraphQueryEngine  # noqa: E402
from repro.serve import example_workload as rexample_workload  # noqa: E402
from repro_torch.core.batch import STATUS_DEADLINE_MISSED, STATUS_OK  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    MODE_COUNT, MODE_PRUNE, MODE_STREAM, GraphQueryEngine, example_workload)

TRI = ([4, 3, 3], [(0, 1), (1, 2), (2, 0)])
SMALL = ([5, 4], [(0, 1)])                      # bucket 2
BIG = ([5, 4, 3, 2], [(0, 1), (1, 2), (2, 3)])  # bucket 4


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _no_policies(tmp_path, monkeypatch):
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    rregistry.set_policy(None)
    yield
    registry.clear_policy()
    rregistry.clear_policy()


@pytest.fixture(scope="module")
def graph():
    return gen.rmat_graph(8, edge_factor=6, seed=3)


def _ref(g):
    return RGraph(g.n, g.src, g.dst, g.labels)


class Pair:
    """The port's engine and the reference's, each with its own fake clock,
    driven by the same calls."""

    def __init__(self, g, **kw):
        kw.setdefault("max_batch", 4)
        kw.setdefault("max_wait_s", 1.0)
        self.clock, self.rclock = FakeClock(), FakeClock()
        self.port = GraphQueryEngine(g, clock=self.clock, device="cpu", **kw)
        self.ref = RGraphQueryEngine(_ref(g), clock=self.rclock, **kw)

    def at(self, t):
        self.clock.t = self.rclock.t = t

    def submit(self, spec, **kw):
        qid = self.port.submit(Template(*spec), **kw)
        assert self.ref.submit(RT(*spec), **kw) == qid
        return qid

    def pump(self, **kw):
        out, rout = self.port.pump(**kw), self.ref.pump(**kw)
        assert _decisions(out) == _decisions(rout)
        return out

    def drain(self):
        out, rout = self.port.drain(), self.ref.drain()
        assert _decisions(out) == _decisions(rout)
        return out

    def check_stats(self):
        keys = ("n_submitted", "n_batches", "n_completed",
                "n_deadline_missed", "policy_active")
        assert ({k: self.port.stats.get(k) for k in keys}
                == {k: self.ref.stats.get(k) for k in keys})
        batches = [(b["batch_id"], b["B"], b["bucket"])
                   for b in self.port.stats.get("batches", [])]
        assert batches == [(b["batch_id"], b["B"], b["bucket"])
                           for b in self.ref.stats.get("batches", [])]

    def check_lanes(self, qids):
        for qid in qids:
            r, rr = self.port.result(qid), self.ref.result(qid)
            assert (r.result is None) == (rr.result is None)
            if r.result is not None:
                np.testing.assert_array_equal(
                    r.result.state.omega.numpy(),
                    np.asarray(rr.result.state.omega))
                np.testing.assert_array_equal(
                    r.result.state.edge_active.numpy(),
                    np.asarray(rr.result.state.edge_active))


def _decisions(results):
    return [(r.query_id, r.status, r.mode, r.batch_id, r.batch_size,
             r.wait_s, r.n_embeddings) for r in results]


def test_batcher_waits_then_launches_on_max_wait(graph):
    eng = Pair(graph)
    eng.submit(TRI)
    assert eng.pump() == []  # not full, not overdue -> keeps waiting
    assert eng.port.n_pending == 1
    eng.at(1.5)  # the oldest query is now past max_wait_s
    out = eng.pump()
    assert len(out) == 1 and out[0].status == STATUS_OK
    assert out[0].batch_size == 1
    assert eng.port.n_pending == 0
    eng.check_stats()


def test_batcher_launches_full_batch_immediately(graph):
    eng = Pair(graph, max_batch=2)
    qids = [eng.submit(TRI), eng.submit(TRI)]
    out = eng.pump()  # full batch -> no waiting
    assert len(out) == 2
    assert {r.batch_size for r in out} == {2}
    assert eng.port.stats["n_batches"] == 1
    eng.check_stats()
    eng.check_lanes(qids)


def test_batcher_groups_by_shape_bucket(graph):
    """Different-bucket templates never share a batch; same-bucket ones do."""
    eng = Pair(graph, max_batch=8)
    ids = [eng.submit(x) for x in (BIG, SMALL, BIG, SMALL)]
    eng.at(2.0)
    out = eng.pump()
    assert len(out) == 4
    by_id = {r.query_id: r for r in out}
    assert by_id[ids[0]].batch_id == by_id[ids[2]].batch_id
    assert by_id[ids[1]].batch_id == by_id[ids[3]].batch_id
    assert by_id[ids[0]].batch_id != by_id[ids[1]].batch_id
    assert eng.port.stats["n_batches"] == 2
    eng.check_stats()
    eng.check_lanes(ids)


def test_queued_deadline_cancellation_skips_execution(graph):
    """A query whose deadline passes while queued is emitted deadline_missed
    without device time; its batchmates run normally."""
    eng = Pair(graph)
    qid_dead = eng.submit(TRI, timeout_s=0.5)
    qid_live = eng.submit(TRI)
    eng.at(2.0)
    by_id = {r.query_id: r for r in eng.pump()}
    assert by_id[qid_dead].status == STATUS_DEADLINE_MISSED
    assert by_id[qid_dead].batch_id is None  # cancelled in queue, not run
    assert by_id[qid_live].status == STATUS_OK
    assert eng.port.stats["n_deadline_missed"] == 1
    eng.check_stats()


def test_count_mode_matches_standalone_prune(graph):
    eng = Pair(graph)
    qid = eng.submit(BIG, mode=MODE_COUNT)
    eng.at(2.0)
    (r,) = eng.pump()
    seq = rprune(_ref(graph), RT(*BIG))
    assert r.n_embeddings == int(rcount(seq.dg, seq.state, RT(*BIG)).n_embeddings)
    np.testing.assert_array_equal(
        eng.port.result(qid).result.state.omega.numpy(),
        np.asarray(seq.state.omega))
    eng.check_lanes([qid])


def _rows(blocks, n0):
    rows = (np.concatenate(list(blocks)) if blocks
            else np.empty((0, n0), np.int32))
    return rows[np.lexsort(rows.T[::-1])]


def test_stream_emission(graph):
    """Stream-mode queries emit the rows of the reference's stream and of
    the enumeration of the single prune."""
    eng = Pair(graph)
    qid = eng.submit(BIG, mode=MODE_STREAM)
    eng.at(2.0)
    eng.pump()
    got = _rows(list(eng.port.stream(qid, chunk=64)), 4)
    ref = _rows(list(eng.ref.stream(qid, chunk=64)), 4)
    seq = rprune(_ref(graph), RT(*BIG))
    want = _rows([renumerate(seq.dg, seq.state, RT(*BIG)).embeddings], 4)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 0


def test_stream_of_deadline_missed_query_is_empty(graph):
    eng = Pair(graph)
    qid = eng.submit(TRI, mode=MODE_STREAM, timeout_s=0.1)
    eng.at(5.0)
    eng.pump()
    assert list(eng.port.stream(qid)) == []
    with pytest.raises(KeyError):
        eng.port.stream(qid + 1)


def test_drain_32_query_workload_zero_dropped(graph):
    """A 32-query mixed workload drains completely, in the reference's
    batches: every query gets a result, none is dropped, 8 per batch."""
    eng = Pair(graph, max_batch=8)
    templates = example_workload(32, seed=1, labels_max=int(graph.labels.max()))
    rtemplates = rexample_workload(32, seed=1,
                                   labels_max=int(graph.labels.max()))
    assert [(t.labels.tolist(), sorted(t.edge_set)) for t in templates] == [
        (np.asarray(t.labels).tolist(), sorted(t.edge_set)) for t in rtemplates]
    ids = [eng.port.submit(t, mode=MODE_PRUNE) for t in templates]
    assert [eng.ref.submit(t, mode=MODE_PRUNE) for t in rtemplates] == ids
    results = eng.drain()
    assert len(results) == 32
    assert eng.port.n_pending == 0
    assert {r.query_id for r in results} == set(ids)
    assert all(r.status == STATUS_OK for r in results)
    assert eng.port.stats["n_completed"] == 32
    assert eng.port.stats["n_deadline_missed"] == 0
    assert eng.port.stats["n_batches"] <= 8
    assert max(b["B"] for b in eng.port.stats["batches"]) == 8
    eng.check_stats()
    eng.check_lanes(ids)


def test_policy_cache_routing_at_startup(graph, tmp_path):
    """A policy cache given at startup drives the batched route under the
    b<B>-prefixed key, in both packages."""
    bucket = registry.batch_bucket(2, registry.shard_bucket(1, graph.n, 1024))
    pol = registry.DispatchPolicy()
    pol.set_route("prune.nlcc", "cpu", bucket, registry.ROUTE_UNPACKED)
    pol.save(str(tmp_path / "port.json"))
    rpol = rregistry.DispatchPolicy()
    rpol.set_route("prune.nlcc", "cpu", rregistry.batch_bucket(
        2, rregistry.shard_bucket(1, graph.n, 1024)), rregistry.ROUTE_UNPACKED)
    rpol.save(tmp_path / "ref.json")
    clock, rclock = FakeClock(), FakeClock()
    eng = GraphQueryEngine(graph, policy=str(tmp_path / "port.json"),
                           max_batch=2, wave=1024, clock=clock, device="cpu")
    reng = RGraphQueryEngine(_ref(graph), policy=str(tmp_path / "ref.json"),
                             max_batch=2, wave=1024, clock=rclock)
    assert eng.stats.get("policy_active")
    for e, T in ((eng, Template), (reng, RT)):
        e.submit(T(*TRI))
        e.submit(T(*TRI))
    out, rout = eng.pump(), reng.pump()
    assert _decisions(out) == _decisions(rout)
    assert all(r.status == STATUS_OK for r in out)
    lane = eng.result(out[0].query_id).result
    assert lane.stats["dispatch_routes"]["prune.nlcc"] == "unpacked"
    np.testing.assert_array_equal(
        lane.state.omega.numpy(),
        np.asarray(reng.result(out[0].query_id).result.state.omega))


@pytest.mark.parametrize("stored,looked_up,want", [
    ("p1x256x1024", "b1xp1x256x1024", "packed"),    # b1 -> unbatched entry
    ("p1x256x1024", "b2xp1x256x1024", "fused"),     # b2: no fallback
    ("b1xp1x256x1024", "b1xp1x256x1024", "packed"),  # exact key
    ("*", "b1xp1x256x1024", "packed"),              # then the wildcard
    ("p1x256x1024", "b1", "fused"),                 # b1 of the wildcard
], ids=["b1_fallback", "b2_no_fallback", "exact", "wildcard", "b1_any"])
def test_route_entry_b1_fallback(stored, looked_up, want):
    """A batch-size-1 key with no entry of its own resolves to the unbatched
    entry before the wildcard, as the reference's lookup does."""
    def parse(key):
        if key == "*":
            return registry.BUCKET_ANY
        return tuple(p if not p.isdigit() else int(p) for p in key.split("x"))

    pol, rpol = registry.DispatchPolicy(), rregistry.DispatchPolicy()
    pol.set_route("prune.nlcc", "cpu", parse(stored), "packed")
    rpol.set_route("prune.nlcc", "cpu", parse(stored), "packed")
    registry.set_policy(pol)
    rregistry.set_policy(rpol)
    got = registry.resolve_route("prune.nlcc", parse(looked_up),
                                 default="fused", backend="cpu")
    rgot = rregistry.resolve_route("prune.nlcc", parse(looked_up),
                                   default="fused", backend="cpu")
    assert got == rgot == want
    assert registry.bucket_key(registry.batch_bucket(
        8, registry.shard_bucket(1, 1000, 1000))) == rregistry.bucket_key(
        rregistry.batch_bucket(8, rregistry.shard_bucket(1, 1000, 1000))) \
        == "b8xp1x1024x1024"


# ------------------------------------------------------------ sharded graph
@pytest.mark.parametrize("mode", [MODE_COUNT, MODE_STREAM])
def test_sharded_engine_against_the_reference_and_one_shard(graph, mode):
    """GraphQueryEngine(partition=2) against the reference's engine at
    P = 2 (the same decisions and lanes) and the port's one-shard engine
    (the same counts and rows), with a query cancelled in the queue and one
    cancelled inside its batch."""
    pair = Pair(graph, partition=2)
    assert pair.port.partition.P == 2
    one = GraphQueryEngine(graph, clock=pair.clock, device="cpu",
                           max_batch=4, max_wait_s=1.0)
    specs = [TRI, BIG, ([5, 4, 4, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
             ([4, 4, 3], [(0, 1), (1, 2), (2, 0)])]
    pair.at(0.0)
    qids = [pair.submit(s, mode=mode) for s in specs[:2]]
    qids.append(pair.submit(specs[2], mode=mode, timeout_s=0.5))
    for s in specs[:2]:
        one.submit(Template(*s), mode=mode)
    one.submit(Template(*specs[2]), mode=mode, timeout_s=0.5)
    pair.at(0.6)  # the third query expires in the queue
    qids.append(pair.submit(specs[3], mode=mode))
    one.submit(Template(*specs[3]), mode=mode)
    out = pair.drain()
    one_out = {r.query_id: r for r in one.drain()}
    assert [r.status for r in out].count(STATUS_DEADLINE_MISSED) == 1
    pair.check_stats()
    pair.check_lanes(qids)
    for r in out:
        o = one_out[r.query_id]
        assert (r.status, r.n_embeddings) == (o.status, o.n_embeddings)
        if r.status == STATUS_OK and mode == MODE_STREAM:
            rows = list(pair.port.stream(r.query_id))
            want = list(one.stream(r.query_id))
            got = (np.unique(np.concatenate(rows), axis=0) if rows else [])
            exp = (np.unique(np.concatenate(want), axis=0) if want else [])
            np.testing.assert_array_equal(got, exp)


def test_sharded_engine_cancels_inside_the_batch(graph):
    """A deadline that passes while its sharded batch runs zeroes the lane
    at a phase boundary, as the reference's sharded engine does."""

    class Ticking(FakeClock):
        def __call__(self):
            self.t += 0.25
            return self.t

    port = GraphQueryEngine(graph, partition=2, clock=Ticking(),
                            device="cpu", max_batch=2, max_wait_s=100.0)
    ref = RGraphQueryEngine(_ref(graph), partition=2, clock=Ticking(),
                            max_batch=2, max_wait_s=100.0)
    for eng, T in ((port, Template), (ref, RT)):
        eng.submit(T(*TRI), mode=MODE_COUNT)
        eng.submit(T(*BIG), mode=MODE_COUNT, timeout_s=1.2)
    out, rout = port.drain(), ref.drain()
    assert _decisions(out) == _decisions(rout)
    assert STATUS_DEADLINE_MISSED in [r.status for r in out]


def _mesh_rank(rank, P, init, out):
    """One rank of a two-rank gloo engine. Rank 1's clock runs 100 s ahead:
    left to itself it would expire every deadline; rank 0 decides."""
    import json
    import os
    import torch.distributed as dist
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.launch.mesh import make_shard_group

    torch.set_num_threads(1)
    group = make_shard_group(P, backend="gloo", init_method=init, rank=rank,
                             timeout_s=60)
    clock = FakeClock()
    clock.t = 100.0 * rank
    eng = GraphQueryEngine(rmat_graph(8, edge_factor=6, seed=3), mesh=group,
                           clock=clock, device="cpu", max_batch=3,
                           max_wait_s=1.0)
    for spec in (TRI, BIG, TRI, ([4, 4, 3], [(0, 1), (1, 2), (2, 0)])):
        eng.submit(Template(*spec), mode=MODE_COUNT, timeout_s=50.0)
    results = eng.drain()
    log = [{k: v for k, v in b.items() if k != "seconds"}
           for b in eng.stats["batches"]]
    with open(os.path.join(out, f"engine_{rank}.json"), "w") as f:
        json.dump({"results": [(r.query_id, r.status, r.batch_id,
                                r.batch_size, r.n_embeddings)
                               for r in results], "log": log}, f)
    dist.destroy_process_group()


def test_mesh_engine_ranks_agree(tmp_path, graph):
    """Two gloo ranks serve the same submissions with mesh=: identical
    results and batch logs, rank 0's decisions, the counts of the one-shard
    engine."""
    import json

    from torch_spawn import spawn

    spawn(_mesh_rank, 2, (2, f"file://{tmp_path / 'rdv'}", str(tmp_path)))
    runs = [json.load(open(tmp_path / f"engine_{r}.json")) for r in range(2)]
    assert runs[0] == runs[1]
    assert all(r[1] == STATUS_OK for r in runs[0]["results"])
    one = GraphQueryEngine(graph, clock=FakeClock(), device="cpu",
                           max_batch=3, max_wait_s=1.0)
    for spec in (TRI, BIG, TRI, ([4, 4, 3], [(0, 1), (1, 2), (2, 0)])):
        one.submit(Template(*spec), mode=MODE_COUNT, timeout_s=50.0)
    assert ([(r.query_id, r.n_embeddings) for r in one.drain()]
            == [(r[0], r[4]) for r in runs[0]["results"]])
