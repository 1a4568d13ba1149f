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
