"""The port's span and counter recorder (`repro_torch.tracing`) on the
prune, count and batched serving paths, on the CPU at R-MAT scale 10.

Off, the recorder keeps nothing and hands out one shared no-op; on, the
answers are the same bit for bit, every span name is in `NAMES`, children
lie inside their parents and carry their root's trace, the phase spans last
exactly their `PhaseStat.seconds`, the NLCC host reads are the ones
`nlcc_host_syncs` counts, and every span that opens a profiler range starts
within 1 ms of that range's event on the profiler's clock.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro_torch import tracing  # noqa: E402
from repro_torch.core import nlcc, pipeline  # noqa: E402
from repro_torch.core.enumerate import count_matches  # noqa: E402
from repro_torch.core.lcc import TemplateDev, lcc_fixpoint  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.core.template import Template, generate_constraints  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structs import DeviceGraph  # noqa: E402
from repro_torch.serve.graph_query import (MODE_COUNT,  # noqa: E402
                                          GraphQueryEngine)

TRI = Template([3, 5, 7], [(0, 1), (1, 2), (2, 0)])
SQ = Template([3, 4, 6, 7], [(0, 1), (1, 2), (2, 3), (3, 0)])
PATH = Template([3, 4, 5, 3], [(0, 1), (1, 2), (2, 3)])
# the NLCC route's host reads, the ones `nlcc_host_syncs` counts
NLCC_READS = ("host.read/nlcc.heads", "host.read/nlcc.messages")
PHASE_SPAN = {"LCC": "prune.lcc", "NLCC-cycle": "prune.nlcc",
              "NLCC-path": "prune.nlcc", "NLCC-tds": "prune.tds"}


@pytest.fixture(scope="module")
def graph():
    return gen.rmat_graph(10, edge_factor=16, seed=3)


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.snapshot(reset=True)
    yield
    tracing.disable()
    tracing.snapshot(reset=True)


def _serve(g, templates, max_batch=4):
    eng = GraphQueryEngine(g, device="cpu", max_batch=max_batch)
    qids = [eng.submit(t, mode=MODE_COUNT) for t in templates]
    return eng, qids, {qr.query_id: qr for qr in eng.drain()}


def _work(g, collect_stats=False):
    """A prune and its count, then four queries served in one batch."""
    res = pipeline.prune(g, TRI, device="cpu", collect_stats=collect_stats)
    n = count_matches(res).n_embeddings
    eng, qids, out = _serve(g, [TRI, SQ, TRI, PATH])
    return res, n, eng, [out[q] for q in qids]


def _by_id(snap):
    return {s["span_id"]: s for s in snap["spans"]}


def test_off_is_one_shared_no_op_and_keeps_nothing(graph):
    assert not tracing.enabled()
    assert tracing.span("pipeline.prune", k=1) is tracing.OFF
    assert tracing.read("lcc.sweep") is tracing.OFF
    assert tracing.stamp() is None
    with tracing.span("prune.lcc") as sp:
        sp.at(1.0, 2.0)
    tracing.count("x")
    tracing.record("serve.queue", 1, 2, "query/0")
    res, n, _, served = _work(graph)
    assert n > 0 and all(qr.status == "ok" for qr in served)
    snap = tracing.snapshot()
    assert snap == {"spans": [], "counters": {}, "clock": "unix_ns"}


def test_answers_are_the_same_with_the_recorder_on(graph):
    res0, n0, _, served0 = _work(graph)
    tracing.enable()
    res1, n1, _, served1 = _work(graph)
    tracing.disable()
    assert tracing.snapshot()["spans"]
    assert n1 == n0
    assert torch.equal(res1.state.omega, res0.state.omega)
    assert torch.equal(res1.state.edge_active, res0.state.edge_active)
    for a, b in zip(served0, served1):
        assert a.n_embeddings == b.n_embeddings
        assert torch.equal(a.result.state.omega, b.result.state.omega)
        assert torch.equal(a.result.state.edge_active,
                           b.result.state.edge_active)


@pytest.mark.parametrize("collect_stats", [False, True])
def test_spans_nest_inside_their_roots(graph, collect_stats):
    tracing.enable()
    _work(graph, collect_stats=collect_stats)
    snap = tracing.snapshot()
    spans = _by_id(snap)
    assert {s["name"] for s in snap["spans"]} <= set(tracing.NAMES)
    roots = {s["name"] for s in snap["spans"] if s["parent_id"] is None}
    assert roots == {"pipeline.prune", "count.join", "engine.stage",
                     "serve.batch", "serve.queue"}
    for s in snap["spans"]:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent_id"] is None:
            if s["name"] != "serve.queue":
                assert s["trace_id"] == f"{s['name']}/{s['span_id']}"
            continue
        p = spans[s["parent_id"]]
        assert s["trace_id"] == p["trace_id"]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    reads = [s for s in snap["spans"] if s["name"] == tracing.READ]
    read_counts = {k: v for k, v in snap["counters"].items()
                   if k.startswith(f"{tracing.READ}/")}
    assert set(snap["counters"]) - set(read_counts) <= {"nlcc.source_uploads"}
    assert sum(read_counts.values()) == len(reads)
    for s in reads:
        assert snap["counters"][f"host.read/{s['attrs']['site']}"] >= 1


@pytest.mark.parametrize("template", [TRI, SQ, PATH], ids=["tri", "sq", "path"])
@pytest.mark.parametrize("collect_stats", [False, True])
def test_phase_spans_last_their_phase_seconds(graph, template, collect_stats):
    tracing.enable()
    res = pipeline.prune(graph, template, device="cpu",
                         collect_stats=collect_stats)
    snap = tracing.snapshot()
    phases = [s for s in snap["spans"] if s["name"].startswith("prune.")]
    assert [s["name"] for s in phases] == [PHASE_SPAN[p.phase]
                                           for p in res.phases]
    for s, p in zip(phases, res.phases):
        assert abs((s["end_ns"] - s["start_ns"]) * 1e-9 - p.seconds) <= 2e-9
    syncs = sum(p.extra.get("nlcc_host_syncs", 0) for p in res.phases)
    assert syncs >= 1
    assert sum(snap["counters"].get(k, 0) for k in NLCC_READS) == syncs
    sweeps = [s for s in snap["spans"] if s["name"] == "lcc.sweep"]
    assert len(sweeps) == res.stats["lcc_iterations"]


def test_one_source_upload_per_walk(graph):
    """A walk's source ids go up once however many waves it runs: on the
    cycle constraints of the square after LCC at 32 sources a wave."""
    tracing.enable()
    dg = DeviceGraph.from_host(graph, "cpu")
    state = lcc_fixpoint(dg, TemplateDev(SQ, dg.device), init_state(dg, SQ))
    stats, walks = {}, 0
    for c in generate_constraints(SQ, label_freq=graph.label_frequency()):
        if c.kind != "cycle":
            continue
        heads = [w[0] for w in nlcc.expand_walks(c)]
        walks += int(state.omega[:, heads].any(dim=0).sum())
        nlcc.verify_constraint(dg, state, c, wave=32, stats=stats)
    snap = tracing.snapshot()
    assert walks > 0 and stats["nlcc_fused_waves"] > walks
    assert snap["counters"]["nlcc.source_uploads"] == walks


def test_batched_head_reads_are_its_nlcc_host_syncs(graph):
    tracing.enable()
    _, qids, out = _serve(graph, [TRI, SQ, PATH, SQ])
    snap = tracing.snapshot()
    st = out[qids[0]].result.stats
    assert snap["counters"]["host.read/batch.heads"] == st["nlcc_host_syncs"]
    names = [s["name"] for s in snap["spans"]]
    assert names.count("batch.init") == 1 and names.count("batch.nlcc") >= 1
    assert names.count("lcc.sweep") == snap["counters"]["host.read/batch.sweep"]
    # the batch's phases follow its set-up: batch.init ends where the
    # batched seconds start, and the spans after it lie within them
    init = next(s for s in snap["spans"] if s["name"] == "batch.init")
    work = [s for s in snap["spans"]
            if s["name"] in ("batch.lcc", "batch.nlcc", "batch.tds")]
    assert min(s["start_ns"] for s in work) >= init["end_ns"]
    covered = sum(s["end_ns"] - s["start_ns"] for s in work) * 1e-9
    assert covered <= out[qids[0]].seconds


def test_spans_start_with_their_profiler_ranges(graph):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        tracing.enable()
        _work(graph)
        tracing.disable()
    snap = tracing.snapshot()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in tracing.NAMES:
            events.setdefault(e.name(), []).append(e.start_ns())
    want = {}
    for s in snap["spans"]:
        if s["name"] != "serve.queue":
            want.setdefault(s["name"], []).append(s["start_ns"])
    assert set(want) == set(events)
    for name, starts in want.items():
        got = sorted(events[name])
        assert len(got) == len(starts), name
        diff = np.abs(np.array(sorted(starts)) - np.array(got))
        assert diff.max() < 1_000_000, (name, int(diff.max()))


def test_queue_spans_end_before_their_batches(graph):
    tracing.enable()
    _, qids, out = _serve(graph, [TRI, SQ, TRI, SQ, PATH, TRI], max_batch=4)
    _serve(graph, [SQ, TRI])
    snap = tracing.snapshot()
    names = [s["name"] for s in snap["spans"]]
    assert names.count("engine.stage") == 2
    batches = [s for s in snap["spans"] if s["name"] == "serve.batch"]
    assert len(batches) == 3
    queues = [s for s in snap["spans"] if s["name"] == "serve.queue"]
    assert len(queues) == 8
    first = {q: out[q].batch_id for q in qids}
    for b in batches[:2]:
        assert b["attrs"]["batch_id"] in set(first.values())
        ids = b["attrs"]["query_ids"]
        assert sorted(ids) == sorted(q for q in qids
                                     if first[q] == b["attrs"]["batch_id"])
        for q in ids:
            (s,) = [s for s in queues[:6] if s["attrs"]["query_id"] == q]
            assert s["trace_id"] == f"query/{q}"
            assert s["end_ns"] <= b["start_ns"]
            assert s["parent_id"] is None


def test_row_budget_back_offs_keep_the_spans_whole(graph):
    # a row budget this small makes the TDS and the count's join back off
    # and retry their chunks inside their spans
    t = Template([6, 7, 8], [(0, 1), (1, 2), (2, 0)])
    want = count_matches(pipeline.prune(graph, t, device="cpu")).n_embeddings
    tracing.enable()
    res = pipeline.prune(graph, t, device="cpu", tds_max_rows=2000)
    assert count_matches(res, max_rows=2000).n_embeddings == want
    snap = tracing.snapshot()
    names = [s["name"] for s in snap["spans"]]
    tds_phases = [p for p in res.phases if p.phase == "NLCC-tds"]
    assert tds_phases
    assert names.count("tds.join") == names.count("prune.tds") == len(
        tds_phases)
    assert names.count("count.join") == 1
    spans = _by_id(snap)
    for s in snap["spans"]:
        if s["name"] == "tds.join":
            assert spans[s["parent_id"]]["name"] == "prune.tds"


def test_batch_phase_spans_do_not_overlap(graph):
    tracing.enable()
    _serve(graph, [TRI, SQ, PATH, SQ, TRI, PATH], max_batch=8)
    snap = tracing.snapshot()
    spans = _by_id(snap)
    (batch,) = [s for s in snap["spans"] if s["name"] == "serve.batch"]
    work = sorted((s for s in snap["spans"]
                   if s["name"] in ("batch.init", "batch.lcc", "batch.nlcc",
                                    "batch.tds")),
                  key=lambda s: s["start_ns"])
    assert {s["name"] for s in work} >= {"batch.init", "batch.lcc",
                                         "batch.nlcc", "batch.tds"}
    for a, b in zip(work, work[1:]):
        assert a["end_ns"] <= b["start_ns"]
    for s in work:
        assert spans[s["parent_id"]] is batch


def test_snapshot_reset_and_counters():
    tracing.enable()
    tracing.count("widgets", 3)
    with tracing.span("tds.join", lane=2) as sp:
        sp.at(end=None)
    with tracing.read("lcc.sweep"):
        pass
    snap = tracing.snapshot(reset=True)
    assert snap["counters"] == {"widgets": 3, "host.read/lcc.sweep": 1}
    assert [s["name"] for s in snap["spans"]] == ["tds.join", tracing.READ]
    assert snap["spans"][0]["attrs"] == {"lane": 2}
    assert snap["spans"][1]["attrs"] == {"site": "lcc.sweep"}
    assert tracing.snapshot() == {"spans": [], "counters": {},
                                  "clock": "unix_ns"}
