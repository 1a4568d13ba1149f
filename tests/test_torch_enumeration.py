"""The port's enumeration routes against the JAX package's and the oracle.

The templates are those of tests/test_enumeration.py. The port's host join
and device join (`route=`) must give the same embeddings, counts and vertex
sets as each other and as the reference's join on the same graph (whose
own tests hold its host and device joins equal); count mode must equal the brute-force oracle. Also: `stream_matches`
against materialize, the chunk-1 overflow falling back to streaming, the
route following an injected policy, and the sharded row placements raising.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.core.enumerate import enumerate_matches as renumerate  # noqa: E402
from repro.core.pipeline import prune as rprune  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro_torch.core.enumerate import (  # noqa: E402
    count_matches, enumerate_matches, stream_matches)
from repro_torch.core.oracle import enumerate_matches_bruteforce  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

TEMPLATES = [
    ("path-repeat", ([0, 1, 2, 1], [(0, 1), (1, 2), (2, 3)])),
    ("triangle", ([0, 1, 2], [(0, 1), (1, 2), (2, 0)])),
    ("triangle-sym", ([1, 1, 1], [(0, 1), (1, 2), (2, 0)])),
    ("bowtie", ([0, 1, 1, 2, 2],
                [(0, 1), (1, 2), (2, 0), (0, 3), (3, 4), (4, 0)])),
]
ROUTES = ("host", "device")


@pytest.fixture(autouse=True)
def _port_policy(tmp_path, monkeypatch):
    """Every test starts with no port policy, its cache path under tmp_path."""
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    yield
    registry.clear_policy()


def _er(seed=1, n=150, deg=6.0, n_labels=3):
    return gen.erdos_renyi_graph(n, deg, seed=seed, n_labels=n_labels)


def _ref_graph(g):
    return RGraph(g.n, g.src, g.dst, g.labels)


def _prune(g, labels, edges):
    return prune(g, Template(labels, edges), device="cpu")


@pytest.mark.parametrize("case", TEMPLATES, ids=lambda c: c[0])
def test_host_device_route_parity(case):
    """Host and device joins agree with each other and with the
    reference's join: embeddings, counts, vertex sets."""
    _, (labels, edges) = case
    g = _er()
    res = _prune(g, labels, edges)
    host = enumerate_matches(res, route="host")
    dev = enumerate_matches(res, route="device")
    assert (host.route, dev.route) == ("host", "device")
    np.testing.assert_array_equal(host.embeddings, dev.embeddings)
    assert host.n_embeddings == dev.n_embeddings
    assert host.n_distinct_vertex_sets == dev.n_distinct_vertex_sets
    rres = rprune(_ref_graph(g), RT(labels, edges))
    want = renumerate(rres.dg, rres.state, rres.template, route="host")
    np.testing.assert_array_equal(dev.embeddings, np.asarray(want.embeddings))
    assert dev.n_distinct_vertex_sets == want.n_distinct_vertex_sets
    assert host.n_embeddings == len(enumerate_matches_bruteforce(
        g, Template(labels, edges)))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", TEMPLATES, ids=lambda c: c[0])
def test_count_mode_matches_oracle(case, route):
    """Symmetry restrictions in flight: canonical count x |Aut| equals the
    oracle's embedding count, rows never materialized."""
    _, (labels, edges) = case
    g = _er(seed=2)
    tmpl = Template(labels, edges)
    res = prune(g, tmpl, device="cpu")
    oracle = enumerate_matches_bruteforce(g, tmpl)
    c = count_matches(res, route=route)
    assert c.mode == "count" and c.route == route
    assert c.embeddings.shape == (0, tmpl.n0)
    assert c.n_distinct_vertex_sets == -1
    assert c.n_embeddings == len(oracle)
    assert c.n_canonical * c.automorphisms == len(oracle)


@pytest.mark.parametrize("route", ROUTES)
def test_symmetry_broken_materialize_is_canonical(route):
    g = _er(seed=3, n_labels=2)
    res = _prune(g, [1, 1, 1], [(0, 1), (1, 2), (2, 0)])
    full = enumerate_matches(res, route=route)
    canon = enumerate_matches(res, symmetry_break=True, route=route)
    assert canon.n_canonical * canon.automorphisms == full.n_embeddings
    emb = canon.embeddings
    assert np.all(emb[:, 0] < emb[:, 1]) and np.all(emb[:, 1] < emb[:, 2])
    full_set = {tuple(r) for r in full.embeddings}
    assert all(tuple(r) in full_set for r in emb)


@pytest.mark.parametrize("route", ROUTES)
def test_stream_matches_equals_materialize(route):
    g = _er(seed=4)
    res = _prune(g, [0, 1, 2, 1], [(0, 1), (1, 2), (2, 3)])
    full = enumerate_matches(res)
    stats = {}
    blocks = list(stream_matches(res, max_rows=40, route=route, stats=stats))
    assert stats["enumerate_route"] == route
    assert stats["enumerate_mode"] == "stream"
    assert len(blocks) > 1 and all(b.shape[1] == 4 for b in blocks)
    cat = np.unique(np.concatenate(blocks, axis=0), axis=0)
    np.testing.assert_array_equal(cat, full.embeddings)
    assert sum(b.shape[0] for b in blocks) == full.n_embeddings


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", ["materialize", "count"])
def test_chunk1_overflow_falls_back_to_streaming(route, mode):
    """A max_rows so tight that a single source overflows: enumeration
    finishes through the streaming emitter and still equals the oracle."""
    g = _er(seed=5)
    tmpl = Template([0, 1, 2, 1], [(0, 1), (1, 2), (2, 3)])
    res = prune(g, tmpl, device="cpu")
    oracle = enumerate_matches_bruteforce(g, tmpl)
    stats = {}
    enum = enumerate_matches(res, max_rows=3, chunk=8, route=route, mode=mode,
                             stats=stats)
    assert stats.get("enum_stream_fallbacks", 0) > 0
    assert enum.n_embeddings == len(oracle)


def test_empty_result_both_modes_and_routes():
    g = gen.star_graph(10, center_label=0, leaf_label=1)
    res = _prune(g, [0, 1, 1], [(0, 1), (1, 2), (0, 2)])
    for route in ROUTES:
        for mode in ("materialize", "count"):
            assert enumerate_matches(res, route=route, mode=mode).n_embeddings == 0
        assert list(stream_matches(res, route=route)) == []


def test_enumerate_join_route_follows_policy():
    """A tuned ``enumerate.join`` decision routes the join and lands in
    stats; the untuned default is the host join; a pin beats the policy."""
    g = _er(seed=6)
    res = _prune(g, [0, 1, 2], [(0, 1), (1, 2), (2, 0)])
    stats = {}
    c0 = count_matches(res, stats=stats)
    assert c0.route == stats["enumerate_route"] == registry.ROUTE_HOST
    pol = registry.DispatchPolicy()
    pol.set_route("enumerate.join", "cpu", ("local", "count"),
                  registry.ROUTE_DEVICE)
    registry.set_policy(pol)
    stats = {}
    c = count_matches(res, stats=stats)
    assert c.route == stats["enumerate_route"] == registry.ROUTE_DEVICE
    assert c.n_embeddings == c0.n_embeddings
    # the policy's entry is per (kind, mode) bucket and per backend
    assert enumerate_matches(res).route == registry.ROUTE_HOST
    assert count_matches(res, route="host").route == registry.ROUTE_HOST
    pol.set_route("enumerate.join", "cuda", registry.BUCKET_ANY,
                  registry.ROUTE_DEVICE)
    assert enumerate_matches(res).route == registry.ROUTE_HOST
    # a stale candidate in the cache falls back to the default
    pol.set_route("enumerate.join", "cpu", ("local", "materialize"),
                  "rowsharded")
    assert enumerate_matches(res).route == registry.ROUTE_HOST


@pytest.mark.parametrize("route,match", [
    ("rowsharded", "sharded row placement"),
    ("replicated", "sharded row placement"),
    ("gpu", "unknown enumerate.join route"),
])
def test_sharded_and_unknown_routes_raise(route, match):
    g = _er(seed=7, n=60)
    res = _prune(g, [0, 1, 2], [(0, 1), (1, 2), (2, 0)])
    with pytest.raises(ValueError, match=match):
        enumerate_matches(res, route=route)
    with pytest.raises(ValueError, match=match):
        list(stream_matches(res, route=route))


def test_device_join_reads_scalars_only():
    """The device join's row table stays a device tensor between steps,
    and expansion slots count every out-arc of the frontier rows."""
    g = _er(seed=8)
    res = _prune(g, [0, 1, 2], [(0, 1), (1, 2), (2, 0)])
    from repro_torch.core import enumerate as enum_mod
    from repro_torch.core import join as join_mod

    walk = enum_mod.template_walk(res.template)
    eng = join_mod.DeviceJoin(join_mod.LocalJoinContext(res.dg, res.state),
                              res.template, walk, 10_000, stats={})
    rows = eng.seed(eng.sources())
    for r in range(1, len(eng.steps) + 1):
        rows = eng.step(rows, r)
        assert isinstance(rows, torch.Tensor)
    assert eng.stats["join_expansions"] > 0
    host = enumerate_matches(res, route="host")
    np.testing.assert_array_equal(np.unique(eng.emit(rows), axis=0),
                                  host.embeddings)
