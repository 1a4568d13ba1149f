"""The port's sharded `sim` backend against the JAX package.

The counterparts of tests/test_sharded_engine.py on the port's `sim`
backend (every shard in one process), on the CPU: `prune(partition=P)` for
P in {1, 2, 4, 8} must equal the reference's single-device `prune` bit for
bit (omega, the edge mask, the vertex mask, the phase trajectory) across
the cyclic, path and TDS cases; the reference's own suite holds its `sim`
equal to its local engine, so the reference's `sim` runs once per case, at
one P, only for the counters it has apart from the local engine
(`lcc_iterations` on the lagged schedule and the wave counters). The
sharded joins, in both flavors and streaming, must give the reference's
embeddings and counts without gathering the reduced subgraph. Also the
receive-side OR's plain version against the reference's `segment_or` on a
skewed receive layout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.core.enumerate import enumerate_matches as renumerate  # noqa: E402
from repro.core.pipeline import prune as rprune  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import enumerate as enum_mod  # noqa: E402
from repro_torch.core import join as join_mod  # noqa: E402
from repro_torch.core.enumerate import (  # noqa: E402
    count_matches, enumerate_matches, stream_matches)
from repro_torch.core.oracle import enumerate_matches_bruteforce  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.state import PruneState, state_from_numpy  # noqa: E402
from repro_torch.core.template import Template, generate_constraints  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.partition import partition_graph  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402
from repro_torch.kernels import ops, registry  # noqa: E402

SHARDS = (1, 2, 4, 8)
# (name, labels, edges, prune kwargs, the P the reference's sim runs at)
CASES = [
    # CC constraints only (monocycle, unique labels, no complete TDS)
    ("cyclic", [8, 7, 7], [(0, 1), (1, 2), (2, 0)],
     dict(guarantee_precision=False), 2),
    # acyclic, repeated labels >= 3 hops apart -> PC + union-of-paths TDS
    ("path", [3, 4, 5, 3], [(0, 1), (1, 2), (2, 3)],
     dict(guarantee_precision=False), 4),
    # the complete-walk TDS annotation
    ("tds", [4, 3, 5, 3], [(0, 1), (1, 2), (2, 3)],
     dict(guarantee_precision=True), 8),
]
CASE_IDS = [c[0] for c in CASES]
SIM_COUNTERS = ("nlcc_waves", "nlcc_overlapped_waves", "nlcc_host_syncs",
                "nlcc_tokens", "nlcc_constraints", "nlcc_fused_waves",
                "nlcc_packed_waves", "nlcc_plane_waves", "tds_gather_bridge")
WAVE_STATS = {registry.ROUTE_FUSED: "nlcc_fused_waves",
              registry.ROUTE_PACKED: "nlcc_packed_waves",
              registry.ROUTE_UNPACKED: "nlcc_plane_waves"}


@pytest.fixture(autouse=True)
def _port_policy(tmp_path, monkeypatch):
    """Every test starts with no port policy, its cache path under tmp_path."""
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    yield
    registry.clear_policy()


def _ref(g):
    return RGraph(g.n, g.src, g.dst, g.labels)


def _traj(res):
    return [(p.phase, p.active_vertices, p.active_edges, p.omega_bits)
            for p in res.phases]


def _arrays(res):
    return dict(omega=np.asarray(res.omega), edge_mask=np.asarray(res.edge_mask),
                vertex_mask=np.asarray(res.vertex_mask), traj=_traj(res))


def _assert_same(want, got, tag):
    for k in ("omega", "edge_mask", "vertex_mask"):
        np.testing.assert_array_equal(want[k], getattr(got, k), err_msg=f"{tag} {k}")
    assert want["traj"] == _traj(got), tag


def _counters(res):
    return [(p.phase, {k: p.extra[k] for k in SIM_COUNTERS if k in p.extra})
            for p in res.phases]


@pytest.fixture(scope="module")
def graph():
    return gen.rmat_graph(9, edge_factor=6, seed=5)


@pytest.fixture(scope="module")
def reference(graph):
    """Per case, computed once: the reference's local prune and host-route
    enumeration, and its sim prune at the case's P (counters only)."""
    rg = _ref(graph)
    out = {}
    for name, labels, edges, kw, sim_p in CASES:
        base = rprune(rg, RT(labels, edges), **kw)
        enum = renumerate(base)
        sim = rprune(rg, RT(labels, edges), partition=sim_p, **kw)
        out[name] = dict(base=_arrays(base), emb=np.asarray(enum.embeddings),
                         n_emb=enum.n_embeddings,
                         vsets=enum.n_distinct_vertex_sets,
                         sim_p=sim_p, sim_iters=sim.stats["lcc_iterations"],
                         sim_counters=_counters(sim),
                         sim_routes=sim.stats["dispatch_routes"])
    return out


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _port_prune(graph, name, **extra):
    _, labels, edges, kw, _ = _case(name)
    return prune(graph, Template(labels, edges), device="cpu", **kw, **extra)


# ----------------------------------------------------------- sim backend
@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", CASE_IDS)
def test_sim_prune_parity(graph, reference, P, name):
    ref = reference[name]
    assert ref["base"]["vertex_mask"].sum() > 0  # nontrivial
    res = _port_prune(graph, name, partition=P)
    assert res.stats["backend"] == "sim"
    assert res.stats["sharded"]["P"] == P
    assert res.stats["sharded"]["bucket"] == registry.bucket_key(
        registry.shard_bucket(P, (graph.n + P - 1) // P, 1024))
    if name == "tds":
        # only the complete-TDS constraint: no wave runs, and the route says so
        assert res.stats["dispatch_routes"]["prune.nlcc"] == "none"
    _assert_same(ref["base"], res, f"sim P={P} {name}")


@pytest.mark.parametrize("name", CASE_IDS)
def test_sim_counters_equal_the_reference_sim(graph, reference, name):
    """`lcc_iterations` counts the lagged schedule's sweeps (one past the
    first unchanged one, at every P), and the wave counters (waves, tokens,
    overlapped waves, one host read per constraint) and reported routes are
    the reference sim's."""
    ref = reference[name]
    res = _port_prune(graph, name, partition=ref["sim_p"])
    assert res.stats["lcc_iterations"] == ref["sim_iters"]
    assert _counters(res) == ref["sim_counters"]
    assert res.stats["dispatch_routes"] == ref["sim_routes"]
    local = _port_prune(graph, name)
    assert local.stats["lcc_iterations"] < res.stats["lcc_iterations"]


@pytest.mark.parametrize("route", list(WAVE_STATS))
def test_sim_wave_routes_parity_and_reporting(graph, reference, route):
    """All three sharded wave routes prune identically, report the route
    taken, and count their waves under its key."""
    pol = registry.DispatchPolicy()
    pol.set_route("prune.nlcc", "cpu",
                  registry.shard_bucket(4, partition_graph(graph, 4).n_local, 1024),
                  route)
    registry.set_policy(pol)
    res = _port_prune(graph, "cyclic", partition=4)
    assert res.stats["dispatch_routes"]["prune.nlcc"] == route
    waves = sum(p.extra.get(WAVE_STATS[route], 0) for p in res.phases)
    others = sum(p.extra.get(k, 0) for p in res.phases
                 for r, k in WAVE_STATS.items() if r != route)
    assert waves > 0 and others == 0
    _assert_same(reference["cyclic"]["base"], res, f"route={route}")


def test_sim_multiplicity_counts_path():
    """Same-label multiplicity templates exercise the counts side of the
    sharded LCC's receive aggregation."""
    g = gen.rmat_graph(8, edge_factor=10, seed=6)
    lbl = int(np.bincount(g.labels).argmax())
    base = rprune(_ref(g), RT([lbl] * 3, [(0, 1), (0, 2)]),
                  guarantee_precision=False)
    assert base.counts()["V*"] > 0
    res = prune(g, Template([lbl] * 3, [(0, 1), (0, 2)]), device="cpu",
                partition=4, guarantee_precision=False)
    _assert_same(_arrays(base), res, "multiplicity")


def test_sim_wave_chunking_and_small_waves(graph):
    """wave=32 forces several waves per walk; survivors accumulate as on
    the local backend, one host read per constraint."""
    t = Template([8, 7, 7], [(0, 1), (1, 2), (2, 0)])
    base = rprune(_ref(graph), RT([8, 7, 7], [(0, 1), (1, 2), (2, 0)]),
                  wave=32, guarantee_precision=False)
    res = prune(graph, t, device="cpu", partition=4, wave=32,
                guarantee_precision=False)
    _assert_same(_arrays(base), res, "wave=32")
    local = prune(graph, t, device="cpu", wave=32, guarantee_precision=False)

    def total(r, k):
        return sum(p.extra.get(k, 0) for p in r.phases)

    waves, consts = total(res, "nlcc_waves"), total(res, "nlcc_constraints")
    assert consts > 0 and waves > consts
    assert total(res, "nlcc_host_syncs") == consts
    assert waves == total(local, "nlcc_waves")
    assert total(res, "nlcc_tokens") == total(local, "nlcc_tokens")
    assert total(res, "nlcc_overlapped_waves") == waves - 3  # 3 rotations


def test_sharded_fused_gate_composes_with_shard_local_shapes(
        graph, reference, monkeypatch):
    """A tuned fused choice whose shard-local resident state passes the
    reference's gate falls back to the packed per-hop route."""
    pol = registry.DispatchPolicy()
    pol.set_route("prune.nlcc", "cpu", registry.BUCKET_ANY, registry.ROUTE_FUSED)
    registry.set_policy(pol)
    assert engine.sharded_fused_eligible(64, 4, 8, 1024, 3)
    monkeypatch.setattr(engine, "SHARDED_FUSED_BUDGET", 1)
    assert not engine.sharded_fused_eligible(64, 4, 8, 1024, 3)
    res = _port_prune(graph, "cyclic", partition=4)
    assert res.stats["dispatch_routes"]["prune.nlcc"] == registry.ROUTE_PACKED
    _assert_same(reference["cyclic"]["base"], res, "gated fallback")


def test_shard_bucket_keys_and_the_fused_budget():
    b = registry.shard_bucket(4, 500, 1024)
    assert b == ("p4", 512, 1024)
    assert registry.bucket_key(b) == "p4x512x1024"
    assert registry.shard_bucket(8, 500, 1024) != b
    # the reference's gate, in bytes: 12 MiB
    assert engine.SHARDED_FUSED_BUDGET == 12 * 1024 * 1024
    assert engine.sharded_fused_resident_bytes(100, 2, 50, 64, 3) == (
        3 * 101 * 2 * 4 + 2 * 50 * 2 * 4 + 4 * 100)


def test_sharded_rejects_local_only_knobs(graph):
    t = Template([8, 7, 7], [(0, 1), (1, 2), (2, 0)])
    for kw in (dict(nlcc_route="fused"), dict(lcc_route="packed")):
        with pytest.raises(ValueError, match="local backend"):
            prune(graph, t, device="cpu", partition=2, **kw)
    with pytest.raises(ValueError, match="local-backend-only"):
        prune(graph, t, device="cpu", partition=2, edge_elimination=False)
    with pytest.raises(TypeError, match="host Graph"):
        prune(DeviceGraph.from_host(graph, "cpu"), t, partition=2)
    # resilience= is ported: it takes a ResilienceConfig, and a resilient
    # sharded prune equals the plain one
    with pytest.raises(TypeError, match="ResilienceConfig"):
        prune(graph, t, device="cpu", partition=2, resilience=object())
    from repro_torch.core.resilience import ResilienceConfig

    plain = prune(graph, t, device="cpu", partition=2)
    resilient = prune(graph, t, device="cpu", partition=2,
                      resilience=ResilienceConfig())
    assert torch.equal(plain.state.omega, resilient.state.omega)
    assert torch.equal(plain.state.edge_active, resilient.state.edge_active)
    assert resilient.stats["resilience"]["ladder"] == []


def test_sim_edge_prune_parity_and_change_flag():
    """nlcc_edge_prune runs through the gather bridge; an edge-only
    elimination (omega untouched) still triggers the LCC re-run. Two
    labeled 4-cycles and a label-compatible chord on no 4-cycle."""
    pairs = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4), (0, 5)]
    labels = [0, 1, 0, 1, 0, 1, 0, 1]
    tl, te = [0, 1, 0, 1], [(0, 1), (1, 2), (2, 3), (3, 0)]
    base = rprune(RGraph.from_undirected_pairs(8, pairs, labels), RT(tl, te),
                  nlcc_edge_prune=True, guarantee_precision=True)
    assert base.counts() == {"V*": 8, "E*": 16}
    res = prune(Graph.from_undirected_pairs(8, pairs, labels), Template(tl, te),
                device="cpu", partition=2, nlcc_edge_prune=True,
                guarantee_precision=True)
    _assert_same(_arrays(base), res, "edge_prune")


def test_sharded_change_flag_sees_edge_only_elimination(graph, monkeypatch):
    """The sharded nlcc() change flag watches edge_active, not only omega."""
    from repro_torch.core import nlcc as nlcc_mod

    t = Template([8, 7, 7], [(0, 1), (1, 2), (2, 0)])
    empty = PruneState(omega=torch.zeros((graph.n, t.n0), dtype=torch.bool),
                       edge_active=torch.ones(graph.m, dtype=torch.bool))

    def edge_only_prune(dg, state, c, template, wave, stats):
        ea = state.edge_active.clone()
        ea[int(torch.nonzero(ea)[0])] = False
        return PruneState(omega=state.omega, edge_active=ea)

    monkeypatch.setattr(nlcc_mod, "_edge_prune_pass", edge_only_prune)
    be = engine.make_backend(graph, t, device="cpu", partition=2,
                             nlcc_edge_prune=True)
    be.init(empty)
    c = [c for c in generate_constraints(t, guarantee_precision=False)
         if c.kind == "cycle"][0]
    changed = be.nlcc(c, {})
    after = be.gather_state()
    assert not bool(after.omega.any())
    assert int(after.edge_active.sum()) == graph.m - 1
    assert bool(changed)


def test_sharded_initial_state_roundtrip(graph):
    """initial_state= scatters onto the shards and gathers back losslessly:
    a prune resumed from the reference's state is that state's fixpoint."""
    rbase = rprune(_ref(graph), RT([4, 3, 5, 3], [(0, 1), (1, 2), (2, 3)]),
                   guarantee_precision=False)
    state = state_from_numpy(np.asarray(rbase.state.omega),
                             np.asarray(rbase.state.edge_active), "cpu")
    res = prune(graph, Template([4, 3, 5, 3], [(0, 1), (1, 2), (2, 3)]),
                device="cpu", partition=4, guarantee_precision=False,
                initial_state=state)
    np.testing.assert_array_equal(np.asarray(rbase.omega), res.omega)
    np.testing.assert_array_equal(np.asarray(rbase.state.edge_active),
                                  res.state.edge_active.numpy())


# ----------------------------------------------------- sharded enumeration
@pytest.fixture
def no_gather(monkeypatch):
    """Fail if enumeration compacts the reduced subgraph on the host."""
    calls = {"n": 0}
    real = enum_mod.compact_active

    def guard(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(enum_mod, "compact_active", guard)
    yield calls
    assert calls["n"] == 0, "sharded enumeration gathered the reduced subgraph"


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", CASE_IDS)
def test_sim_enumeration_parity(graph, reference, no_gather, P, name):
    """Both flavors of the sharded join give the reference's embeddings,
    counts and vertex sets; count mode breaks symmetry in flight."""
    ref = reference[name]
    res = _port_prune(graph, name, partition=P)
    for flavor in (registry.ROUTE_ROWSHARDED, registry.ROUTE_REPLICATED):
        st = {}
        se = enumerate_matches(res, route=flavor, stats=st)
        assert se.route == "device" and st["enumerate_join_engine"] == flavor
        np.testing.assert_array_equal(ref["emb"], se.embeddings,
                                      err_msg=f"{name} P={P} {flavor}")
        assert se.n_embeddings == ref["n_emb"]
        assert se.n_distinct_vertex_sets == ref["vsets"]
        sc = count_matches(res, route=flavor)
        assert sc.n_embeddings == ref["n_emb"]
        assert sc.n_canonical * sc.automorphisms == ref["n_emb"]
    if name == "cyclic":
        assert ref["n_emb"] > 0


def test_sim_enumeration_symmetry_counts_vs_oracle(graph, no_gather):
    """Symmetry-broken sharded counts x |Aut| equal the brute-force count
    (|Aut| = 6: a same-label triangle)."""
    t = Template([5, 5, 5], [(0, 1), (1, 2), (2, 0)])
    oracle = len(enumerate_matches_bruteforce(graph, t))
    assert oracle > 0
    sc = count_matches(prune(graph, t, device="cpu", partition=4))
    assert sc.automorphisms == 6
    assert sc.n_canonical * 6 == oracle == sc.n_embeddings


@pytest.mark.parametrize("flavor", [registry.ROUTE_ROWSHARDED,
                                    registry.ROUTE_REPLICATED])
def test_sim_enumeration_streaming_parity(graph, reference, no_gather, flavor):
    """stream_matches on a sharded result: blocks under a row budget that
    splits them concatenate to the reference's embeddings."""
    res = _port_prune(graph, "path", partition=2)
    st = {}
    blocks = list(stream_matches(res, max_rows=64, route=flavor, stats=st))
    assert len(blocks) > 1 and all(b.shape[0] <= 64 for b in blocks)
    assert st["enumerate_route"] == "device"
    cat = np.unique(np.concatenate(blocks, axis=0), axis=0)
    np.testing.assert_array_equal(reference["path"]["emb"], cat)


def _hub_graph():
    """Four hubs at ids 0..3 (one shard's block at every P) adjacent to
    every leaf: a walk through the hub label funnels most rows onto the
    hubs' owner."""
    n, hubs = 64, 4
    pairs = [(h, v) for h in range(hubs) for v in range(hubs, n)]
    return n, pairs, [1] * hubs + [0] * (n - hubs)


def test_rowsharded_flavor_policy_and_rejections(graph):
    """The policy's ("sharded", mode) bucket picks the flavor (rowsharded by
    default); flavors raise on a local result, route="host" on a sharded
    one."""
    t = Template([8, 7, 7], [(0, 1), (1, 2), (2, 0)])
    res = prune(graph, t, device="cpu", partition=2, guarantee_precision=False)
    st = {}
    count_matches(res, stats=st)
    assert st["enumerate_join_engine"] == registry.ROUTE_ROWSHARDED
    st = {}
    count_matches(res, route="device", stats=st)
    assert st["enumerate_join_engine"] == registry.ROUTE_ROWSHARDED
    pol = registry.DispatchPolicy()
    pol.set_route("enumerate.join", "cpu", ("sharded", "count"),
                  registry.ROUTE_REPLICATED)
    registry.set_policy(pol)
    st = {}
    se = count_matches(res, stats=st)
    assert se.route == "device"
    assert st["enumerate_join_engine"] == registry.ROUTE_REPLICATED
    local = prune(graph, t, device="cpu", guarantee_precision=False)
    with pytest.raises(ValueError, match="row placement"):
        enumerate_matches(local, route=registry.ROUTE_ROWSHARDED)
    with pytest.raises(ValueError, match="device-resident"):
        enumerate_matches(res, route="host")
    with pytest.raises(ValueError, match="device-resident"):
        list(stream_matches(res, route="host"))


@pytest.mark.parametrize("P", SHARDS)
def test_rowsharded_skewed_ownership_pads_not_drops(no_gather, P):
    """One shard owns every hub, hence most rows: the exchange buckets pad,
    never drop, and the rows equal the reference's host join's."""
    n, pairs, labels = _hub_graph()
    tl, te = [0, 1, 0], [(0, 1), (1, 2)]
    be = renumerate(rprune(RGraph.from_undirected_pairs(n, pairs, labels),
                           RT(tl, te), guarantee_precision=False), route="host")
    assert be.n_embeddings > 0
    res = prune(Graph.from_undirected_pairs(n, pairs, labels), Template(tl, te),
                device="cpu", partition=P, guarantee_precision=False)
    st = {}
    se = enumerate_matches(res, route=registry.ROUTE_ROWSHARDED, stats=st)
    np.testing.assert_array_equal(np.asarray(be.embeddings), se.embeddings)
    assert st["rowshard_owner_frac_max"] >= 0.8
    assert st["rowshard_bucket_occupancy_max"] <= st["rowshard_bucket_cap"]
    sc = count_matches(res, route=registry.ROUTE_ROWSHARDED)
    assert sc.n_embeddings == be.n_embeddings


def test_rowsharded_memory_scales_inverse_P():
    """On a balanced frontier the per-shard resident rows fall with P: the
    peak shard block at P = 8 is at most half the P = 1 table."""
    g = gen.erdos_renyi_graph(256, 6.0, seed=3, n_labels=2)
    t = Template([0, 1, 0], [(0, 1), (1, 2)])
    peaks, counts = {}, {}
    for P in (1, 8):
        res = prune(g, t, device="cpu", partition=P, guarantee_precision=False)
        st = {}
        counts[P] = count_matches(res, route=registry.ROUTE_ROWSHARDED,
                                  stats=st).n_embeddings
        peaks[P] = st["rowshard_peak_shard_rows"]
        assert (st["rowshard_resident_rows_max"]
                < 2 * max(st["rowshard_peak_shard_rows"], 1) + 1)
    assert counts[1] == counts[8] > 0
    assert peaks[8] * 2 <= peaks[1]


def test_rowsharded_int32_capacity_guard():
    """A per-shard expansion capacity past int32 raises, as the reference's
    slot-map guard does, instead of wrapping."""
    with pytest.raises(NotImplementedError, match="int32"):
        join_mod._guard_int32(2 ** 31, "unit slots")
    join_mod._guard_int32(2 ** 31 - 1, "unit slots")
    n, pairs, labels = _hub_graph()
    t = Template([0, 1, 0], [(0, 1), (1, 2)])
    res = prune(Graph.from_undirected_pairs(n, pairs, labels), t, device="cpu",
                partition=2, guarantee_precision=False)
    eng = enum_mod._make_engine(
        registry.ROUTE_ROWSHARDED, res.dg, res.state, t,
        enum_mod.template_walk(t), 2 ** 40, False, None, res.backend)
    # a private copy of the row plan: the partition's cached one stays clean
    eng.rp = dataclasses.replace(
        eng.rp, deg=np.full_like(eng.rp.deg, np.int64(2) ** 27))
    rows = eng.seed(eng.sources()[:64])
    with pytest.raises(NotImplementedError, match="int32"):
        eng.step(rows, 1)


# ------------------------------------------------ the receive-side OR
@pytest.mark.parametrize("W", [1, 2, 3])
def test_segment_or_plain_equals_the_reference(W):
    """`ops.bitset_segment_or` (its plain version on the CPU) over the
    partition's receive arc list equals the reference's `segment_or` over
    each shard's dst-sorted received words, on random words (pads too, and
    a third of the messages zero) and the hub graph's skewed layout, where
    one shard receives most arcs."""
    import jax
    import jax.numpy as jnp
    from repro.graph.segment_ops import SegmentMeta, segment_or

    n, pairs, labels = _hub_graph()
    part = partition_graph(Graph.from_undirected_pairs(n, pairs, labels), 4)
    P, S, nl = part.P, part.P * part.B, part.n_local
    rng = np.random.default_rng(W)
    recv = rng.integers(-2**31, 2**31, size=(P, S, W), dtype=np.int64
                        ).astype(np.int32)
    recv[:, ::3] = 0            # zero messages, as inactive senders send
    d = part.device_arrays("cpu")
    got = ops.bitset_segment_or(
        torch.from_numpy(recv.reshape(P * S, W)), d["rx_src"], d["rx_dst"],
        d["rx_ptr"], P * nl).numpy().reshape(P, nl, W)
    in_arcs = np.diff(d["rx_ptr"].numpy()).reshape(P, nl).sum(axis=1)
    assert in_arcs.max() > 2 * in_arcs.min()
    sortedv = np.take_along_axis(recv.view(np.uint32),
                                 part.recv_perm[..., None].astype(np.int64), 1)
    per_shard = jax.jit(jax.vmap(lambda v, st, le: segment_or(
        v, SegmentMeta(is_start=st, last_edge_of_vertex=le), nl)))
    want = np.asarray(per_shard(jnp.asarray(sortedv),
                                jnp.asarray(part.recv_is_start),
                                jnp.asarray(part.recv_last_edge)))
    np.testing.assert_array_equal(got, want.view(np.int32))
    # an arc mask: every arc active is the default, an inactive arc
    # contributes nothing
    m = d["rx_src"].shape[0]
    for active, expect in ((torch.ones(m, dtype=torch.bool), got),
                           (torch.zeros(m, dtype=torch.bool), 0 * got)):
        out = ops.bitset_segment_or(torch.from_numpy(recv.reshape(P * S, W)),
                                    d["rx_src"], d["rx_dst"], d["rx_ptr"],
                                    P * nl, active)
        np.testing.assert_array_equal(out.numpy().reshape(P, nl, W), expect)
