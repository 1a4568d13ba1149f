"""The port's NLCC frontier edge-prune pass (`prune(nlcc_edge_prune=True)`)
against the JAX package's.

The cases are those of tests/test_perf_features.py: unique-label cycles of
length 3 to 6 and the cactus, where the pass makes the complete-walk TDS
unnecessary, each also held to the brute-force oracle; then a path template
and a template with repeated labels, where that fast path does not apply.
Omega, the edge mask, the phase trajectory with each phase's
`nlcc_edges_pruned`, `lcc_iterations` and the skip flag must be
bit-identical. One wave of the forward-backward pass is compared directly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import nlcc as rnlcc  # noqa: E402
from repro.core.oracle import solution_subgraph_oracle  # noqa: E402
from repro.core.pipeline import prune as rprune  # noqa: E402
from repro.core.state import init_state as rinit_state  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.structs import DeviceGraph as RDeviceGraph  # noqa: E402
from repro_torch.core import nlcc  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

CACTUS = ([0, 1, 2, 3, 4, 5, 6],
          [(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 5), (5, 3), (4, 6)])


@pytest.fixture(autouse=True)
def _port_policy(tmp_path, monkeypatch):
    """Every test starts with no port policy, its cache path under tmp_path."""
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    yield
    registry.clear_policy()


def _cycle(length):
    return list(range(length)), [(i, (i + 1) % length) for i in range(length)]


def _port_graph(g):
    return Graph(g.n, g.src, g.dst, g.labels)


def _trajectory(res):
    return [(p.phase, p.constraint, p.active_vertices, p.active_edges,
             p.omega_bits, p.extra.get("nlcc_edges_pruned"))
            for p in res.phases]


def _assert_same(res, ref):
    np.testing.assert_array_equal(res.omega, np.asarray(ref.state.omega))
    np.testing.assert_array_equal(res.state.edge_active.numpy(),
                                  np.asarray(ref.state.edge_active))
    np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
    assert _trajectory(res) == _trajectory(ref)
    assert res.stats.get("lcc_iterations") == ref.stats.get("lcc_iterations")
    assert (res.stats.get("tds_skipped_via_frontier_edge_prune")
            == ref.stats.get("tds_skipped_via_frontier_edge_prune"))


def _assert_exact(res, g, labels, edges):
    vm, em, om, _ = solution_subgraph_oracle(g, RT(labels, edges))
    order = np.lexsort((g.src, g.dst))
    np.testing.assert_array_equal(res.vertex_mask, vm)
    np.testing.assert_array_equal(res.edge_mask, em[order])
    np.testing.assert_array_equal(res.omega, om)


# (graph, template): the fast path applies to every one of them
FAST_PATH = {
    "cycle3": (dict(seed=11, n_labels=3), _cycle(3)),
    "cycle4": (dict(seed=12, n_labels=4), _cycle(4)),
    "cycle5": (dict(seed=13, n_labels=5), _cycle(5)),
    "cycle6": (dict(seed=14, n_labels=6), _cycle(6)),
    "cactus-0": (dict(seed=0, n_labels=7, n=140, avg_degree=6.5), CACTUS),
    "cactus-3": (dict(seed=3, n_labels=7, n=140, avg_degree=6.5), CACTUS),
    "cactus-7": (dict(seed=7, n_labels=7, n=140, avg_degree=6.5), CACTUS),
}


def _er(seed, n_labels, n=90, avg_degree=5.0):
    return rgen.erdos_renyi_graph(n, avg_degree, seed=seed, n_labels=n_labels)


@pytest.mark.parametrize("name", list(FAST_PATH))
def test_fast_path_matches_reference_and_oracle(name):
    gkw, (labels, edges) = FAST_PATH[name]
    g = _er(**gkw)
    ref = rprune(g, RT(labels, edges), nlcc_edge_prune=True, wave=64)
    res = prune(_port_graph(g), Template(labels, edges), device="cpu",
                nlcc_edge_prune=True, wave=64)
    assert res.stats["tds_skipped_via_frontier_edge_prune"] is True
    assert not any(c.endswith(":complete") for c in
                   (p["sig"] for p in res.stats["plan"]["phases"]))
    _assert_same(res, ref)
    _assert_exact(res, g, labels, edges)


def test_edge_prune_removes_arcs_like_the_reference():
    """A dense square search where the pass removes arcs: the count of
    pruned arcs per phase is part of the trajectory, on every NLCC route
    and at a wave that is no whole number of words."""
    g = rgen.erdos_renyi_graph(200, 12.0, seed=4, n_labels=4)
    labels, edges = _cycle(4)
    ref = rprune(g, RT(labels, edges), nlcc_edge_prune=True, wave=64)
    assert sum(p.extra.get("nlcc_edges_pruned", 0) for p in ref.phases) > 0
    for wave, route in ((64, "fused"), (64, "packed"), (64, "unpacked"),
                        (33, None)):
        res = prune(_port_graph(g), Template(labels, edges), device="cpu",
                    nlcc_edge_prune=True, wave=wave, nlcc_route=route)
        _assert_same(res, ref)


@pytest.mark.parametrize("labels,edges", [
    ([0, 1, 2, 0], [(0, 1), (1, 2), (2, 3)]),          # path: acyclic
    ([0, 1, 0, 1], [(0, 1), (1, 2), (2, 3), (3, 0)]),  # repeated labels
], ids=["path", "repeated-labels"])
def test_no_fast_path_still_matches_reference(labels, edges):
    g = rgen.erdos_renyi_graph(150, 6.0, seed=1, n_labels=3)
    ref = rprune(g, RT(labels, edges), nlcc_edge_prune=True, wave=64)
    res = prune(_port_graph(g), Template(labels, edges), device="cpu",
                nlcc_edge_prune=True, wave=64)
    assert "tds_skipped_via_frontier_edge_prune" not in res.stats
    assert any(p["sig"].endswith(":complete")
               for p in res.stats["plan"]["phases"])
    _assert_same(res, ref)
    _assert_exact(res, g, labels, edges)


@pytest.mark.parametrize("cyclic", [True, False], ids=["cycle", "path"])
def test_one_wave_of_frontiers_and_edges(cyclic):
    """`walk_frontiers_and_edges` on one wave of 40 sources (padded to two
    words inside): survivors and the per-hop live arcs equal the
    reference's boolean planes."""
    g = rgen.rmat_graph(8, edge_factor=8, seed=2, labeler="random", n_labels=3)
    labels, edges = ((_cycle(3)) if cyclic
                     else ([0, 1, 2, 0], [(0, 1), (1, 2), (2, 3)]))
    walk = (0, 1, 2, 0) if cyclic else (0, 1, 2, 3)
    rdg = RDeviceGraph.from_host(g)
    rstate = rinit_state(rdg, RT(labels, edges))
    dg = DeviceGraph.from_host(_port_graph(g), "cpu")
    state = init_state(dg, Template(labels, edges))
    omega = np.asarray(rstate.omega)
    np.testing.assert_array_equal(state.omega.numpy(), omega)
    sources = np.flatnonzero(omega[:, walk[0]])[:40].astype(np.int32)
    cand_r = jnp.stack([rstate.omega[:, q] for q in walk])
    cand = torch.stack([state.omega[:, q] for q in walk])
    want = rnlcc.walk_frontiers_and_edges(
        rdg, rstate, cand_r, cyclic, jnp.asarray(sources))
    got = nlcc.walk_frontiers_and_edges(
        dg, state, cand, cyclic, torch.from_numpy(sources.astype(np.int64)))
    assert got[1].any() and got[0].any()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_edge_prune_batch_holds_the_plane_budget():
    """The forward frontiers of one batch stay within the budget, in whole
    words, and never exceed the wave."""
    for n, L, wave in ((1 << 20, 6, 1024), (1 << 10, 3, 1024), (100, 2, 33)):
        s = nlcc._edge_prune_batch(n, L, wave)
        assert s % 32 == 0 and s >= 32
        assert s <= -(-wave // 32) * 32
        assert s == 32 or (L + 1) * n * s // 8 <= nlcc.EDGE_PRUNE_PLANE_BYTES
    assert nlcc._edge_prune_batch(1 << 20, 6, 1024) < 1024


def test_edge_prune_follows_no_policy_route():
    """The pass runs its own forward and backward hops, so a tuned NLCC
    route changes nothing in its result."""
    g = rgen.erdos_renyi_graph(120, 8.0, seed=6, n_labels=4)
    labels, edges = _cycle(4)
    base = prune(_port_graph(g), Template(labels, edges), device="cpu",
                 nlcc_edge_prune=True, wave=64)
    pol = registry.DispatchPolicy()
    pol.set_route("prune.nlcc", "cpu", registry.BUCKET_ANY,
                  registry.ROUTE_UNPACKED)
    registry.set_policy(pol)
    tuned = prune(_port_graph(g), Template(labels, edges), device="cpu",
                  nlcc_edge_prune=True, wave=64)
    assert tuned.stats["dispatch_routes"]["prune.nlcc"] == "unpacked"
    assert _trajectory(tuned) == _trajectory(base)
    np.testing.assert_array_equal(tuned.edge_mask, base.edge_mask)


def test_reversed_graph_is_built_once_and_reads_out_arcs():
    """`DeviceGraph.reversed()` is built on the first call and kept: the
    pass and the join context read that one copy. Its in-arcs of u are the
    out-arcs of u in ascending head order, and perm maps its arcs back."""
    from repro_torch.core.join import LocalJoinContext

    g = rgen.erdos_renyi_graph(60, 4.0, seed=8, n_labels=3)
    dg = DeviceGraph.from_host(_port_graph(g), "cpu")
    rev, perm = dg.reversed()
    assert dg.reversed()[0] is rev and dg.reversed()[1] is perm
    src, dst = dg.src.numpy(), dg.dst.numpy()
    order = np.lexsort((dst, src))
    np.testing.assert_array_equal(rev.dst.numpy(), src[order])
    np.testing.assert_array_equal(rev.src.numpy(), dst[order])
    np.testing.assert_array_equal(src[perm.numpy()], rev.dst.numpy())
    np.testing.assert_array_equal(
        rev.dst_ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(src, minlength=dg.n))]))
    ctx = LocalJoinContext(dg, init_state(dg, Template(*_cycle(3))))
    assert ctx.csr_off is rev.dst_ptr
