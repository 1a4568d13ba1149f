"""The paper's central claim through the port: the pruned solution subgraph
equals the union of all exact matches (100% precision and recall) and omega
equals the exact per-vertex match lists. The cases of
tests/test_precision_recall.py, run by the port on the CPU and held to the
JAX package's brute-force oracle, with the port's enumeration count beside
it; the fixed cases also with the frontier edge-prune pass on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

try:  # optional dev dependency: the property tests degrade to skips
    from hypothesis import HealthCheck, given, settings, strategies as st
except ImportError:
    given = None

from conftest import sample_template_from  # noqa: E402
from repro.core.oracle import solution_subgraph_oracle  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro_torch.core.enumerate import enumerate_matches  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph.structs import Graph  # noqa: E402


def _port(g, t):
    return (Graph(g.n, g.src, g.dst, g.labels),
            Template(t.labels.tolist(), sorted(t.edge_set)))


def _assert_exact(g, tmpl, **kw):
    pg, pt = _port(g, tmpl)
    res = prune(pg, pt, device="cpu", **kw)
    vm_o, em_o, omega_o, matches = solution_subgraph_oracle(g, tmpl)
    order = np.lexsort((g.src, g.dst))
    np.testing.assert_array_equal(res.vertex_mask, vm_o)
    np.testing.assert_array_equal(res.edge_mask, em_o[order])
    np.testing.assert_array_equal(res.omega, omega_o)
    assert enumerate_matches(res).n_embeddings == len(matches)
    return res, matches


@pytest.mark.parametrize("edge_prune", [False, True], ids=["default", "edge-prune"])
def test_fig2a_unrolled_cycle_rejected(edge_prune):
    tmpl = RT([0, 1, 2], [(0, 1), (1, 2), (2, 0)])
    bg = rgen.cycle_graph(6, [0, 1, 2, 0, 1, 2])
    res, matches = _assert_exact(bg, tmpl, nlcc_edge_prune=edge_prune)
    assert res.counts()["V*"] == 0 and len(matches) == 0


@pytest.mark.parametrize("edge_prune", [False, True], ids=["default", "edge-prune"])
def test_fig2b_path_constraint_needed(edge_prune):
    tmpl = RT([5, 1, 2, 5], [(0, 1), (1, 2), (2, 3)])
    bg = RGraph.from_undirected_pairs(
        5, [(0, 1), (1, 2), (2, 3), (3, 4)], [5, 1, 2, 1, 5])
    _assert_exact(bg, tmpl, nlcc_edge_prune=edge_prune)


@pytest.mark.parametrize("edge_prune", [False, True], ids=["default", "edge-prune"])
def test_fig2c_torus_survives_cycle_checks_but_tds_rejects(edge_prune):
    tmpl = RT([0, 1, 2, 3], [(0, 1), (1, 2), (2, 0), (1, 3), (3, 2)])
    bg = rgen.torus_graph(4, 3, np.tile([0, 1, 2, 3], 3))
    _assert_exact(bg, tmpl, nlcc_edge_prune=edge_prune)


@pytest.mark.parametrize("edge_prune", [False, True], ids=["default", "edge-prune"])
def test_triangle_exact_on_planted(edge_prune):
    tmpl = RT([0, 1, 2], [(0, 1), (1, 2), (2, 0)])
    g = RGraph.from_undirected_pairs(
        6, [(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 5), (5, 3)],
        [0, 1, 2, 0, 1, 2])
    _, matches = _assert_exact(g, tmpl, nlcc_edge_prune=edge_prune)
    assert len(matches) > 0


def _random_case(g, size, seed):
    if g.m == 0:
        return None
    try:
        tmpl = sample_template_from(g, size, seed)
    except ValueError:
        return None
    if tmpl.n0 < 2 or tmpl.m0 < 1:
        return None
    return tmpl


if given is not None:
    @settings(max_examples=15, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(seed=st.integers(0, 10_000), n=st.integers(20, 70),
           avg_deg=st.floats(2.0, 5.0), n_labels=st.integers(2, 5),
           size=st.integers(3, 6))
    def test_property_exactness_erdos_renyi(seed, n, avg_deg, n_labels, size):
        g = rgen.erdos_renyi_graph(n=n, avg_degree=avg_deg, seed=seed,
                                   n_labels=n_labels)
        tmpl = _random_case(g, size, seed + 1)
        if tmpl is not None:
            _assert_exact(g, tmpl)

    @settings(max_examples=6, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(seed=st.integers(0, 1000), size=st.integers(3, 5))
    def test_property_exactness_rmat(seed, size):
        g = rgen.rmat_graph(8, edge_factor=4, seed=seed)
        tmpl = _random_case(g, size, seed + 7)
        if tmpl is not None:
            _assert_exact(g, tmpl)
else:
    def test_property_exactness_erdos_renyi():
        pytest.importorskip("hypothesis")

    def test_property_exactness_rmat():
        pytest.importorskip("hypothesis")


def test_recall_never_violated_heuristic_mode():
    """Without the complete-TDS guarantee pruning may keep false positives
    but never drops a match."""
    for seed in range(5):
        g = rgen.erdos_renyi_graph(40, 4.0, seed=seed, n_labels=3)
        tmpl = _random_case(g, 4, seed + 3)
        if tmpl is None:
            continue
        pg, pt = _port(g, tmpl)
        res = prune(pg, pt, device="cpu", guarantee_precision=False)
        _, _, omega_o, _ = solution_subgraph_oracle(g, tmpl)
        assert np.all(res.omega[omega_o]), "heuristic mode dropped a true match"


def test_networkx_cross_check():
    """Independent oracle: networkx VF2 subgraph monomorphism count."""
    nx = pytest.importorskip("networkx")
    from networkx.algorithms import isomorphism as iso

    g = rgen.erdos_renyi_graph(30, 4.0, seed=11, n_labels=2)
    tmpl = sample_template_from(g, 4, 13)
    if tmpl.m0 < 2:
        tmpl = RT([0, 1, 0], [(0, 1), (1, 2)])
    pg, pt = _port(g, tmpl)
    er = enumerate_matches(prune(pg, pt, device="cpu"), route="device")
    G = nx.Graph()
    G.add_nodes_from((i, {"l": int(g.labels[i])}) for i in range(g.n))
    G.add_edges_from(zip(g.src.tolist(), g.dst.tolist()))
    T = nx.Graph()
    T.add_nodes_from((i, {"l": int(tmpl.labels[i])}) for i in range(tmpl.n0))
    T.add_edges_from(tmpl.edge_set)
    gm = iso.GraphMatcher(G, T, node_match=lambda a, b: a["l"] == b["l"])
    assert er.n_embeddings == sum(1 for _ in gm.subgraph_monomorphisms_iter())
