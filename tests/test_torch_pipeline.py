"""The port's prune -> enumerate main path against the JAX package's.

The scenarios are those of tests/test_system.py plus R-MAT runs of RMAT-2,
Q4 and the unique-label hexagon. Each runs through the reference once and
through the port (on the CPU, i.e. the plain versions of the kernels) on
every LCC route x NLCC route: omega, the edge mask, the phase trajectory and
`lcc_iterations` must be bit-identical. Enumeration is compared by counts and
canonical (np.unique'd) embedding sets, against the reference and the
brute-force oracle.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.core import enumerate as renum_mod  # noqa: E402
from repro.core.oracle import enumerate_matches_bruteforce  # noqa: E402
from repro.core.pipeline import prune as rprune  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.structs import DeviceGraph as RDeviceGraph  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro_torch.core import oracle  # noqa: E402
from repro_torch.core.enumerate import count_matches, enumerate_matches  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.state import state_from_numpy  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402

DIAMOND = ([7, 8, 9, 8], [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)])
HEX = ([3, 4, 5, 6, 7, 8], [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)])


def _scenarios():
    needle = RGraph.from_undirected_pairs(4, DIAMOND[1], DIAMOND[0])
    bg = rgen.rmat_graph(8, edge_factor=4, seed=3, labeler="random", n_labels=6)
    rmat9 = rgen.rmat_graph(9, edge_factor=8, seed=1)
    return {
        "fig2a": (rgen.cycle_graph(9, [0, 1, 2] * 3),
                  ([0, 1, 2], [(0, 1), (1, 2), (2, 0)])),
        "fig2c": (rgen.torus_graph(4, 3, np.zeros(12, dtype=np.int32)),
                  ([0] * 5, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3), (2, 4),
                             (1, 4), (3, 4)])),
        "needles": (rgen.planted_pattern_graph(bg, needle, n_copies=3, seed=5),
                    DIAMOND),
        "no_match": (rgen.star_graph(10, center_label=0, leaf_label=1),
                     ([0, 1, 1], [(0, 1), (1, 2), (0, 2)])),
        "single_vertex": (rgen.star_graph(4, center_label=3, leaf_label=1),
                          ([1], [])),
        "triangle_er": (rgen.erdos_renyi_graph(120, 5.0, seed=2, n_labels=3),
                        ([0, 1, 2], [(0, 1), (1, 2), (2, 0)])),
        "path_constraint": (rgen.erdos_renyi_graph(150, 6.0, seed=1, n_labels=3),
                            ([0, 1, 2, 0], [(0, 1), (1, 2), (2, 3)])),
        "rmat2": (rmat9, ([2, 3, 4, 5, 6, 7, 1],
                          [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (1, 6)])),
        "q4": (rmat9, ([3, 4, 5, 4, 2], [(0, 1), (0, 2), (0, 3), (1, 4)])),
        "hex": (rgen.rmat_graph(9, edge_factor=16, seed=3), HEX),
    }


SCENARIOS = _scenarios()
ROUTES = list(itertools.product(["packed", "unpacked"],
                                ["fused", "packed", "unpacked"]))
WAVE = 64  # two packed words per vertex


def _port_graph(g):
    return Graph(g.n, g.src, g.dst, g.labels)


def _trajectory(res):
    return [(p.phase, p.constraint, p.active_vertices, p.active_edges,
             p.omega_bits) for p in res.phases]


@pytest.fixture(scope="module")
def reference():
    """Reference prune + enumeration per scenario, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            g, (labels, edges) = SCENARIOS[name]
            res = rprune(g, RT(labels, edges), wave=WAVE)
            enum = renum_mod.enumerate_matches(res.dg, res.state, res.template)
            cache[name] = (res, enum)
        return cache[name]

    return get


@pytest.mark.parametrize("lcc_route,nlcc_route", ROUTES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_prune_matches_reference_on_every_route(name, lcc_route, nlcc_route,
                                                reference):
    g, (labels, edges) = SCENARIOS[name]
    ref, _ = reference(name)
    res = prune(_port_graph(g), Template(labels, edges), device="cpu",
                wave=WAVE, lcc_route=lcc_route, nlcc_route=nlcc_route)
    np.testing.assert_array_equal(res.omega, np.asarray(ref.state.omega))
    np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
    assert _trajectory(res) == _trajectory(ref)
    assert res.stats.get("lcc_iterations") == ref.stats.get("lcc_iterations")
    assert res.counts() == ref.counts()


@pytest.mark.parametrize("wave", [32, 1024])
@pytest.mark.parametrize("name", ["fig2a", "triangle_er", "path_constraint",
                                  "needles", "hex"])
def test_fused_waves_match_reference_at_any_wave_width(name, wave, reference):
    """The fused route's waves, each seeded from its slice of the walk's one
    upload of source ids: at 32 sources a wave and at 1,024 (one wave,
    mostly pads) omega, the edge mask and the trajectory equal the
    reference's, which the wave width does not move."""
    g, (labels, edges) = SCENARIOS[name]
    ref, _ = reference(name)
    res = prune(_port_graph(g), Template(labels, edges), device="cpu",
                wave=wave, nlcc_route="fused")
    assert sum(p.extra.get("nlcc_fused_waves", 0) for p in res.phases) > 0
    np.testing.assert_array_equal(res.omega, np.asarray(ref.state.omega))
    np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
    assert _trajectory(res) == _trajectory(ref)
    assert res.counts() == ref.counts()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_enumeration_matches_reference_and_oracle(name, reference):
    g, (labels, edges) = SCENARIOS[name]
    _, ref_enum = reference(name)
    res = prune(_port_graph(g), Template(labels, edges), device="cpu", wave=WAVE)
    enum = enumerate_matches(res)
    cnt = count_matches(res)
    want = np.unique(np.asarray(ref_enum.embeddings).reshape(-1, len(labels)), axis=0)
    np.testing.assert_array_equal(np.unique(enum.embeddings, axis=0), want)
    assert enum.n_embeddings == ref_enum.n_embeddings == cnt.n_embeddings
    assert enum.n_distinct_vertex_sets == ref_enum.n_distinct_vertex_sets
    brute = oracle.enumerate_matches_bruteforce(_port_graph(g), Template(labels, edges))
    assert len(brute) == len(enumerate_matches_bruteforce(g, RT(labels, edges)))
    assert enum.n_embeddings == len(brute)
    if brute:
        np.testing.assert_array_equal(
            np.unique(np.asarray(brute, np.int32), axis=0), want)


def test_prune_ablations_and_eager_stats_match_reference():
    g, (labels, edges) = SCENARIOS["path_constraint"]
    for kw in (dict(collect_stats=True), dict(edge_elimination=False),
               dict(work_aggregation=False), dict(guarantee_precision=False)):
        ref = rprune(g, RT(labels, edges), wave=WAVE, **kw)
        res = prune(_port_graph(g), Template(labels, edges), device="cpu",
                    wave=WAVE, **kw)
        np.testing.assert_array_equal(res.omega, np.asarray(ref.state.omega))
        np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
        assert _trajectory(res) == _trajectory(ref)
        assert res.stats.get("lcc_iterations") == ref.stats.get("lcc_iterations")


def test_state_from_numpy_carries_a_reference_state_across():
    """Start the port mid-pipeline from the reference's state after its
    initial LCC; the rest of the run must land where the reference does."""
    from repro.core.lcc import TemplateDev, lcc_fixpoint
    from repro.core.state import init_state

    g, (labels, edges) = SCENARIOS["triangle_er"]
    rdg = RDeviceGraph.from_host(g)
    rt = RT(labels, edges)
    mid = lcc_fixpoint(rdg, TemplateDev(rt), init_state(rdg, rt))
    ref = rprune(g, rt, initial_state=mid, wave=WAVE)
    st = state_from_numpy(np.asarray(mid.omega), np.asarray(mid.edge_active), "cpu")
    res = prune(_port_graph(g), Template(labels, edges), device="cpu",
                initial_state=st, wave=WAVE)
    np.testing.assert_array_equal(res.omega, np.asarray(ref.state.omega))
    np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
    assert _trajectory(res) == _trajectory(ref)


def test_generators_and_device_graph_match_reference():
    """Same seeds, same graphs: the port's 1-D key dedup gives the identical
    arc lists, and the dst-sorted layout is the reference's."""
    pairs = [
        (rgen.rmat_graph(9, edge_factor=8, seed=1), gen.rmat_graph(9, edge_factor=8, seed=1)),
        (rgen.rmat_graph(8, 4, "chakrabarti", 3, "random", 6),
         gen.rmat_graph(8, 4, "chakrabarti", 3, "random", 6)),
        (rgen.erdos_renyi_graph(150, 6.0, seed=1, n_labels=3),
         gen.erdos_renyi_graph(150, 6.0, seed=1, n_labels=3)),
        (rgen.torus_graph(4, 3, np.arange(12)), gen.torus_graph(4, 3, np.arange(12))),
        (rgen.cycle_graph(9, np.arange(9)), gen.cycle_graph(9, np.arange(9))),
        (rgen.star_graph(6, 1, 2), gen.star_graph(6, 1, 2)),
        (rgen.path_graph(7, np.arange(7)), gen.path_graph(7, np.arange(7))),
        (rgen.clique_graph(5, np.arange(5)), gen.clique_graph(5, np.arange(5))),
    ]
    bg_r, bg_t = pairs[1]
    pat_r = RGraph.from_undirected_pairs(4, DIAMOND[1], DIAMOND[0])
    pat_t = Graph.from_undirected_pairs(4, DIAMOND[1], DIAMOND[0])
    pairs.append((rgen.planted_pattern_graph(bg_r, pat_r, 3, seed=5),
                  gen.planted_pattern_graph(bg_t, pat_t, 3, seed=5)))
    for r, t in pairs:
        assert t.n == r.n
        for a in ("src", "dst", "labels"):
            np.testing.assert_array_equal(getattr(t, a), getattr(r, a))
        np.testing.assert_array_equal(t.degrees(), r.degrees())
        for x, y in zip(t.csr(), r.csr()):
            np.testing.assert_array_equal(x, y)
        rdg, dg = RDeviceGraph.from_host(r), DeviceGraph.from_host(t, "cpu")
        np.testing.assert_array_equal(dg.src.numpy(), np.asarray(rdg.src))
        np.testing.assert_array_equal(dg.dst.numpy(), np.asarray(rdg.dst))
        ptr = dg.dst_ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == dg.m
        np.testing.assert_array_equal(np.repeat(np.arange(dg.n), np.diff(ptr)),
                                      dg.dst.numpy())


def test_unported_options_raise(tmp_path, reference):
    """Every option of the reference's prune is ported: resilience= (a
    checkpointed prune whose collective fault is retried in place) and
    partition= (the sim backend) equal the reference's prune and
    enumeration; an unknown route still raises."""
    from repro_torch.core import resilience as res

    g, (labels, edges) = SCENARIOS["triangle_er"]
    tg, tm = _port_graph(g), Template(labels, edges)
    ref, ref_enum = reference("triangle_er")
    inj = res.FaultInjector([res.FaultSpec(
        kind=res.FAULT_COLLECTIVE_TIMEOUT, phase=1, cleared_by="retry")])
    resilient = prune(tg, tm, device="cpu", wave=WAVE, resilience=(
        res.ResilienceConfig(checkpoint_dir=str(tmp_path), injector=inj)))
    rs = resilient.stats["resilience"]
    assert [r for r, _ in rs["ladder"]] == ["retry"]
    assert rs["checkpoints"] == resilient.stats["n_constraints"] + 1
    np.testing.assert_array_equal(resilient.omega, np.asarray(ref.state.omega))
    np.testing.assert_array_equal(resilient.edge_mask, ref.edge_mask)
    assert _trajectory(resilient) == _trajectory(ref)
    assert count_matches(resilient).n_embeddings == ref_enum.n_embeddings
    res = prune(tg, tm, device="cpu", wave=WAVE, partition=2)
    assert res.stats["backend"] == "sim"
    np.testing.assert_array_equal(res.omega, np.asarray(ref.state.omega))
    np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
    assert _trajectory(res) == _trajectory(ref)
    assert count_matches(res).n_embeddings == ref_enum.n_embeddings
    with pytest.raises(ValueError):
        prune(tg, tm, device="cpu", nlcc_route="sideways")


@pytest.mark.parametrize("name", ["needles", "triangle_er", "fig2c"])
def test_solution_oracle_and_counts_match_reference(name, reference):
    """`core/oracle.solution_subgraph_oracle` against the reference's (the
    vertex and arc masks, omega and the matches), and `core/state.
    solution_counts` of the port's prune against the reference's of its
    own."""
    from repro.core.oracle import solution_subgraph_oracle as r_oracle
    from repro.core.state import solution_counts as r_counts
    from repro_torch.core.state import solution_counts

    g, (labels, edges) = SCENARIOS[name]
    want = r_oracle(g, RT(labels, edges))
    got = oracle.solution_subgraph_oracle(_port_graph(g), Template(labels, edges))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert sorted(map(tuple, got[3])) == sorted(map(tuple, want[3]))
    res = prune(_port_graph(g), Template(labels, edges), device="cpu", wave=WAVE)
    assert solution_counts(res.state) == r_counts(reference(name)[0].state)
