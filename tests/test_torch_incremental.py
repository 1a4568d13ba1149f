"""The port's interactive search (core/incremental.py, core/exploratory.py,
launch/interactive_search.py) against the JAX package's.

`candidate_set` (the relaxed LCC, its OR-aggregation through packed words)
equal to the reference's; an `IncrementalSession` over the example's
revisions, with a chord-only revision and a repeat that reuses cached
passes, equal search by search (omega and the `QueryStat` counts)
with the candidate set and the work reuse on and off; `exploratory_search`
on the example's planted-squares recipe (levels, `found_level`,
`vertex_mask`); the packed wave check, fused and per hop, against the
boolean planes of both packages on the same sources; and the launcher with
`--device cpu`. The port runs on the CPU (the kernels' plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import nlcc as rnlcc  # noqa: E402
from repro.core.exploratory import exploratory_search as rexploratory  # noqa: E402
from repro.core.incremental import IncrementalSession as RSession  # noqa: E402
from repro.core.incremental import candidate_set as rcandidate_set  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph.structs import DeviceGraph as RDeviceGraph  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro_torch.core import nlcc  # noqa: E402
from repro_torch.core.exploratory import exploratory_search  # noqa: E402
from repro_torch.core.incremental import IncrementalSession, candidate_set  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structs import DeviceGraph  # noqa: E402
from repro_torch.launch import interactive_search  # noqa: E402

LABELS = interactive_search.LABELS
# the example's three revisions, a chord-only revision (a triangle constraint
# on a path) and a repeat of the first (its passes come from the cache)
REVISIONS = interactive_search.REVISIONS[:1] + [
    [(0, 1), (1, 2), (2, 3), (3, 4), (1, 3)]] + interactive_search.REVISIONS[1:] + [
    interactive_search.REVISIONS[0]]


@pytest.fixture(scope="module")
def graph():
    return gen.rmat_graph(9, edge_factor=8, seed=0)  # degree labels


def _ref(g):
    return RGraph(g.n, g.src, g.dst, g.labels)


@pytest.mark.parametrize("spec", [
    (LABELS, REVISIONS[0]),
    (LABELS, REVISIONS[3]),
    ([3, 4, 4], [(0, 1), (1, 2), (2, 0)]),
], ids=["path", "chorded_cycle", "triangle"])
def test_candidate_set_equals_reference(graph, spec):
    st = candidate_set(DeviceGraph.from_host(graph, "cpu"), Template(*spec))
    rst = rcandidate_set(RDeviceGraph.from_host(_ref(graph)), RT(*spec))
    np.testing.assert_array_equal(st.omega.numpy(), np.asarray(rst.omega))
    np.testing.assert_array_equal(st.edge_active.numpy(),
                                  np.asarray(rst.edge_active))
    assert st.omega.any()


@pytest.mark.parametrize("use_cand,use_reuse", [(True, True), (False, True),
                                                (True, False)],
                         ids=["both", "no_candidate_set", "no_reuse"])
def test_incremental_session_equals_reference(graph, use_cand, use_reuse):
    kw = dict(use_candidate_set=use_cand, use_work_reuse=use_reuse)
    s = IncrementalSession(graph, Template(LABELS, REVISIONS[0]),
                           device="cpu", **kw)
    rs = RSession(_ref(graph), RT(LABELS, REVISIONS[0]), **kw)
    matched = []
    for edges in REVISIONS:
        st, stat = s.search(Template(LABELS, edges))
        rst, rstat = rs.search(RT(LABELS, edges))
        np.testing.assert_array_equal(st.omega.numpy(), np.asarray(rst.omega),
                                      err_msg=f"revision {edges}")
        np.testing.assert_array_equal(st.edge_active.numpy(),
                                      np.asarray(rst.edge_active))
        for f in ("template_edges", "matched_vertices", "constraints_checked",
                  "constraints_reused"):
            assert getattr(stat, f) == getattr(rstat, f), (edges, f)
        matched.append(stat.matched_vertices)
    assert matched[0] > 0
    assert (s.history[-1].constraints_reused > 0) == use_reuse
    assert sorted(s._pass_cache) == sorted(rs._pass_cache)
    for key in s._pass_cache:
        np.testing.assert_array_equal(s._pass_cache[key], rs._pass_cache[key])


def test_incremental_session_rejects_unaligned_wave(graph):
    with pytest.raises(ValueError, match="multiple of 32"):
        IncrementalSession(graph, Template(LABELS, REVISIONS[0]), wave=100,
                           device="cpu")


def test_exploratory_search_equals_reference():
    g = interactive_search.planted_squares(scale=8)
    clique = interactive_search.CLIQUE
    res = exploratory_search(g, Template(*clique), device="cpu")
    rres = rexploratory(_ref(g), RT(*clique))
    assert res.found_level == rres.found_level == 2
    np.testing.assert_array_equal(res.vertex_mask, rres.vertex_mask)
    assert res.candidate_vertices == rres.candidate_vertices
    assert [(lv.k, lv.n_variants, lv.matched_vertices) for lv in res.levels] == [
        (lv.k, lv.n_variants, lv.matched_vertices) for lv in rres.levels]
    assert res.vertex_mask.sum() >= 12  # the three planted squares at least


@pytest.mark.parametrize("walk", [(0, 1, 2, 3, 0), (0, 1, 2, 3),
                                  (0, 1, 2, 0)],
                         ids=["cycle", "path", "triangle"])
def test_packed_walk_check_equals_boolean_planes(graph, walk):
    """Survivors of the packed wave, fused (`bitset_wave`) and per hop
    (`bitset_spmm`), equal the boolean planes' (the reference's check) on
    the same unknown-source ids, pads included."""
    dg = DeviceGraph.from_host(graph, "cpu")
    # label candidacy of a square whose walks survive at some sources only
    state = init_state(dg, Template([4, 5, 5, 4],
                                    [(0, 1), (1, 2), (2, 3), (3, 0)]))
    cand = torch.stack([state.omega[:, q] for q in walk], dim=0)
    rng = np.random.default_rng(7)
    heads = np.flatnonzero(state.omega[:, walk[0]].numpy())
    ids = np.full(64, -1, np.int64)
    ids[:40] = rng.choice(heads, size=40, replace=heads.size < 40)
    ids_dev = torch.from_numpy(ids)
    is_cyclic = walk[0] == walk[-1]
    want, _ = nlcc.check_walk_constraint(dg, state, cand, is_cyclic, ids_dev)
    rdg = RDeviceGraph.from_host(_ref(graph))
    from repro.core.state import PruneState as RPruneState
    rstate = RPruneState(omega=jnp.asarray(state.omega.numpy()),
                         edge_active=jnp.asarray(state.edge_active.numpy()))
    rwant, _ = rnlcc.check_walk_constraint(
        rdg, rstate, jnp.asarray(cand.numpy()), is_cyclic,
        jnp.asarray(ids, jnp.int32))
    np.testing.assert_array_equal(want.numpy(), np.asarray(rwant))
    for fused in (True, False):
        got = nlcc.check_walk_constraint_packed(dg, state, cand, is_cyclic,
                                                ids_dev, fused=fused)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.any() and not want.all()


def test_interactive_search_launcher_on_cpu(capsys):
    stats, res = interactive_search.main(["--device", "cpu"])
    assert len(stats) == 3 and stats[0].matched_vertices > 0
    assert res.found_level == 2
    assert capsys.readouterr().out.strip().endswith("OK")
