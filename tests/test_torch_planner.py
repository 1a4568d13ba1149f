"""The port's query planner and graph statistics against the JAX package's.

Signatures and plan buckets; `collect_graph_stats` on the host and on the
device against the reference's; `reorder_is_sound`; `enumerate_orders`
and the phases `plan_query` chooses, equal to the reference's with the
static cost term pinned to one value in both packages (the reference costs
a hop from XLA's HLO, the port counts it; without measurements every phase
cost is proportional to that term, with them it is not); `record_plan` and
`resolve_query_plan` round trips, a stale plan ignored with a warning; and a
planned prune bit-identical to the heuristic one and to the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.core import planner as rplanner  # noqa: E402
from repro.core.pipeline import prune as rprune  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.core.template import generate_constraints as rgenerate  # noqa: E402
from repro.graph import stats as rstats  # noqa: E402
from repro.graph.structs import DeviceGraph as RDeviceGraph  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro.kernels import registry as rregistry  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.enumerate import count_matches  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.template import Template, generate_constraints  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.stats import collect_graph_stats  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

SQUARE = ([2, 3, 4, 3], [(0, 1), (1, 2), (2, 3), (3, 0)])
# square + chord + tail: several cycle and path constraints and the complete
# TDS, a real reordering space
MULTI = ([2, 3, 4, 3, 5], [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (2, 4)])
STATIC_S = 3.0e-6


@pytest.fixture(autouse=True)
def _port_policy(tmp_path, monkeypatch):
    """Every test starts with no port policy, its cache path under tmp_path."""
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    yield
    registry.clear_policy()


@pytest.fixture
def pinned_static(monkeypatch):
    """The same static hop cost in both packages."""
    for mod in (planner, rplanner):
        monkeypatch.setattr(mod, "static_dispatch_seconds",
                            lambda backend, wave, m_bucket: STATIC_S)


def _graph():
    """R-MAT background with 3 planted labeled squares."""
    pattern = Graph.from_undirected_pairs(
        4, [(0, 1), (1, 2), (2, 3), (3, 0)], [2, 3, 4, 3])
    bg = gen.rmat_graph(8, edge_factor=4, seed=3, labeler="random", n_labels=6)
    return gen.planted_pattern_graph(bg, pattern, n_copies=3, seed=5)


def _ref(g):
    return RGraph(g.n, g.src, g.dst, g.labels)


def _ids(plan):
    return [(p.signature, p.engine, p.direction) for p in plan.phases]


def _stats_equal(a, b):
    assert (a.n, a.m, a.bucket()) == (b.n, b.m, b.bucket())
    np.testing.assert_array_equal(a.label_hist, np.asarray(b.label_hist))
    np.testing.assert_array_equal(a.degree_hist, np.asarray(b.degree_hist))


@pytest.mark.parametrize("labels,edges", [SQUARE, MULTI], ids=["square", "multi"])
def test_signatures_and_plan_bucket(labels, edges):
    g = _graph()
    t, rt = Template(labels, edges), RT(labels, edges)
    assert planner.template_signature(t) == rplanner.template_signature(rt)
    cs = generate_constraints(t, label_freq=g.label_frequency())
    rcs = rgenerate(rt, label_freq=g.label_frequency())
    assert ([planner.constraint_signature(c) for c in cs]
            == [rplanner.constraint_signature(c) for c in rcs])
    st, rst = collect_graph_stats(g), rstats.collect_graph_stats(_ref(g))
    assert planner.plan_bucket(t, st) == rplanner.plan_bucket(rt, rst)
    assert planner.reorder_is_sound(cs) == rplanner.reorder_is_sound(rcs)
    cs_h = generate_constraints(t, label_freq=g.label_frequency(),
                                guarantee_precision=False)
    rcs_h = rgenerate(rt, label_freq=g.label_frequency(),
                      guarantee_precision=False)
    assert planner.reorder_is_sound(cs_h) == rplanner.reorder_is_sound(rcs_h)
    assert not planner.reorder_is_sound([])


@pytest.mark.parametrize("name", ["planted", "rmat-degree", "star"])
def test_graph_stats_host_device_and_reference(name):
    g = {"planted": _graph,
         "rmat-degree": lambda: gen.rmat_graph(9, edge_factor=8, seed=1),
         "star": lambda: gen.star_graph(40, center_label=5, leaf_label=1)}[name]()
    host = collect_graph_stats(g)
    dev = collect_graph_stats(DeviceGraph.from_host(g, "cpu"),
                              n_labels=g.n_labels)
    ref_host = rstats.collect_graph_stats(_ref(g))
    ref_dev = rstats.collect_graph_stats(RDeviceGraph.from_host(_ref(g)),
                                         n_labels=g.n_labels)
    for other in (dev, ref_host, ref_dev):
        _stats_equal(host, other)
    assert host.label_skew() == ref_host.label_skew()
    with pytest.raises(ValueError, match="n_labels"):
        collect_graph_stats(DeviceGraph.from_host(g, "cpu"))


@pytest.mark.parametrize("measured", [False, True], ids=["static", "measured"])
@pytest.mark.parametrize("labels,edges", [SQUARE, MULTI], ids=["square", "multi"])
def test_plan_query_chooses_the_reference_plan(labels, edges, measured,
                                               pinned_static):
    g = _graph()
    t, rt = Template(labels, edges), RT(labels, edges)
    st, rst = collect_graph_stats(g), rstats.collect_graph_stats(_ref(g))
    pol = rpol = None
    if measured:
        pol, rpol = registry.DispatchPolicy(), rregistry.DispatchPolicy()
        bucket = registry.shape_bucket(g.n, 1024)
        pol.set_route("prune.nlcc", "cpu", bucket, "fused", {"fused": 2e-3})
        rpol.set_route("prune.nlcc", "cpu", bucket, "fused", {"fused": 2e-3})
    qp = planner.plan_query(t, st, backend="cpu", policy=pol)
    rqp = rplanner.plan_query(rt, rst, backend="cpu", policy=rpol)
    assert _ids(qp) == _ids(rqp)
    assert qp.source == rqp.source
    assert qp.predicted_s == pytest.approx(rqp.predicted_s, rel=1e-12)
    assert qp.per_phase_s == pytest.approx(rqp.per_phase_s, rel=1e-12)
    model = planner._CostModel(t, st, backend="cpu", wave=1024, policy=pol)
    rmodel = rplanner._CostModel(rt, rst, backend="cpu", wave=1024, policy=rpol)
    prefix = [c for c in generate_constraints(t, label_freq=st.label_hist)
              if not c.complete]
    rprefix = [c for c in rgenerate(rt, label_freq=rst.label_hist)
               if not c.complete]
    orders = planner.enumerate_orders(model, prefix)
    rorders = rplanner.enumerate_orders(rmodel, rprefix)
    assert ([[planner.constraint_signature(c) for c in o] for o in orders]
            == [[rplanner.constraint_signature(c) for c in o] for o in rorders])
    if labels == MULTI[0]:
        assert len(orders) > 1
        assert sorted(qp.signatures()) == sorted(
            planner.constraint_signature(c)
            for c in generate_constraints(t, label_freq=st.label_hist))
        assert qp.phases[-1].constraint.complete


def test_plan_query_without_complete_phase_stays_heuristic():
    g = _graph()
    t = Template(*SQUARE)
    cs = generate_constraints(t, label_freq=g.label_frequency(),
                              guarantee_precision=False)
    assert not planner.reorder_is_sound(cs)
    qp = planner.plan_query(t, collect_graph_stats(g), backend="cpu",
                            guarantee_precision=False, constraints=cs)
    assert qp.is_heuristic() and qp.source == "heuristic"
    assert qp.constraints() == list(cs)
    assert qp.per_phase_s is not None and qp.predicted_s > 0


def test_static_dispatch_seconds_counts_the_hop():
    a = planner.static_dispatch_seconds("cpu", 1024, 2048)
    assert a > 0 and a == planner.static_dispatch_seconds("cpu", 1024, 2048)
    assert planner.static_dispatch_seconds("cpu", 1024, 4096) > a


def test_every_plan_is_bit_identical_to_the_heuristic():
    """Reordered phases and weakened directions, with the complete TDS
    last, land on the same bits as the heuristic order."""
    g = _graph()
    t = Template(*MULTI)
    cs = generate_constraints(t, label_freq=g.label_frequency())
    assert planner.reorder_is_sound(cs)
    base = prune(g, t, device="cpu")
    head, last = list(cs[:-1]), cs[-1]
    for order in (list(cs), head[::-1] + [last]):
        for direction in ("default", "head", "fwd"):
            phases = [planner.PlanPhase(
                c, planner.default_engine(c),
                direction if not c.complete else "default") for c in order]
            out = prune(g, t, device="cpu",
                        plan=planner.QueryPlan(phases=phases, source="planner"))
            np.testing.assert_array_equal(out.omega, base.omega)
            np.testing.assert_array_equal(out.edge_mask, base.edge_mask)


def test_planned_prune_matches_heuristic_and_reference(pinned_static):
    g = _graph()
    t, rt = Template(*MULTI), RT(*MULTI)
    st = collect_graph_stats(g)
    qp = planner.plan_query(t, st, backend="cpu")
    base = prune(g, t, device="cpu")
    planned = prune(g, t, device="cpu", plan=qp)
    assert base.stats["plan"]["source"] == "heuristic"
    assert planned.stats["plan"]["source"] == qp.source
    rqp = rplanner.plan_query(rt, rstats.collect_graph_stats(_ref(g)),
                              backend="cpu")
    ref = rprune(_ref(g), rt, plan=rqp)
    for res in (planned,):
        np.testing.assert_array_equal(res.omega, base.omega)
        np.testing.assert_array_equal(res.edge_mask, base.edge_mask)
        np.testing.assert_array_equal(res.omega, np.asarray(ref.state.omega))
        np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
    assert ([(p.phase, p.constraint, p.active_vertices, p.active_edges,
              p.omega_bits) for p in planned.phases]
            == [(p.phase, p.constraint, p.active_vertices, p.active_edges,
                 p.omega_bits) for p in ref.phases])
    assert (count_matches(planned).n_embeddings
            == count_matches(base).n_embeddings)
    rep = planned.stats["plan"]["phases"]
    assert [ph["sig"] for ph in rep] == qp.signatures()
    assert all(ph["actual_s"] >= 0 and ph["predicted_s"] > 0 for ph in rep)


def test_mismatched_plan_is_rejected():
    g = _graph()
    other = planner.plan_query(Template(*MULTI), collect_graph_stats(g),
                               backend="cpu")
    with pytest.raises(ValueError, match="does not match"):
        prune(g, Template(*SQUARE), device="cpu", plan=other)


def test_record_and_resolve_roundtrip(tmp_path):
    g = _graph()
    t = Template(*MULTI)
    st = collect_graph_stats(g)
    cs = generate_constraints(t, label_freq=g.label_frequency())
    pol = registry.DispatchPolicy()
    qp = planner.plan_query(t, st, backend="cpu", policy=pol)
    planner.record_plan(pol, t, st, qp, backend="cpu", measured_s={"x": 1.0})
    path = pol.save(str(tmp_path / "plans.json"))
    registry.set_policy(registry.DispatchPolicy.load(path))
    got = planner.resolve_query_plan(t, cs, st, backend="cpu")
    assert got is not None and got.source == "policy"
    assert got.identities() == qp.identities()
    assert got.per_phase_s == pytest.approx(qp.per_phase_s)
    assert planner.resolve_query_plan(t, cs, st, backend="cuda") is None
    bigger = collect_graph_stats(gen.rmat_graph(10, edge_factor=8, seed=1,
                                                labeler="random", n_labels=6))
    assert bigger.bucket() != st.bucket()
    assert planner.resolve_query_plan(t, cs, bigger, backend="cpu") is None


def test_stale_plan_is_ignored_with_a_warning():
    g = _graph()
    t = Template(*SQUARE)
    st = collect_graph_stats(g)
    cs = generate_constraints(t, label_freq=g.label_frequency())
    pol = registry.DispatchPolicy()
    pol.set_plan("cpu", planner.plan_bucket(t, st), registry.PlanEntry(
        phases=[{"sig": "cycle:9,9,9"}]))
    registry.set_policy(pol)
    with pytest.warns(RuntimeWarning, match="stale plan cache entry"):
        assert planner.resolve_query_plan(t, cs, st, backend="cpu") is None
    with pytest.warns(RuntimeWarning, match="stale plan cache entry"):
        res = prune(g, t, device="cpu")
    assert res.stats["plan"]["source"] == "heuristic"


def test_policy_plan_drives_prune_bit_identically():
    """A plan recorded in the active policy is what an unplanned prune
    runs, on the host graph and on a DeviceGraph; results unchanged."""
    g = _graph()
    t = Template(*MULTI)
    st = collect_graph_stats(g)
    base = prune(g, t, device="cpu")
    pol = registry.DispatchPolicy()
    qp = planner.plan_query(t, st, backend="cpu")
    rev = planner.QueryPlan(phases=qp.phases[:-1][::-1] + qp.phases[-1:],
                            source="planner", per_phase_s=qp.per_phase_s)
    planner.record_plan(pol, t, st, rev, backend="cpu")
    registry.set_policy(pol)
    dg = DeviceGraph.from_host(g, "cpu")
    for graph in (g, dg):
        tuned = prune(graph, t, device="cpu",
                      label_freq=g.label_frequency())
        assert tuned.stats["plan"]["source"] == "policy"
        assert ([ph["sig"] for ph in tuned.stats["plan"]["phases"]]
                == rev.signatures())
        np.testing.assert_array_equal(tuned.omega, base.omega)
        np.testing.assert_array_equal(tuned.edge_mask, base.edge_mask)


# --------------------------------------------------- checkpoint identity
def _constraints(g, t):
    return generate_constraints(t, label_freq=g.label_frequency())


def test_checkpoint_resume_under_different_order_refuses(tmp_path):
    """A checkpoint keeps the plan it was written under: a run that resumes
    it under another constraint order refuses with PlanMismatch, as the
    reference does."""
    from repro.core import resilience as rres
    from repro_torch.core import resilience as res

    g, t = _graph(), Template(*MULTI)
    cs = _constraints(g, t)
    prune(g, t, device="cpu",
          resilience=res.ResilienceConfig(checkpoint_dir=str(tmp_path)))
    # the same constraints, another order: another plan identity
    alt = planner.QueryPlan(
        phases=[planner.PlanPhase(c, planner.default_engine(c))
                for c in (list(cs[:-1])[::-1] + [cs[-1]])],
        source="planner")
    inj = res.FaultInjector(
        [res.FaultSpec(kind=res.FAULT_SHARD_LOSS, phase=1)])
    cfg2 = res.ResilienceConfig(checkpoint_dir=str(tmp_path), injector=inj)
    with pytest.raises(res.PlanMismatch, match="written under plan"):
        prune(g, t, device="cpu", resilience=cfg2, plan=alt)
    # the reference refuses the port's checkpoint the same way
    rg, rt = _ref(g), RT(*MULTI)
    rcs = rgenerate(rt, label_freq=rg.label_frequency())
    ralt = rplanner.QueryPlan(
        phases=[rplanner.PlanPhase(c, rplanner.default_engine(c))
                for c in (list(rcs[:-1])[::-1] + [rcs[-1]])],
        source="planner")
    rinj = rres.FaultInjector(
        [rres.FaultSpec(kind=rres.FAULT_SHARD_LOSS, phase=1)])
    with pytest.raises(rres.PlanMismatch, match="written under plan"):
        rprune(rg, rt, plan=ralt, resilience=rres.ResilienceConfig(
            checkpoint_dir=str(tmp_path), injector=rinj))


def test_checkpoint_resume_under_different_direction_refuses(tmp_path):
    """Identity is signature + engine + direction: the same order run with
    another walk direction commits another state."""
    from repro_torch.core import resilience as res

    g, t = _graph(), Template(*SQUARE)
    cs = _constraints(g, t)
    prune(g, t, device="cpu",
          resilience=res.ResilienceConfig(checkpoint_dir=str(tmp_path)))
    hp = planner.heuristic_plan(cs)
    alt = planner.QueryPlan(
        phases=[planner.PlanPhase(
            p.constraint, p.engine,
            "head" if p.engine == planner.ENGINE_NLCC else p.direction)
            for p in hp.phases],
        source="planner")
    inj = res.FaultInjector(
        [res.FaultSpec(kind=res.FAULT_SHARD_LOSS, phase=1)])
    cfg2 = res.ResilienceConfig(checkpoint_dir=str(tmp_path), injector=inj)
    with pytest.raises(res.PlanMismatch):
        prune(g, t, device="cpu", resilience=cfg2, plan=alt)


def test_checkpoint_resume_under_same_plan_recovers_bit_identical(tmp_path):
    """The same plan resumes the checkpoint and lands on the fault-free
    prune and the reference's, bit for bit."""
    from repro_torch.core import resilience as res

    g, t = _graph(), Template(*SQUARE)
    base = prune(g, t, device="cpu",
                 resilience=res.ResilienceConfig(checkpoint_dir=str(tmp_path)))
    inj = res.FaultInjector(
        [res.FaultSpec(kind=res.FAULT_SHARD_LOSS, phase=1)])
    cfg2 = res.ResilienceConfig(checkpoint_dir=str(tmp_path), injector=inj)
    out = prune(g, t, device="cpu", resilience=cfg2)
    assert [r["restored_phase"]
            for r in out.stats["resilience"]["restarts"]]
    ref = rprune(_ref(g), RT(*SQUARE))
    from repro.core.enumerate import count_matches as rcount

    want = rcount(ref.dg, ref.state, ref.template).n_embeddings
    for res_ in (base, out):
        np.testing.assert_array_equal(res_.omega, np.asarray(ref.omega))
        np.testing.assert_array_equal(res_.edge_mask, ref.edge_mask)
        assert count_matches(res_).n_embeddings == want
    # the resumed run restored the newest checkpoint, the base run's last
    # phase, and ran nothing after it
    assert (out.stats["resilience"]["restarts"][0]["restored_phase"]
            == base.stats["n_constraints"])
