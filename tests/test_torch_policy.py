"""The port's dispatch policy (`repro_torch.kernels.registry`) against the
JAX package's, on the CPU.

The JSON round trip; the port's own cache path and environment variable,
apart from the JAX package's; an unreadable cache warning and falling back;
unknown routes falling back; untuned routes equal to the routes without a
policy; LCC and NLCC routes following an injected policy with identical
results; `tune(routes=)` measuring, persisting and extending a cache; and
the route buckets equal to the reference's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.core.lcc import lcc_route_bucket as rlcc_bucket  # noqa: E402
from repro.core.nlcc import nlcc_route_bucket as rnlcc_bucket  # noqa: E402
from repro.core.state import init_state as rinit_state  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph.structs import DeviceGraph as RDeviceGraph  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro.kernels import registry as rregistry  # noqa: E402
from repro_torch.core import engine, lcc, nlcc  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structs import DeviceGraph  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

LCC, NLCC = lcc.LCC_ROUTE, nlcc.NLCC_ROUTE
TRIANGLE = ([0, 1, 2], [(0, 1), (1, 2), (2, 0)])


@pytest.fixture(autouse=True)
def _port_policy(tmp_path, monkeypatch):
    """Every test starts with no port policy, its cache path under tmp_path."""
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    yield
    registry.clear_policy()


def _setup():
    g = gen.erdos_renyi_graph(100, 5.0, seed=3, n_labels=3)
    return g, Template(*TRIANGLE)


def _prune(g, t, **kw):
    return prune(g, t, device="cpu", wave=64, **kw)


def test_policy_json_roundtrip(tmp_path):
    pol = registry.DispatchPolicy()
    pol.set_route(LCC, "cpu", registry.BUCKET_ANY, registry.ROUTE_UNPACKED,
                  {"packed": 0.2, "unpacked": 0.1})
    pol.set_route(NLCC, "cuda", (1024, 1024), registry.ROUTE_PACKED)
    pol.set_plan("cpu", ("lsig", "n64xd4xs1"), registry.PlanEntry(
        phases=[{"sig": "cycle:0,1,2,0", "engine": "nlcc",
                 "direction": "head", "predicted_s": 0.5}],
        predicted_s=0.5, measured_s={"planner": 0.4}))
    path = pol.save(str(tmp_path / "sub" / "pol.json"))
    reloaded = registry.DispatchPolicy.load(path)
    assert reloaded.to_json() == pol.to_json()
    assert json.loads(open(path).read())["schema_version"] == 1
    registry.set_policy(reloaded)
    assert registry.resolve_route(
        LCC, (1, 2), default=registry.ROUTE_PACKED,
        backend="cpu") == registry.ROUTE_UNPACKED
    assert registry.resolve_route(
        NLCC, (1024, 1024), default=registry.ROUTE_FUSED,
        backend="cuda") == registry.ROUTE_PACKED
    # an entry is per backend: the cuda entry does not serve the CPU
    assert registry.resolve_route(
        NLCC, (1024, 1024), default=registry.ROUTE_FUSED,
        backend="cpu") == registry.ROUTE_FUSED
    # the route table reads like the JAX package's
    rpol = rregistry.DispatchPolicy.from_json(pol.to_json())
    assert {k: e.to_json() for k, e in rpol.routes.items()} == {
        k: e.to_json() for k, e in pol.routes.items()}


def test_own_cache_path_and_environment_variable(tmp_path, monkeypatch):
    """The port reads and writes its own cache, never the JAX package's,
    and loads it lazily."""
    monkeypatch.delenv(registry.POLICY_ENV)
    assert registry.policy_path() == registry.DEFAULT_POLICY_PATH
    assert registry.DEFAULT_POLICY_PATH.endswith("torch_dispatch_policy.json")
    assert registry.DEFAULT_POLICY_PATH != rregistry.DEFAULT_POLICY_PATH
    assert registry.POLICY_ENV != "REPRO_DISPATCH_POLICY"
    path = str(tmp_path / "cache.json")
    pol = registry.DispatchPolicy()
    pol.set_route(LCC, "cpu", registry.BUCKET_ANY, registry.ROUTE_UNPACKED)
    pol.save(path)
    monkeypatch.setenv("REPRO_DISPATCH_POLICY", path)  # the JAX package's
    registry.clear_policy()
    assert registry.get_policy() is None
    monkeypatch.setenv(registry.POLICY_ENV, path)
    registry.clear_policy()
    assert registry.get_policy().to_json() == pol.to_json()
    g, t = _setup()
    assert _prune(g, t).stats["dispatch_routes"][LCC] == registry.ROUTE_UNPACKED


@pytest.mark.parametrize("kind", ["stale-schema", "not-json", "directory"])
def test_unreadable_cache_warns_and_falls_back(tmp_path, monkeypatch, kind):
    path = tmp_path / "broken.json"
    if kind == "stale-schema":
        path.write_text('{"schema_version": 999}')
    elif kind == "not-json":
        path.write_text("{routes")
    else:
        path = tmp_path
    monkeypatch.setenv(registry.POLICY_ENV, str(path))
    registry.clear_policy()
    with pytest.warns(RuntimeWarning, match="unreadable dispatch policy"):
        route = registry.resolve_route(LCC, default=registry.ROUTE_PACKED,
                                       backend="cpu")
    assert route == registry.ROUTE_PACKED


def test_unknown_route_values_fall_back_to_defaults():
    g, t = _setup()
    pol = registry.DispatchPolicy()
    pol.set_route(LCC, "cpu", registry.BUCKET_ANY, "Packed-Typo")
    pol.set_route(NLCC, "cpu", registry.BUCKET_ANY, "Packed-Typo")
    registry.set_policy(pol)
    assert _prune(g, t).stats["dispatch_routes"] == {
        LCC: registry.ROUTE_PACKED, NLCC: registry.ROUTE_FUSED}


def test_untuned_routes_are_the_defaults():
    """No policy, an empty policy and a policy for another backend route
    exactly as before: packed LCC, fused NLCC; the capability gates still
    send message counting to the boolean planes."""
    g, t = _setup()
    want = {LCC: registry.ROUTE_PACKED, NLCC: registry.ROUTE_FUSED}
    base = _prune(g, t)
    assert base.stats["dispatch_routes"] == want
    other = registry.DispatchPolicy()
    other.set_route(LCC, "cuda", registry.BUCKET_ANY, registry.ROUTE_UNPACKED)
    other.set_route(NLCC, "cuda", registry.BUCKET_ANY, registry.ROUTE_UNPACKED)
    for pol in (None, registry.DispatchPolicy(), other):
        registry.set_policy(pol)
        res = _prune(g, t)
        assert res.stats["dispatch_routes"] == want
        np.testing.assert_array_equal(res.omega, base.omega)
    counted = _prune(g, t, collect_stats=True)
    assert counted.stats["dispatch_routes"] == {
        LCC: registry.ROUTE_UNPACKED, NLCC: registry.ROUTE_UNPACKED}


@pytest.mark.parametrize("backend,m,want", [
    ("cpu", 1 << 25, registry.ROUTE_UNPACKED),
    ("cuda", 1 << 20, registry.ROUTE_UNPACKED),
    ("cuda", 1 << 25, registry.ROUTE_PACKED),
], ids=["cpu", "cuda-fits", "cuda-too-large"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_policy_unpacked_nlcc_route_is_capped_on_the_card(backend, m, want,
                                                         batched):
    """A policy's unpacked wave runs on the card only where its [m, wave]
    bool plane fits; single and batched prunes resolve through one rule."""
    n, wave = 1 << 20, 1024
    bucket = (registry.batch_bucket(8, registry.shard_bucket(1, n, wave))
              if batched else None)
    pol = registry.DispatchPolicy()
    pol.set_route(NLCC, backend, registry.BUCKET_ANY, registry.ROUTE_UNPACKED)
    registry.set_policy(pol)
    assert nlcc.nlcc_resolved_route(n, wave, backend, m=m,
                                    bucket=bucket) == want
    # an explicit pin and the capability gates are not capped
    assert nlcc.nlcc_resolved_route(n, wave, backend, m=m,
                                    route="unpacked") == "unpacked"
    assert nlcc.nlcc_resolved_route(n, 48, backend, m=m) == "unpacked"


@pytest.mark.parametrize("backend,P,want", [
    ("cpu", 4, registry.ROUTE_UNPACKED),
    ("cuda", 2, registry.ROUTE_UNPACKED),
    ("cuda", 4, registry.ROUTE_PACKED),
], ids=["cpu", "cuda-fits", "cuda-too-large"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_policy_unpacked_sharded_nlcc_route_is_capped_on_the_card(
        backend, P, want, batched):
    """The sharded prune and the sharded batch resolve their wave route
    through one rule: a policy's unpacked wave runs on the card only where
    one job's [Pl*P*B, wave] bool plane fits (the sim holds Pl = P shards),
    and a fused choice the reference's gate refuses runs packed."""
    n_local, B, wave = 1 << 18, 1 << 17, 1024
    shard = registry.shard_bucket(P, n_local, wave)
    bucket = registry.batch_bucket(8, shard) if batched else shard
    pol = registry.DispatchPolicy()
    pol.set_route(NLCC, backend, registry.BUCKET_ANY, registry.ROUTE_UNPACKED)
    registry.set_policy(pol)
    assert engine.sharded_nlcc_route(bucket, P, P, B, n_local, wave, 3,
                                     backend) == want
    pol.set_route(NLCC, backend, registry.BUCKET_ANY, registry.ROUTE_FUSED)
    assert not engine.sharded_fused_eligible(n_local, P, B, wave, 3)
    assert engine.sharded_nlcc_route(bucket, P, P, B, n_local, wave, 3,
                                     backend) == registry.ROUTE_PACKED
    # the capability gate (a wave that packs into no whole word) is not
    # capped
    assert engine.sharded_nlcc_route(bucket, P, P, B, n_local, 48, 3,
                                     backend) == registry.ROUTE_UNPACKED


@pytest.mark.parametrize("exact", [True, False], ids=["bucket", "wildcard"])
def test_lcc_and_nlcc_routes_follow_injected_policy(exact):
    g, t = _setup()
    base = _prune(g, t)
    dg = DeviceGraph.from_host(g, "cpu")
    pol = registry.DispatchPolicy()
    pol.set_route(LCC, "cpu", lcc.lcc_route_bucket(dg) if exact
                  else registry.BUCKET_ANY, registry.ROUTE_UNPACKED)
    pol.set_route(NLCC, "cpu", nlcc.nlcc_route_bucket(g.n, 64) if exact
                  else registry.BUCKET_ANY, registry.ROUTE_PACKED)
    registry.set_policy(pol)
    routed = _prune(g, t)
    assert routed.stats["dispatch_routes"] == {
        LCC: registry.ROUTE_UNPACKED, NLCC: registry.ROUTE_PACKED}
    assert routed.stats.get("lcc_packed_calls") is None
    assert routed.phases[1].extra["nlcc_packed_waves"] > 0
    np.testing.assert_array_equal(routed.omega, base.omega)
    np.testing.assert_array_equal(routed.edge_mask, base.edge_mask)
    assert routed.stats["lcc_iterations"] == base.stats["lcc_iterations"]
    # an explicit pin beats the policy, the capability gates beat both
    pinned = _prune(g, t, lcc_route="packed", nlcc_route="fused")
    assert pinned.stats["dispatch_routes"] == base.stats["dispatch_routes"]
    gated = _prune(g, t, lcc_route="packed", collect_stats=True)
    assert gated.stats["dispatch_routes"][LCC] == registry.ROUTE_UNPACKED
    # a bucket that no entry matches keeps the default
    if exact:
        g2 = gen.erdos_renyi_graph(300, 5.0, seed=3, n_labels=3)
        assert _prune(g2, t).stats["dispatch_routes"] == {
            LCC: registry.ROUTE_PACKED, NLCC: registry.ROUTE_FUSED}


def test_route_buckets_equal_the_reference():
    g = gen.rmat_graph(7, edge_factor=4, seed=1)
    rg = RGraph(g.n, g.src, g.dst, g.labels)
    rdg = RDeviceGraph.from_host(rg)
    rstate = rinit_state(rdg, RT(*TRIANGLE))
    dg = DeviceGraph.from_host(g, "cpu")
    assert lcc.lcc_route_bucket(dg) == rlcc_bucket(rstate, rdg)
    for wave in (32, 64, 1000):
        assert nlcc.nlcc_route_bucket(g.n, wave) == rnlcc_bucket(rstate, wave)
    for dims in [(), (1,), (3, 1024, 1025)]:
        assert registry.shape_bucket(*dims) == rregistry.shape_bucket(*dims)
        assert registry.bucket_key(registry.shape_bucket(*dims)) == \
            rregistry.bucket_key(rregistry.shape_bucket(*dims))
    assert registry.bucket_key(registry.BUCKET_ANY) == "*"


def test_tune_measures_candidates_and_persists(tmp_path):
    path = str(tmp_path / "tuned.json")
    calls = {"a": 0, "b": 0}

    def cand(name):
        def run():
            calls[name] += 1
            return torch.zeros(4)
        return run

    pol = registry.tune(
        routes=[("test.route", registry.BUCKET_ANY,
                 {"a": cand("a"), "b": cand("b")})],
        backend="cpu", repeat=2, path=path)
    entry = pol.routes[f"test.route|cpu|{registry.BUCKET_ANY}"]
    assert set(entry.measured_s) == {"a", "b"}
    assert entry.choice == min(entry.measured_s, key=entry.measured_s.get)
    assert calls == {"a": 3, "b": 3}  # one warm-up and two repeats
    assert pol.meta["backend"] == "cpu"
    assert registry.get_policy() is pol
    assert registry.DispatchPolicy.load(path).to_json() == pol.to_json()


def test_tune_prune_routes_and_prune_follows():
    """Tune the LCC and NLCC routes of a real prune on the CPU: the tuned
    policy is what the next prune resolves, with identical results."""
    g, t = _setup()
    base = _prune(g, t)
    dg = DeviceGraph.from_host(g, "cpu")
    pol = registry.tune(routes=[
        (LCC, lcc.lcc_route_bucket(dg),
         {r: (lambda r=r: _prune(dg, t, lcc_route=r)) for r in registry.LCC_ROUTES}),
        (NLCC, nlcc.nlcc_route_bucket(dg.n, 64),
         {r: (lambda r=r: _prune(dg, t, nlcc_route=r)) for r in registry.NLCC_ROUTES}),
    ], backend="cpu", repeat=1, persist=False)
    want = {LCC: pol.route_for(LCC, "cpu", lcc.lcc_route_bucket(dg)),
            NLCC: pol.route_for(NLCC, "cpu", nlcc.nlcc_route_bucket(dg.n, 64))}
    assert set(pol.route_entry_for(NLCC, "cpu", nlcc.nlcc_route_bucket(
        dg.n, 64)).measured_s) == set(registry.NLCC_ROUTES)
    tuned = _prune(dg, t)
    assert tuned.stats["dispatch_routes"] == want
    np.testing.assert_array_equal(tuned.omega, base.omega)
    np.testing.assert_array_equal(tuned.edge_mask, base.edge_mask)


def test_tune_extends_an_existing_cache(tmp_path):
    path = str(tmp_path / "tuned.json")
    old = registry.DispatchPolicy()
    old.set_route(LCC, "cpu", (2048, 32768), registry.ROUTE_PACKED,
                  {"packed": 0.05, "unpacked": 0.07})
    old.set_plan("cpu", ("t", "s"), registry.PlanEntry(
        phases=[{"sig": "cycle:0,1,2,0"}]))
    old.save(path)
    pol = registry.tune(
        routes=[("test.route", (8, 8), {"a": lambda: None, "b": lambda: None})],
        backend="cpu", repeat=1, path=path)
    key = f"{LCC}|cpu|2048x32768"
    assert pol.routes[key].measured_s == {"packed": 0.05, "unpacked": 0.07}
    assert "test.route|cpu|8x8" in pol.routes
    assert pol.plans and pol.to_json()["plans"] == old.to_json()["plans"]
    assert registry.DispatchPolicy.load(path).to_json() == pol.to_json()


def test_tune_replaces_an_unreadable_cache(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text('{"schema_version": 999}')
    pol = registry.tune(routes=[("test.route", registry.BUCKET_ANY,
                                 {"a": lambda: None})],
                        backend="cpu", repeat=1, path=str(path))
    assert list(pol.routes) == [f"test.route|cpu|{registry.BUCKET_ANY}"]
    registry.DispatchPolicy.load(str(path))


def test_malformed_plan_entry_is_skipped_with_a_warning(tmp_path):
    path = tmp_path / "pol.json"
    pol = registry.DispatchPolicy()
    pol.set_route(LCC, "cpu", registry.BUCKET_ANY, registry.ROUTE_UNPACKED)
    d = pol.to_json()
    d["plans"] = {"prune.plan|cpu|x": {"phases": [{"engine": "nlcc"}]}}
    path.write_text(json.dumps(d))
    with pytest.warns(RuntimeWarning, match="malformed plan cache entry"):
        loaded = registry.DispatchPolicy.load(str(path))
    assert loaded.plans == {}
    assert loaded.route_for(LCC, "cpu", (4, 4)) == registry.ROUTE_UNPACKED
