"""The port's fault-tolerant elastic execution (core/resilience.py, the
re-enterable driver of core/pipeline.py, core/loadbalance.py and the
checkpoint module) against the JAX package.

The counterparts of tests/test_resilience.py, on its graph and template:
every faulted port run, on the CPU, equals the reference's fault-free prune
bit for bit (omega, edge mask, vertex mask, phase trajectory), and its
`stats["resilience"]` (ladder rungs and messages, restarts with the restored
phase and from_P / to_P, rebalances) equals the reference's run under the
same fault specs. The injector's seeded plans, the elastic handoff's
sub-graph, permutation and partition arrays, and the checkpoint format are
the reference's too (a checkpoint of either package restores in the other).
The reference's in-process 8-device spmd test becomes a gloo group of four
spawned ranks, as tests/test_torch_spmd.py runs them.
"""
import dataclasses
import glob
import os
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.checkpoint import ckpt as rckpt  # noqa: E402
from repro.core import loadbalance as rlb  # noqa: E402
from repro.core import resilience as rres  # noqa: E402
from repro.core.enumerate import enumerate_matches as renumerate  # noqa: E402
from repro.core.pipeline import prune as rprune  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph import rmat_graph as rrmat  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core import loadbalance as lb  # noqa: E402
from repro_torch.core import resilience as res  # noqa: E402
from repro_torch.core.enumerate import count_matches, enumerate_matches  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.state import PruneState  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph.generators import rmat_graph  # noqa: E402
from repro_torch.kernels import ops, registry  # noqa: E402

KW = dict(guarantee_precision=False)


def _graph():
    return rmat_graph(9, edge_factor=6, seed=5)


def _template():
    # acyclic, repeated labels -> PC + union-of-paths TDS: phases 0 (LCC),
    # 1 (NLCC-path + LCC re-run), 2 (TDS)
    return Template([3, 4, 5, 3], [(0, 1), (1, 2), (2, 3)])


def _rtemplate():
    return RT([3, 4, 5, 3], [(0, 1), (1, 2), (2, 3)])


@pytest.fixture(autouse=True)
def _port_policy(tmp_path, monkeypatch):
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    yield
    registry.clear_policy()


@pytest.fixture(scope="module")
def base():
    """The reference's fault-free prune."""
    return rprune(rrmat(9, edge_factor=6, seed=5), _rtemplate(), **KW)


def _traj(result):
    return [(p.phase, p.active_vertices, p.active_edges, p.omega_bits)
            for p in result.phases]


def _assert_bit_identical(ref, out, tag):
    np.testing.assert_array_equal(np.asarray(ref.omega), out.omega, err_msg=tag)
    np.testing.assert_array_equal(np.asarray(ref.edge_mask), out.edge_mask,
                                  err_msg=tag)
    np.testing.assert_array_equal(np.asarray(ref.vertex_mask), out.vertex_mask,
                                  err_msg=tag)
    assert _traj(ref) == _traj(out), tag


def _specs(mod, specs):
    return [mod.FaultSpec(**s) for s in specs]


def _records(stats):
    """What the two packages' resilience records share."""
    rs = stats["resilience"]
    return {
        "ladder": [tuple(x) for x in rs["ladder"]],
        "restarts": [{k: r[k] for k in ("cause", "restored_phase", "from_P",
                                        "to_P")} for r in rs["restarts"]],
        "rebalances": [{k: r[k] for k in ("phase", "from_P", "to_P",
                                          "max_over_mean_before")}
                       for r in rs["rebalances"]],
        "checkpoints": rs["checkpoints"],
    }


def _run_both(tmp_path, specs=(), *, ckpt_dir=True, elastic=None,
              cfg_kw=None, random_plan=None, **prune_kw):
    """The same faulted prune in both packages, their records compared ->
    (port result, reference result, port injector)."""
    out = []
    for mod, run, g, t, sub in (
            (res, prune, _graph(), _template(), "port"),
            (rres, rprune, rrmat(9, edge_factor=6, seed=5), _rtemplate(), "ref")):
        inj = (mod.FaultInjector.random(*random_plan) if random_plan
               else mod.FaultInjector(_specs(mod, specs)))
        d = None
        if ckpt_dir:
            d = str(tmp_path / sub)
        cfg = mod.ResilienceConfig(
            checkpoint_dir=d, injector=inj,
            elastic=mod.ElasticConfig(**elastic) if elastic else None,
            **(cfg_kw or {}))
        kw = dict(KW, **prune_kw)
        if mod is res:
            kw["device"] = "cpu"
        out.append((run(g, t, resilience=cfg, **kw), inj))
    (port, pinj), (ref, rinj) = out
    assert _records(port.stats) == _records(ref.stats)
    assert pinj.fired == rinj.fired
    return port, ref, pinj


# ------------------------------------------------------------ fault injector
def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        res.FaultSpec(kind="meteor_strike")
    with pytest.raises(ValueError, match="ladder rung"):
        res.FaultSpec(kind=res.FAULT_SHARD_LOSS, cleared_by="nope")
    assert res.FAULT_KINDS == rres.FAULT_KINDS and res.RUNGS == rres.RUNGS


def test_injector_is_deterministic():
    def drive(mod):
        inj = mod.FaultInjector([
            mod.FaultSpec(kind=mod.FAULT_SHARD_LOSS, phase=1, site="nlcc"),
            mod.FaultSpec(kind=mod.FAULT_COLLECTIVE_TIMEOUT, phase=2,
                          site="wave", wave=0, times=2)])
        seen = []
        for phase in range(3):
            inj.begin_phase(phase)
            for site in ("lcc", "nlcc", "wave", "tds"):
                try:
                    inj.event(site, wave=0 if site == "wave" else None)
                except mod.InjectedFault as e:
                    seen.append((phase, site, e.kind, str(e)))
        return seen

    runs = [drive(res) for _ in range(2)]
    assert runs[0] == runs[1] == drive(rres)
    assert (1, "nlcc", "shard_loss") in [r[:3] for r in runs[0]]


def test_injector_after_and_times():
    inj = res.FaultInjector([res.FaultSpec(
        kind=res.FAULT_TRANSIENT_KERNEL, site="lcc", after=1, times=1)])
    inj.begin_phase(0)
    inj.event("lcc")  # skipped (after=1)
    with pytest.raises(res.TransientKernelFailure):
        inj.event("lcc")
    inj.event("lcc")  # exhausted (times=1)
    assert [f["site"] for f in inj.fired] == ["lcc"]


@pytest.mark.parametrize("seed", [3, 7, 8])
def test_injector_random_plan_equals_the_reference(seed):
    a = res.FaultInjector.random(seed, n_phases=3, n_faults=4,
                                 kinds=res.FAULT_KINDS)
    b = res.FaultInjector.random(seed, n_phases=3, n_faults=4,
                                 kinds=res.FAULT_KINDS)
    r = rres.FaultInjector.random(seed, n_phases=3, n_faults=4,
                                  kinds=rres.FAULT_KINDS)
    assert [x.spec for x in a.armed] == [x.spec for x in b.armed]
    assert ([dataclasses.astuple(x.spec) for x in a.armed]
            == [dataclasses.astuple(x.spec) for x in r.armed])
    other = res.FaultInjector.random(seed + 100, n_phases=3, n_faults=4,
                                     kinds=res.FAULT_KINDS)
    assert [x.spec for x in a.armed] != [x.spec for x in other.armed]


def test_instrument_prims_traces_and_injects():
    prims = engine_mod.sim_prims(4, torch.device("cpu"))
    inj = res.FaultInjector([res.FaultSpec(
        kind=res.FAULT_COLLECTIVE_TIMEOUT, site="prim:psum")])
    wrapped = res.instrument_prims(prims, inj)
    assert type(wrapped) is type(prims)
    assert torch.equal(wrapped.exchange(torch.ones(4, 4, 2)),
                       torch.ones(4, 4, 2))
    inj.begin_phase(0)
    with pytest.raises(res.CollectiveTimeout):
        wrapped.psum(torch.ones(4, 3))
    assert inj.prim_trace == {"exchange": 1, "psum": 1}


def test_registry_dispatch_hook_seam():
    feats = torch.zeros((8, 4, 8))
    mask = torch.zeros((8, 4), dtype=torch.bool)
    calls = []
    with registry.dispatch_hook(lambda name, mode: calls.append((name, mode))):
        ops.segment_agg(feats, mask)
    assert calls == [("segment_agg", registry.MODE_REF)]
    # a raising hook propagates (the fault seam) and uninstalls cleanly
    inj = res.FaultInjector([res.FaultSpec(
        kind=res.FAULT_TRANSIENT_KERNEL, site="dispatch",
        kernel="segment_agg")])
    inj.begin_phase(0)
    with registry.dispatch_hook(inj.on_dispatch):
        with pytest.raises(res.TransientKernelFailure):
            ops.segment_agg(feats, mask)
    assert registry.get_dispatch_hook() is None


def test_registry_mode_override():
    t = torch.zeros(3, dtype=torch.int32)
    assert registry.resolve_mode(t) == registry.MODE_REF  # a CPU tensor
    registry.reset_launches()
    with registry.mode_override(registry.MODE_REF):
        assert registry.resolve_mode(t) == registry.MODE_REF
    with registry.mode_override(registry.MODE_KERNEL):
        assert registry.resolve_mode(t) == registry.MODE_REF
    with pytest.raises(ValueError):
        with registry.mode_override("warp-drive"):
            pass
    # only plain-version calls on the card are counted
    ops.segment_agg(torch.zeros((2, 2, 2)), torch.ones((2, 2), dtype=torch.bool))
    assert sum(registry.plain_counts().values()) == 0


# ------------------------------------------------- checkpoint torn-write
def _tree():
    return {"omega": np.arange(12, dtype=np.int32).reshape(3, 4),
            "edge_active": np.ones(5, bool)}


def test_restore_skips_truncated_checkpoint(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tree())
    ckpt.save_checkpoint(d, 2, {k: v * 0 for k, v in _tree().items()})
    [arrays] = glob.glob(os.path.join(d, "step_000000000002", "*.npz"))
    blob = open(arrays, "rb").read()
    with open(arrays, "wb") as f:
        f.write(blob[:len(blob) // 2])
    assert ckpt.latest_step(d) == 2
    assert not ckpt.checkpoint_valid(os.path.join(d, "step_000000000002"))
    with pytest.warns(RuntimeWarning, match="corrupt/partial checkpoint"):
        assert ckpt.latest_valid_step(d) == 1
    with pytest.warns(RuntimeWarning):
        tree, meta = ckpt.restore_checkpoint(d, _tree())
    assert meta["step"] == 1
    np.testing.assert_array_equal(tree["omega"], _tree()["omega"])


def test_restore_skips_corrupt_manifest(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 3, _tree())
    ckpt.save_checkpoint(d, 4, _tree())
    with open(os.path.join(d, "step_000000000004", "manifest.json"), "w") as f:
        f.write("{ torn")
    with pytest.warns(RuntimeWarning, match="corrupt/partial"):
        assert ckpt.latest_valid_step(d) == 3
    with pytest.raises(Exception):
        ckpt.restore_checkpoint(d, _tree(), step=4)


def test_restore_no_valid_checkpoints(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _tree())
    with open(os.path.join(d, "step_000000000001", "manifest.json"), "w") as f:
        f.write("!")
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError, match="no valid checkpoints"):
            ckpt.restore_checkpoint(d, _tree())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    """The on-disk layout and manifest are the reference's: a directory
    written by either package restores in the other, with retention."""
    d = str(tmp_path)
    tree = {"omega": np.arange(12, dtype=np.int32).reshape(3, 4),
            "edge_active": np.array([1, 0, 1, 1, 0], bool),
            "z": [np.ones(2, np.float32), {"b": np.zeros(1), "a": np.ones(3)}],
            "t": (np.arange(3),)}
    save, restore = ((ckpt.save_checkpoint, rckpt.restore_checkpoint)
                     if writer == "port"
                     else (rckpt.save_checkpoint, ckpt.restore_checkpoint))
    for step in (1, 2, 3, 4):
        save(d, step, tree, extra_meta={"phase": step}, keep=2)
    assert sorted(os.listdir(d)) == ["step_000000000003", "step_000000000004"]
    got, meta = restore(d, tree)
    assert meta["step"] == 4 and meta["phase"] == 4
    for a, b in zip((got["omega"], got["edge_active"], got["z"][0],
                     got["z"][1]["a"], got["z"][1]["b"], got["t"][0]),
                    (tree["omega"], tree["edge_active"], tree["z"][0],
                     tree["z"][1]["a"], tree["z"][1]["b"], tree["t"][0])):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the same manifest either way
    port_dir, ref_dir = str(tmp_path / "p"), str(tmp_path / "r")
    ckpt.save_checkpoint(port_dir, 5, tree)
    rckpt.save_checkpoint(ref_dir, 5, tree)
    import json

    manifests = [json.load(open(os.path.join(x, "step_000000000005",
                                             "manifest.json")))
                 for x in (port_dir, ref_dir)]
    assert manifests[0] == manifests[1]


# ------------------------------------------- phase-boundary checkpointing
def test_phase_checkpoints_written_and_harmless(tmp_path, base):
    cfg = res.ResilienceConfig(checkpoint_dir=str(tmp_path))
    out = prune(_graph(), _template(), partition=4, resilience=cfg,
                device="cpu", **KW)
    rs = out.stats["resilience"]
    n_phases = out.stats["n_constraints"] + 1
    assert rs["checkpoints"] == n_phases
    assert len(rs["checkpoint_seconds"]) == n_phases
    assert rs["restarts"] == [] and rs["rebalances"] == []
    assert out.backend is not None  # no handoff: the sharded joins
    _assert_bit_identical(base, out, "checkpointing-only run")
    # the newest checkpoint holds the final original-coordinate state, and
    # records the backend and the shard count
    tree, meta = ckpt.restore_checkpoint(
        str(tmp_path), {"omega": np.zeros(out.omega.shape, bool),
                        "edge_active": np.zeros(out.edge_mask.shape, bool)})
    assert meta["phase"] == n_phases - 1
    assert (meta["backend"], meta["P"]) == ("sim", 4)
    np.testing.assert_array_equal(tree["omega"], np.asarray(base.omega))
    # and the reference reads it
    rtree, rmeta = rckpt.restore_checkpoint(
        str(tmp_path), {"omega": np.zeros(out.omega.shape, bool),
                        "edge_active": np.zeros(out.edge_mask.shape, bool)})
    np.testing.assert_array_equal(np.asarray(rtree["omega"]),
                                  np.asarray(base.omega))


def test_checkpoint_cadence_and_restore_truncation(tmp_path, base):
    # checkpoint_every=2: checkpoints at phases 0 and 2 only; a fault at
    # phase 2 restores phase 0 and replays 1..2 without duplicating them
    out, _, _ = _run_both(
        tmp_path, [dict(kind=res.FAULT_SHARD_LOSS, phase=2)],
        cfg_kw=dict(checkpoint_every=2), partition=4)
    rs = out.stats["resilience"]
    assert [r["restored_phase"] for r in rs["restarts"]] == [0]
    _assert_bit_identical(base, out, "cadence-2 recovery")


# --------------------------------------------------- recovery-parity sweep
@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("phase", [0, 1, 2])
def test_shard_loss_recovery_parity(tmp_path, base, P, phase):
    """Shard loss at every phase boundary on 1/2/4/8 sim shards: restore
    the last checkpoint (none before phase 0: a fresh prune) and land on
    the fault-free state bit for bit, with the reference's records."""
    out, _, _ = _run_both(
        tmp_path, [dict(kind=res.FAULT_SHARD_LOSS, phase=phase)], partition=P)
    rs = out.stats["resilience"]
    assert len(rs["restarts"]) == 1
    assert rs["restarts"][0]["restored_phase"] == phase - 1
    assert rs["recovery_seconds"] > 0
    _assert_bit_identical(base, out, f"P={P} phase={phase}")


def test_recovery_onto_fewer_shards_and_enumeration(tmp_path, base):
    """P=4 -> restart_P=2: bit parity, and enumeration still works (the
    result has no backend and takes the local joins)."""
    out, ref, _ = _run_both(
        tmp_path, [dict(kind=res.FAULT_SHARD_LOSS, phase=1)],
        elastic=dict(restart_P=2), partition=4)
    r = out.stats["resilience"]["restarts"][0]
    assert (r["from_P"], r["to_P"]) == (4, 2)
    assert r["handoff"]["n"] == int(np.asarray(base.vertex_mask).sum())
    assert out.backend is None and ref.backend is None
    _assert_bit_identical(base, out, "elastic 4->2")
    want = np.asarray(renumerate(base).embeddings)
    np.testing.assert_array_equal(enumerate_matches(out).embeddings, want)
    assert count_matches(out).n_embeddings == len(want)


def test_local_backend_recovery(tmp_path, base):
    """The driver recovers the local backend too (a plain restart on the
    original graph from the restored state)."""
    out, _, _ = _run_both(
        tmp_path, [dict(kind=res.FAULT_SHARD_LOSS, phase=2)])
    assert out.stats["backend"] == "local"
    assert len(out.stats["resilience"]["restarts"]) == 1
    _assert_bit_identical(base, out, "local recovery")


def test_mid_wave_fault_recovery(tmp_path, base):
    """A fault inside a constraint (its second wave) rolls back to the
    previous phase boundary: no partial wave progress leaks."""
    out, _, inj = _run_both(
        tmp_path, [dict(kind=res.FAULT_SHARD_LOSS, phase=1, site="wave",
                        wave=1)], partition=4, wave=4)
    assert inj.fired and inj.fired[0]["site"] == "wave"
    assert inj.fired[0]["wave"] == 1
    assert len(out.stats["resilience"]["restarts"]) == 1
    _assert_bit_identical(base, out, "mid-wave recovery")


@pytest.mark.parametrize("seed", [1, 3, 6])
def test_seeded_random_fault_plan_recovers(tmp_path, base, seed):
    out, _, _ = _run_both(tmp_path, random_plan=(seed, 3), partition=4)
    _assert_bit_identical(base, out, f"random plan {seed}")


# ------------------------------------------------------- degradation ladder
def test_transient_collective_retries_in_place(tmp_path, base):
    out, _, _ = _run_both(
        tmp_path, [dict(kind=res.FAULT_COLLECTIVE_TIMEOUT, phase=1,
                        cleared_by="retry")], ckpt_dir=False, partition=4)
    rs = out.stats["resilience"]
    assert rs["restarts"] == []
    assert [r for r, _ in rs["ladder"]] == ["retry"]
    _assert_bit_identical(base, out, "retry in place")


def test_kernel_fault_escalates_to_ref_rung(tmp_path, base):
    # times=0 (every match) + cleared_by="ref": the retries keep failing
    # until the ladder runs the kernels' plain versions
    out, _, _ = _run_both(
        tmp_path, [dict(kind=res.FAULT_TRANSIENT_KERNEL, phase=1,
                        cleared_by="ref", times=0)],
        ckpt_dir=False, partition=4)
    rs = out.stats["resilience"]
    assert [r for r, _ in rs["ladder"]] == ["retry", "retry", "ref"]
    # on the CPU the plain versions are the only versions: none counted
    assert sum(rs["plain_calls"].values()) == 0
    _assert_bit_identical(base, out, "ref rung")


def test_resource_exhaustion_backs_off_chunk(tmp_path, base):
    out, ref, _ = _run_both(
        tmp_path, [dict(kind=res.FAULT_RESOURCE_EXHAUSTED, phase=2,
                        site="tds", cleared_by="chunk")],
        ckpt_dir=False, partition=4, tds_chunk=4096)
    rs = out.stats["resilience"]
    assert [r for r, _ in rs["ladder"]] == ["chunk"]
    assert out.backend.tds_chunk == ref.backend.tds_chunk == 4096 // 4
    _assert_bit_identical(base, out, "chunk back-off")


def test_ladder_catches_only_its_own_classes(monkeypatch):
    """A plain RuntimeError (a kernel that fails to build or launch) is not
    absorbed by any rung: it fails the run."""
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("bitset_spmm: launch failed")

    monkeypatch.setattr(ops, "bitset_segment_or", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        prune(_graph(), _template(), partition=4, device="cpu",
              resilience=res.ResilienceConfig(), **KW)
    assert len(calls) == 1


def test_unrecoverable_without_checkpoint_dir():
    inj = res.FaultInjector([res.FaultSpec(kind=res.FAULT_SHARD_LOSS, phase=1)])
    with pytest.raises(res.ResilienceExhausted, match="no checkpoint_dir"):
        prune(_graph(), _template(), partition=4, device="cpu",
              resilience=res.ResilienceConfig(injector=inj), **KW)


def test_restart_budget_exhausts(tmp_path):
    # a persistent fault re-fires after every restart until the budget ends
    inj = res.FaultInjector([res.FaultSpec(kind=res.FAULT_SHARD_LOSS,
                                           phase=1, times=0)])
    cfg = res.ResilienceConfig(checkpoint_dir=str(tmp_path), injector=inj,
                               max_restarts=2)
    with pytest.raises(res.ResilienceExhausted, match="restart budget"):
        prune(_graph(), _template(), partition=4, device="cpu",
              resilience=cfg, **KW)
    assert len(inj.fired) == 3  # the first attempt + 2 restarted ones


def test_snapshot_is_a_copy(tmp_path, base, monkeypatch):
    """A fault injected after an in-place write to the shard arrays still
    retries from the phase-entry state, bit for bit; a snapshot that only
    held references would hand the retry the written state."""
    made = []
    real = engine_mod.make_backend

    def recording(*a, **k):
        be = real(*a, **k)
        made.append(be)
        return be

    class Scribbler(res.FaultInjector):
        def event(self, site, *, wave=None, kernel=None):
            if (site == "wave" and self.phase == 1 and wave == 1
                    and self.rung == res.RUNG_FIRST):
                made[-1].omega_all.zero_()  # an in-place write, then a fault
                made[-1].ea_all.zero_()
            return super().event(site, wave=wave, kernel=kernel)

    monkeypatch.setattr(engine_mod, "make_backend", recording)

    def run():
        inj = Scribbler([res.FaultSpec(kind=res.FAULT_COLLECTIVE_TIMEOUT,
                                       phase=1, site="wave", wave=1,
                                       cleared_by="retry")])
        return prune(_graph(), _template(), partition=4, wave=4, device="cpu",
                     resilience=res.ResilienceConfig(injector=inj), **KW)

    out = run()
    assert [r for r, _ in out.stats["resilience"]["ladder"]] == ["retry"]
    _assert_bit_identical(base, out, "in-place write, then a fault")
    monkeypatch.setattr(engine_mod._ShardedBackend, "snapshot",
                        lambda self: (self.omega_all, self.ea_all))
    monkeypatch.setattr(engine_mod._ShardedBackend, "restore_snapshot",
                        lambda self, s: setattr(self, "omega_all", s[0])
                        or setattr(self, "ea_all", s[1]))
    aliased = run()
    assert not np.array_equal(aliased.omega, np.asarray(base.omega))


# ------------------------------------------------- imbalance + elastic unit
def test_device_shard_counts_match_host_oracle(base):
    out = prune(_graph(), _template(), partition=4, device="cpu", **KW)
    counts = out.backend.shard_counts_dev().numpy()
    host = lb.imbalance_stats(_graph(), out.state, 4, out.dg)
    np.testing.assert_array_equal(counts[:, 0], host.vertices_per_shard)
    np.testing.assert_array_equal(counts[:, 1], host.edges_per_shard)
    dev_stats = lb.imbalance_stats_from_counts(counts[:, 0], counts[:, 1])
    assert dev_stats.max_over_mean_edges == host.max_over_mean_edges
    assert dev_stats.shards_holding_half == host.shards_holding_half
    rhost = rlb.imbalance_stats(rrmat(9, edge_factor=6, seed=5), base.state,
                                4, base.dg)
    np.testing.assert_array_equal(rhost.edges_per_shard, host.edges_per_shard)
    assert rhost.gini_edges == host.gini_edges == lb._gini(counts[:, 1])


@pytest.mark.parametrize("to_P", [1, 2, 4])
def test_imbalance_triggered_rebalance(tmp_path, base, to_P):
    # a trigger of 1.0 trips at the first boundary: compact and reshuffle
    # onto to_P shards with no fault, still bit-identical (onto one shard
    # the port runs the rest on the local backend)
    out, ref, _ = _run_both(
        tmp_path, ckpt_dir=False, partition=4,
        elastic=dict(imbalance_trigger=1.0, rebalance_P=to_P))
    rb = out.stats["resilience"]["rebalances"]
    assert rb and rb[0]["from_P"] == 4 and rb[0]["to_P"] == to_P
    assert rb[0]["max_over_mean_before"] > 1.0
    assert out.backend is None and ref.backend is None
    _assert_bit_identical(base, out, f"triggered rebalance onto {to_P}")


def test_elastic_handoff_equals_the_reference(base):
    """The same sub-graph, permutation and partition arrays for one seed,
    and the map back gives the endpoint-consistent restriction."""
    g = _graph()
    state = PruneState(omega=torch.from_numpy(np.array(base.omega)),
                       edge_active=torch.from_numpy(
                           np.array(base.state.edge_active)))
    from repro_torch.graph.structs import DeviceGraph

    dg = DeviceGraph.from_host(g, "cpu")
    out = lb.elastic_handoff(g, dg, state, 2, seed=11)
    rout = rlb.elastic_handoff(rrmat(9, edge_factor=6, seed=5), base.dg,
                               base.state, 2, seed=11)
    (sub, part, state_new, remap), (rsub, rpart, rstate, rremap) = out, rout
    for a in ("src", "dst", "labels"):
        np.testing.assert_array_equal(getattr(sub, a), getattr(rsub, a))
    np.testing.assert_array_equal(remap.old_of_new, rremap.old_of_new)
    np.testing.assert_array_equal(remap.arc_pos, rremap.arc_pos)
    for f in ("send_src_local", "send_pad", "twin_recv_flat", "recv_perm",
              "labels_local", "vertex_valid", "global_of_local"):
        np.testing.assert_array_equal(getattr(part, f),
                                      np.asarray(getattr(rpart, f)), err_msg=f)
    assert (part.P, part.B, part.n_local) == (rpart.P, rpart.B, rpart.n_local)
    np.testing.assert_array_equal(state_new.omega, np.asarray(rstate.omega))
    assert sub.n == int(np.asarray(base.vertex_mask).sum())
    back = lb.remap_state_to_original(state_new, remap, 4)
    vact = np.asarray(base.vertex_mask)
    np.testing.assert_array_equal(back.omega,
                                  np.asarray(base.omega) * vact[:, None])
    np.testing.assert_array_equal(back.edge_active, np.asarray(base.edge_mask))
    shuffled, perm = lb.balanced_shuffle(sub, seed=5)
    rshuffled, rperm = rlb.balanced_shuffle(rsub, seed=5)
    np.testing.assert_array_equal(perm, rperm)
    np.testing.assert_array_equal(shuffled.src, rshuffled.src)


def test_elastic_handoff_degenerate_returns_none():
    g = _graph()
    from repro_torch.graph.structs import DeviceGraph

    empty = lb.elastic_handoff(
        g, DeviceGraph.from_host(g, "cpu"),
        PruneState(omega=np.zeros((g.n, 4), bool),
                   edge_active=np.zeros(g.m, bool)), 2)
    assert empty is None


# ----------------------------------------------------------- spmd backend
def _rank_main(rank, P, init, ckpt_dir, out):
    """One rank of the group: prune with a shard loss at phase 1 and a
    restart onto 2 ranks; ranks 2 and 3 take the result by broadcast."""
    import torch.distributed as dist
    from repro_torch.core import resilience as r
    from repro_torch.core.pipeline import prune as p
    from repro_torch.core.template import Template as T
    from repro_torch.graph.generators import rmat_graph as rm
    from repro_torch.launch.mesh import make_shard_group

    torch.set_num_threads(1)
    group = make_shard_group(P, backend="gloo", init_method=init, rank=rank,
                             timeout_s=60)
    inj = r.FaultInjector([r.FaultSpec(kind=r.FAULT_SHARD_LOSS, phase=1)])
    cfg = r.ResilienceConfig(checkpoint_dir=ckpt_dir, injector=inj,
                             elastic=r.ElasticConfig(restart_P=2))
    res_ = p(rm(9, edge_factor=6, seed=5), T([3, 4, 5, 3], [(0, 1), (1, 2), (2, 3)]),
             mesh=group, device="cpu", resilience=cfg, guarantee_precision=False)
    rs = res_.stats["resilience"]
    np.savez(os.path.join(out, f"rank_{rank}.npz"),
             omega=res_.omega, edge_mask=res_.edge_mask,
             vertex_mask=res_.vertex_mask,
             traj=np.array([(p_.active_vertices, p_.active_edges, p_.omega_bits)
                            for p_ in res_.phases]),
             restarts=np.array([(x["restored_phase"], x["from_P"], x["to_P"])
                                for x in rs["restarts"]]),
             backend=res_.stats["backend"])
    dist.destroy_process_group()


def test_spmd_shard_loss_restarts_onto_smaller_group(tmp_path, base):
    """Four gloo ranks lose a shard at phase 1 and restart onto a group of
    the first two: every rank, the two outside it too, returns the
    fault-free prune."""
    init = f"file://{tmp_path / 'rendezvous'}"
    from torch_spawn import spawn

    spawn(_rank_main, 4, (4, init, str(tmp_path / "ckpt"), str(tmp_path)))
    want = np.array([(a, e, o) for _, a, e, o in _traj(base)])
    for rank in range(4):
        got = np.load(tmp_path / f"rank_{rank}.npz")
        tag = f"rank {rank}"
        assert str(got["backend"]) == "spmd", tag
        np.testing.assert_array_equal(got["restarts"], [[0, 4, 2]], err_msg=tag)
        np.testing.assert_array_equal(got["omega"], np.asarray(base.omega),
                                      err_msg=tag)
        np.testing.assert_array_equal(got["edge_mask"],
                                      np.asarray(base.edge_mask), err_msg=tag)
        np.testing.assert_array_equal(got["vertex_mask"],
                                      np.asarray(base.vertex_mask), err_msg=tag)
        np.testing.assert_array_equal(got["traj"], want, err_msg=tag)
