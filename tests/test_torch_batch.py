"""The port's template-batched prune (core/batch.py) against the JAX
package's `prune_batch` and `prune`.

Every local case of tests/test_batch.py, on the same graphs and templates:
each lane's omega, edge mask and match count equal to the reference's
batched lane and to the reference's single prune of that template; the
lane statuses, `lcc_iterations` (the batched fixpoint's lagged count), the
wave counters (lockstep rounds, tokens, padded jobs, constraints, host
syncs), the batched route bucket and the shared candidacy planes equal to
the reference's. The port runs on the CPU (the kernels' plain versions).
The sharded cases (`partition=`) run the sharded batched engine on the sim
prims against the reference's sharded batch, with lockstep groups of one
job against the ungrouped run, and on a gloo group of two spawned ranks
(`mesh=`).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.core import count_matches as rcount  # noqa: E402
from repro.core import prune as rprune  # noqa: E402
from repro.core import prune_batch as rprune_batch  # noqa: E402
from repro.core.template import Template as RT  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro.kernels import registry as rregistry  # noqa: E402
from repro_torch.core import batch as batch_mod  # noqa: E402
from repro_torch.core.batch import (  # noqa: E402
    STATUS_DEADLINE_MISSED, STATUS_OK, BatchedEngine, BatchedPruneResult,
    prune_batch)
from repro_torch.core.enumerate import count_matches  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structs import DeviceGraph  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

# same pow2 shape bucket (n0 in {3, 4} -> 4); mixed cyclic / path / counted
VARIANTS = [
    ([5, 4, 4, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),  # square
    ([5, 4, 3, 2], [(0, 1), (1, 2), (2, 3)]),          # path
    ([4, 3, 3], [(0, 1), (1, 2), (2, 0)]),             # triangle
    ([6, 5, 4, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([3, 2, 2, 2], [(0, 1), (1, 2), (2, 3)]),
    ([5, 5, 4], [(0, 1), (1, 2), (2, 0)]),             # repeated label
    ([4, 4, 3, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([6, 4, 2], [(0, 1), (1, 2), (2, 0)]),
]
SHARED = [  # 4 lanes x 4 columns = 16 columns over 4 distinct labels
    ([5, 4, 4, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([4, 5, 3, 4], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    ([3, 4, 5, 2], [(0, 1), (1, 2), (2, 3)]),
    ([2, 3, 4, 5], [(0, 1), (1, 2), (2, 3)]),
]
FAST = ([8, 3, 8], [(0, 1), (1, 2), (2, 0)])  # 1-vertex head
SLOW = ([6, 5, 6], [(0, 1), (1, 2), (2, 0)])  # wide head
COUNTERS = ("lcc_iterations", "lcc_calls", "nlcc_waves", "nlcc_tokens",
            "nlcc_lockstep_padded", "nlcc_constraints", "nlcc_host_syncs",
            "tds_gather_bridge", "deadline_cancelled",
            "shared_candidacy_planes", "n_constraints")


@pytest.fixture(autouse=True)
def _no_policies(tmp_path, monkeypatch):
    """No dispatch policy in either package: untuned routes."""
    monkeypatch.setenv(registry.POLICY_ENV, str(tmp_path / "policy.json"))
    registry.clear_policy()
    rregistry.set_policy(None)
    yield
    registry.clear_policy()
    rregistry.clear_policy()


def _graph():
    return gen.rmat_graph(8, edge_factor=6, seed=3)


def _ref(g):
    return RGraph(g.n, g.src, g.dst, g.labels)


class Ref:
    """The reference's single prunes of a graph, one per template, kept."""

    def __init__(self, g):
        self.g, self.rg = g, _ref(g)
        self._seq = {}

    def seq(self, spec, **kw):
        key = (repr(spec), tuple(sorted(kw.items())))
        if key not in self._seq:
            res = rprune(self.rg, RT(*spec), **kw)
            self._seq[key] = (
                np.asarray(res.state.omega), np.asarray(res.state.edge_active),
                int(rcount(res.dg, res.state, RT(*spec)).n_embeddings))
        return self._seq[key]


@pytest.fixture(scope="module")
def ref8():
    return Ref(_graph())


@pytest.fixture(scope="module")
def batch8(ref8):
    """The reference's batched runs on the scale-8 graph, by case."""
    runs = {}

    def run(name, specs, **kw):
        if name not in runs:
            runs[name] = rprune_batch(ref8.rg, [RT(*s) for s in specs], **kw)
        return runs[name]

    return run


def _assert_lanes(bres, rbres, specs, ref, **kw):
    """Each lane equal to the reference's batched lane and single prune,
    omega, edge mask and count; statuses and counters equal."""
    assert isinstance(bres, BatchedPruneResult)
    assert bres.n_lanes == len(specs)
    assert bres.status == rbres.status
    for i, spec in enumerate(specs):
        lane, rlane = bres.results[i], rbres.results[i]
        omega = lane.state.omega.numpy()
        ea = lane.state.edge_active.numpy()
        np.testing.assert_array_equal(omega, np.asarray(rlane.state.omega),
                                      err_msg=f"lane {i}: omega")
        np.testing.assert_array_equal(ea, np.asarray(rlane.state.edge_active),
                                      err_msg=f"lane {i}: edge mask")
        assert lane.stats["lane_status"] == rlane.stats["lane_status"]
        if bres.status[i] != STATUS_OK:
            continue
        s_omega, s_ea, s_count = ref.seq(spec, **kw)
        np.testing.assert_array_equal(omega, s_omega,
                                      err_msg=f"lane {i}: omega vs prune")
        np.testing.assert_array_equal(ea, s_ea,
                                      err_msg=f"lane {i}: edge mask vs prune")
        assert count_matches(lane.dg, lane.state, Template(*spec)
                             ).n_embeddings == s_count, f"lane {i}: count"
    for key in COUNTERS:
        assert bres.stats.get(key) == rbres.stats.get(key), key
    assert bres.stats["batched"]["bucket"] == rbres.stats["batched"]["bucket"]
    assert (bres.stats["batched"]["B"], bres.stats["batched"]["P"]) == (
        rbres.stats["batched"]["B"], rbres.stats["batched"]["P"])


@pytest.mark.parametrize("B", [1, 2, 8])
def test_batched_parity_local(B, ref8, batch8):
    specs = VARIANTS[:B]
    bres = prune_batch(ref8.g, [Template(*s) for s in specs], device="cpu")
    _assert_lanes(bres, batch8(f"B{B}", specs), specs, ref8)
    assert bres.stats["batched"]["B"] == B
    assert bres.stats["batched"]["bucket"].startswith(
        f"b{1 << (B - 1).bit_length() if B > 1 else 1}x")
    assert bres.stats["dispatch_routes"] == {"prune.nlcc": "fused"}


def test_straggler_masking():
    """One lane's sources run dry in round 1 while a batchmate needs
    several rounds: the exhausted lane rides pad (-1) waves, counted in
    nlcc_lockstep_padded, and both lanes keep parity."""
    g = gen.rmat_graph(9, edge_factor=8, seed=5)
    ref = Ref(g)
    specs = [FAST, SLOW]
    kw = dict(wave=32, guarantee_precision=False)
    bres = prune_batch(g, [Template(*s) for s in specs], device="cpu", **kw)
    rbres = rprune_batch(ref.rg, [RT(*s) for s in specs], **kw)
    assert bres.stats.get("nlcc_lockstep_padded", 0) > 0
    _assert_lanes(bres, rbres, specs, ref, **kw)


def test_deadline_cancellation_masks_lane(ref8, batch8):
    """A lane whose deadline passed is zeroed at a phase boundary and
    masked for the rest of the batch; the other lanes keep parity."""
    specs = VARIANTS[:3]
    kw = dict(deadlines=[None, 50.0, None], clock=lambda: 100.0)
    bres = prune_batch(ref8.g, [Template(*s) for s in specs], device="cpu",
                       **kw)
    assert bres.status == [STATUS_OK, STATUS_DEADLINE_MISSED, STATUS_OK]
    dead = bres.results[1]
    assert not dead.state.omega.any()
    assert not dead.state.edge_active.any()
    assert dead.stats["lane_status"] == STATUS_DEADLINE_MISSED
    assert bres.stats["deadline_cancelled"] == 1
    _assert_lanes(bres, batch8("deadline", specs, **kw), specs, ref8)


def test_deadline_midrun_cancellation(ref8):
    """A deadline crossed mid-run cancels at the next phase boundary under a
    ticking clock, never aborting the batch."""
    specs = VARIANTS[:2]

    def ticking():
        tick = {"t": 0.0}

        def clock():
            tick["t"] += 1.0
            return tick["t"]
        return clock

    bres = prune_batch(ref8.g, [Template(*s) for s in specs], device="cpu",
                       deadlines=[1.5, None], clock=ticking())
    rbres = rprune_batch(ref8.rg, [RT(*s) for s in specs],
                         deadlines=[1.5, None], clock=ticking())
    assert bres.status == [STATUS_DEADLINE_MISSED, STATUS_OK]
    assert not bres.results[0].state.omega.any()
    _assert_lanes(bres, rbres, specs, ref8)


@pytest.mark.parametrize("case", ["mixed_bucket", "single_vertex", "empty",
                                  "device_graph"])
def test_rejections(case):
    g = _graph()
    small = Template([5, 4], [(0, 1)])                      # bucket 2
    big = Template([5, 4, 3, 2], [(0, 1), (1, 2), (2, 3)])  # bucket 4
    if case == "mixed_bucket":
        with pytest.raises(ValueError, match="bucket"):
            prune_batch(g, [small, big], device="cpu")
        with pytest.raises(ValueError, match="bucket"):
            rprune_batch(_ref(g), [RT([5, 4], [(0, 1)]),
                                   RT([5, 4, 3, 2], [(0, 1), (1, 2), (2, 3)])])
    elif case == "single_vertex":
        with pytest.raises(ValueError, match="n0 == 1"):
            prune_batch(g, [Template([5], [])], device="cpu")
    elif case == "empty":
        with pytest.raises(ValueError, match="at least one"):
            prune_batch(g, [], device="cpu")
    else:
        with pytest.raises(TypeError, match="host Graph"):
            prune_batch(DeviceGraph.from_host(g, "cpu"), [big], device="cpu")


def test_batched_parity_sharded(ref8, batch8):
    """The local contract composed with the shard axis (sim, P = 4): each
    lane equal to the reference's sharded lane and single prune, the
    counters (the lagged lcc_iterations among them) equal."""
    specs = VARIANTS[:3]
    bres = prune_batch(ref8.g, [Template(*s) for s in specs], device="cpu",
                       partition=4)
    _assert_lanes(bres, batch8("P4", specs, partition=4), specs, ref8)
    assert bres.stats["batched"]["P"] == 4
    assert bres.stats["batched"]["backend"] == "sim"


def test_shared_candidacy_planes_sharded(ref8, batch8):
    specs = VARIANTS[:4]
    bres = prune_batch(ref8.g, [Template(*s) for s in specs], device="cpu",
                       partition=4)
    planes = bres.stats["shared_candidacy_planes"]
    assert planes["distinct"] <= planes["lane_columns"]
    _assert_lanes(bres, batch8("P4 shared", specs, partition=4), specs, ref8)


@pytest.mark.parametrize("route", ["packed", "unpacked"])
def test_sharded_lockstep_groups_of_one(route, ref8, batch8, monkeypatch):
    """Lockstep groups forced to one job (a budget that holds less than one
    job) give the lanes and counters of the ungrouped run, on the packed
    words and on the boolean planes."""
    specs = VARIANTS[:8]
    pol = registry.DispatchPolicy()
    pol.set_route("prune.nlcc", "cpu", registry.batch_bucket(
        8, registry.shard_bucket(2, -(-ref8.g.n // 2), 1024)), route)
    registry.set_policy(pol)
    runs = []
    for budget in (batch_mod.LOCKSTEP_CPU_BUDGET, 1):
        monkeypatch.setattr(batch_mod, "LOCKSTEP_CPU_BUDGET", budget)
        runs.append(prune_batch(ref8.g, [Template(*s) for s in specs],
                                device="cpu", partition=2))
    assert runs[0].stats["batched"]["lockstep"]["jobs_per_group"] > 1
    assert runs[1].stats["batched"]["lockstep"]["jobs_per_group"] == 1
    assert runs[0].stats["dispatch_routes"] == {"prune.nlcc": route}
    for a, b in zip(runs[0].results, runs[1].results):
        assert torch.equal(a.state.omega, b.state.omega)
        assert torch.equal(a.state.edge_active, b.state.edge_active)
    for key in COUNTERS:
        assert runs[0].stats.get(key) == runs[1].stats.get(key), key
    _assert_lanes(runs[1], batch8("P2", specs, partition=2), specs, ref8)


def test_sharded_deadline_and_stragglers():
    """A sharded batch with a straggler pair at wave 32 (padded lockstep
    rounds) and a deadline crossed mid-run, against the reference's."""
    g = gen.rmat_graph(9, edge_factor=8, seed=5)
    ref = Ref(g)
    specs = [FAST, SLOW, VARIANTS[2]]

    def ticking():
        tick = {"t": 0.0}

        def clock():
            tick["t"] += 1.0
            return tick["t"]
        return clock

    kw = dict(wave=32, guarantee_precision=False, partition=2,
              deadlines=[None, None, 1.5])
    bres = prune_batch(g, [Template(*s) for s in specs], device="cpu",
                       clock=ticking(), **kw)
    rbres = rprune_batch(ref.rg, [RT(*s) for s in specs], clock=ticking(),
                         **kw)
    assert bres.stats.get("nlcc_lockstep_padded", 0) > 0
    assert bres.status[2] == STATUS_DEADLINE_MISSED
    _assert_lanes(bres, rbres, specs, ref, wave=32, guarantee_precision=False)


def _spmd_batch_rank(rank, P, init, out):
    """One rank of a gloo group running a sharded batch."""
    import torch.distributed as dist
    from repro_torch.core.batch import prune_batch as pb
    from repro_torch.core.template import Template as T
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.launch.mesh import make_shard_group

    torch.set_num_threads(1)
    group = make_shard_group(P, backend="gloo", init_method=init, rank=rank,
                             timeout_s=60)
    g = rmat_graph(8, edge_factor=6, seed=3)
    bres = pb(g, [T(*s) for s in VARIANTS[:4]], mesh=group, device="cpu")
    assert bres.stats["batched"]["backend"] == "spmd"
    np.savez(os.path.join(out, f"batch_{rank}.npz"),
             **{f"omega{i}": r.state.omega.numpy()
                for i, r in enumerate(bres.results)},
             **{f"ea{i}": r.state.edge_active.numpy()
                for i, r in enumerate(bres.results)},
             counters=np.array([bres.stats.get(k, 0) for k in COUNTERS[:8]]))
    dist.destroy_process_group()


def test_sharded_batch_on_gloo_spmd(tmp_path, ref8, batch8):
    """Two gloo ranks run the batch with mesh=: every rank's lanes equal the
    reference's sharded lanes at P = 2, and the counters agree."""
    from torch_spawn import spawn

    specs = VARIANTS[:4]
    spawn(_spmd_batch_rank, 2, (2, f"file://{tmp_path / 'rdv'}",
                                 str(tmp_path)))
    rbres = batch8("P2 four", specs, partition=2)
    for rank in range(2):
        got = np.load(tmp_path / f"batch_{rank}.npz")
        for i in range(len(specs)):
            np.testing.assert_array_equal(
                got[f"omega{i}"], np.asarray(rbres.results[i].state.omega))
            np.testing.assert_array_equal(
                got[f"ea{i}"], np.asarray(rbres.results[i].state.edge_active))
        np.testing.assert_array_equal(
            got["counters"], [rbres.stats.get(k, 0) for k in COUNTERS[:8]])


def test_batched_route_resolution_uses_batch_bucket(ref8):
    """prune.nlcc resolves under the b<B>-prefixed bucket, rendered as the
    reference renders it."""
    specs = VARIANTS[:2]
    bres = prune_batch(ref8.g, [Template(*s) for s in specs], device="cpu")
    bucket = bres.stats["batched"]["bucket"]
    assert bucket.startswith("b2x")
    assert bucket == rregistry.bucket_key(rregistry.batch_bucket(
        2, rregistry.shard_bucket(1, ref8.g.n, 1024)))
    assert bres.stats["dispatch_routes"]["prune.nlcc"] != "none"


@pytest.mark.parametrize("route", ["fused", "packed", "unpacked"])
def test_policy_routes_keep_parity(route, ref8, batch8):
    """A policy entry under the batched bucket picks the wave route; every
    route gives the same lanes as the reference."""
    specs = VARIANTS[:8]
    pol = registry.DispatchPolicy()
    pol.set_route("prune.nlcc", "cpu", registry.batch_bucket(
        8, registry.shard_bucket(1, ref8.g.n, 1024)), route)
    registry.set_policy(pol)
    bres = prune_batch(ref8.g, [Template(*s) for s in specs], device="cpu")
    assert bres.stats["dispatch_routes"] == {"prune.nlcc": route}
    _assert_lanes(bres, batch8("B8", specs), specs, ref8)


def test_shared_candidacy_plane_prefix_parity(ref8, batch8):
    """One candidacy plane per distinct label: 16 lane columns over 4
    planes, and the lanes keep parity."""
    bres = prune_batch(ref8.g, [Template(*s) for s in SHARED], device="cpu")
    assert bres.stats["shared_candidacy_planes"] == {"distinct": 4,
                                                     "lane_columns": 16}
    _assert_lanes(bres, batch8("shared", SHARED), SHARED, ref8)


def test_lcc_call_that_changes_nothing_counts_two():
    """The lagged schedule: a fixpoint call on lanes already at their
    fixpoint runs one sweep and counts 2, as the reference's batched
    while-loop does."""
    eng = BatchedEngine(_graph(), [Template(*s) for s in VARIANTS[:3]],
                        device="cpu")
    eng.init()
    eng.lcc()
    omega, ea = eng.omega_b.clone(), eng.ea_b.clone()
    stats = {}
    eng.lcc(stats)
    assert stats == {"lcc_calls": 1, "lcc_iterations": 2}
    assert torch.equal(omega, eng.omega_b) and torch.equal(ea, eng.ea_b)
    eng.lcc(stats, lanes=[])
    assert stats["lcc_iterations"] == 4


def test_lane_gather_scatter_cancel_round_trip(ref8):
    """gather_lane returns a lane in its template's own width; scatter_lane
    writes it back with the padded columns empty; cancel_lane zeroes it."""
    eng = BatchedEngine(ref8.g, [Template(*VARIANTS[2]),
                                 Template(*VARIANTS[0])], device="cpu")
    eng.init()
    eng.lcc()
    st = eng.gather_lane(0)
    assert st.omega.shape == (ref8.g.n, 3)
    before = eng.omega_b.clone()
    eng.scatter_lane(0, st)
    assert torch.equal(before, eng.omega_b)
    assert not eng.omega_b[0, :, 3].any()
    eng.cancel_lane(1)
    assert not eng.omega_b[1].any() and not eng.ea_b[1].any()
    assert torch.equal(eng.omega_b[0], before[0])
