"""The port's edge partition against the JAX package's.

`partition_graph` must build the reference's arrays field for field on the
same graph at P in {1, 2, 4, 8}; so must the join plan and the row plan,
which are cached on the partition. Also: `partition_shapes`, the receive
arc list `bitset_spmm` walks, the device upload, and the arc-slot round
trip of the sharded backends' gather and scatter bridge.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

from repro.graph import partition as rpart  # noqa: E402
from repro.graph.generators import rmat_graph as rrmat  # noqa: E402
from repro_torch.core.engine import make_backend  # noqa: E402
from repro_torch.core.state import PruneState  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.graph import partition as part_mod  # noqa: E402
from repro_torch.graph.generators import rmat_graph  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402

SHARDS = (1, 2, 4, 8)


def _pow2(k):
    return 1 if k <= 1 else 1 << (k - 1).bit_length()


@pytest.fixture(scope="module")
def graphs():
    """The sharded suite's graph from both packages' generators."""
    return rmat_graph(9, edge_factor=6, seed=5), rrmat(9, edge_factor=6, seed=5)


@pytest.mark.parametrize("P", SHARDS)
def test_partition_arrays_equal_the_reference(graphs, P):
    g, rg = graphs
    np.testing.assert_array_equal(g.src, rg.src)
    part, ref = part_mod.partition_graph(g, P), rpart.partition_graph(rg, P)
    fields = [f.name for f in dataclasses.fields(rpart.EdgePartition)]
    assert [f.name for f in dataclasses.fields(part_mod.EdgePartition)] == fields
    for name in fields:
        a, b = getattr(part, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert part.meta() == ref.meta() and part.total_slots == ref.total_slots


@pytest.mark.parametrize("P", SHARDS)
def test_join_and_row_plans_equal_the_reference(graphs, P):
    g, rg = graphs
    part, ref = part_mod.partition_graph(g, P), rpart.partition_graph(rg, P)
    jp, rjp = part.join_plan(), ref.join_plan()
    assert (jp.A, jp.n_pad) == (rjp.A, rjp.n_pad)
    for name in ("perm", "csr_off", "arc_dst", "deg"):
        np.testing.assert_array_equal(getattr(jp, name), getattr(rjp, name))
        assert getattr(jp, name).dtype == getattr(rjp, name).dtype
    rp, rrp = part.row_plan(), ref.row_plan()
    assert (rp.P, rp.n_local, rp.n_pad) == (rrp.P, rrp.n_local, rrp.n_pad)
    np.testing.assert_array_equal(rp.deg, rrp.deg)
    ids = np.arange(0, g.n, 7).reshape(-1, 1).astype(np.int32)
    rows = np.concatenate([ids, ids[::-1]], axis=1)
    for x, y in zip(rp.shard_rows(rows, 1, _pow2), rrp.shard_rows(rows, 1, _pow2)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(rp.owner_of(np.array([0, g.n - 1, rp.n_pad])),
                                  rrp.owner_of(np.array([0, g.n - 1, rp.n_pad])))


def test_join_plan_and_row_plan_cached_on_partition(graphs, monkeypatch):
    """The plans are built once per partition, and the device copies once
    per partition and device, however many enumerations read them."""
    from repro_torch.core.enumerate import count_matches
    from repro_torch.core.pipeline import prune

    g, _ = graphs
    part = part_mod.partition_graph(g, 4)
    calls = {"n": 0}
    real = part_mod.build_join_plan

    def counting(p):
        calls["n"] += 1
        return real(p)

    monkeypatch.setattr(part_mod, "build_join_plan", counting)
    tmpl = Template([8, 7, 7], [(0, 1), (1, 2), (2, 0)])
    res = prune(g, tmpl, partition=part, device="cpu",
                guarantee_precision=False)
    count_matches(res)
    count_matches(res, route="replicated")
    assert calls["n"] <= 1
    assert part.join_plan() is part.join_plan()
    assert part.join_plan_dev("cpu") is part.join_plan_dev("cpu")
    assert part.device_arrays("cpu") is part.device_arrays("cpu")
    assert part.row_plan() is part.row_plan()
    assert part.row_plan().deg.dtype == np.int64


@pytest.mark.parametrize("P", SHARDS)
def test_partition_shapes_equal_the_reference(P):
    assert (part_mod.partition_shapes(5000, 80000, P, 2)
            == rpart.partition_shapes(5000, 80000, P, 2))


@pytest.mark.parametrize("P", SHARDS)
def test_receive_arcs_and_device_arrays(graphs, P):
    """The receive arc list holds every real received slot once, sorted by
    (shard, local dst), its CSR offsets match, and the upload keeps the
    static index arrays int32."""
    g, _ = graphs
    part = part_mod.partition_graph(g, P)
    src, dst, ptr = part.recv_arcs()
    S = P * part.B
    assert src.dtype == np.int32 and dst.dtype == np.int32
    assert src.shape[0] == g.m and np.all(np.diff(dst) >= 0)
    np.testing.assert_array_equal(
        np.repeat(np.arange(P * part.n_local), np.diff(ptr)), dst)
    real = part.recv_sorted_dst_local < part.n_local
    want_src = np.concatenate([p * S + part.recv_perm[p][real[p]]
                               for p in range(P)])
    want_dst = np.concatenate([p * part.n_local
                               + part.recv_sorted_dst_local[p][real[p]]
                               for p in range(P)])
    np.testing.assert_array_equal(src, want_src)
    np.testing.assert_array_equal(dst, want_dst)
    d = part.device_arrays("cpu")
    for name in part_mod.SHARD_FIELDS:
        want = getattr(part, name)
        assert d[name].dtype == (torch.bool if want.dtype == bool else torch.int32)
        np.testing.assert_array_equal(d[name].numpy(), want)
    assert d["rx_src"].dtype == d["rx_dst"].dtype == torch.int32
    assert d["rx_ptr"].dtype == torch.int64


@pytest.mark.parametrize("P", SHARDS)
def test_arc_slot_round_trip(graphs, P):
    """scatter_state then gather_state returns a global state unchanged, and
    the arc-slot map sends every arc of the dst-sorted graph to its own
    bucket slot (one dst-sort serves the graph and the map)."""
    g, _ = graphs
    tmpl = Template([4, 3, 5, 3], [(0, 1), (1, 2), (2, 3)])
    be = make_backend(g, tmpl, device="cpu", partition=P)
    order = DeviceGraph.dst_sort_order(g)
    np.testing.assert_array_equal(be.dg.src.numpy(), g.src[order])
    part = be.part
    slots = be._arc_slot.numpy().astype(np.int64)
    assert np.unique(slots).size == g.m
    p, rest = slots // (P * part.B), slots % (P * part.B)
    q, b = rest // part.B, rest % part.B
    src, dst = be.dg.src.numpy(), be.dg.dst.numpy()
    np.testing.assert_array_equal(p, src // part.n_local)
    np.testing.assert_array_equal(q, dst // part.n_local)
    np.testing.assert_array_equal(part.send_src_local[p, q, b], src % part.n_local)
    rng = np.random.default_rng(P)
    state = PruneState(
        omega=torch.from_numpy(rng.random((g.n, tmpl.n0)) < 0.5),
        edge_active=torch.from_numpy(rng.random(g.m) < 0.5))
    be.init(state)
    back = be.gather_state()
    assert torch.equal(back.omega, state.omega)
    assert torch.equal(back.edge_active, state.edge_active)
    # counts from the shards, whole and per shard (each arc on its source's)
    total = be.counts_dev().tolist()
    assert total == [int(state.omega.any(1).sum()),
                     int(state.edge_active.sum()), int(state.omega.sum())]
    per_shard = be.shard_counts_dev().numpy()
    assert per_shard.shape == (P, 2) and per_shard.sum(0).tolist() == total[:2]
    owner = be.dg.src.numpy() // part.n_local
    np.testing.assert_array_equal(
        per_shard[:, 1], np.bincount(owner[state.edge_active.numpy()],
                                     minlength=P))


def test_undirected_check_and_from_host_order(graphs):
    g, _ = graphs
    with pytest.raises(ValueError, match="undirected"):
        part_mod.partition_graph(Graph(3, [0, 1], [1, 2], [0, 0, 0]), 2)
    order = DeviceGraph.dst_sort_order(g)
    a = DeviceGraph.from_host(g, "cpu")
    b = DeviceGraph.from_host(g, "cpu", order=order)
    for name in ("src", "dst", "dst_ptr", "labels"):
        assert torch.equal(getattr(a, name), getattr(b, name))
