"""The port's packed-word helpers and the plain PyTorch versions of its two
kernels, held against the JAX package's oracles and its interpret-mode
Pallas kernels. Packed words cross between the packages as numpy arrays:
the port's int32 words viewed as uint32 are the reference's words."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import state as rstate  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.blocked import build_blocked_structure  # noqa: E402
from repro.graph.structs import DeviceGraph as RDeviceGraph  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core.state import pack_bits, unpack_bits  # noqa: E402
from repro_torch.graph import segment_ops  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402
from repro_torch.kernels import ops, ref, registry  # noqa: E402


def _graphs(g):
    """The same host graph as the reference's and the port's device graph."""
    tg = Graph(g.n, g.src, g.dst, g.labels)
    return RDeviceGraph.from_host(g), DeviceGraph.from_host(tg, "cpu")


def _words(rng, n, w):
    u = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    return u, torch.from_numpy(u.view(np.int32).copy())


def _cand(rng, hops, n, p=0.8):
    u = np.where(rng.random((hops, n)) < p, np.uint32(0xFFFFFFFF), np.uint32(0))
    return u, torch.from_numpy(u.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------ pack / unpack
@pytest.mark.parametrize("n0", [1, 7, 31, 32, 33, 64])
def test_pack_unpack_roundtrip_and_reference_bits(n0):
    rng = np.random.default_rng(n0)
    bits = rng.random((50, n0)) < 0.5
    bits[0, :] = True  # bit 31 of every full word set
    packed = pack_bits(torch.from_numpy(bits))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(
        _u32(packed), np.asarray(rstate.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(unpack_bits(packed, n0).numpy(), bits)
    if n0 >= 32:
        assert int(packed[0, 0]) == -1  # all 32 bits: the sign bit included


# -------------------------------------------------------------- bitset_spmm
@pytest.mark.parametrize("scale,w", [(6, 1), (7, 2), (8, 4), (6, 32)])
def test_bitset_spmm_ref_matches_reference(scale, w):
    g = rgen.rmat_graph(scale, edge_factor=4, seed=scale + w)
    rdg, dg = _graphs(g)
    rng = np.random.default_rng(scale * 10 + w)
    u, vals = _words(rng, g.n, w)
    active = rng.random(dg.m) < 0.7
    want = rref.bitset_spmm_ref(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                                jnp.asarray(active))
    got = ops.bitset_or_aggregate(vals, dg, torch.from_numpy(active))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_bitset_kernels_match_interpret_mode_pallas():
    """One small shape against the reference's Pallas kernels, run in
    interpret mode the way tests/test_kernels.py runs them."""
    g = rgen.rmat_graph(6, edge_factor=4, seed=5)
    rdg, dg = _graphs(g)
    rng = np.random.default_rng(5)
    u, vals = _words(rng, g.n, 2)
    active = rng.random(dg.m) < 0.7
    cu, cand = _cand(rng, 3, g.n)
    bs = build_blocked_structure(np.asarray(rdg.src), np.asarray(rdg.dst), g.n, bn=64)
    want = rops.bitset_or_aggregate(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                                    jnp.asarray(active), blocked=bs,
                                    force_pallas=True)
    got = ops.bitset_or_aggregate(vals, dg, torch.from_numpy(active))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    want = rops.bitset_wave(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                            jnp.asarray(active), jnp.asarray(cu), blocked=bs,
                            force_pallas=True)
    got = ops.bitset_wave(vals, dg, torch.from_numpy(active), cand)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_bitset_spmm_all_edges_inactive_and_no_in_arcs():
    g = rgen.erdos_renyi_graph(100, 4.0, seed=0)
    # 5 trailing vertices with no arcs at all
    tg = Graph(g.n + 5, g.src, g.dst, np.concatenate([g.labels, np.zeros(5, np.int32)]))
    dg = DeviceGraph.from_host(tg, "cpu")
    vals = torch.full((tg.n, 1), -1, dtype=torch.int32)
    out = ops.bitset_or_aggregate(vals, dg, torch.zeros(dg.m, dtype=torch.bool))
    assert not out.any()
    out = ops.bitset_or_aggregate(vals, dg, torch.ones(dg.m, dtype=torch.bool))
    assert not out[-5:].any() and bool((out[:-5] == -1).any())


# -------------------------------------------------------------- bitset_wave
@pytest.mark.parametrize("scale,w,hops", [(6, 1, 1), (7, 2, 3), (8, 4, 5), (6, 32, 6)])
def test_bitset_wave_ref_matches_reference(scale, w, hops):
    g = rgen.rmat_graph(scale, edge_factor=4, seed=scale + w)
    rdg, dg = _graphs(g)
    rng = np.random.default_rng(scale * 10 + w + hops)
    u, vals = _words(rng, g.n, w)
    active = rng.random(dg.m) < 0.7
    cu, cand = _cand(rng, hops, g.n)
    want = rref.bitset_wave_ref(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                                jnp.asarray(active), jnp.asarray(cu))
    got = ops.bitset_wave(vals, dg, torch.from_numpy(active), cand)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_bitset_wave_ref_equals_iterated_spmm_ref():
    """The port's plain wave equals L masked hops of the reference's plain
    OR-aggregation."""
    g = rgen.erdos_renyi_graph(200, 5.0, seed=11)
    rdg, dg = _graphs(g)
    rng = np.random.default_rng(11)
    u, vals = _words(rng, g.n, 2)
    active = rng.random(dg.m) < 0.6
    cu, cand = _cand(rng, 4, g.n, p=0.75)
    got = ref.bitset_wave_ref(vals, dg.src, dg.dst, g.n,
                              torch.from_numpy(active), cand)
    step = jnp.asarray(u)
    for r in range(cand.shape[0]):
        step = rref.bitset_spmm_ref(step, rdg.src, rdg.dst, g.n,
                                    jnp.asarray(active)) & jnp.asarray(cu[r])[:, None]
    np.testing.assert_array_equal(_u32(got), np.asarray(step))


def test_bitset_wave_all_edges_inactive_and_zero_hops():
    g = rgen.erdos_renyi_graph(100, 4.0, seed=0)
    _, dg = _graphs(g)
    vals = torch.ones((g.n, 1), dtype=torch.int32)
    cand = torch.full((2, g.n), -1, dtype=torch.int32)
    out = ops.bitset_wave(vals, dg, torch.zeros(dg.m, dtype=torch.bool), cand)
    assert not out.any()
    empty = torch.zeros((0, g.n), dtype=torch.int32)
    assert ops.bitset_wave(vals, dg, torch.ones(dg.m, dtype=torch.bool), empty) is vals
    no_arcs = DeviceGraph.from_host(Graph(16, [], [], np.zeros(16, np.int32)), "cpu")
    v16 = torch.arange(16, dtype=torch.int32)[:, None]
    assert torch.equal(
        ref.bitset_wave_ref(v16, no_arcs.src, no_arcs.dst, 16,
                            torch.zeros(0, dtype=torch.bool), cand[:, :16]),
        torch.zeros_like(v16))


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions: no kernel launch is
    counted and nothing is built."""
    g = rgen.erdos_renyi_graph(64, 4.0, seed=3)
    _, dg = _graphs(g)
    registry.reset_launches()
    vals = torch.ones((g.n, 32), dtype=torch.int32)
    ops.bitset_or_aggregate(vals, dg, torch.ones(dg.m, dtype=torch.bool))
    ops.bitset_wave(vals, dg, torch.ones(dg.m, dtype=torch.bool),
                    torch.full((3, g.n), -1, dtype=torch.int32))
    ops.segment_agg(torch.ones((4, 3, 5)), torch.ones((4, 3), dtype=torch.bool))
    ops.attention(torch.ones((1, 2, 5, 64)), torch.ones((1, 1, 5, 64)),
                  torch.ones((1, 1, 5, 64)))
    ops.embedding_bag(torch.ones((6, 4)), torch.zeros((2, 3), dtype=torch.int32))
    assert registry.launch_counts() == {
        "bitset_spmm": 0, "bitset_wave": 0, "segment_agg": 0,
        "flash_attention": 0, "embedding_bag": 0}
    with pytest.raises(ValueError):
        registry.uses_kernel(torch.zeros(1, device="meta"))


# ----------------------------------------------------------- segment ops
def test_segment_reductions_give_zero_on_empty_segments():
    ids = torch.tensor([0, 0, 2, 2, 2, 5])
    bits = torch.tensor([[True], [False], [False], [False], [False], [True]])
    assert segment_ops.segment_or_bool(bits, ids, 7)[:, 0].tolist() == [
        True, False, False, False, False, True, False]
    assert segment_ops.segment_sum(torch.ones(6, 1, dtype=torch.int32), ids, 7)[
        :, 0].tolist() == [2, 0, 3, 0, 0, 1, 0]


def test_lcc_sweep_via_packed_route_equals_boolean_planes():
    """The packed LCC sweep (bitset_spmm) equals the boolean-plane sweep
    and the reference's sweep, iteration by iteration."""
    from repro.core import lcc as rlcc
    from repro.core.state import init_state as rinit
    from repro.core.template import Template as RT
    from repro_torch.core import lcc
    from repro_torch.core.state import init_state
    from repro_torch.core.template import Template

    g = rgen.rmat_graph(8, edge_factor=6, seed=4, labeler="random", n_labels=5)
    rdg, dg = _graphs(g)
    labels, edges = [0, 1, 2, 3], [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    rtm, tm = RT(labels, edges), Template(labels, edges)
    tdev = lcc.TemplateDev(tm, dg.device)
    rtdev = rlcc.TemplateDev(rtm)
    rst, st_b = rinit(rdg, rtm), init_state(dg, tm)
    st_p = st_b
    for _ in range(4):
        rst, _ = rlcc.lcc_iteration(rdg, rtdev, rst)
        st_b, _ = lcc.lcc_iteration(dg, tdev, st_b)
        st_p, _ = lcc.lcc_iteration_packed(dg, tdev, st_p)
        for st in (st_b, st_p):
            np.testing.assert_array_equal(st.omega.numpy(), np.asarray(rst.omega))
            np.testing.assert_array_equal(st.edge_active.numpy(),
                                          np.asarray(rst.edge_active))
