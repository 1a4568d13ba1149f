"""The port's packed-word helpers and the plain PyTorch versions of its two
kernels, held against the JAX package's oracles and its interpret-mode
Pallas kernels. Packed words cross between the packages as numpy arrays:
the port's int32 words viewed as uint32 are the reference's words."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import state as rstate  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.blocked import build_blocked_structure  # noqa: E402
from repro.graph.structs import DeviceGraph as RDeviceGraph  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core.state import (as_int32_bits, pack_bits,  # noqa: E402
                                    seeded_frontier, source_bits,
                                    unpack_bits)
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
def _cand_words(rng, hops, n, p_zero=1 / 3):
    """Candidacy words over every bit pattern, a share of them 0."""
    u = rng.integers(0, 2**32, size=(hops, n), dtype=np.uint32)
    u[rng.random((hops, n)) < p_zero] = 0
    return u, torch.from_numpy(u.view(np.int32).copy())


_WAVE_CASES = [(6, 1, 1), (7, 2, 3), (8, 4, 5), (6, 32, 6)]


@pytest.mark.parametrize("scale,w,hops,words", [
    *(pytest.param(*c, False, id="-".join(map(str, c))) for c in _WAVE_CASES),
    *(pytest.param(*c, True, id="-".join(map(str, c)) + "-words")
      for c in _WAVE_CASES)])
def test_bitset_wave_ref_matches_reference(scale, w, hops, words):
    """The plain wave equals the reference's, with 0 / -1 candidacy and with
    random candidacy words, which the AND keeps bit by bit."""
    g = rgen.rmat_graph(scale, edge_factor=4, seed=scale + w)
    rdg, dg = _graphs(g)
    rng = np.random.default_rng(scale * 10 + w + hops)
    u, vals = _words(rng, g.n, w)
    active = rng.random(dg.m) < 0.7
    cu, cand = (_cand_words if words else _cand)(rng, hops, g.n)
    want = rref.bitset_wave_ref(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                                jnp.asarray(active), jnp.asarray(cu))
    got = ops.bitset_wave(vals, dg, torch.from_numpy(active), cand)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_bitset_wave_random_words_match_interpret_mode_pallas():
    """Random candidacy words through the reference's Pallas wave in
    interpret mode: the kernel ANDs the words too, not only 0 / -1 masks."""
    g = rgen.rmat_graph(6, edge_factor=4, seed=9)
    rdg, dg = _graphs(g)
    rng = np.random.default_rng(9)
    u, vals = _words(rng, g.n, 2)
    active = rng.random(dg.m) < 0.7
    cu, cand = _cand_words(rng, 3, g.n)
    bs = build_blocked_structure(np.asarray(rdg.src), np.asarray(rdg.dst), g.n, bn=64)
    want = rops.bitset_wave(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                            jnp.asarray(active), jnp.asarray(cu), blocked=bs,
                            force_pallas=True)
    got = ops.bitset_wave(vals, dg, torch.from_numpy(active), cand)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert (_u32(got) != 0).any()


def _wave_schedule(vals, dg, active, cand, chunk, rng):
    """The CUDA wave kernel's schedule (csrc/bitset.cu) in numpy: per-hop
    work items of the candidates, one per `chunk` in-arcs (at least one);
    reads gated by the previous hop's candidacy; hops r < L - 1 writing
    scratch buffer r % ops.BITSET_WAVE_BUFFERS, hop L - 1 writing `out`; a
    split row zeroed in the grid of the hop before (the worklist pass for
    hop 0) and then ORed into by each chunk; `out` zeroed before the pass.
    Every buffer starts as random words, and before each hop every scratch
    row that the schedule does not rely on is refilled with random words.
    Returns out as uint32[n, W]."""
    n, w = vals.shape
    hops = cand.shape[0]
    src, dst = dg.src.numpy().astype(np.int64), dg.dst.numpy().astype(np.int64)
    ptr = dg.dst_ptr.numpy()
    deg = np.diff(ptr)

    def noise(shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    scratch = [noise((n, w)) for _ in range(min(ops.BITSET_WAVE_BUFFERS, hops - 1))]
    out = noise((n, w))

    def buffer(r):
        return out if r == hops - 1 else scratch[r % len(scratch)]

    items = []
    for r in range(hops):
        hop = []
        for v in np.flatnonzero(cand[r]):
            k = -(-deg[v] // chunk) if deg[v] > chunk else 1
            hop += [(v, -1)] if k == 1 else [(v, c) for c in range(k)]
        items.append(hop)

    def zero_split(r):
        for v, c in items[r]:
            if c == 0:
                buffer(r)[v] = 0

    out[:] = 0  # cudaMemsetAsync
    if hops > 1:
        zero_split(0)  # the worklist pass
    for r in range(hops):
        prev = vals if r == 0 else buffer(r - 1)
        nxt = buffer(r)
        relied = {}  # scratch buffer id -> rows that must keep their words
        if r > 0:
            relied.setdefault(id(prev), set()).update(np.flatnonzero(cand[r - 1]))
        relied.setdefault(id(nxt), set()).update(v for v, c in items[r] if c == 0)
        for buf in scratch:
            keep = np.zeros(n, bool)
            keep[list(relied.get(id(buf), ()))] = True
            buf[~keep] = noise((int((~keep).sum()), w))
        for v, c in items[r]:
            lo, hi = ptr[v], ptr[v + 1]
            if c >= 0:
                lo, hi = lo + c * chunk, min(hi, lo + (c + 1) * chunk)
            e = np.arange(lo, hi)
            e = e[active[e]]
            if r > 0:
                e = e[cand[r - 1][src[e]] != 0]
            acc = np.bitwise_or.reduce(prev[src[e]], axis=0) if e.size else np.zeros(w, np.uint32)
            acc &= cand[r][v]
            if c < 0:
                nxt[v] = acc
            else:
                nxt[v] |= acc
        if r + 1 < hops - 1:
            zero_split(r + 1)
    return out


def _hub_graph(rng, n=300, hub=0, hub_in=700, rest=1500):
    """A random graph whose vertex `hub` has `hub_in` in-arcs (3 chunks of
    ops.BITSET_ARC_CHUNK) and out-arcs to many vertices."""
    src = np.concatenate([rng.integers(0, n, hub_in), rng.integers(0, n, rest),
                          np.full(40, hub)])
    dst = np.concatenate([np.full(hub_in, hub), rng.integers(1, n, rest),
                          rng.integers(1, n, 40)])
    return Graph(n, src, dst, np.zeros(n, np.int32))


@pytest.mark.parametrize("hops", [1, 3, 6])
@pytest.mark.parametrize("w", [1, 2, 32, 48])
def test_wave_schedule_equals_reference(w, hops):
    """The kernel's schedule, modelled in numpy with leftovers in every
    buffer, equals the plain wave and the reference's bit for bit; the hub
    (3 chunks of in-arcs) is a candidate in hops r - 1 and r + 1 but not in
    hop r, and candidacy mixes 0 / -1 with random words. The first frontier
    is sparse, so a stale row would change the result."""
    rng = np.random.default_rng(100 * w + hops)
    g = _hub_graph(rng)
    rdg, dg = _graphs(g)
    assert int(dg.dst_ptr[1] - dg.dst_ptr[0]) > 2 * ops.BITSET_ARC_CHUNK
    # one bit in a tenth of the rows, as a wave's first frontier holds its
    # sources: ORs stay sparse, so a leftover word read or kept shows
    u = np.zeros((g.n, w), np.uint32)
    rows = np.flatnonzero(rng.random(g.n) < 0.1)
    u[rows, rng.integers(0, w, rows.size)] = np.uint32(1) << rng.integers(
        0, 32, rows.size).astype(np.uint32)
    vals = torch.from_numpy(u.view(np.int32).copy())
    active = rng.random(dg.m) < 0.8
    cu, _ = _cand(rng, hops, g.n, p=0.5)
    cw, _ = _cand_words(rng, hops, g.n)
    cu = np.where(rng.random((hops, g.n)) < 0.5, cu, cw)
    cu[:, 0] = np.where(np.arange(hops) % 2 == 0, np.uint32(0xFFFFFFFF), 0)
    cand = torch.from_numpy(cu.view(np.int32).copy())
    got = _wave_schedule(u, dg, active, cu, ops.BITSET_ARC_CHUNK, rng)
    plain = ref.bitset_wave_ref(vals, dg.src, dg.dst, g.n,
                                torch.from_numpy(active), cand)
    want = rref.bitset_wave_ref(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                                jnp.asarray(active), jnp.asarray(cu))
    np.testing.assert_array_equal(_u32(plain), np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(want))
    if hops > 1:
        assert (np.asarray(want) != 0).any()


# --------------------------------------------------------- seeded_frontier
def _dense_seed(seeds, cand0, n, w):
    """uint32[n, W]: bit j of row seeds[j] for each seed >= 0 with
    cand0[seeds[j]], built bit by bit."""
    u = np.zeros((n, w), np.uint32)
    for j, v in enumerate(seeds):
        if v >= 0 and cand0[v]:
            u[v, j // 32] |= np.uint32(1) << np.uint32(j % 32)
    return u


def _seed_list(rng, n, S, k, must=()):
    """int32[S]: k distinct real ids (those in `must` among them) at random
    positions, -1 elsewhere."""
    rest = np.setdiff1d(np.arange(n), must)
    real = np.concatenate([np.asarray(must, np.int64),
                           rng.choice(rest, k - len(must), replace=False)])
    seeds = np.full(S, -1, np.int64)
    seeds[rng.choice(S, k, replace=False)] = real
    return seeds.astype(np.int32)


def _seeded_case(case, rng):
    """(host graph, seeds int32[S], cand0 bool[n], hops) of one case."""
    if case == "hub":
        g = _hub_graph(rng)
        seeds = _seed_list(rng, g.n, 64, 40, must=[0])
        cand0 = rng.random(g.n) < 0.7
        cand0[0] = True
        return g, seeds, cand0, 3
    g = rgen.rmat_graph(11, edge_factor=4, seed=7)
    cand0 = rng.random(g.n) < 0.8
    if case.startswith("pads-"):
        S = int(case.split("-")[1])
        return g, _seed_list(rng, g.n, S, 3 * S // 4), cand0, 3
    if case == "vertex0":
        # vertex 0 a real source at column 37, pads (which clip onto it in
        # the dense builds) around it
        seeds = np.full(64, -1, np.int32)
        seeds[37] = 0
        seeds[[3, 50]] = [5, 9]
        cand0[[0, 5, 9]] = True
        return g, seeds, cand0, 4
    # a real source that is not a candidate of the walk's head
    seeds = _seed_list(rng, g.n, 32, 20)
    cand0[seeds[seeds >= 0][:3]] = False
    return g, seeds, cand0, 3


@pytest.mark.parametrize("case", ["pads-32", "pads-64", "pads-1024", "vertex0",
                                  "not-candidate", "hub"])
def test_seeded_frontier_wave_equals_reference_on_the_dense_seed(case):
    """A wave's int32 hop-0 frontier made from its source ids equals the
    one built bit by bit, and the port's wave from it equals the
    reference's wave from that one."""
    rng = np.random.default_rng(sum(map(ord, case)))
    g, seeds, cand0, hops = _seeded_case(case, rng)
    rdg, dg = _graphs(g)
    w = seeds.size // 32
    u = _dense_seed(seeds, cand0, g.n, w)
    active = rng.random(dg.m) < 0.8
    cu, cand = _cand(rng, hops, g.n, p=0.6)
    seed0 = seeded_frontier(torch.from_numpy(seeds), torch.from_numpy(cand0), g.n)
    assert seed0.dtype == torch.int32 and seed0.shape == (g.n, w)
    np.testing.assert_array_equal(_u32(seed0), u)
    got = ops.bitset_wave(seed0, dg, torch.from_numpy(active), cand)
    want = rref.bitset_wave_ref(jnp.asarray(u), rdg.src, rdg.dst, g.n,
                                jnp.asarray(active), jnp.asarray(cu))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    if case == "vertex0":
        assert _u32(seed0)[0, 1] == 1 << 5  # column 37 alone in row 0
    if case == "not-candidate":
        off = seeds.copy()
        off[(seeds >= 0) & ~cand0[np.maximum(seeds, 0)]] = -1
        assert torch.equal(seed0, seeded_frontier(
            torch.from_numpy(off), torch.from_numpy(cand0), g.n))
    assert (np.asarray(want) != 0).any()


def _source_bits_int64(n, rows, bits):
    """The int64 build that `source_bits` replaced: S values scattered into
    an int64 [n W] plane, then cut to int32."""
    S = rows.shape[0]
    W = S // 32
    cols = torch.arange(S)
    words = torch.zeros(n * W, dtype=torch.int64)
    words.scatter_add_(0, rows * W + cols // 32,
                       bits.to(torch.int64) * (torch.ones_like(cols) << (cols % 32)))
    return as_int32_bits(words).reshape(n, W)


@pytest.mark.parametrize("S", [32, 64, 1024])
def test_source_bits_equals_the_int64_build(S):
    """The int32 `source_bits` equals the int64 build word for word, with
    rows repeated (pads clipped onto vertex 0) and bit 31 set."""
    rng = np.random.default_rng(S)
    n = 97
    rows = torch.from_numpy(rng.integers(0, n, S))
    rows[rng.random(S) < 0.2] = 0
    bits = torch.from_numpy(rng.random(S) < 0.7)
    bits[31] = True
    got = source_bits(n, rows, bits)
    assert got.dtype == torch.int32 and got.shape == (n, S // 32)
    assert torch.equal(got, _source_bits_int64(n, rows, bits))
    assert bool((got < 0).any())
    ones = torch.ones(S, dtype=torch.bool)
    assert torch.equal(source_bits(n, rows, ones),
                       _source_bits_int64(n, rows, ones))


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


def test_launches_inside_a_backward_are_counted_apart():
    """A launch counted while the autograd engine runs a backward (a forward
    that activation checkpointing recomputes there) also counts in
    `backward_launch_counts`; one outside a backward does not."""
    from torch.utils.checkpoint import checkpoint

    def layer(x):
        registry.count_launch("flash_attention", variant="bf16_tc")
        return x.sin()

    registry.reset_launches()
    x = torch.ones(3, requires_grad=True)
    y = checkpoint(layer, x, use_reentrant=False).sum()
    assert registry.backward_launch_counts()["flash_attention"] == 0
    torch.autograd.grad(y, x)
    assert registry.launch_counts()["flash_attention"] == 2
    assert registry.backward_launch_counts()["flash_attention"] == 1
    assert registry.variant_counts("flash_attention")["bf16_tc"] == 2
    registry.reset_launches()
    assert registry.backward_launch_counts()["flash_attention"] == 0


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
