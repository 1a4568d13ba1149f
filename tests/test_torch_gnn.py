"""The port's GNN slice against the JAX package, on the CPU: `segment_agg`'s
plain version against the JAX oracle and the interpret-mode Pallas kernel,
`neighborhood_agg`, the segment reductions, the sampler and the batch
streams, the four architectures' forward passes with the JAX weights carried
across, and the pattern-filtered dataset. Inputs are made with numpy from a
seed and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core.template import Template as RTemplate  # noqa: E402
from repro.data import graphs as rdata  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph import sampler as rsampler  # noqa: E402
from repro.graph import segment_ops as rseg  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.segment_agg import segment_agg as pallas_segment_agg  # noqa: E402
from repro.models import gnn as rgnn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import GNN_CLASSES  # noqa: E402
from repro_torch.core.template import Template  # noqa: E402
from repro_torch.data import graphs as data  # noqa: E402
from repro_torch.graph import sampler, segment_ops  # noqa: E402
from repro_torch.graph.structs import Graph  # noqa: E402
from repro_torch.kernels import ops, ref, registry  # noqa: E402
from repro_torch.models.gnn import GNN  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)     # forward passes: f32 matmuls, other order
AGG_TOL = dict(rtol=1e-5, atol=1e-5)  # sums of at most D terms in f32
GNN_ARCHS = ("pna", "graphsage-reddit", "gin-tu", "gat-cora")

# the reference's model functions, each compiled once per config and shape
# (op-by-op dispatch of the many small ops costs seconds per new shape)
_r_init = jax.jit(lambda key, cfg, d_in, n_classes:
                  rgnn.init(key, cfg, d_in, n_classes)[0],
                  static_argnums=(1, 2, 3))
_r_apply = jax.jit(rgnn.apply, static_argnums=1)
_r_apply_sampled = jax.jit(rgnn.apply_sampled, static_argnums=1)
_r_loss = jax.jit(lambda params, cfg, batch: rgnn.loss_fn(params, cfg, batch)[0],
                  static_argnums=1)


def _tg(g):
    """The port's Graph of a reference Graph."""
    return Graph(g.n, g.src, g.dst, g.labels)


def _agg_inputs(nt, d, f, seed, p_valid=0.8):
    """f32 features and a mask with an all-False row (row 0) where nt > 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nt, d, f)).astype(np.float32)
    m = rng.random((nt, d)) < p_valid
    if nt > 1:
        m[0] = False
    return x, m


def _as_dtypes(x, m, dtype):
    """The same values as jnp and torch arrays; bf16 rounds alike in both."""
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x)
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    return jx, jnp.asarray(m), tx, torch.from_numpy(m)


def _assert_agg_equal(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 1:3], want[:, 1:3])  # min, max
    np.testing.assert_allclose(got[:, 0], want[:, 0], **AGG_TOL)
    np.testing.assert_allclose(got[:, 3], want[:, 3], **AGG_TOL)


# -------------------------------------------------------------- segment_agg
@pytest.mark.parametrize("nt,d,f,dtype", [
    (1, 1, 1, "f32"), (7, 4, 3, "f32"), (33, 25, 602, "f32"),
    (16, 10, 128, "bf16"), (5, 3, 7, "bf16"),
])
def test_segment_agg_plain_matches_jax_oracle(nt, d, f, dtype):
    x, m = _agg_inputs(nt, d, f, seed=nt * 100 + d)
    jx, jm, tx, tm = _as_dtypes(x, m, dtype)
    _assert_agg_equal(ops.segment_agg(tx, tm), rref.segment_agg_ref(jx, jm))


@pytest.mark.parametrize("nt,d,f,dtype", [
    (16, 10, 128, "f32"), (8, 25, 256, "f32"), (32, 4, 128, "bf16"),
])
def test_segment_agg_plain_matches_pallas_interpret(nt, d, f, dtype):
    x, m = _agg_inputs(nt, d, f, seed=nt + d)
    jx, jm, tx, tm = _as_dtypes(x, m, dtype)
    want = pallas_segment_agg(jx, jm, interpret=True)
    _assert_agg_equal(ref.segment_agg_ref(tx, tm), want)


def test_segment_agg_masked_slots_do_not_leak():
    """NaN and Inf in masked slots leave every statistic finite; empty rows
    hold the identities 0, +3e38, -3e38, 0."""
    x, m = _agg_inputs(9, 6, 5, seed=3, p_valid=0.5)
    x[~m] = np.nan
    x[~m & (np.arange(6)[None, :] % 2 == 0)] = np.inf
    jx, jm, tx, tm = _as_dtypes(x, m, "f32")
    got = ops.segment_agg(tx, tm)
    assert torch.isfinite(got).all()
    _assert_agg_equal(got, rref.segment_agg_ref(jx, jm))
    big = np.float32(3.0e38)
    assert got[0].tolist() == [[0.0] * 5, [float(big)] * 5,
                               [float(-big)] * 5, [0.0] * 5]


def test_segment_agg_rejects_bad_inputs():
    with pytest.raises(ValueError):
        ops.segment_agg(torch.ones((2, 3, 4), dtype=torch.float64),
                        torch.ones((2, 3), dtype=torch.bool))
    with pytest.raises(ValueError):
        ops.segment_agg(torch.ones((2, 3, 4)), torch.ones((2, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        ops.segment_agg(torch.ones((2, 3, 4)), torch.ones((2, 3)))


@pytest.mark.parametrize("nt,d,f", [(8, 6, 128), (5, 15, 19)])
def test_neighborhood_agg_matches_jax(nt, d, f):
    """Every statistic of the JAX wrapper, rows of degree 0 included."""
    x, m = _agg_inputs(nt, d, f, seed=f)
    m[1, : d // 2] = False
    jx, jm, tx, tm = _as_dtypes(x, m, "f32")
    jdeg = jnp.sum(jm, axis=1).astype(jnp.float32)
    want = rops.neighborhood_agg(jx, jm, jdeg)
    got = ops.neighborhood_agg(tx, tm, torch.from_numpy(np.array(jdeg)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **AGG_TOL, err_msg=k)
    assert got["min"][0].abs().max() == 0 and got["max"][0].abs().max() == 0


# ------------------------------------------------------------- segment ops
def test_segment_reductions_match_jax_on_empty_segments():
    """max / min keep JAX's -inf / +inf (and integer min / max) on empty
    segments; count, mean and softmax agree too. Ids are unsorted."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 9, size=40)
    ids[ids == 4] = 5  # segments 4 and 9..10 are empty
    n = 11
    v = rng.standard_normal((40, 3)).astype(np.float32)
    vi = rng.integers(-50, 50, size=(40,)).astype(np.int32)
    tids = torch.from_numpy(ids)
    jids = jnp.asarray(ids)
    pairs = [
        (segment_ops.segment_max(torch.from_numpy(v), tids, n),
         rseg.segment_max(jnp.asarray(v), jids, n, sorted=False)),
        (segment_ops.segment_min(torch.from_numpy(v), tids, n),
         rseg.segment_min(jnp.asarray(v), jids, n, sorted=False)),
        (segment_ops.segment_max(torch.from_numpy(vi), tids, n),
         rseg.segment_max(jnp.asarray(vi), jids, n, sorted=False)),
        (segment_ops.segment_min(torch.from_numpy(vi), tids, n),
         rseg.segment_min(jnp.asarray(vi), jids, n, sorted=False)),
        (segment_ops.segment_count(tids, n),
         rseg.segment_count(jids, n, sorted=False)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        segment_ops.segment_mean(torch.from_numpy(v), tids, n).numpy(),
        np.asarray(rseg.segment_mean(jnp.asarray(v), jids, n, sorted=False)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        segment_ops.segment_softmax(torch.from_numpy(v), tids, n).numpy(),
        np.asarray(rseg.segment_softmax(jnp.asarray(v), jids, n, sorted=False)),
        rtol=1e-6, atol=1e-6)
    assert segment_ops.segment_min(torch.from_numpy(v), tids, n)[4, 0] == float("inf")


# ---------------------------------------------------------- configs, graphs
def test_gnn_configs_match_the_reference():
    # the port registers every arch id of the JAX package's registry
    assert set(configs.ARCH_IDS) == set(rconfigs.ARCH_IDS) >= set(GNN_ARCHS)
    for arch in GNN_ARCHS:
        mine, theirs = configs.get_arch(arch), rconfigs.get_arch(arch)
        for a, b in ((mine.CONFIG, theirs.CONFIG), (mine.smoke(), theirs.smoke())):
            assert type(a).__name__ == type(b).__name__ == "GNNConfig"
            assert {k: getattr(b, k) for k in vars(a)} == vars(a)
            # the reference's fields the port leaves out, each at a value
            # the port's fixed behaviour matches; the sharded message
            # passing's knobs are the port's too (models/gnn_distributed.py)
            assert set(vars(b)) - set(vars(a)) == {"sample_sizes", "dtype"}
            assert b.dtype == "float32"
            assert (a.distributed, a.message_dtype) == (b.distributed, b.message_dtype)
            assert not a.distributed
        assert set(mine.SHAPES) == set(theirs.SHAPES)
        for name, s in mine.SHAPES.items():
            t = theirs.SHAPES[name]
            for field in vars(s):
                assert getattr(s, field) == getattr(t, field), (name, field)
    from repro.launch.cells import GNN_CLASSES as R_CLASSES
    assert GNN_CLASSES == R_CLASSES


@pytest.mark.parametrize("shuffle", [False, True])
def test_csr_and_subgraph_match_the_reference(shuffle):
    """`csr` (on arcs in (src, dst) order and shuffled) and `subgraph` equal
    the reference's."""
    g = rgen.erdos_renyi_graph(90, 6.0, seed=2)
    if shuffle:
        perm = np.random.default_rng(0).permutation(g.m)
        g = RGraph(g.n, g.src[perm], g.dst[perm], g.labels)
    tg = _tg(g)
    for a, b in zip(tg.csr(), g.csr()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    vm, em = rng.random(g.n) < 0.7, rng.random(g.m) < 0.8
    s, r = tg.subgraph(vm, em), g.subgraph(vm, em)
    assert s.n == r.n
    for a, b in ((s.src, r.src), (s.dst, r.dst), (s.labels, r.labels)):
        np.testing.assert_array_equal(a, b)


def _with_isolated_vertices(g, k=5):
    """g plus k vertices without arcs: the sampler's self-sample case."""
    return RGraph(g.n + k, g.src, g.dst,
                  np.concatenate([g.labels, np.zeros(k, np.int32)]))


def test_neighbor_sampler_draws_the_reference_ids():
    g = _with_isolated_vertices(rgen.erdos_renyi_graph(150, 4.0, seed=7))
    mine = sampler.NeighborSampler(_tg(g), (4, 3), seed=11)
    theirs = rsampler.NeighborSampler(g, (4, 3), seed=11)
    seeds = np.array([0, 3, g.n - 1, g.n - 2, 17], np.int32)
    for a, b in zip(mine.sample(seeds), theirs.sample(seeds)):
        np.testing.assert_array_equal(a, b)
    for _ in range(3):
        for a, b in zip(mine.sample_batch(16), theirs.sample_batch(16)):
            np.testing.assert_array_equal(a, b)


def test_sampled_batch_stream_equals_the_reference():
    g = _with_isolated_vertices(rgen.erdos_renyi_graph(200, 5.0, seed=8))
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((g.n, 12))
    labels = rng.integers(0, 6, g.n)
    mine = data.SampledBatchStream(_tg(g), feats, labels, (5, 3), 16, seed=4,
                                   device="cpu")
    theirs = rdata.SampledBatchStream(g, feats, labels, (5, 3), 16, seed=4)
    for step in (0, 1, 7):
        a, b = mine(step), theirs(step)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=k)
        assert a["x_nbr2"].device.type == "cpu"


# ------------------------------------------------------------------ models
def _model_pair(arch, d_in, n_classes, seed=0):
    """The reference's params and the port's model carrying them."""
    cfg = configs.get_arch(arch).smoke()
    rcfg = rconfigs.get_arch(arch).smoke()
    params = _r_init(jax.random.key(seed), rcfg, d_in, n_classes)
    tree = jax.tree.map(np.asarray, params)
    model = GNN(cfg, d_in, n_classes, device="cpu").load_jax_params(tree)
    return rcfg, params, model


def _jax_batch(batch):
    return {k: (v if isinstance(v, float) else jnp.asarray(v.numpy()))
            for k, v in batch.items()}


def _assert_batches_equal(mine, theirs):
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        if isinstance(v, float):
            assert mine[k] == pytest.approx(v, rel=1e-12), k
        else:
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_sampled_matches_jax(masked):
    """The sampled GraphSAGE forward (three segment_agg calls) on a sampled
    batch, with and without padding masks."""
    g = rgen.erdos_renyi_graph(160, 6.0, seed=9)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((g.n, 10))
    labels = rng.integers(0, 5, g.n)
    stream = data.SampledBatchStream(_tg(g), feats, labels, (5, 3), 12, seed=1,
                                     device="cpu")
    batch = stream(2)
    if masked:
        batch["m_nbr"] = torch.from_numpy(rng.random((12, 5)) < 0.7)
        batch["m_nbr2"] = torch.from_numpy(rng.random((12, 5, 3)) < 0.7)
        batch["m_nbr"][0] = False
    rcfg, params, model = _model_pair("graphsage-reddit", 10, 5)
    jb = _jax_batch(batch)
    want = _r_apply_sampled(params, rcfg, jb)
    got = model.forward_sampled(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(model.loss(batch)),
                               float(_r_loss(params, rcfg, jb)), **TOL)


@pytest.mark.parametrize("regime", ["full_graph", "molecule"])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_full_graph_forward_matches_jax(arch, regime):
    if regime == "full_graph":
        g = rgen.erdos_renyi_graph(120, 5.0, seed=1, n_labels=4)
        # a few vertices without in-arcs: the empty-segment rules of every
        # aggregator are exercised
        g = _with_isolated_vertices(g, 3)
        theirs = rdata.full_graph_batch(g, d_feat=8, n_classes=4, seed=0)
        mine = data.full_graph_batch(_tg(g), 8, 4, seed=0, device="cpu")
    else:
        theirs = rdata.molecule_batch(6, 10, 16, d_feat=8, n_classes=4, seed=2)
        mine = data.molecule_batch(6, 10, 16, 8, 4, seed=2, device="cpu")
    _assert_batches_equal(mine, theirs)
    rcfg, params, model = _model_pair(arch, 8, 4, seed=3)
    want = _r_apply(params, rcfg, theirs)
    got = model(mine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(model.loss(mine)),
                               float(_r_loss(params, rcfg, theirs)), **TOL)


def test_load_jax_params_rejects_a_mismatched_tree():
    _, params, model = _model_pair("gin-tu", 8, 4)
    tree = jax.tree.map(np.asarray, params)
    del tree["layers"][0]["eps"]
    with pytest.raises(ValueError):
        model.load_jax_params(tree)
    tree = jax.tree.map(np.asarray, params)
    tree["head"]["w"] = tree["head"]["w"][:, :3]
    with pytest.raises(ValueError):
        model.load_jax_params(tree)
    assert not any(p.requires_grad for p in model.parameters())


def test_pattern_filtered_dataset_matches_the_reference():
    """Scale-8 R-MAT with planted triangles: the same pruned graph, omega and
    batch as the reference's, and the PNA logits on it."""
    bg = rgen.rmat_graph(8, edge_factor=8, seed=0, labeler="random", n_labels=6)
    needle = RGraph.from_undirected_pairs(3, [(0, 1), (1, 2), (2, 0)], [4, 5, 3])
    g = rgen.planted_pattern_graph(bg, needle, n_copies=6, seed=2)
    labels, edges = [4, 5, 3], [(0, 1), (1, 2), (2, 0)]
    theirs = rdata.PatternFilteredDataset(g, RTemplate(labels, edges), 16, 4, seed=0)
    mine = data.PatternFilteredDataset(_tg(g), Template(labels, edges), 16, 4,
                                       seed=0, device="cpu")
    assert mine.prune_counts == theirs.prune_counts
    assert mine.pruned.n == theirs.pruned.n > 0
    for a, b in ((mine.pruned.src, theirs.pruned.src),
                 (mine.pruned.dst, theirs.pruned.dst),
                 (mine.pruned.labels, theirs.pruned.labels),
                 (mine.omega, theirs.omega)):
        np.testing.assert_array_equal(a, b)
    _assert_batches_equal(mine(0), theirs(0))
    rcfg, params, model = _model_pair("pna", 16 + 3, 4)
    np.testing.assert_allclose(model(mine(0)).numpy(),
                               np.asarray(_r_apply(params, rcfg, theirs(0))),
                               **TOL)


def test_cpu_gnn_path_counts_no_launch():
    registry.reset_launches()
    g = rgen.erdos_renyi_graph(60, 4.0, seed=4)
    rng = np.random.default_rng(0)
    stream = data.SampledBatchStream(_tg(g), rng.standard_normal((g.n, 6)),
                                     rng.integers(0, 3, g.n), (3, 2), 4,
                                     device="cpu")
    model = GNN(configs.get_arch("graphsage-reddit").smoke(), 6, 3, device="cpu")
    assert model.forward_sampled(stream(0)).shape == (4, 3)
    assert registry.launch_counts()["segment_agg"] == 0
