"""The port's recsys slice against the JAX package, on the CPU:
`embedding_bag`'s plain version against the JAX oracle and the
interpret-mode Pallas kernel, the BERT4Rec smoke model's encoder, catalog
scores and retrieval scores with the JAX weights carried across, the
masked-sequence stream and the configs. Inputs are made with numpy from a
seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.recsys import MaskedSequenceStream as RSequenceStream  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag as pallas_embedding_bag  # noqa: E402
from repro.models import bert4rec as rbert4rec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RecsysConfig  # noqa: E402
from repro_torch.data.recsys import MaskedSequenceStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.bert4rec import Bert4Rec  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)      # model outputs: f32, another order
BAG_TOL = dict(rtol=1e-5, atol=1e-5)  # sums of at most L products in f32

# the four cases of the JAX package's embedding_bag test
BAG_CASES = [
    (1000, 128, 8, 4, "sum"),
    (5000, 256, 16, 10, "mean"),
    (128, 128, 4, 1, "sum"),
    (2048, 512, 2, 32, "mean"),   # long bags, wide rows
]

_r_init = jax.jit(lambda key, cfg: rbert4rec.init(key, cfg)[0], static_argnums=1)
_r_encode = jax.jit(rbert4rec.encode, static_argnums=1)
_r_serve = jax.jit(rbert4rec.serve_scores, static_argnums=1)
_r_retrieval = jax.jit(rbert4rec.retrieval_scores, static_argnums=1)


def _bag_inputs(v, d, b, l, seed):
    """The JAX test's inputs: a normal table, ids over the table, weights 1
    or 0 (padding)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, l)).astype(np.int32)
    weights = (rng.random((b, l)) < 0.9).astype(np.float32)
    return table, ids, weights


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ embedding_bag
@pytest.mark.parametrize("v,d,b,l,mode", BAG_CASES)
def test_embedding_bag_plain_matches_jax_oracle(v, d, b, l, mode):
    table, ids, weights = _bag_inputs(v, d, b, l, seed=v + b)
    want = rref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(weights), mode=mode)
    got = ops.embedding_bag(*_t(table, ids, weights), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG_TOL)


@pytest.mark.parametrize("v,d,b,l,mode", [BAG_CASES[0], BAG_CASES[2],
                                          (300, 128, 6, 3, "mean")])
def test_embedding_bag_plain_matches_pallas_interpret(v, d, b, l, mode):
    table, ids, weights = _bag_inputs(v, d, b, l, seed=d + l)
    weights[0] = 0.0   # an all-padding bag: mean divides by max(0, 1)
    want = pallas_embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                jnp.asarray(weights), mode=mode, interpret=True)
    got = ref.embedding_bag_ref(*_t(table, ids, weights), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG_TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_bf16_table(mode):
    """A bf16 table gives bf16 bags, summed in f32 and rounded once, like
    the JAX oracle; real-valued weights, so the mean counts nonzeros."""
    table, ids, _ = _bag_inputs(700, 64, 9, 5, seed=11)
    weights = np.random.default_rng(4).standard_normal((9, 5)).astype(np.float32)
    weights[:, -2:] = 0.0
    want = rref.embedding_bag_ref(jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids),
                                  jnp.asarray(weights), mode=mode)
    got = ops.embedding_bag(torch.from_numpy(table).bfloat16(),
                            *_t(ids, weights), mode=mode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -8)


def test_embedding_bag_ids_follow_jnp_take():
    """A negative id counts from the end of the table; an id outside
    [-V, V) reads NaN, as `jnp.take` does."""
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    ids = np.array([[-1, 0], [2, 6], [-7, 1]], np.int32)
    weights = np.ones((3, 2), np.float32)
    want = np.asarray(rref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                             jnp.asarray(weights)))
    got = ops.embedding_bag(*_t(table, ids, weights)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [10.0, 12.0] and np.isnan(got[1:]).all()


def test_embedding_bag_rejects_bad_inputs():
    table = torch.ones((5, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    for call in (lambda: ops.embedding_bag(table, ids.long()),
                 lambda: ops.embedding_bag(table.double(), ids),
                 lambda: ops.embedding_bag(table, ids, torch.ones((2, 2))),
                 lambda: ops.embedding_bag(table, ids, mode="max")):
        with pytest.raises(ValueError):
            call()
    np.testing.assert_array_equal(ops.embedding_bag(table, ids).numpy(),
                                  np.full((2, 4), 3.0, np.float32))


# -------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def smoke_pair():
    """The BERT4Rec smoke model of both packages, with the JAX weights (made
    non-trivial: random biases and LayerNorm parameters) carried across."""
    cfg = rconfigs.get_arch("bert4rec").smoke()
    params = jax.tree.map(np.asarray, _r_init(jax.random.key(0), cfg))
    rng = np.random.default_rng(0)
    params["out_bias"] = rng.standard_normal(params["out_bias"].shape).astype(np.float32)
    for blk in params["blocks"]:
        for name in ("b_in", "b_out", "ln1_b", "ln2_b"):
            blk[name] = 0.1 * rng.standard_normal(blk[name].shape).astype(np.float32)
        for name in ("ln1_g", "ln2_g"):
            blk[name] = 1 + 0.1 * rng.standard_normal(blk[name].shape).astype(np.float32)
    model = Bert4Rec(configs.get_arch("bert4rec").smoke(), device="cpu")
    model.load_jax_params(params)
    items = MaskedSequenceStream(cfg.n_items, 6, cfg.seq_len, seed=2,
                                 device="cpu")(0)["items"]
    return cfg, params, model, items


def test_encode_and_serve_scores_match_jax(smoke_pair):
    cfg, params, model, items = smoke_pair
    jitems = jnp.asarray(items.numpy())
    assert (items == 0).any()  # left padding is masked out of the attention
    np.testing.assert_allclose(model.encode(items).numpy(),
                               np.asarray(_r_encode(params, cfg, jitems)), **TOL)
    got = model.serve_scores(items)
    assert got.shape == (6, cfg.n_items + 2)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_r_serve(params, cfg, jitems)), **TOL)


def test_retrieval_scores_match_jax(smoke_pair):
    cfg, params, model, items = smoke_pair
    cands = np.random.default_rng(3).integers(1, cfg.n_items + 1, 300).astype(np.int32)
    want = _r_retrieval(params, cfg, jnp.asarray(items[:2].numpy()), jnp.asarray(cands))
    got = model.retrieval_scores(items[:2], torch.from_numpy(cands))
    assert got.dtype == torch.float32 and got.shape == (2, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the retrieval scores are the catalog scores of the candidates
    np.testing.assert_allclose(
        got.numpy(), model.serve_scores(items[:2])[:, cands].numpy(), **TOL)


def test_load_jax_params_rejects_a_mismatched_tree(smoke_pair):
    cfg, params, model, _ = smoke_pair
    with pytest.raises(ValueError):
        model.load_jax_params(dict(params, blocks=params["blocks"][:1]))
    with pytest.raises(ValueError):
        model.load_jax_params(dict(params, pos=params["pos"][:, :-1]))


# ------------------------------------------------------------ data, configs
def test_masked_sequence_stream_matches_the_reference():
    mine = MaskedSequenceStream(500, 4, 30, mask_prob=0.3, seed=9, device="cpu")
    theirs = RSequenceStream(500, 4, 30, mask_prob=0.3, seed=9)
    for step in (0, 3):
        got, want = mine(step), theirs(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got["items"].dtype == torch.int32 and got["mlm_mask"].dtype == torch.bool


def test_recsys_config_matches_the_reference():
    mine, theirs = configs.get_arch("bert4rec"), rconfigs.get_arch("bert4rec")
    for a, b in ((mine.CONFIG, theirs.CONFIG), (mine.smoke(), theirs.smoke())):
        assert type(a) is RecsysConfig
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.n_params() == b.n_params()
    assert set(mine.SHAPES) == set(theirs.SHAPES)
    for name, s in mine.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(theirs.SHAPES[name])


@pytest.mark.parametrize("kind", ["serve", "retrieval"])
def test_recsys_scorer_matches_the_reference(smoke_pair, kind):
    """`serve/engine.build_recsys_scorer` against the reference's, on the
    same weights and items; an unknown kind raises in both."""
    from repro.serve import engine as rengine
    from repro_torch.serve import engine

    cfg, params, model, items = smoke_pair
    cands = np.random.default_rng(4).integers(1, cfg.n_items + 1, 50).astype(np.int32)
    args = (items[:3],) + ((torch.from_numpy(cands),) if kind == "retrieval" else ())
    want = rengine.build_recsys_scorer(cfg, kind)(
        params, *(jnp.asarray(a.numpy()) for a in args))
    got = engine.build_recsys_scorer(model, kind)(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        engine.build_recsys_scorer(model, "decode")


def test_get_config_and_get_shapes_match_the_reference():
    """`configs.get_config` and `get_shapes` of every arch equal the
    reference's in every field the port's configs have (the GNN configs
    leave out the reference's `dtype` and `sample_sizes`)."""
    from repro_torch.configs import ARCH_IDS

    assert set(ARCH_IDS) == set(rconfigs.ARCH_IDS)
    for arch in ARCH_IDS:
        mine, theirs = (dataclasses.asdict(c) for c in (
            configs.get_config(arch), rconfigs.get_config(arch)))
        assert mine == {k: theirs[k] for k in mine}
        mine, theirs = configs.get_shapes(arch), rconfigs.get_shapes(arch)
        assert set(mine) == set(theirs)
        for name, s in mine.items():
            assert dataclasses.asdict(s) == dataclasses.asdict(theirs[name])
