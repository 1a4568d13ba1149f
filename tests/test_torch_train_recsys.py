"""The port's recsys training path against the JAX package, on the CPU,
with the bert4rec smoke config: the loss and every gradient of each of the
reference's three objectives (the full-catalog softmax, the blockwise one,
the sampled softmax over shared negatives), the negatives themselves bit
for bit against `jax.random.randint`, and three train steps. Inputs are
made with numpy from a seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.recsys import MaskedSequenceStream as RSequenceStream  # noqa: E402
from repro.models import bert4rec as rbert4rec  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.train import step as rstep_mod  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.recsys import MaskedSequenceStream  # noqa: E402
from repro_torch.models import bert4rec, prng  # noqa: E402
from repro_torch.models.bert4rec import Bert4Rec  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import TrainConfig, build_train_step, init_state  # noqa: E402
from torch_train_util import (  # noqa: E402,F401
    LOSS_RTOL, assert_grads_close, assert_trees_close, few_torch_threads,
    np_tree, port_value_and_grad, run_both)

B = 6
OBJECTIVES = {"full": {}, "fused_ce": {"fused_ce": 96}, "sampled": {"n_negatives": 40}}


def _configs(**kw):
    return (dataclasses.replace(rconfigs.get_arch("bert4rec").smoke(), **kw),
            dataclasses.replace(configs.get_arch("bert4rec").smoke(), **kw))


def _batches(cfg, steps=1):
    theirs = RSequenceStream(cfg.n_items, B, cfg.seq_len, seed=0)
    mine = MaskedSequenceStream(cfg.n_items, B, cfg.seq_len, seed=0, device="cpu")
    return [(theirs(i), mine(i)) for i in range(steps)]


def _reference_negatives(items, n_negatives, n_items):
    """The two lines of the reference's loss_fn that draw the negatives."""
    seed = jnp.sum(items.astype(jnp.uint32)) % jnp.uint32(2**31 - 1)
    key = jax.random.fold_in(jax.random.key(0), seed)
    return jax.random.randint(key, (n_negatives,), 1, n_items + 1)


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_loss_and_grads_match_the_reference(objective):
    rcfg, cfg = _configs(**OBJECTIVES[objective])
    params = rbert4rec.init(jax.random.key(0), rcfg)[0]
    model = Bert4Rec(cfg, device="cpu").load_jax_params(np_tree(params))
    ((theirs, mine),) = _batches(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: rbert4rec.loss_fn(p, rcfg, b)[0]))(params, theirs)
    loss, grads = port_value_and_grad(model, bert4rec.loss_fn, mine)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)


def test_negatives_equal_jax_random_bit_for_bit():
    """24 batches of the masked-sequence stream over a 1,000,000-item
    catalog, and one whose item ids sum past 2^32 (the uint32 sum wraps)."""
    n_items, n_neg = 1_000_000, 512
    stream = RSequenceStream(n_items, 8, 200, seed=3)
    batches = [np.asarray(stream(i)["items"]) for i in range(24)]
    wrap = np.full((64, 100), n_items - 7, np.int32)
    assert int(wrap.astype(np.int64).sum()) > 2**32
    batches.append(wrap)
    for items in batches:
        want = np.asarray(_reference_negatives(jnp.asarray(items), n_neg, n_items))
        got = bert4rec.negatives(torch.from_numpy(np.array(items)), n_neg, n_items)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    # the generator's pieces against JAX's
    k = jax.random.fold_in(jax.random.key(0), jnp.uint32(123456789))
    mk = prng.fold_in(prng.key(0), 123456789)
    np.testing.assert_array_equal(mk, np.asarray(jax.random.key_data(k)))
    np.testing.assert_array_equal(
        prng.split(mk, 3), np.asarray(jax.random.key_data(jax.random.split(k, 3))))
    np.testing.assert_array_equal(
        prng.random_bits(mk, 7), np.asarray(jax.random.bits(k, (7,), jnp.uint32)))


@pytest.mark.parametrize("objective", ["full", "sampled"])
def test_train_steps_match_the_reference(objective):
    rcfg, cfg = _configs(**OBJECTIVES[objective])
    opt = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
    rtc = rstep_mod.TrainConfig(optimizer=RAdamWConfig(**opt), warmup_steps=2,
                                total_steps=10)
    tc = TrainConfig(optimizer=AdamWConfig(**opt), warmup_steps=2, total_steps=10)
    rstate, _ = rstep_mod.init_state(jax.random.key(0), rcfg, rtc)
    model = Bert4Rec(cfg, device="cpu").load_jax_params(np_tree(rstate["params"]))
    rl, pl, rstate, state = run_both(
        jax.jit(rstep_mod.build_train_step(rcfg, rtc)), rstate,
        build_train_step(model, tc), init_state(model, tc), _batches(cfg, 3))
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    assert_trees_close(state["params"], rstate["params"])
    assert_trees_close(state["opt"]["nu"], rstate["opt"]["nu"])
