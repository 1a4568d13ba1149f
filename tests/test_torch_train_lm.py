"""The port's LM training path against the JAX package, on the CPU, with
the qwen2-1.5b smoke config in f32: the loss and every gradient against
`jax.value_and_grad` of the reference's `loss_fn`, the blockwise loss
(`fused_ce`) against the plain one and the reference's, the three remat
settings, two microbatches, compressed gradients, a three-step trajectory,
and the plain `flash_attention` backward against `jax.vjp` of the
reference oracle. Inputs are made with numpy from a seed and handed to
both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.tokens import SyntheticTokenStream as RTokenStream  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.train import step as rstep_mod  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.tokens import SyntheticTokenStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import TrainConfig, build_train_step, init_state  # noqa: E402
from torch_train_util import (  # noqa: E402,F401
    LOSS_RTOL, PARAM_ATOL, assert_grads_close, assert_trees_close,
    few_torch_threads, np_tree, port_value_and_grad, run_both)

B, S = 4, 32
FUSED_BLOCK = 48   # not a divisor of the smoke vocab (128): a short last block
# the attention backward on f32 inputs: sums of S terms in another order
ATTN_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
# with compressed gradients: the share of a leaf's entries whose int8 value
# may differ by one step (test_train_steps_match_the_reference)
FLIP_SHARE = 1e-3


def _configs(**kw):
    rcfg = dataclasses.replace(rconfigs.get_arch("qwen2-1.5b").smoke(), **kw)
    cfg = dataclasses.replace(configs.get_arch("qwen2-1.5b").smoke(), **kw)
    return rcfg, cfg


_r_init = jax.jit(lambda key, cfg: rtransformer.init(key, cfg)[0], static_argnums=1)


def _model(rcfg, cfg, seed=0):
    params = _r_init(jax.random.key(seed), rcfg)
    return params, Transformer(cfg, device="cpu").load_jax_params(np_tree(params))


def _batches(cfg, steps=1, b=B, s=S):
    theirs = RTokenStream(cfg.vocab, b, s, seed=0)
    mine = SyntheticTokenStream(cfg.vocab, b, s, seed=0, device="cpu")
    return [(theirs(i), mine(i)) for i in range(steps)]


@pytest.mark.parametrize("fused", [0, FUSED_BLOCK])
def test_loss_and_grads_match_the_reference(fused):
    rcfg, cfg = _configs(fused_ce=fused)
    params, model = _model(rcfg, cfg)
    ((theirs, mine),) = _batches(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: rtransformer.loss_fn(p, rcfg, b)[0]))(params, theirs)
    loss, grads = port_value_and_grad(model, transformer.loss_fn, mine)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)


def test_fused_ce_equals_the_plain_loss():
    """The blockwise loss and its recomputing backward against the plain
    cross-entropy, with a mask, and against the reference's."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 7, 16)).astype(np.float32)
    head = rng.standard_normal((16, 130)).astype(np.float32) * 0.3
    labels = rng.integers(0, 130, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6
    for m in (None, mask):
        th, thead = (torch.from_numpy(a).requires_grad_(True) for a in (h, head))
        tm = None if m is None else torch.from_numpy(m)
        got = common.blockwise_cross_entropy(th, thead, torch.from_numpy(labels), tm,
                                             block=FUSED_BLOCK)
        gh, ghead = torch.autograd.grad(got, (th, thead))
        th2, thead2 = (torch.from_numpy(a).requires_grad_(True) for a in (h, head))
        plain = common.cross_entropy(th2 @ thead2, torch.from_numpy(labels), tm)
        ph, phead = torch.autograd.grad(plain, (th2, thead2))
        np.testing.assert_allclose(float(got), float(plain), rtol=LOSS_RTOL)
        np.testing.assert_allclose(gh.numpy(), ph.numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ghead.numpy(), phead.numpy(), rtol=1e-5, atol=1e-7)
        jm = None if m is None else jnp.asarray(m)
        want, (wh, whead) = jax.value_and_grad(
            lambda a, b: rcommon.blockwise_cross_entropy(
                a, b, jnp.asarray(labels), jm, block=FUSED_BLOCK), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(head))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ghead.numpy(), np.asarray(whead), rtol=1e-5, atol=1e-7)


def test_remat_settings_give_the_same_gradients():
    """False, True (recompute each layer) and "dots" (keep the matrix
    products): the same gradients, equal to the reference's under its
    remat."""
    rcfg, cfg = _configs()
    params, model = _model(rcfg, cfg)
    ((theirs, mine),) = _batches(cfg)
    base = None
    for remat in (False, True, "dots"):
        loss, grads = port_value_and_grad(model, transformer.loss_fn, mine, remat=remat)
        if base is None:
            base = (loss, grads)
            want_loss, want_grads = jax.jit(jax.value_and_grad(
                lambda p: rtransformer.loss_fn(p, rcfg, theirs, remat=True)[0]))(params)
            assert_grads_close(grads, want_grads)
        else:
            assert loss == base[0]
            for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(base[1])):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def _pair(rcfg, cfg, **tc_kw):
    rtc = rstep_mod.TrainConfig(optimizer=RAdamWConfig(**OPT), warmup_steps=2,
                                total_steps=10, **tc_kw)
    tc = TrainConfig(optimizer=AdamWConfig(**OPT), warmup_steps=2, total_steps=10,
                     **tc_kw)
    rstate, _ = rstep_mod.init_state(jax.random.key(0), rcfg, rtc)
    model = Transformer(cfg, device="cpu").load_jax_params(np_tree(rstate["params"]))
    return (rstate, jax.jit(rstep_mod.build_train_step(rcfg, rtc)),
            build_train_step(model, tc), init_state(model, tc))


@pytest.mark.parametrize("tc_kw", [
    dict(), dict(microbatches=2, remat=True), dict(compress_grads=True)],
    ids=["plain", "microbatches2_remat", "compressed"])
def test_train_steps_match_the_reference(tc_kw):
    """Three steps from the same state: losses, parameters and moments (and
    the error feedback with compressed gradients)."""
    rcfg, cfg = _configs()
    rstate, rstep, step, like = _pair(rcfg, cfg, **tc_kw)
    rl, pl, rstate, state = run_both(rstep, rstate, step, like, _batches(cfg, 3))
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    if not tc_kw.get("compress_grads"):
        assert_trees_close(state["params"], rstate["params"])
        assert_trees_close(state["opt"]["mu"], rstate["opt"]["mu"])
        return
    # int8 rounding: where a corrected gradient lies within f32 rounding of
    # a .5 boundary, the two packages may pick neighbouring int8 values, a
    # quantization step apart; such an entry's Adam steps then differ by at
    # most lr each. Every other entry is held to PARAM_ATOL.
    for got, want in ((state["params"], rstate["params"]),
                      (state["ef"], rstate["ef"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            diff = np.abs(a.numpy() - np.asarray(b))
            flipped = diff > PARAM_ATOL
            assert flipped.mean() <= FLIP_SHARE
    for a, b in zip(jax.tree.leaves(state["params"]), jax.tree.leaves(rstate["params"])):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 3 * OPT["lr"]
    if tc_kw.get("microbatches"):
        assert all(x.dtype == torch.float32 for x in jax.tree.leaves(state["params"]))


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (2, 4, 2, 128, 32, None), (1, 6, 2, 128, 16, 24), (1, 2, 2, 77, 64, None)])
def test_attention_backward_matches_jax_vjp(b, hq, hkv, s, d, window):
    """GQA and causal (the group's dk, dv summed), with a window, at an odd
    length."""
    rng = np.random.default_rng(s + hq)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) * 0.5 for shape in (
        (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d)))
    _, vjp = jax.vjp(lambda a, b_, c: rref.attention_ref(a, b_, c, causal=True,
                                                         window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.attention_backward(*(torch.from_numpy(a) for a in (q, k, v, do)),
                                 causal=True, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_GRAD_TOL)
    # the wrapper's autograd Function runs the same backward on the CPU
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (ops.attention(tq, tk, tv, causal=True, window=window)
     * torch.from_numpy(do)).sum().backward()
    for g, t in zip(got, (tq, tk, tv)):
        torch.testing.assert_close(t.grad, g, rtol=0, atol=0)
