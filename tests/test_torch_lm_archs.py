"""The port's four other LM architectures against the JAX package, on the
CPU, at their smoke configs in f32: qwen3-8b (qk-norm), starcoder2-15b
(LayerNorm, the GELU MLP with biases, the sliding window and its ring
cache), deepseek-v2-lite-16b (MLA without q compression, MoE with shared
and routed experts) and deepseek-v3-671b (MLA with q-LoRA, MoE, MTP). The
JAX weights (gains and biases made non-trivial) are carried across with
`load_jax_params`; each arch's model pair is built once per module and each
reference function jitted once per config. Held: `forward`'s logits and aux
loss, `loss_fn` (MTP and aux included), every gradient of the loss against
`jax.grad` within the training bounds, decode steps against `decode_step`
(starcoder2 past its window of 16, so the ring wraps), the prefill's cache
and last logits against the reference's teacher-forced `build_prefill`,
greedy tokens, and the parameter paths and `load_jax_state` against the
reference's trees."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro.serve import engine as rengine  # noqa: E402
from repro.train import step as rstep_mod  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.tokens import SyntheticTokenStream  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.step import TrainConfig, init_state, load_jax_state  # noqa: E402
from torch_train_util import (  # noqa: E402,F401
    LOSS_RTOL, assert_grads_close, assert_trees_close, few_torch_threads,
    np_tree, port_value_and_grad)

ARCHS = ("qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b", "deepseek-v3-671b")
# model outputs: f32 matmuls and reductions in another order
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24           # starcoder2's smoke window is 16: S crosses it
PROMPT, MAX_SEQ = 20, 26
# leaves the reference initialises to ones or zeros: drawn at random here,
# so that a gain or bias read at the wrong place shows
_FLAT_LEAVES = {"g", "b", "bq", "bk", "bv", "b_in", "b_out", "q_norm", "k_norm",
                "q_a_norm", "kv_a_norm"}


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def one(path, x):
        x = np.asarray(x)
        if jax.tree_util.keystr(path[-1:]).strip("[]'") in _FLAT_LEAVES:
            base = 1.0 if np.all(x == 1) else 0.0
            return (base + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(one, params)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference config, its params as numpy, the port's model with
    them, the reference functions jitted for this config)."""
    arch = request.param
    rcfg, cfg = rconfigs.get_arch(arch).smoke(), configs.get_arch(arch).smoke()
    init = jax.jit(lambda key: rtransformer.init(key, rcfg)[0])
    params = _perturbed(np_tree(init(jax.random.key(0))), 1)
    model = Transformer(cfg, device="cpu").load_jax_params(params)
    fns = {
        "forward": jax.jit(lambda p, t: rtransformer.forward(p, rcfg, t)),
        "loss": jax.jit(jax.value_and_grad(
            lambda p, b: rtransformer.loss_fn(p, rcfg, b), has_aux=True)),
        "decode": jax.jit(lambda p, t, c: rtransformer.decode_step(p, rcfg, t, c)),
        "prefill": jax.jit(rengine.build_prefill(rcfg), static_argnums=2),
    }
    return arch, rcfg, params, model, fns


def _tokens(vocab, b, s, seed=3):
    toks = SyntheticTokenStream(vocab, b, s, seed=seed, device="cpu")(0)
    return {k: jnp.asarray(v.numpy()) for k, v in toks.items()}, toks


def _np(x):
    return np.asarray(x, dtype=np.float32)


def test_forward_logits_and_aux_match_jax(pair):
    arch, rcfg, params, model, fns = pair
    jt, tt = _tokens(rcfg.vocab, B, S)
    want, want_aux = fns["forward"](params, jt["tokens"])
    got, aux = model(tt["tokens"])
    assert got.shape == (B, S, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert (float(aux) > 0) == rcfg.moe


def test_loss_and_gradients_match_jax(pair):
    """The loss with the MTP term and router_aux_coef x aux, its metrics,
    and every gradient (through the kernel's autograd Function, the MoE
    dispatch's gathers and scatters, the MTP block) within the training
    bounds of tests/torch_train_util.py."""
    arch, rcfg, params, model, fns = pair
    jt, tt = _tokens(rcfg.vocab, B, S, seed=4)
    (want, want_m), want_grads = fns["loss"](params, jt)
    loss, metrics = transformer.loss_fn(model, tt)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]), **TOL)
    got, grads = port_value_and_grad(model, transformer.loss_fn, tt)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)
    if rcfg.mtp:  # the MTP block takes a gradient
        assert float(grads["mtp"]["proj"].abs().max()) > 0


def test_decode_steps_match_jax(pair):
    """Teacher-forced decode from an empty cache, step by step: logits at
    every step and the cache at the end. starcoder2's smoke window is 16,
    so from step 16 on the ring overwrites its oldest slots."""
    arch, rcfg, params, model, fns = pair
    jt, tt = _tokens(rcfg.vocab, B, S, seed=5)
    jcache = rtransformer.init_cache(rcfg, B, S)
    cache = model.init_cache(B, S)
    for t in range(S):
        want, jcache = fns["decode"](params, jt["tokens"][:, t], jcache)
        got, cache = model.decode_step(tt["tokens"][:, t], cache)
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=f"step {t}", **TOL)
    assert cache["pos"] == int(jcache["pos"]) == S
    assert set(cache["layers"]) == set(jcache["layers"])
    for name, got in cache["layers"].items():
        assert got.shape == jcache["layers"][name].shape
        np.testing.assert_allclose(got.numpy(), _np(jcache["layers"][name]), **TOL)
    if rcfg.window:
        assert cache["layers"]["k"].shape[3] == rcfg.window < S


def test_prefill_matches_jax_teacher_forced_fill(pair):
    """One forward that writes the cache (MoE dropless) gives the JAX scan's
    cache and last logits; starcoder2's 20-token prompt is longer than its
    window, so the ring holds the last 16 positions at slot p % 16."""
    arch, rcfg, params, model, fns = pair
    jt, tt = _tokens(rcfg.vocab, B + 1, PROMPT, seed=6)
    jcache, jlogits = fns["prefill"](params, jt["tokens"], MAX_SEQ)
    cache, logits = engine.build_prefill(model)(tt["tokens"], MAX_SEQ)
    assert cache["pos"] == int(jcache["pos"]) == PROMPT
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    for name, got in cache["layers"].items():
        np.testing.assert_allclose(got.numpy(), _np(jcache["layers"][name]), **TOL)


def test_greedy_tokens_match_jax(pair):
    """The reference's `greedy_generate` (its prefill and decode jitted):
    the same tokens."""
    arch, rcfg, params, model, fns = pair
    jt, tt = _tokens(rcfg.vocab, B, PROMPT - 8, seed=7)
    new = MAX_SEQ - (PROMPT - 8)
    jcache, jlogits = fns["prefill"](params, jt["tokens"], MAX_SEQ)
    tok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    want = [tok]
    for _ in range(new - 1):
        logits, jcache = fns["decode"](params, tok, jcache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(tok)
    got = engine.greedy_generate(model, tt["tokens"], new, MAX_SEQ)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_param_paths_are_the_reference_tree(pair):
    """Every leaf of `transformer.init`'s tree has a parameter at its path
    (recorded, not parsed from the name), and the port's tree nests back to
    it: the names with "_" inside keys (moe_layers, w_gate, q_a_norm,
    norm_h) stay whole."""
    arch, rcfg, params, model, fns = pair
    want = {jax.tree_util.keystr(p): np.shape(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    paths = model.param_paths()
    got = {"".join(f"[{k!r}]" for k in path): tuple(model.params[name].shape)
           for name, path in paths.items()}
    assert got == want
    assert all(name == "_".join(path) for name, path in paths.items())


def test_load_jax_state_carries_the_reference_state(pair):
    """`train.step.load_jax_state` carries the reference's train state
    (its `init_state`, the perturbed parameters in it) into the port's, leaf
    for leaf: every new tree (MLA, MoE with its f32 router, MTP, LayerNorm
    biases) finds its place."""
    arch, rcfg, params, model, fns = pair
    rstate, _ = rstep_mod.init_state(jax.random.key(0), rcfg, rstep_mod.TrainConfig(),
                                     model_init=lambda key, cfg: (params, None))
    rstate = np_tree(rstate)
    like = init_state(model, TrainConfig())
    state = load_jax_state(rstate, like=like)
    assert_trees_close(state, rstate, atol=0)
    assert state["params"]["embed"].dtype == torch.float32
    if rcfg.moe:
        assert state["params"]["moe_layers"]["mlp"]["router"].dtype == torch.float32
