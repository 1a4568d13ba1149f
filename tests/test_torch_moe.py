"""The port's MoE dispatch and blocks against the JAX package, on the CPU
(models/transformer.py: `moe_dispatch`, and `_moe_block` with its global
and per-group dispatch). Both packages get the same router logits as numpy
arrays (the tokens themselves, routed through an identity router, whose
f32 product changes no bit), so the top-k, the stable sort by expert, the
capacity, the slots, the tokens and the keep mask are compared bit for bit:
with drops at capacity_factor 1.0, at the default 1.25, and dropless. The
gates are within 2 ulps: torch's f32 exp and XLA's differ by an ulp in
about one value of ten, so the softmax cannot agree to the bit. The blocks
(expert SwiGLUs, the segment sum and the shared experts) and their
gradients are held within the f32 tolerances of the model tests, and the
reference's conservation property (tests/test_arch_smoke.py) holds for the
port's dispatch.

Routing ties (the k-th and (k+1)-th probabilities within 1e-6 of each
other) could make two orders of the same f32 sums pick other experts. The
inputs here are drawn from a seed and checked to hold no such tie, and
each test says so (`_no_near_ties`)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from torch_train_util import few_torch_threads  # noqa: E402,F401

# block outputs: f32 products and sums in another order
TOL = dict(rtol=1e-5, atol=1e-5)
# the renormalised gates: two f32 ulps (the softmax's exp differs by one)
GATE_RTOL = 2.0 ** -22
# the k-th and (k+1)-th probabilities of a token closer than this: a tie
NEAR_TIE = 1e-6

# the reference's functions, each compiled once per config
_r_dispatch = jax.jit(rtransformer.moe_dispatch, static_argnums=(2, 3))
_r_block = jax.jit(rtransformer._moe_block, static_argnums=(1, 3))
_r_grouped = jax.jit(rtransformer._moe_block_grouped, static_argnums=1)


def _cfgs(arch="deepseek-v2-lite-16b", **kw):
    return (dataclasses.replace(rconfigs.get_arch(arch).smoke(), **kw),
            dataclasses.replace(configs.get_arch(arch).smoke(), **kw))


def _logits(t, e, seed):
    return (np.random.default_rng(seed).standard_normal((t, e)) * 2).astype(np.float32)


def _no_near_ties(logits, k):
    """The inputs hold no routing tie: a tie would make the reference's own
    indices the ones to compare against; these seeds have none."""
    p = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1)), axis=-1)[:, ::-1]
    return bool((p[:, k - 1] - p[:, k] > NEAR_TIE).all())


def _dispatch_both(rcfg, cfg, logits, dropless):
    eye = np.eye(logits.shape[1], dtype=np.float32)
    want = _r_dispatch(jnp.asarray(logits), jnp.asarray(eye), rcfg, dropless)
    got = transformer.moe_dispatch(torch.from_numpy(logits), torch.from_numpy(eye),
                                   cfg, dropless=dropless)
    return got, want


@pytest.mark.parametrize("t,capacity_factor,dropless", [
    (64, 1.0, False),     # drops: each expert keeps ceil(T k / E) entries
    (96, 1.25, False),    # the default factor
    (50, 1.0, True),      # dropless: capacity T
    (7, 1.0, False),      # fewer tokens than experts
])
def test_moe_dispatch_matches_the_reference_bit_for_bit(t, capacity_factor, dropless):
    rcfg, cfg = _cfgs(capacity_factor=capacity_factor)
    logits = _logits(t, cfg.n_routed, seed=t)
    assert _no_near_ties(logits, cfg.top_k)
    got, want = _dispatch_both(rcfg, cfg, logits, dropless)
    slot, token_of, keep, gate, aux, cap = got
    assert cap == want[5] == (t if dropless else int(np.ceil(t * cfg.top_k / cfg.n_routed
                                                             * capacity_factor)))
    for name, a, b in (("slot", slot, want[0]), ("token_of", token_of, want[1]),
                       ("keep", keep, want[2])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_allclose(gate.numpy(), np.asarray(want[3]), rtol=GATE_RTOL, atol=0)
    np.testing.assert_allclose(float(aux), float(want[4]), rtol=1e-6)
    if not dropless and t > cfg.n_routed:
        assert not bool(keep.all())     # some expert overflowed: drops happened
        assert bool((slot[~keep] == cfg.n_routed * cap).all())   # the trash slot
    if dropless:
        assert bool(keep.all())


def test_moe_dispatch_conservation():
    """The reference's property (tests/test_arch_smoke.py) for the port:
    every kept entry lands in its own slot, and each token's gates sum to 1."""
    cfg = configs.get_arch("deepseek-v2-lite-16b").smoke()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, cfg.d_model), generator=g)
    router = torch.randn((cfg.d_model, cfg.n_routed), generator=g)
    slot, token_of, keep, gate, aux, capacity = transformer.moe_dispatch(x, router, cfg)
    assert slot.shape == (64 * cfg.top_k,)
    s = slot[keep].numpy()
    assert len(np.unique(s)) == len(s), "slot collision"
    assert bool((slot[keep] < cfg.n_routed * capacity).all())
    per_token = torch.zeros(64).index_add(0, token_of, gate)
    np.testing.assert_allclose(per_token.numpy(), 1.0, rtol=1e-4)


def _block_params(cfg, seed):
    """One MoE layer's mlp parameters in the reference's tree and shapes
    (router, experts, shared experts), drawn with numpy at the reference's
    init scales, and the same arrays by the port's names."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_routed

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    mlp = {"router": w(d, e), "w_gate": w(e, d, f), "w_up": w(e, d, f),
           "w_down": w(e, f, d)}
    if cfg.n_shared:
        fs = cfg.n_shared * f
        mlp["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs), "w_down": w(fs, d)}
    flat = {"mlp_" + k: torch.from_numpy(v) for k, v in mlp.items() if k != "shared"}
    flat.update({"mlp_shared_" + k: torch.from_numpy(v)
                 for k, v in mlp.get("shared", {}).items()})
    return mlp, flat


@pytest.mark.parametrize("arch,capacity_factor,dropless", [
    ("deepseek-v2-lite-16b", 1.0, False),
    ("deepseek-v2-lite-16b", 1.0, True),
    ("deepseek-v3-671b", 1.25, False),
])
def test_moe_block_matches_the_reference(arch, capacity_factor, dropless):
    """The global block: dispatch, expert SwiGLUs, the gate-weighted segment
    sum and the shared experts. Dropless, the port sizes its buffers by the
    largest expert's load, not T: the same values."""
    rcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    mlp, flat = _block_params(cfg, seed=2)
    x = (np.random.default_rng(3).standard_normal((80, cfg.d_model)) * 0.5
         ).astype(np.float32)
    assert _no_near_ties(x @ mlp["router"], cfg.top_k)
    want, want_aux = _r_block(mlp, rcfg, jnp.asarray(x), dropless)
    model = Transformer(cfg, device="cpu")
    got, aux = model._moe_block(flat, torch.from_numpy(x), dropless=dropless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_grouped_moe_block_matches_the_reference():
    """moe_groups = 4: dispatch within each group of T / 4 tokens (the
    reference's `_moe_block_grouped`), the aux loss the groups' mean; a T
    that 4 does not divide takes the global block in both packages, and so
    does a dropless call."""
    rcfg, cfg = _cfgs(moe_groups=4, capacity_factor=1.0)
    mlp, flat = _block_params(cfg, seed=4)
    model = Transformer(cfg, device="cpu")
    for t, dropless in ((96, False), (90, False), (96, True)):
        x = (np.random.default_rng(t).standard_normal((t, cfg.d_model)) * 0.5
             ).astype(np.float32)
        assert _no_near_ties(x @ mlp["router"], cfg.top_k)
        want, want_aux = _r_block(mlp, rcfg, jnp.asarray(x), dropless)
        got, aux = model._moe_block(flat, torch.from_numpy(x), dropless=dropless)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    # the grouped path itself (T = 96, a multiple of 4), against the reference's
    x = (np.random.default_rng(5).standard_normal((96, cfg.d_model)) * 0.5).astype(np.float32)
    want, want_aux = _r_grouped(mlp, rcfg, jnp.asarray(x))
    got, aux = model._moe_block(flat, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_moe_block_gradients_match_the_reference():
    """Gradients through the dispatch's gathers and scatters by index, with
    drops: the tokens', the router's and each expert weight's."""
    rcfg, cfg = _cfgs(capacity_factor=1.0)
    mlp, flat = _block_params(cfg, seed=6)
    x = (np.random.default_rng(7).standard_normal((64, cfg.d_model)) * 0.5).astype(np.float32)
    assert _no_near_ties(x @ mlp["router"], cfg.top_k)
    w = np.random.default_rng(8).standard_normal((64, cfg.d_model)).astype(np.float32)

    def r_loss(m, xx):
        y, aux = rtransformer._moe_block(m, rcfg, xx)
        return jnp.sum(y * w) + aux
    want_gm, want_gx = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(mlp, jnp.asarray(x))
    model = Transformer(cfg, device="cpu")
    xs = torch.from_numpy(x).requires_grad_(True)
    ps = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    y, aux = model._moe_block(ps, xs)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(want_gx), rtol=1e-4, atol=1e-5)
    for k, v in want_gm.items():
        if k == "shared":
            continue
        got = ps["mlp_" + k].grad.numpy()
        tol = 1e-5 + 1e-4 * float(np.abs(np.asarray(v)).max())
        np.testing.assert_allclose(got, np.asarray(v), rtol=0, atol=tol, err_msg=k)
