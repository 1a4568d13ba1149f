"""The port's optimizer layer against the JAX package, on the CPU: the
schedules, AdamW (f32 and bf16 moments, with and without clipping, a
learning-rate scale below 1) and int8 gradient compression with error
feedback, on the same trees made with numpy from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import compression as rcompression  # noqa: E402
from repro.optim import schedules as rschedules  # noqa: E402
from repro_torch.optim import adamw, compression, schedules  # noqa: E402
from repro_torch.optim.tree import leaves, tree_map, unflatten  # noqa: E402
from torch_train_util import few_torch_threads  # noqa: E402,F401

# f32 arithmetic in the same order: XLA and PyTorch may differ by an ulp in
# pow, sqrt and cos
F32_TOL = dict(rtol=1e-6, atol=1e-7)
# a bf16 moment is the f32 value rounded once: an ulp where the two f32
# values straddle a rounding boundary
BF16_TOL = dict(rtol=2 ** -7, atol=1e-30)


def _tree(seed, scale=1.0):
    """A nested tree of f32 arrays whose keys are out of sorted order."""
    rng = np.random.default_rng(seed)
    a = lambda *s: np.asarray(rng.standard_normal(s) * scale, np.float32)  # noqa: E731
    return {"w": a(5, 3), "b": [a(4), {"z": a(2, 2), "a": a(3)}], "a": a()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree, dtype=torch.float32):
    return tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(dtype), tree)


def _close(got, want, tol):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)


def test_tree_order_is_jax_order():
    tree = _tree(0)
    want = jax.tree.leaves(tree)
    got = leaves(tree)
    assert all(a is b for a, b in zip(got, want)) and len(got) == len(want)
    back = unflatten(tree, [x * 2 for x in got])
    assert list(back) == list(tree)
    np.testing.assert_array_equal(back["b"][1]["a"], tree["b"][1]["a"] * 2)


@pytest.mark.parametrize("warm,total", [(10, 100), (0, 50), (7, 7)])
def test_warmup_cosine_matches_the_reference(warm, total):
    for step in sorted({0, 1, warm // 2, warm, (warm + total) // 2, total - 1,
                        total, total + 5}):
        want = rschedules.warmup_cosine(jnp.int32(step), warmup_steps=warm,
                                        total_steps=total)
        got = schedules.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                      warmup_steps=warm, total_steps=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **F32_TOL)
    assert float(schedules.constant(torch.tensor(3), 0.5)) == 0.5


@pytest.mark.parametrize("state_dtype,clip,lr_scale", [
    ("float32", 1.0, 1.0), ("float32", None, 0.37), ("bfloat16", 1.0, 0.5),
    ("bfloat16", None, 1.0), ("float32", 1e-3, 0.9)])
def test_adamw_update_matches_the_reference(state_dtype, clip, lr_scale):
    """Four updates on identical trees: params, moments, count and the
    gradient norm. The gradients are large enough that clip_norm bites."""
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip, state_dtype=state_dtype)
    rcfg, cfg = radamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    rp, p = _j(_tree(1)), _t(_tree(1))
    rs, s = radamw.init_state(rp, rcfg), adamw.init_state(p, cfg)
    assert s["count"].dtype == torch.int32
    upd = jax.jit(lambda g, s, p: radamw.update(g, s, p, rcfg, lr_scale=jnp.float32(lr_scale)))
    for step in range(4):
        g = _tree(10 + step, scale=3.0)
        rp, rs, rm = upd(_j(g), rs, rp)
        p, s, m = adamw.update(_t(g), s, p, cfg,
                               lr_scale=torch.tensor(lr_scale, dtype=torch.float32))
        _close(p, rp, F32_TOL)
        tol = BF16_TOL if state_dtype == "bfloat16" else F32_TOL
        _close(s["mu"], rs["mu"], tol)
        _close(s["nu"], rs["nu"], tol)
        assert int(s["count"]) == int(rs["count"]) == step + 1
        assert leaves(s["mu"])[0].dtype == adamw.STATE_DTYPES[state_dtype]
        if clip is not None:
            np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                                       **F32_TOL)


def test_adamw_keeps_bf16_params_bf16():
    cfg = adamw.AdamWConfig(state_dtype="bfloat16")
    p = _t(_tree(2), torch.bfloat16)
    new, s, _ = adamw.update(_t(_tree(3), torch.bfloat16), adamw.init_state(p, cfg), p, cfg)
    assert all(x.dtype == torch.bfloat16 for x in leaves(new) + leaves(s["mu"]))
    rcfg = radamw.AdamWConfig(state_dtype="bfloat16")
    rp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _tree(2))
    rg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _tree(3))
    rnew, _, _ = radamw.update(rg, radamw.init_state(rp, rcfg), rp, rcfg)
    _close(new, rnew, BF16_TOL)


def test_global_norm_and_clip_match_the_reference():
    tree = _tree(4, scale=2.0)
    np.testing.assert_allclose(float(adamw.global_norm(_t(tree))),
                               float(radamw.global_norm(_j(tree))), **F32_TOL)
    got, n = adamw.clip_by_global_norm(_t(tree), 0.5)
    want, rn = radamw.clip_by_global_norm(_j(tree), 0.5)
    _close(got, want, F32_TOL)
    np.testing.assert_allclose(float(n), float(rn), **F32_TOL)


def test_round_half_to_even_in_both():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


def test_quantize_int8_matches_the_reference_exactly():
    # values whose quotient by the scale lands exactly on .5: amax = 127 so
    # the scale is 1 and round() sees the halves themselves
    x = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 63.5, 0.0], np.float32)
    q, scale = compression.quantize_int8(torch.from_numpy(x))
    rq, rscale = rcompression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and float(scale) == float(rscale) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [127, -127, 0, 2, 2, 0, -4, 64, 0]
    x = np.random.default_rng(5).standard_normal(200).astype(np.float32) * 7
    q, scale = compression.quantize_int8(torch.from_numpy(x))
    rq, rscale = rcompression.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)


def test_compress_grads_error_feedback_matches_over_three_rounds():
    g0 = _tree(6)
    ref_ef, ef = rcompression.init_error_feedback(_j(g0)), compression.init_error_feedback(_t(g0))
    for r in range(3):
        g = _tree(20 + r, scale=0.1)
        rdeq, ref_ef = rcompression.compress_grads(_j(g), ref_ef)
        deq, ef = compression.compress_grads(_t(g), ef)
        # the int8 values are equal, so the round trip is the same product
        for a, b in zip(leaves(deq), jax.tree.leaves(rdeq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(ef), jax.tree.leaves(ref_ef)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert any(float(x.abs().max()) > 0 for x in leaves(ef))


@pytest.mark.parametrize("dtype,state_dtype", [(torch.float32, "float32"),
                                               (torch.bfloat16, "bfloat16")])
def test_update_in_place_and_in_pieces_equals_the_whole(monkeypatch, dtype, state_dtype):
    """`update` a piece of a leaf at a time (here 4 elements, so that every
    leaf of more spans several, the last one short) and in place (a donated
    state): the values of the update that leaves its inputs as they are,
    bit for bit, written into the given tensors; a non-contiguous leaf is
    updated whole."""
    cfg = adamw.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    p = _t(_tree(4), dtype)
    p["w"] = p["w"].t()   # non-contiguous
    g = _t(_tree(5, scale=3.0), dtype)
    g["w"] = g["w"].t()
    want_p, want_s, want_m = adamw.update(g, adamw.init_state(p, cfg), p, cfg)
    monkeypatch.setattr(adamw, "UPDATE_PIECE", 4)
    p2, s2 = tree_map(torch.clone, p), adamw.init_state(p, cfg)
    given = leaves(p2) + leaves(s2["mu"]) + leaves(s2["nu"])
    got_p, got_s, got_m = adamw.update(g, s2, p2, cfg, inplace=True)
    assert all(a is b for a, b in zip(leaves(got_p) + leaves(got_s["mu"])
                                      + leaves(got_s["nu"]), given))
    for a, b in zip(leaves(got_p) + leaves(got_s["mu"]) + leaves(got_s["nu"]),
                    leaves(want_p) + leaves(want_s["mu"]) + leaves(want_s["nu"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(got_m["grad_norm"]) == float(want_m["grad_norm"])
