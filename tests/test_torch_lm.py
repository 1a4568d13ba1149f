"""The port's LM slice against the JAX package, on the CPU: the attention
plain versions against the JAX oracles and the interpret-mode Pallas kernel
(also at MLA's head dims, where v's differs from q's and k's), the norms
and RoPE, the qwen2 smoke model's forward, decode steps, prefill (cache and
last logits) and greedy tokens with the JAX weights carried across, the
token stream and the configs of the five LM archs. Inputs are made with
numpy from a seed and handed to both packages (the other four archs' models:
tests/test_torch_lm_archs.py)."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_train_util import few_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.tokens import SyntheticTokenStream as RTokenStream  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_attention  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro.serve import engine as rengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import LMConfig  # noqa: E402
from repro_torch.data.tokens import SyntheticTokenStream  # noqa: E402
from repro_torch.kernels import ops, ref, registry  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

# model outputs: f32 matmuls and reductions in another order
TOL = dict(rtol=1e-4, atol=1e-4)
# attention on the same f32 inputs: sums of S terms in another order; the
# kernel scales q before the product, the oracles scale the logits after
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 outputs of f32 arithmetic rounded once (the blockwise oracle also
# rounds p to bf16): two bf16 ulps of values below 1
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)

# the six cases of the JAX package's flash_attention test
ATTN_CASES = [
    (1, 4, 4, 256, 128, True, None),    # MHA causal
    (2, 8, 2, 256, 128, True, None),    # GQA
    (1, 4, 1, 384, 128, False, None),   # MQA bidirectional
    (1, 2, 2, 512, 128, True, 128),     # sliding window
    (1, 2, 2, 256, 256, True, None),    # wide head dim
    (3, 6, 3, 128, 128, True, 64),      # GQA + window, odd batch
]

# the reference's model functions, each compiled once per config
_r_init = jax.jit(lambda key, cfg: rtransformer.init(key, cfg)[0], static_argnums=1)
_r_forward = jax.jit(lambda p, cfg, t: rtransformer.forward(p, cfg, t)[0],
                     static_argnums=1)
_r_decode = jax.jit(rtransformer.decode_step, static_argnums=1)
# the JAX oracles at MLA's head dims, compiled once per shape
_r_attention_ref = jax.jit(rref.attention_ref, static_argnames=("causal", "window"))
_r_attention_blockwise = jax.jit(rref.attention_blockwise,
                                 static_argnames=("causal", "window", "block_k"))


def _qkv(b, hq, hkv, s, d, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _both(arrays, dtype="f32"):
    """The same values as jnp and torch arrays; bf16 rounds alike in both."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", ATTN_CASES)
def test_attention_plain_matches_jax_oracles(b, hq, hkv, s, d, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, hq, hkv, s, d, seed=hq * s))
    want = _np(rref.attention_ref(jq, jk, jv, causal=causal, window=window))
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, hq, s, d)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    blockwise = ref.attention_blockwise(tq, tk, tv, causal=causal, window=window,
                                        block_k=96)
    np.testing.assert_allclose(blockwise.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("s,window,dtype,block_k", [
    # the oracles' default block, past the plain path's cutoff
    pytest.param(2304, None, "f32", 1024, id="2304-None-f32"),
    pytest.param(2304, 300, "f32", 1024, id="2304-300-f32"),
    pytest.param(1100, None, "bf16", 1024, id="1100-None-bf16"),
] + [
    # the bf16 kernel's kv tiles (ops.ATTENTION_KV_TILE), whose numerics are
    # the blockwise oracle's at that block size
    (s, window, dtype, block_k) for block_k in (64, 128)
    for s, window, dtype in ((1100, None, "f32"), (1100, 300, "bf16"),
                             (777, None, "bf16"))
])
def test_attention_blockwise_matches_jax_blockwise(s, window, dtype, block_k):
    """Past ATTENTION_BLOCKWISE_CUTOFF the CPU path is the blockwise plain
    version; at bf16 both oracles round p to bf16 before the second product.
    At the kernel's kv tiles the two oracles agree block for block."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 1, s, 64, seed=s), dtype)
    want = _np(rref.attention_blockwise(jq, jk, jv, causal=True, window=window,
                                        block_k=block_k))
    got = ref.attention_blockwise(tq, tk, tv, causal=True, window=window,
                                  block_k=block_k)
    tol = ATTN_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    if s > ref.ATTENTION_BLOCKWISE_CUTOFF:
        torch.testing.assert_close(
            ops.attention(tq, tk, tv, causal=True, window=window), got,
            rtol=0, atol=0)


def _two_bf16_ulps(want):
    w = want.float().abs().clamp_min(2.0 ** -126)
    return 2 * torch.exp2(torch.floor(torch.log2(w)) - 7)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 4, 2, 600, 64, True, None),     # GQA causal
    (1, 4, 1, 700, 128, False, 100),    # MQA, window only
    (2, 6, 3, 300, 64, True, 50),       # GQA causal + window
    (1, 2, 2, 1100, 256, True, None),   # wide head dim
])
def test_bf16_blockwise_within_bound_of_f32_rounded_once(b, hq, hkv, s, d,
                                                         causal, window):
    """The bf16 kernel's contract (ii) as it applies to the blockwise oracle:
    elementwise within 2 bf16 ulps + (2^-8 + 2^-16) A of f32 arithmetic
    rounded once, A = the softmax weights' sum with |v| (attention of |v| in
    f32). Rounding p to bf16 moves each p by at most 2^-8 of itself (the
    unit roundoff of bf16's 8 significant bits) while l sums the unrounded
    p; 2^-16 covers f32 sums in another order. Held here by the blockwise
    oracle at the kernel's smallest kv tile and at the oracle's default
    block; the p rounding shows: 2 ulps alone fail."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(b, hq, hkv, s, d, seed=s + d))
    want = ref.attention_ref(q, k, v, causal=causal, window=window).float()
    weights = ref.attention_ref(q.float(), k.float(), v.float().abs(),
                                causal=causal, window=window)
    floor = (2.0 ** -8 + 2.0 ** -16) * weights
    for block_k in (64, 1024):
        got = ref.attention_blockwise(q, k, v, causal=causal, window=window,
                                      block_k=block_k).float()
        err = (got - want).abs()
        assert bool((err <= _two_bf16_ulps(want) + floor).all()), block_k
        assert bool((err > _two_bf16_ulps(want)).any()), block_k


def test_attention_routing_by_dtype_and_head_dim():
    """The pure-Python half of the CUDA wrapper: bf16 takes the tensor-core
    kernel, f32 the CUDA-core kernel, at each (Dqk, Dv) pair, MLA's
    (192, 128) among them; the kv tile per pair; the checks of the TMA maps'
    alignment raise, naming the pair."""
    assert ops.ATTENTION_HEAD_DIM_PAIRS == ((64, 64), (128, 128), (256, 256), (192, 128))
    for d, dv in ops.ATTENTION_HEAD_DIM_PAIRS:
        assert ops.attention_variant(torch.bfloat16, d, dv) == "bf16_tc"
        assert ops.attention_variant(torch.float32, d, dv) == "f32"
    for d in ops.ATTENTION_HEAD_DIMS:   # dv defaults to d
        assert ops.attention_variant(torch.bfloat16, d) == "bf16_tc"
    assert ops.ATTENTION_KV_TILE == {(64, 64): 128, (128, 128): 128,
                                     (256, 256): 64, (192, 128): 128}
    # the wrapper passes the kv tile to the kernel, which is built for these
    # (Dqk, Dv, kv tile) triples alone and refuses any other; the f32 kernel
    # is built for the same pairs
    csrc = Path(ops.__file__).parent / "csrc"
    built = re.findall(r"if \(d == (\d+) && dv == (\d+) && kv_tile == (\d+)\)",
                       (csrc / "flash_attention_sm90.cu").read_text())
    assert {(int(d), int(dv)): int(t) for d, dv, t in built} == ops.ATTENTION_KV_TILE
    built = re.findall(r"if \(d == (\d+) && dv == (\d+)\)",
                       (csrc / "flash_attention.cu").read_text())
    assert tuple((int(d), int(dv)) for d, dv in built) == ops.ATTENTION_HEAD_DIM_PAIRS
    for dtype, d, dv in ((torch.bfloat16, 96, 96), (torch.float16, 128, 128),
                         (torch.float64, 64, 64), (torch.bfloat16, 192, 192),
                         (torch.float32, 128, 192), (torch.bfloat16, 24, 16)):
        with pytest.raises(ValueError):
            ops.attention_variant(dtype, d, dv)
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        ops.tma_strides("v", torch.zeros((2, 3, 8, 65), dtype=torch.bfloat16)[..., :64],
                        (192, 128))
    # where TMA cannot read a view in place, the wrapper passes a copy
    odd = torch.zeros((2, 3, 8, 65), dtype=torch.bfloat16)[..., :64]
    t, st = ops.tma_operand("v", odd, (64, 64))
    assert t.is_contiguous() and st == t.stride()[:3]
    # MLA's v: a slice of the kv projection [B, S, H, dn + dv], read in place
    kv = torch.zeros((2, 8, 4, 128 + 128), dtype=torch.bfloat16).transpose(1, 2)
    v = kv[..., 128:]
    t, st = ops.tma_operand("v", v, (192, 128))
    assert t.data_ptr() == v.data_ptr() and st == (8 * 4 * 256, 256, 4 * 256)
    assert registry.VARIANTS["flash_attention"] == ("bf16_tc", "f32")

    # contiguous, a transposed [B, S, H, D] view (the model's v) and a
    # length-1 axis with a stride TMA never steps: accepted as they are
    t = torch.zeros((2, 3, 70, 128), dtype=torch.bfloat16)
    assert ops.tma_strides("q", t) == t.stride()[:3]
    v = torch.zeros((2, 70, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert ops.tma_strides("v", v) == (70 * 4 * 64, 64, 4 * 64)
    one = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)[:, :, ::2]
    assert ops.tma_strides("k", one) == (2 * 4 * 64, 8 * 64, 2 * 64)
    # a base off the 16-byte grid, and a position stride of 65 elements
    flat = torch.zeros(2 * 3 * 8 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ops.tma_strides("q", flat[1:].view(2, 3, 8, 64))
    wide = torch.zeros((2, 3, 8, 65), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="stride"):
        ops.tma_strides("k", wide)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 2, 1, 256, 128, True, None), (1, 2, 2, 256, 128, False, 100),
])
def test_attention_plain_matches_pallas_interpret(b, hq, hkv, s, d, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, hq, hkv, s, d, seed=s + hq))
    want = _np(pallas_attention(jq, jk, jv, causal=causal, window=window,
                                interpret=True))
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("s", [1, 77, 1000])
def test_attention_odd_lengths_and_bf16(s):
    """Any S (no S % 128 gate), D = 64, and bf16 outputs in bf16."""
    arrays = _qkv(2, 4, 2, s, 64, seed=s)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays)
    want = _np(rref.attention_ref(jq, jk, jv, causal=True))
    np.testing.assert_allclose(ops.attention(tq, tk, tv).numpy(), want, **ATTN_TOL)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bf16")
    got = ops.attention(tq, tk, tv, causal=False, window=5)
    assert got.dtype == torch.bfloat16
    want = _np(rref.attention_ref(jq, jk, jv, causal=False, window=5))
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_attention_rejects_bad_inputs():
    q, k = torch.ones((1, 4, 8, 64)), torch.ones((1, 3, 8, 64))
    with pytest.raises(ValueError):
        ops.attention(q, k, k)                      # 4 heads over 3 kv heads
    with pytest.raises(ValueError):
        ops.attention(q, q.double(), q.double())    # mixed dtypes
    with pytest.raises(ValueError):
        ops.attention(q, q, q, window=0)


@pytest.mark.parametrize("v_shape", [
    (2, 2, 8, 16),     # another batch
    (1, 1, 8, 16),     # another kv head count
    (1, 2, 9, 16),     # another length
    (1, 2, 8),         # not 4-D
])
def test_attention_rejects_a_v_that_does_not_fit(v_shape):
    """v may have its own head dim (MLA), but its (B, Hkv, S) must be k's."""
    q, k = torch.ones((1, 4, 8, 24)), torch.ones((1, 2, 8, 24))
    assert ops.attention(q, k, torch.ones((1, 2, 8, 16))).shape == (1, 4, 8, 16)
    with pytest.raises(ValueError):
        ops.attention(q, k, torch.ones(v_shape))


@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal,window", [
    (1, 4, 4, 40, 24, 16, True, None),      # the MLA smoke configs' pair
    (2, 4, 2, 33, 24, 16, False, 9),
    (1, 2, 2, 300, 192, 128, True, None),   # full width: the kernel's pair
    (1, 2, 1, 130, 192, 128, True, 50),
])
def test_attention_plain_at_mla_head_dims_matches_jax_oracles(
        b, hq, hkv, s, d, dv, causal, window):
    """q, k [.., Dqk] and v [.., Dv]: the output is [.., Dv] and the logits
    are scaled by 1 / sqrt(Dqk), as the JAX oracles (to which the JAX
    package sends MLA) compute it; the blockwise version at the kernel's kv
    tile and its default block agree, in f32 and in bf16."""
    rng = np.random.default_rng(s + d)
    arrays = [(rng.standard_normal(shape) * 0.3).astype(np.float32)
              for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrays)
    want = _np(_r_attention_ref(jq, jk, jv, causal=causal, window=window))
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (b, hq, s, dv)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    np.testing.assert_allclose(
        _np(_r_attention_blockwise(jq, jk, jv, causal=causal, window=window,
                                   block_k=128)), want, **ATTN_TOL)
    for block_k in (128, 1024):
        blockwise = ref.attention_blockwise(tq, tk, tv, causal=causal,
                                            window=window, block_k=block_k)
        np.testing.assert_allclose(blockwise.numpy(), want, **ATTN_TOL)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bf16")
    want = _np(_r_attention_blockwise(jq, jk, jv, causal=causal, window=window,
                                      block_k=128))
    got = ref.attention_blockwise(tq, tk, tv, causal=causal, window=window, block_k=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_attention_backward_at_mla_head_dims_matches_jax_vjp():
    """The plain backward with v of its own head dim: dq, dk [.., Dqk] and
    dv [.., Dv] against `jax.vjp` of the reference oracle."""
    rng = np.random.default_rng(11)
    arrays = [(rng.standard_normal(shape) * 0.3).astype(np.float32)
              for shape in ((1, 4, 37, 24), (1, 2, 37, 24), (1, 2, 37, 16),
                            (1, 4, 37, 16))]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrays)
    _, vjp = jax.vjp(lambda q, k, v: _r_attention_ref(q, k, v, causal=True),
                     jq, jk, jv)
    for got, want in zip(ref.attention_backward(tq, tk, tv, tdo, causal=True), vjp(jdo)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- norms and RoPE
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_jax(dtype):
    """rms_norm casts back to x's dtype before the gain; layer_norm takes the
    biased variance; both in f32 inside."""
    rng = np.random.default_rng(1)
    x, g, b = (rng.standard_normal(s).astype(np.float32) * 2
               for s in ((3, 5, 48), (48,), (48,)))
    (jx, jg, jb), (tx, tg, tb) = _both([x, g, b], dtype)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "f32" else BF16_TOL
    got = common.rms_norm(tx, tg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(rcommon.rms_norm(jx, jg)), **tol)
    got = common.layer_norm(tx, tg, tb)
    np.testing.assert_allclose(got.float().numpy(),
                               _np(rcommon.layer_norm(jx, jg, jb)), **tol)
    np.testing.assert_allclose(common.gelu(tx).float().numpy(),
                               _np(rcommon.gelu(jx)), **tol)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    """Interleaved pairs (x[0::2], x[1::2]), per-batch positions."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 1, 40)).astype(np.int32)
    want = rcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        common.rope_freqs(16, theta).numpy(), _np(rcommon.rope_freqs(16, theta)),
        rtol=1e-6)


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def smoke_pair():
    """The qwen2 smoke model of both packages, with the JAX weights (made
    non-trivial: random biases and gains) carried into the port."""
    cfg = rconfigs.get_arch("qwen2-1.5b").smoke()
    params = jax.tree.map(np.asarray, _r_init(jax.random.key(0), cfg))
    rng = np.random.default_rng(0)
    layers = params["dense_layers"]
    for name in ("bq", "bk", "bv"):
        layers["attn"][name] = rng.standard_normal(layers["attn"][name].shape
                                                   ).astype(np.float32) * 0.1
    for ln in ("ln1", "ln2"):
        layers[ln]["g"] = 1 + 0.1 * rng.standard_normal(layers[ln]["g"].shape
                                                         ).astype(np.float32)
    model = Transformer(configs.get_arch("qwen2-1.5b").smoke(), device="cpu")
    model.load_jax_params(params)
    return cfg, params, model


def _prompt(cfg, b, s, seed=3):
    toks = SyntheticTokenStream(cfg.vocab, b, s, seed=seed, device="cpu")(0)["tokens"]
    return jnp.asarray(toks.numpy()), toks


def test_transformer_forward_matches_jax(smoke_pair):
    cfg, params, model = smoke_pair
    jt, tt = _prompt(cfg, 2, 24)
    want = _np(_r_forward(params, cfg, jt))
    got, aux = model(tt)
    assert got.shape == (2, 24, cfg.vocab) and float(aux) == 0.0  # no MoE layer
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    h, _ = model.forward_hidden(tt)
    np.testing.assert_allclose(model.logits_from_hidden(h).numpy(), want, **TOL)


def test_transformer_decode_steps_match_jax(smoke_pair):
    cfg, params, model = smoke_pair
    jt, tt = _prompt(cfg, 2, 6)
    jcache = rtransformer.init_cache(cfg, 2, 10)
    cache = model.init_cache(2, 10)
    for t in range(6):
        want, jcache = _r_decode(params, cfg, jt[:, t], jcache)
        got, cache = model.decode_step(tt[:, t], cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert cache["pos"] == int(jcache["pos"]) == 6
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   _np(jcache["layers"][name]), **TOL)


def test_prefill_matches_jax_teacher_forced_fill(smoke_pair):
    """One forward that writes K/V gives the JAX scan's cache and logits."""
    cfg, params, model = smoke_pair
    jt, tt = _prompt(cfg, 3, 11)
    jcache, jlogits = rengine.build_prefill(cfg)(params, jt, 16)
    cache, logits = engine.build_prefill(model)(tt, 16)
    assert cache["pos"] == int(jcache["pos"]) == 11
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    for name in ("k", "v"):
        got = cache["layers"][name]
        assert got.shape == (cfg.n_layers, 3, cfg.n_kv_heads, 16, cfg.hd)
        np.testing.assert_allclose(got.numpy(), _np(jcache["layers"][name]), **TOL)
        assert not got[:, :, :, 11:].any()


def test_greedy_generate_matches_jax(smoke_pair):
    cfg, params, model = smoke_pair
    jt, tt = _prompt(cfg, 2, 8, seed=5)
    want = np.asarray(rengine.greedy_generate(params, cfg, jt, 6, 14))
    got = engine.greedy_generate(model, tt, 6, 14)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_jax_params_rejects_a_mismatched_tree(smoke_pair):
    cfg, params, model = smoke_pair
    before = model.params["embed"].clone()
    bad = dict(params, embed=params["embed"][:-1])
    with pytest.raises(ValueError):
        model.load_jax_params(bad)
    missing = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(ValueError):
        model.load_jax_params(missing)
    torch.testing.assert_close(model.params["embed"], before, rtol=0, atol=0)


@pytest.mark.parametrize("field", [
    dict(attention="linear"), dict(attention="mla"), dict(moe=True, mlp="gelu"),
    dict(mlp="relu"), dict(norm="batchnorm"), dict(dtype="float16"),
])
def test_unported_config_fields_raise(field):
    """Every field of the five archs runs (tests/test_torch_lm_archs.py);
    what neither package runs raises: an unknown attention, MLP, norm or
    dtype, MLA without its kv latent rank, and MoE with GELU experts (the
    JAX package's experts are SwiGLU only)."""
    cfg = dataclasses.replace(configs.get_arch("qwen2-1.5b").smoke(), **field)
    with pytest.raises(NotImplementedError):
        Transformer(cfg, device="cpu")


def test_window_runs_forward_but_not_the_decode_cache():
    """A window runs through the kernel in the forward, and the decode
    cache is a ring of min(max_seq, window) positions (it used to be
    refused): decoding past the window equals the windowed forward."""
    cfg = dataclasses.replace(configs.get_arch("qwen2-1.5b").smoke(), window=4)
    model = Transformer(cfg, device="cpu")
    toks = torch.arange(9, dtype=torch.int32)[None] * 7 % cfg.vocab
    logits, _ = model(toks)
    assert torch.isfinite(logits).all()
    assert model.init_cache(1, 16)["layers"]["k"].shape[3] == 4
    assert model.init_cache(1, 3)["layers"]["k"].shape[3] == 3
    cache = model.init_cache(1, 16)
    for t in range(9):
        got, cache = model.decode_step(toks[:, t], cache)
        np.testing.assert_allclose(got.numpy(), logits[:, t].numpy(), **TOL)


# ------------------------------------------------------------ data, configs
def test_token_stream_matches_the_reference():
    mine = SyntheticTokenStream(300, 3, 50, seed=7, device="cpu")
    theirs = RTokenStream(300, 3, 50, seed=7)
    for step in (0, 4):
        got, want = mine(step), theirs(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


LM_ARCHS = ("qwen2-1.5b", "qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b",
            "deepseek-v3-671b")
# the published sizes, counted as the reference's n_params counts them
N_PARAMS = {"qwen2-1.5b": 1_543_569_408, "qwen3-8b": 8_190_427_136,
            "starcoder2-15b": 15_955_132_416, "deepseek-v2-lite-16b": 15_706_357_760,
            "deepseek-v3-671b": 671_025_397_760}


def test_lm_config_matches_the_reference():
    """The five LM archs' configs, smoke configs and shapes field for field
    (every field of the reference's LMConfig, MLA, MoE and MTP included),
    with the same n_params."""
    assert set(LM_ARCHS) <= set(configs.ARCH_IDS)
    assert set(configs.ARCH_IDS) == set(rconfigs.ARCH_IDS)
    for arch in LM_ARCHS:
        mine, theirs = configs.get_arch(arch), rconfigs.get_arch(arch)
        for a, b in ((mine.CONFIG, theirs.CONFIG), (mine.smoke(), theirs.smoke())):
            assert type(a) is LMConfig
            assert vars(a) == vars(b)
            assert [f.name for f in dataclasses.fields(a)] == \
                [f.name for f in dataclasses.fields(b)]
            assert a.n_params() == b.n_params() and a.hd == b.hd
        assert mine.CONFIG.n_params() == N_PARAMS[arch]
        assert set(mine.SHAPES) == set(theirs.SHAPES)
        for name, s in mine.SHAPES.items():
            assert dataclasses.asdict(s) == dataclasses.asdict(theirs.SHAPES[name])
