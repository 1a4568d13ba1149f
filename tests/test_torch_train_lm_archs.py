"""The train step of the four other LM architectures against the JAX
package's, on the CPU, at their smoke configs in f32: qwen3-8b (qk-norm),
starcoder2-15b (LayerNorm, the GELU MLP, the sliding window in training),
deepseek-v2-lite-16b (MLA, capacity-bound MoE with shared experts and its
aux term) and deepseek-v3-671b (MLA with q-LoRA, MoE, MTP, and the bf16
AdamW moments its cell keeps, `launch/cells.py`'s LM_STATE_DTYPE). Three
steps of `train/step.py`'s `build_train_step` (2 microbatches, full remat,
AdamW, the warmup-cosine schedule) from the reference's state carried
across with `load_jax_state`, against the reference's jitted step: losses,
parameters and first moments within the training tolerances of
tests/torch_train_util.py. And `launch/train.py --arch` for an MoE arch.

Routing ties (the k-th and (k+1)-th router probabilities within NEAR_TIE)
could send a token to other experts in the two packages; every router call
of the port's steps is recorded and each test says that none held one
(hazard (ii): no seed is picked to avoid one)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.tokens import SyntheticTokenStream as RTokenStream  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.train import step as rstep_mod  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.tokens import SyntheticTokenStream  # noqa: E402
from repro_torch.launch import cells, train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import TrainConfig, build_train_step, init_state  # noqa: E402
from torch_train_util import (  # noqa: E402,F401
    LOSS_RTOL, PARAM_ATOL, assert_trees_close, few_torch_threads, np_tree, run_both)

ARCHS = ("qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b", "deepseek-v3-671b")
B, S, STEPS = 4, 24, 3      # starcoder2's smoke window is 16: S crosses it
OPT = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
# the k-th and (k+1)-th router probabilities of a token closer than this: a tie
NEAR_TIE = 1e-6
# bf16 moments: the two packages round the same f32 update to bf16, but a
# value within f32 noise of a rounding boundary may round one bf16 ulp
# (2^-8 relative) apart; mu within BF16_MU_RTOL of its leaf's largest |mu|
BF16_MU_RTOL = 2.0 ** -7


def _batches(vocab, steps):
    theirs = RTokenStream(vocab, B, S, seed=0)
    mine = SyntheticTokenStream(vocab, B, S, seed=0, device="cpu")
    return [(theirs(i), mine(i)) for i in range(steps)]


def _routing_gaps(monkeypatch):
    """Record, for every router call of the port, the smallest gap between
    a token's k-th and (k+1)-th probability."""
    gaps = []
    dispatch = transformer.moe_dispatch

    def recording(x2d, router, cfg, dropless=False):
        with torch.no_grad():
            p = torch.softmax((x2d.float() @ router.float()), dim=-1)
            top = torch.topk(p, cfg.top_k + 1, dim=-1).values
            gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return dispatch(x2d, router, cfg, dropless=dropless)

    monkeypatch.setattr(transformer, "moe_dispatch", recording)
    return gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_reference(arch, monkeypatch):
    rcfg, cfg = rconfigs.get_arch(arch).smoke(), configs.get_arch(arch).smoke()
    state_dtype = cells.LM_STATE_DTYPE.get(arch, "float32")
    kw = dict(warmup_steps=2, total_steps=10, microbatches=2, remat=True)
    rtc = rstep_mod.TrainConfig(
        optimizer=RAdamWConfig(state_dtype=state_dtype, **OPT), **kw)
    tc = TrainConfig(optimizer=AdamWConfig(state_dtype=state_dtype, **OPT), **kw)
    rstate, _ = rstep_mod.init_state(jax.random.key(0), rcfg, rtc)
    model = Transformer(cfg, device="cpu").load_jax_params(np_tree(rstate["params"]))
    gaps = _routing_gaps(monkeypatch)
    rl, pl, rstate, state = run_both(jax.jit(rstep_mod.build_train_step(rcfg, rtc)),
                                     rstate, build_train_step(model, tc),
                                     init_state(model, tc), _batches(cfg.vocab, STEPS))
    # every MoE layer routes in each microbatch's forward and again in its
    # recomputation under remat
    assert bool(gaps) == cfg.moe
    assert min(gaps, default=1.0) > NEAR_TIE, "a routing tie: hazard (ii)"
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    assert_trees_close(state["params"], rstate["params"])
    mu, rmu = state["opt"]["mu"], rstate["opt"]["mu"]
    if state_dtype == "float32":
        assert_trees_close(mu, rmu)
        return
    for a, b in zip(jax.tree.leaves(mu), jax.tree.leaves(rmu)):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=BF16_MU_RTOL * float(np.abs(b).max(initial=0.0)))


def test_donated_step_equals_the_plain_one():
    """build_train_step(donate=True) overwrites the state it is given (the
    reference's train cells donate theirs) and returns it, with the values
    of the step that leaves its inputs as they are: deepseek-v3's smoke
    config, bf16 moments, 2 microbatches, two steps."""
    cfg = configs.get_arch("deepseek-v3-671b").smoke()
    tc = TrainConfig(optimizer=AdamWConfig(state_dtype="bfloat16", **OPT),
                     warmup_steps=2, total_steps=10, microbatches=2, remat=True)
    model = Transformer(cfg, device="cpu", seed=1)
    batches = [b for _, b in _batches(cfg.vocab, 2)]
    plain, donated = init_state(model, tc), init_state(model, tc)
    donated = jax.tree.map(torch.clone, donated)
    given = jax.tree.leaves(donated["params"]) + jax.tree.leaves(donated["opt"]["mu"])
    step, dstep = build_train_step(model, tc), build_train_step(model, tc, donate=True)
    for b in batches:
        plain, m = step(plain, b)
        donated, dm = dstep(donated, b)
        assert float(m["loss"]) == float(dm["loss"])
    got = jax.tree.leaves(donated["params"]) + jax.tree.leaves(donated["opt"]["mu"])
    assert all(a is b for a, b in zip(got, given))
    for a, b in zip(jax.tree.leaves(donated), jax.tree.leaves(plain)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_cli_runs_an_moe_arch():
    """`python -m repro_torch.launch.train --arch deepseek-v2-lite-16b
    --device cpu`: the smoke config's steps, finite losses."""
    out = train_cli.main(["--arch", "deepseek-v2-lite-16b", "--steps", "2",
                          "--device", "cpu", "--log-every", "0"])
    assert out.steps_run == 2
    assert all(np.isfinite(x) for x in out.losses)
