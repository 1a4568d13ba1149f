"""The port's fault-tolerant trainer on the CPU: a simulated failure
restored from the last checkpoint gives the losses of an uninterrupted run,
a run resumes from a checkpoint with its data skipped ahead, a checkpoint
written by the JAX package's trainer resumes in the port's with the
reference's next losses, and `launch/train.py --device cpu` trains one arch
of each family in a process of its own."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.tokens import SyntheticTokenStream as RTokenStream  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.train import step as rstep_mod  # noqa: E402
from repro.train import trainer as rtrainer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data.tokens import SyntheticTokenStream  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.step import TrainConfig, build_train_step, init_state  # noqa: E402
from torch_train_util import LOSS_RTOL, few_torch_threads, np_tree  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
STEPS = 6


def _port(seed=0, dtype="float32"):
    cfg = dataclasses.replace(configs.get_arch("qwen2-1.5b").smoke(), dtype=dtype)
    tc = TrainConfig(optimizer=AdamWConfig(**OPT), warmup_steps=2, total_steps=STEPS)
    model = Transformer(cfg, device="cpu", seed=seed)
    stream = SyntheticTokenStream(cfg.vocab, 4, 16, seed=0, device="cpu")
    return init_state(model, tc), build_train_step(model, tc), stream


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_simulated_failure_restores_and_matches_an_uninterrupted_run(tmp_path, dtype):
    """bf16 parameters are checkpointed as f32 (numpy has no bf16), which
    holds them exactly, and restored in the state's dtypes."""
    state, step, stream = _port(dtype=dtype)
    clean = trainer.run(state, step, stream, num_steps=STEPS)
    fired = []

    def fail_at_3(s):
        if s == 3 and not fired:
            fired.append(s)
            raise trainer.SimulatedFailure("injected")

    rep = trainer.run(state, step, stream, num_steps=STEPS, ckpt_dir=str(tmp_path),
                      ckpt_interval=2, fail_hook=fail_at_3)
    assert fired == [3] and rep.restarts == 1 and rep.final_step == STEPS
    # steps 0-2, then the retry from the step-2 checkpoint: steps 2-5
    assert len(rep.losses) == STEPS + 1
    assert rep.losses[:3] + rep.losses[4:] == clean.losses[:2] + clean.losses[2:]
    assert rep.losses[3] == clean.losses[2]


def test_failures_past_the_limit_raise(tmp_path):
    state, step, stream = _port()

    def always(s):
        raise trainer.SimulatedFailure("injected")

    with pytest.raises(trainer.SimulatedFailure):
        trainer.run(state, step, stream, num_steps=2, ckpt_dir=str(tmp_path),
                    max_failures=2, fail_hook=always)


def test_resume_skips_the_data_ahead(tmp_path):
    state, step, stream = _port()
    clean = trainer.run(state, step, stream, num_steps=STEPS)
    first = trainer.run(state, step, stream, num_steps=3, ckpt_dir=str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 3
    resumed = trainer.run(state, step, stream, num_steps=STEPS, ckpt_dir=str(tmp_path))
    assert resumed.steps_run == 3 and resumed.final_step == STEPS
    assert first.losses + resumed.losses == clean.losses


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's trainer runs 3 steps and checkpoints; the port's
    trainer restores that checkpoint (the shared format) and runs steps 3-5,
    whose losses equal the reference's uninterrupted run's."""
    rcfg = rconfigs.get_arch("qwen2-1.5b").smoke()
    rtc = rstep_mod.TrainConfig(optimizer=RAdamWConfig(**OPT), warmup_steps=2,
                                total_steps=STEPS)
    rstate, _ = rstep_mod.init_state(jax.random.key(0), rcfg, rtc)
    rstep = jax.jit(rstep_mod.build_train_step(rcfg, rtc))
    rstream = RTokenStream(rcfg.vocab, 4, 16, seed=0)
    want = rtrainer.run(rstate, rstep, rstream, num_steps=STEPS).losses
    d = str(tmp_path / "ckpt")
    rtrainer.run(rstate, rstep, rstream, num_steps=3, ckpt_dir=d)
    state, step, stream = _port(seed=1)   # other weights: the restore replaces them
    got = trainer.run(state, step, stream, num_steps=STEPS, ckpt_dir=d)
    assert got.steps_run == 3
    np.testing.assert_allclose(got.losses, want[3:], rtol=LOSS_RTOL)
    # and the port's checkpoint of step 6 restores into the reference's tree
    restored, meta = ckpt.restore_checkpoint(d, np_tree(rstate))
    assert meta["step"] == STEPS and int(restored["opt"]["count"]) == STEPS


@pytest.mark.parametrize("arch", ["pna", "qwen2-1.5b", "bert4rec"])
def test_train_cli_runs_on_the_cpu(arch):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    env.update({k: v for k, v in os.environ.items()
                if k in ("HOME", "TMPDIR", "LD_LIBRARY_PATH")})
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", "3", "--device", "cpu", "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done on cpu: 3 steps" in proc.stdout
