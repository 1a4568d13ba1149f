"""Host-side training loop: checkpoint/restart, deterministic resume and
failure handling over the train step (the JAX package's
`train/trainer.py`).

Recovery contract:
  - the state is checkpointed every `ckpt_interval` steps through
    `checkpoint/ckpt.py` (atomic, with a manifest; the JAX package's
    format, so either package resumes the other's run);
  - on (re)start the trainer restores the newest checkpoint and skips the
    data stream ahead: batches are a pure function of (seed, step), so no
    replay buffer is needed;
  - up to `max_failures` step failures (`ckpt_failure_types`) are retried
    from the last checkpoint; the step leaves its input state as it is, so
    a retry is safe.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.optim.tree import leaves, tree_map


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    final_step: int
    losses: List[float]
    restarts: int
    step_times: List[float]


def _restore(ckpt_dir: str, state):
    device = leaves(state)[0].device
    restored, meta = ckpt.restore_checkpoint(ckpt_dir, state, device=device)
    # in the state's dtypes: a bf16 leaf is saved as f32 (`ckpt._host`)
    return tree_map(lambda t, like: t.to(like.dtype), restored, state), int(meta["step"])


def run(
    state,
    train_step: Callable,
    batch_fn: Callable[[int], Any],
    *,
    num_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_interval: int = 50,
    keep: int = 3,
    max_failures: int = 3,
    fail_hook: Optional[Callable[[int], None]] = None,
    log_every: int = 0,
) -> TrainerReport:
    """Run `num_steps` steps of `train_step`, resuming from ckpt_dir if it
    holds a checkpoint.

    `batch_fn(step)` must be deterministic in `step` (skip-ahead resume).
    `fail_hook(step)` lets tests inject failures at chosen steps."""
    start_step = 0
    restarts = 0
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        state, start_step = _restore(ckpt_dir, state)
    losses: List[float] = []
    times: List[float] = []
    step = start_step
    failures = 0
    while step < num_steps:
        t0 = time.perf_counter()
        try:
            if fail_hook is not None:
                fail_hook(step)
            batch = batch_fn(step)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
        except ckpt_failure_types():  # transient failure -> restore + retry
            failures += 1
            restarts += 1
            if ckpt_dir is None or failures > max_failures:
                raise
            if ckpt.latest_step(ckpt_dir) is not None:
                state, step = _restore(ckpt_dir, state)
            else:
                step = 0
            continue
        losses.append(loss)
        times.append(time.perf_counter() - t0)
        step += 1
        if log_every and step % log_every == 0:
            print(f"step {step}: loss={loss:.4f} ({times[-1] * 1e3:.0f} ms)")
        if ckpt_dir is not None and ckpt_interval > 0 and step % ckpt_interval == 0:
            ckpt.save_checkpoint(ckpt_dir, step, state, {"data_cursor": step}, keep=keep)
    if ckpt_dir is not None:
        ckpt.save_checkpoint(ckpt_dir, step, state, {"data_cursor": step}, keep=keep)
    return TrainerReport(
        steps_run=step - start_step, final_step=step, losses=losses,
        restarts=restarts, step_times=times,
    )


class SimulatedFailure(RuntimeError):
    """Raised by fail_hook in fault-tolerance tests."""


def ckpt_failure_types():
    return (SimulatedFailure,)
