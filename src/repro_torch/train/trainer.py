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

On a mesh (`mesh=`, a `launch/mesh.RankMesh`, with `specs` the state's
resolved specs, `train/step.state_shardings`), every rank runs the loop on
its blocks of the state: the mesh's first rank decides which checkpoint to
resume from and writes the checkpoints (global arrays, gathered), every
rank restores its blocks, and the restart resumes at the same step on every
rank, on this mesh whatever mesh saved it. A failure before a step
(`fail_hook`) on any rank is agreed on by every rank before the step's
collectives begin, so that all of them restore; a failure inside a step
leaves the other ranks inside its collectives, so on a mesh it is not
retried: it raises `MeshStepFailure`.
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


def _restore(ckpt_dir: str, state, mesh=None, specs=None):
    device = leaves(state)[0].device
    restored, meta = ckpt.restore_checkpoint(ckpt_dir, state, device=device,
                                             mesh=mesh, specs=specs)
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
    mesh=None,
    specs=None,
) -> TrainerReport:
    """Run `num_steps` steps of `train_step`, resuming from ckpt_dir if it
    holds a checkpoint.

    `batch_fn(step)` must be deterministic in `step` (skip-ahead resume).
    `fail_hook(step)` lets tests inject failures at chosen steps. With
    `mesh`, every rank of the mesh calls it (the state its blocks, `specs`
    their resolved specs, `train_step` built on the mesh)."""
    start_step = 0
    restarts = 0

    def has_checkpoint():
        found = ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None
        if mesh is None:
            return found
        from repro_torch.launch.mesh import broadcast_int

        return bool(broadcast_int(int(found), mesh))

    def save(step, state):
        ckpt.save_checkpoint(ckpt_dir, step, state, {"data_cursor": step}, keep=keep,
                             mesh=mesh, specs=specs)

    def before_step(step):
        """fail_hook(step); on a mesh, a failure on any rank is every
        rank's."""
        failed = None
        if fail_hook is not None:
            try:
                fail_hook(step)
            except ckpt_failure_types() as e:
                failed = e
        if mesh is not None:
            from repro_torch.launch.mesh import any_rank

            if any_rank(failed is not None, mesh) and failed is None:
                failed = PeerFailure(f"another rank of {mesh} failed before step {step}")
        if failed is not None:
            raise failed

    def take_step(state, batch):
        if mesh is None:
            return train_step(state, batch)
        try:
            return train_step(state, batch)
        except ckpt_failure_types() as e:
            raise MeshStepFailure(
                f"step failed inside the step on {mesh}: the other ranks wait in "
                f"its collectives, so a mesh does not retry it") from e

    if has_checkpoint():
        state, start_step = _restore(ckpt_dir, state, mesh, specs)
    losses: List[float] = []
    times: List[float] = []
    step = start_step
    failures = 0
    while step < num_steps:
        t0 = time.perf_counter()
        try:
            before_step(step)
            batch = batch_fn(step)
            state, metrics = take_step(state, batch)
            loss = float(metrics["loss"])
        except ckpt_failure_types():  # transient failure -> restore + retry
            failures += 1
            restarts += 1
            if ckpt_dir is None or failures > max_failures:
                raise
            if has_checkpoint():
                state, step = _restore(ckpt_dir, state, mesh, specs)
            else:
                step = 0
            continue
        losses.append(loss)
        times.append(time.perf_counter() - t0)
        step += 1
        if log_every and step % log_every == 0:
            print(f"step {step}: loss={loss:.4f} ({times[-1] * 1e3:.0f} ms)")
        if ckpt_dir is not None and ckpt_interval > 0 and step % ckpt_interval == 0:
            save(step, state)
    if ckpt_dir is not None:
        save(step, state)
    return TrainerReport(
        steps_run=step - start_step, final_step=step, losses=losses,
        restarts=restarts, step_times=times,
    )


class SimulatedFailure(RuntimeError):
    """Raised by fail_hook in fault-tolerance tests."""


class PeerFailure(RuntimeError):
    """Another rank of the mesh failed before the step: this rank restores
    with it."""


class MeshStepFailure(RuntimeError):
    """A failure inside a step on a mesh, which the loop does not retry."""


def ckpt_failure_types():
    return (SimulatedFailure, PeerFailure)
