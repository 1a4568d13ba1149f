"""Spawned ranks for the port's gloo tests: `spawn(fn, P, args)` runs
fn(rank, *args) in P processes started with `torch.multiprocessing`
(spawn), terminates them and fails the test if they are not done within
the deadline; a rank's exception re-raises in the caller. `start` and
`finish` split it, so that the caller works while the ranks run."""
import time

import pytest


def start(fn, P, args):
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=args, nprocs=P, join=False,
                              start_method="spawn")


def finish(ctx, deadline_s=150, started=None):
    """Wait for the ranks of `start`: deadline_s from `started` (a
    `time.monotonic()` reading, default now)."""
    end = (time.monotonic() if started is None else started) + deadline_s
    while not ctx.join(timeout=1):
        if time.monotonic() > end:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
            for proc in ctx.processes:
                proc.join(5)
            pytest.fail(f"ranks not done within {deadline_s} s")


def spawn(fn, P, args, deadline_s=150):
    finish(start(fn, P, args), deadline_s)
