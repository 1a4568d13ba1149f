"""Elastic training on a mesh of ranks (the port's counterpart of
tests/test_elastic.py): checkpoints are global arrays with a manifest, so
a run resumes on another mesh.

One job of four gloo ranks on the CPU (spawned, a `file://` rendezvous
under tmp_path): `train/trainer.run` takes 3 steps of qwen2's smoke config
on a (2, 2) mesh and checkpoints at step 3 (the leaves gathered, rank 0
alone writing), then three of the ranks restore that checkpoint onto a
(3, 1) mesh (a batch of 8 rows over 3 data ranks: the divisibility guard
replicates it) and take step 4. The parent holds step 4's loss and the
saved parameters to an uninterrupted single-process run of 4 steps within
11a's bounds, and the mesh's checkpoint to a single-card save of the same
step: the same manifest (keys, shapes, dtypes, structure).

The same job then slices the step-3 checkpoint onto a (1, 4) mesh, where
the leaves really split (over `model`), and takes step 4 there; and runs
the trainer at (2, 2) with a failure injected on rank 1 alone before step
3: every rank agrees on it, restores the step-2 checkpoint onto (2, 2) and
finishes the uninterrupted run's losses. A failure inside a step on a mesh
is not retried (`trainer.MeshStepFailure`)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_spawn import spawn  # noqa: E402

ARCH = "qwen2-1.5b"
B, S, LR = 8, 32, 1e-3
SAVED_AT, RESUMED_TO = 3, 4
RETRY_EVERY = 2     # the retried run's checkpoint interval
# 11a's bounds (chip_smoke.py)
TRAIN_LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_FLIP_SHARE = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup():
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig

    cfg = get_arch(ARCH).smoke()
    model = Transformer(cfg, device="cpu", seed=0)
    tc = TrainConfig(optimizer=AdamWConfig(lr=LR))
    stream = SyntheticTokenStream(cfg.vocab, B, S, seed=0, device="cpu")
    return model, tc, stream


def _job(rank, init, ckpt_dir, retry_dir, out):
    import sys

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import mesh as rmesh
    from repro_torch.optim.tree import leaves
    from repro_torch.train import trainer
    from repro_torch.train.step import (build_train_step, init_state, shard_state,
                                        state_shardings)

    torch.set_num_threads(2)
    writes = []
    retain = ckpt._retain

    def counting(directory, keep):   # called once a checkpoint is written
        writes.append(rank)
        return retain(directory, keep)

    ckpt._retain = counting
    rmesh.make_shard_group(4, backend="gloo", init_method=init, rank=rank,
                           timeout_s=60)
    model, tc, stream = _setup()
    reports = {}
    for shape, ranks, steps in (((2, 2), None, SAVED_AT), ((3, 1), [0, 1, 2], RESUMED_TO)):
        mesh = rmesh.make_rank_mesh(shape, ranks=ranks)
        if mesh is None:
            continue
        sh = state_shardings(model, tc, mesh)
        state = shard_state(init_state(model, tc), sh, mesh)
        rep = trainer.run(state, build_train_step(model, tc, mesh=mesh), stream,
                          num_steps=steps, ckpt_dir=ckpt_dir, ckpt_interval=SAVED_AT,
                          mesh=mesh, specs=sh)
        reports[str(shape)] = {"losses": rep.losses, "steps_run": rep.steps_run,
                               "final_step": rep.final_step}
    n_writes = len(writes)
    # the (2, 2) checkpoint of step 3 sliced onto (1, 4), and step 4 there
    mesh = rmesh.make_rank_mesh((1, 4))
    sh = state_shardings(model, tc, mesh)
    like = shard_state(init_state(model, tc), sh, mesh)
    state, meta = ckpt.restore_checkpoint(ckpt_dir, like, step=SAVED_AT, mesh=mesh,
                                          specs=sh)
    split = sum(tuple(a.shape) != tuple(b.shape)
                for a, b in zip(leaves(state), leaves(init_state(model, tc))))
    state, m = build_train_step(model, tc, mesh=mesh)(state, stream(SAVED_AT))
    reports["(1, 4)"] = {"loss": float(m["loss"]), "split_leaves": split,
                         "step": int(meta["step"])}
    # the trainer at (2, 2), rank 1 alone failing once before step 3
    mesh = rmesh.make_rank_mesh((2, 2))
    sh = state_shardings(model, tc, mesh)
    fired = []

    def fail_once(step):
        if rank == 1 and step == SAVED_AT and not fired:
            fired.append(step)
            raise trainer.SimulatedFailure("injected on rank 1")

    rep = trainer.run(shard_state(init_state(model, tc), sh, mesh),
                      build_train_step(model, tc, mesh=mesh), stream,
                      num_steps=RESUMED_TO, ckpt_dir=retry_dir, ckpt_interval=RETRY_EVERY,
                      fail_hook=fail_once, mesh=mesh, specs=sh)
    reports["retry"] = {"losses": rep.losses, "restarts": rep.restarts,
                        "final_step": rep.final_step}
    assert "jax" not in sys.modules and "repro" not in sys.modules
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"writes": writes[:n_writes], "retry_writes": writes[n_writes:],
                   "reports": reports}, f)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    ckpt_dir = str(d / "ckpt")
    spawn(_job, 4, (f"file://{d}/rendezvous", ckpt_dir, str(d / "retry"), str(d)),
          deadline_s=300)
    reports = []
    for rank in range(4):
        with open(d / f"rank{rank}.json") as f:
            reports.append(json.load(f))
    return d, ckpt_dir, reports


def _uninterrupted(steps):
    from repro_torch.train.step import build_train_step, init_state

    model, tc, stream = _setup()
    state, step = init_state(model, tc), build_train_step(model, tc)
    losses, states = [], {}
    for i in range(steps):
        state, m = step(state, stream(i))
        losses.append(float(m["loss"]))
        states[i + 1] = state
    return losses, states


def test_restore_onto_another_mesh_continues_the_run(job):
    from repro_torch.checkpoint import ckpt
    from repro_torch.optim.tree import keyed_leaves

    _, ckpt_dir, reports = job
    losses, states = _uninterrupted(RESUMED_TO)
    for rank in range(4):
        first = reports[rank]["reports"]["(2, 2)"]
        assert first["steps_run"] == SAVED_AT
        np.testing.assert_allclose(first["losses"], losses[:SAVED_AT], rtol=TRAIN_LOSS_RTOL)
    for rank in range(3):   # resumed at step 3, one step on (3, 1)
        second = reports[rank]["reports"]["(3, 1)"]
        assert (second["steps_run"], second["final_step"]) == (1, RESUMED_TO)
        np.testing.assert_allclose(second["losses"], losses[SAVED_AT:], rtol=TRAIN_LOSS_RTOL)
    assert "(3, 1)" not in reports[3]["reports"]
    want = states[RESUMED_TO]
    got, meta = ckpt.restore_checkpoint(ckpt_dir, want, step=RESUMED_TO)
    assert int(meta["step"]) == RESUMED_TO
    for (key, a), (_, b) in zip(keyed_leaves(got["params"]), keyed_leaves(want["params"])):
        d = np.abs(np.asarray(a, np.float64) - b.double().numpy())
        assert float((d > PARAM_ATOL).mean()) <= PARAM_FLIP_SHARE, key
        assert float(d.max()) <= RESUMED_TO * LR, key


def test_restore_slices_the_leaves_onto_a_mesh_that_splits_them(job):
    """The step-3 checkpoint, saved at (2, 2), restored at (1, 4): the
    leaves split over four model ranks, and step 4 there is the
    uninterrupted run's."""
    _, _, reports = job
    losses, _ = _uninterrupted(RESUMED_TO)
    for rank in range(4):
        got = reports[rank]["reports"]["(1, 4)"]
        assert got["step"] == SAVED_AT
        assert got["split_leaves"] > 0
        np.testing.assert_allclose(got["loss"], losses[SAVED_AT], rtol=TRAIN_LOSS_RTOL)


def test_a_failure_on_one_rank_restores_every_rank(job):
    """Rank 1 alone fails before step 3: every rank restores the step-2
    checkpoint onto (2, 2), retakes step 2 and ends on the uninterrupted
    run's losses."""
    _, _, reports = job
    losses, _ = _uninterrupted(RESUMED_TO)
    want = losses[:SAVED_AT] + losses[RETRY_EVERY:RESUMED_TO]
    for rank in range(4):
        got = reports[rank]["reports"]["retry"]
        assert (got["restarts"], got["final_step"]) == (1, RESUMED_TO)
        np.testing.assert_allclose(got["losses"], want, rtol=TRAIN_LOSS_RTOL)


def test_a_failure_inside_a_step_on_a_mesh_is_not_retried(tmp_path):
    """Inside a step the other ranks wait in its collectives, so the loop
    raises in place of restoring (here on a one-process mesh)."""
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.train import trainer
    from repro_torch.train.step import build_train_step, init_state, state_shardings

    model, tc, stream = _setup()
    mesh = local_mesh()
    step = build_train_step(model, tc, mesh=mesh)

    def failing(state, batch):
        if int(state["step"]) == 1:
            raise trainer.SimulatedFailure("inside the step")
        return step(state, batch)

    with pytest.raises(trainer.MeshStepFailure):
        trainer.run(init_state(model, tc, mesh=mesh), failing, stream, num_steps=2,
                    ckpt_dir=str(tmp_path), ckpt_interval=1, mesh=mesh,
                    specs=state_shardings(model, tc, mesh))


def test_only_rank_0_wrote(job):
    _, _, reports = job
    # step 3 on (2, 2), at the interval and at the end of the run; step 4
    # at the end of the run on (3, 1)
    assert reports[0]["writes"] == [0, 0, 0]
    # the retried run: steps 2 and 4 at the interval, step 4 at the end
    assert reports[0]["retry_writes"] == [0, 0, 0]
    assert all(r["writes"] == [] and r["retry_writes"] == [] for r in reports[1:])


def test_mesh_checkpoint_reads_like_a_single_card_one(job, tmp_path):
    from repro_torch.checkpoint import ckpt

    _, ckpt_dir, _ = job
    _, states = _uninterrupted(SAVED_AT)
    single = ckpt.save_checkpoint(str(tmp_path), SAVED_AT, states[SAVED_AT],
                                  {"data_cursor": SAVED_AT})
    with open(os.path.join(single, "manifest.json")) as f:
        want = json.load(f)
    with open(os.path.join(ckpt_dir, f"step_{SAVED_AT:012d}", "manifest.json")) as f:
        got = json.load(f)
    assert got == want
    assert ckpt.checkpoint_valid(os.path.join(ckpt_dir, f"step_{SAVED_AT:012d}"))
