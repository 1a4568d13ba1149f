"""The port's LM train step on a (data, model) mesh of gloo ranks on the
CPU, against the JAX package's step.

One job of four ranks (spawned with `torch.multiprocessing`, a `file://`
rendezvous under tmp_path, two torch threads a rank) runs, for each of the
five archs' smoke configs in f32 on a (2, 2) mesh, three steps of
`build_train_step(mesh=)` (2 microbatches of 4 x 24 tokens, full remat,
AdamW, deepseek-v3 with its cell's bf16 moments) from the reference's
initial state sharded by `shard_state`; while the ranks run, the parent
takes the reference's jitted single-device steps on the same batches. The
parent then holds the port's losses (rtol TRAIN_LOSS_RTOL) and its
gathered parameters (11a's rule: PARAM_ATOL but for PARAM_FLIP_SHARE of a
leaf, within lr a step) to the reference's, and each rank's local shape of
every parameter and AdamW moment to the reference's shard shape under the
same mesh (`repro.sharding.resolve_axis_spec` on a stand-in mesh).

The same job also runs: qwen2 at (1, 4), where its two kv heads do not
split over four model ranks (the divisibility guard, hazard m); a (1, 1)
mesh on rank 0, bit for bit the single-process step; the router's inputs of
the MoE archs compared bit for bit across each model group (hazard ii);
qwen2 with the blockwise CE (`fused_ce`) and deepseek-v2-lite with
`moe_groups` = 2 at (2, 2) against the port's single-process step; and one
step of qwen3 at (2, 2) under `launch/op_cost.OpCounter`, whose FLOPs on a
rank are at most FLOPS_SHARE of the single-process step's (TP and FSDP
split the work, they do not repeat it). A second job shows that a rank
that raises inside the step fails the whole job. The ranks import only the
port; the reference's imports are in the parent's fixture."""
import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_spawn import finish, spawn, start  # noqa: E402

ARCHS = ("qwen2-1.5b", "qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b",
         "deepseek-v3-671b")
MOE_ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
B, S, STEPS, MICRO = 8, 24, 3, 2
OPT = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
SCHEDULE = dict(warmup_steps=2, total_steps=10, microbatches=MICRO, remat=True)
STATE_DTYPE = {"deepseek-v3-671b": "bfloat16"}   # launch/cells.LM_STATE_DTYPE
# 11a's bounds (chip_smoke.py): losses relative; parameters within
# PARAM_ATOL but for PARAM_FLIP_SHARE of a leaf, every entry within lr a step
TRAIN_LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_FLIP_SHARE = 1e-4, 1e-3
FLOPS_SHARE = 0.3
THREADS = 2
JOB_DEADLINE_S = 400


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    from repro_torch.optim.tree import keyed_leaves

    return dict(keyed_leaves(tree))


def _tc(arch, **kw):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig

    return TrainConfig(optimizer=AdamWConfig(
        state_dtype=STATE_DTYPE.get(arch, "float32"), **OPT), **SCHEDULE, **kw)


def _run_on_mesh(cfg, tc, np_state, mesh, steps=STEPS):
    """`steps` steps of the port on `mesh` from the reference state ->
    (losses, the gathered state, each local leaf's shape by key)."""
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding import gather_tree
    from repro_torch.train.step import (build_train_step, init_state, load_jax_state,
                                        shard_state, state_shardings)

    model = Transformer(cfg, device="cpu")
    state = load_jax_state(np_state, like=init_state(model, tc))
    sh = state_shardings(model, tc, mesh)
    local = shard_state(state, sh, mesh)
    shapes = {k: list(v.shape) for k, v in _flat(local).items()}
    step = build_train_step(model, tc, mesh=mesh)
    stream = SyntheticTokenStream(cfg.vocab, B, S, seed=0, device="cpu")
    losses = []
    for i in range(steps):
        local, m = step(local, stream(i))
        losses.append(float(m["loss"]))
    return losses, gather_tree(local, sh, mesh), shapes


def _single(cfg, tc, np_state, steps=STEPS):
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.step import build_train_step, init_state, load_jax_state

    model = Transformer(cfg, device="cpu")
    state = load_jax_state(np_state, like=init_state(model, tc))
    step = build_train_step(model, tc)
    stream = SyntheticTokenStream(cfg.vocab, B, S, seed=0, device="cpu")
    losses = []
    for i in range(steps):
        state, m = step(state, stream(i))
        losses.append(float(m["loss"]))
    return losses, state


def _save_params(out, name, losses, state):
    np.savez(os.path.join(out, f"{name}.npz"), losses=np.asarray(losses),
             **{k: v.detach().float().numpy() for k, v in _flat(state["params"]).items()})


def _router_inputs(transformer):
    """Record every router call's input (the tokens it routes)."""
    seen = []
    dispatch = transformer.moe_dispatch

    def recording(x2d, router, cfg, dropless=False):
        seen.append(x2d.detach().clone())
        return dispatch(x2d, router, cfg, dropless=dropless)

    transformer.moe_dispatch = recording
    return seen, lambda: setattr(transformer, "moe_dispatch", dispatch)


def _job(rank, init, out, states):
    """One rank of the four: runs in a spawned process that imports only
    the port."""
    import sys

    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as rmesh
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models import transformer

    torch.set_num_threads(THREADS)
    rmesh.make_shard_group(4, backend="gloo", init_method=init, rank=rank,
                           timeout_s=60)
    mesh = rmesh.make_rank_mesh((2, 2))
    report = {"shapes": {}, "router": {}}
    for arch in ARCHS:
        cfg = get_arch(arch).smoke()
        seen, restore = _router_inputs(transformer)
        losses, state, report["shapes"][arch] = _run_on_mesh(
            cfg, _tc(arch), states[arch], mesh)
        restore()
        if arch in MOE_ARCHS:   # each router input equal across the model group
            same = [bool(torch.equal(*rmesh.all_gather(x[None], mesh, "model", 0)))
                    for x in seen]
            report["router"][arch] = [len(seen), all(same)]
        if rank == 0:
            _save_params(out, f"mesh22-{arch}", losses, state)
    # the guard: qwen2's 2 kv heads over 4 model ranks
    guard = rmesh.make_rank_mesh((1, 4))
    losses, state, report["shapes"]["guard"] = _run_on_mesh(
        get_arch("qwen2-1.5b").smoke(), _tc("qwen2-1.5b"), states["qwen2-1.5b"], guard)
    if rank == 0:
        _save_params(out, "mesh14-qwen2-1.5b", losses, state)
    # the options no config sets, at (2, 2) against the single-process step
    for name, arch, kw in (("fused_ce", "qwen2-1.5b", {"fused_ce": 32}),
                           ("moe_groups", "deepseek-v2-lite-16b", {"moe_groups": 2})):
        cfg = dataclasses.replace(get_arch(arch).smoke(), **kw)
        losses, state, _ = _run_on_mesh(cfg, _tc(arch), states[arch], mesh)
        if rank == 0:
            _save_params(out, f"{name}-mesh", losses, state)
            _save_params(out, f"{name}-single", *_single(cfg, _tc(arch), states[arch]))
    # one step of a dense arch under the op counter
    cfg, tc = get_arch("qwen3-8b").smoke(), _tc("qwen3-8b")
    with OpCounter() as counted:
        _run_on_mesh(cfg, tc, states["qwen3-8b"], mesh, steps=1)
    report["flops"] = counted.flops_f32 + counted.flops_tc
    # a (1, 1) mesh on rank 0 against the single-process step, bit for bit
    one = rmesh.make_rank_mesh((1, 1), ranks=[0])
    if rank == 0:
        with OpCounter() as counted:
            _single(cfg, tc, states["qwen3-8b"], steps=1)
        report["flops_single"] = counted.flops_f32 + counted.flops_tc
        report["one_by_one"] = {}
        for arch in ("qwen2-1.5b", "deepseek-v2-lite-16b"):
            cfg, tc = get_arch(arch).smoke(), _tc(arch)
            l1, s1, _ = _run_on_mesh(cfg, tc, states[arch], one)
            l0, s0 = _single(cfg, tc, states[arch])
            report["one_by_one"][arch] = l1 == l0 and all(
                torch.equal(a, b) for a, b in zip(_flat(s1).values(), _flat(s0).values()))
    assert "jax" not in sys.modules and "repro" not in sys.modules
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _reference(arch, steps=STEPS):
    """The reference's initial state (numpy), its losses and final params,
    and its specs, jitted on one device."""
    import jax

    from repro import configs as rconfigs
    from repro.data.tokens import SyntheticTokenStream as RTokenStream
    from repro.optim.adamw import AdamWConfig as RAdamWConfig
    from repro.train import step as rstep

    rcfg = rconfigs.get_arch(arch).smoke()
    rtc = rstep.TrainConfig(optimizer=RAdamWConfig(
        state_dtype=STATE_DTYPE.get(arch, "float32"), **OPT), **SCHEDULE)
    state, specs = rstep.init_state(jax.random.key(0), rcfg, rtc)
    np_state = jax.tree.map(np.asarray, state)
    step = jax.jit(rstep.build_train_step(rcfg, rtc))
    stream = RTokenStream(rcfg.vocab, B, S, seed=0)
    losses = []
    for i in range(steps):
        state, m = step(state, stream(i))
        losses.append(float(m["loss"]))
    return np_state, losses, state, specs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Start the four ranks on the reference's initial states, take the
    reference's steps meanwhile -> (output directory, the reference's
    results by arch)."""
    import jax

    d = tmp_path_factory.mktemp("sharded_lm")
    started = time.monotonic()
    refs = {}
    for arch in ARCHS:   # the initial states first: the ranks start from them
        import repro.configs as rconfigs
        from repro.optim.adamw import AdamWConfig as RAdamWConfig
        from repro.train import step as rstep

        rtc = rstep.TrainConfig(optimizer=RAdamWConfig(
            state_dtype=STATE_DTYPE.get(arch, "float32"), **OPT), **SCHEDULE)
        state, _ = rstep.init_state(jax.random.key(0), rconfigs.get_arch(arch).smoke(), rtc)
        refs[arch] = jax.tree.map(np.asarray, state)
    ctx = start(_job, 4, (f"file://{d}/rendezvous", str(d), refs))
    results = {arch: _reference(arch) for arch in ARCHS}
    finish(ctx, JOB_DEADLINE_S, started)
    return d, results


def _assert_params(got, want, steps=STEPS, lr=OPT["lr"], what=""):
    """11a's rule, leaf by leaf."""
    for key, b in want.items():
        a = got[key]
        assert a.shape == b.shape, key
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert float((d > PARAM_ATOL).mean()) <= PARAM_FLIP_SHARE, f"{what} {key}"
        assert float(d.max()) <= steps * lr, f"{what} {key}: {float(d.max())}"


def _load(d, name):
    with np.load(os.path.join(d, f"{name}.npz")) as z:
        return list(z["losses"]), {k: z[k] for k in z.files if k != "losses"}


def _port_keys(params):
    """The reference's flattened params under the port's keys."""
    import jax

    from repro_torch.optim.tree import keyed_leaves

    return {k: np.asarray(v, np.float32) for k, v in keyed_leaves(
        jax.tree.map(np.asarray, params))}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference(job, arch):
    d, results = job
    _, rlosses, rstate, _ = results[arch]
    losses, params = _load(d, f"mesh22-{arch}")
    np.testing.assert_allclose(losses, rlosses, rtol=TRAIN_LOSS_RTOL)
    _assert_params(params, _port_keys(rstate["params"]), what=arch)


def test_guard_replicates_kv_heads_at_model_4(job):
    """qwen2 smoke's 2 kv heads over 4 model ranks: each rank's q head reads
    kv head h // group by its global index."""
    d, results = job
    _, rlosses, rstate, _ = results["qwen2-1.5b"]
    losses, params = _load(d, "mesh14-qwen2-1.5b")
    np.testing.assert_allclose(losses, rlosses, rtol=TRAIN_LOSS_RTOL)
    _assert_params(params, _port_keys(rstate["params"]), what="(1, 4)")


def _shard_shapes(state, specs, mesh_shape):
    """The reference's shard shape of each leaf, under the port's keys."""
    import jax

    from repro import sharding as rsharding
    from repro_torch.optim.tree import keyed_leaves

    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(mesh_shape))
    sizes = dict(zip(("data", "model"), mesh_shape))

    def one(spec, x):
        p = rsharding.resolve_axis_spec(x.shape, spec, mesh)
        shape = list(x.shape)
        for i, ax in enumerate(p):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                shape[i] //= sizes[a]
        return shape

    shapes = jax.tree.map(one, specs, state, is_leaf=lambda s: isinstance(s, tuple) and all(
        a is None or isinstance(a, str) for a in s))
    return {k: v for k, v in keyed_leaves(shapes, is_leaf=lambda s: isinstance(s, list)
                                          and all(isinstance(a, int) for a in s))}


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_are_the_reference_shard_shapes(job, arch):
    d, results = job
    np_state, _, _, specs = results[arch]
    want = _shard_shapes(np_state, specs, (2, 2))
    for rank in range(4):
        with open(os.path.join(d, f"rank{rank}.json")) as f:
            got = json.load(f)["shapes"][arch]
        assert set(got) == set(want)
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        assert not bad, bad
    with open(os.path.join(d, "rank0.json")) as f:
        guard = json.load(f)["shapes"]["guard"]
    if arch == "qwen2-1.5b":
        assert guard == _shard_shapes(np_state, specs, (1, 4))


def test_one_by_one_mesh_is_the_single_process_step(job):
    d, _ = job
    with open(os.path.join(d, "rank0.json")) as f:
        assert json.load(f)["one_by_one"] == {"qwen2-1.5b": True,
                                              "deepseek-v2-lite-16b": True}


def test_router_inputs_are_bit_identical_across_model_ranks(job):
    d, _ = job
    for rank in range(4):
        with open(os.path.join(d, f"rank{rank}.json")) as f:
            router = json.load(f)["router"]
        for arch in MOE_ARCHS:
            n, same = router[arch]
            assert n > 0 and same, (rank, arch, router[arch])


@pytest.mark.parametrize("name", ["fused_ce", "moe_groups"])
def test_options_on_the_mesh_equal_the_single_process_step(job, name):
    d, _ = job
    losses, params = _load(d, f"{name}-mesh")
    want_losses, want = _load(d, f"{name}-single")
    np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_LOSS_RTOL)
    _assert_params(params, want, what=name)


def test_a_dense_rank_does_a_quarter_of_the_work(job):
    d, _ = job
    with open(os.path.join(d, "rank0.json")) as f:
        single = json.load(f)["flops_single"]
    for rank in range(4):
        with open(os.path.join(d, f"rank{rank}.json")) as f:
            flops = json.load(f)["flops"]
        assert 0 < flops <= FLOPS_SHARE * single, (rank, flops, single)


def _failing(rank, init):
    """Rank 1 raises inside the train step's forward; rank 0 then waits in
    a collective that never completes, until the job is torn down."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as rmesh
    from repro_torch.models import transformer

    torch.set_num_threads(1)
    rmesh.make_shard_group(2, backend="gloo", init_method=init, rank=rank,
                           timeout_s=60)
    mesh = rmesh.make_rank_mesh((1, 2))
    if rank == 1:
        def broken(*a, **k):
            raise RuntimeError("injected fault on rank 1")
        transformer.Transformer._mlp = broken
    cfg = get_arch("qwen2-1.5b").smoke()
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.step import build_train_step, init_state, shard_state, \
        state_shardings
    from repro_torch.data.tokens import SyntheticTokenStream

    model = Transformer(cfg, device="cpu")
    tc = _tc("qwen2-1.5b")
    state = shard_state(init_state(model, tc), state_shardings(model, tc, mesh), mesh)
    build_train_step(model, tc, mesh=mesh)(
        state, SyntheticTokenStream(cfg.vocab, B, S, seed=0, device="cpu")(0))


def test_a_rank_that_raises_fails_the_job(tmp_path):
    """No fallback: the fault on one rank fails the whole job (the spawner
    re-raises it and tears the other rank down)."""
    import torch.multiprocessing as mp

    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException, match="injected fault on rank 1"):
        spawn(_failing, 2, (f"file://{tmp_path}/rendezvous",), deadline_s=150)
    assert time.monotonic() - t0 < 150
