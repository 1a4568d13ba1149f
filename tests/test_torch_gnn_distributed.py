"""The sharded PNA step (`models/gnn_distributed.py`) against the JAX
package, on the CPU: the partitioned batches bit for bit, the analytic batch
shapes, the loss and every gradient at P = 1 against the reference's
`build_distributed_pna_loss` on a one-device mesh (f32 and bf16 messages),
at P = 2 and 4 on the sim backend against the reference's single-device
`gnn.loss_fn` (which equals its distributed loss, gradients included), a
tie on a segment max whose gradient splits as JAX splits it, and a
two-rank gloo group equal to the sim at P = 2. Inputs are made with numpy
from a seed and handed to both packages."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro.models import gnn as rgnn  # noqa: E402
from repro.models import gnn_distributed as rgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.engine import sim_prims  # noqa: E402
from repro_torch.graph.structs import Graph  # noqa: E402
from repro_torch.models import gnn_distributed as gd  # noqa: E402
from repro_torch.models.gnn import GNN  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import param_tree  # noqa: E402
from torch_spawn import spawn  # noqa: E402
from torch_train_util import (  # noqa: E402,F401
    LOSS_RTOL, assert_grads_close, few_torch_threads, np_tree)

D_FEAT, N_CLASSES = 6, 3
# bf16 messages: the two packages round the same f32 values to bf16, but a
# value within f32 noise of a rounding boundary may round one ulp (2^-8)
# apart; the loss within BF16_LOSS_RTOL, each gradient leaf within
# BF16_GRAD_RTOL of its largest |g|
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-3, 1e-2


def _tg(g):
    return Graph(g.n, g.src, g.dst, g.labels)


def _without_degree_one(g):
    """g without the edges (both arcs: the partition wants an undirected
    graph) of each vertex that has exactly one, repeated until none has:
    PNA's variance is exactly 0 there and its f32 gradient is cancellation
    noise in either package (tests/test_torch_train_gnn.py)."""
    src, dst = g.src, g.dst
    while True:
        deg = np.bincount(dst, minlength=g.n)
        keep = (deg[dst] != 1) & (deg[src] != 1)
        if keep.all():
            return RGraph(g.n, src, dst, g.labels)
        src, dst = src[keep], dst[keep]


@pytest.fixture(scope="module")
def graph():
    return _without_degree_one(rgen.erdos_renyi_graph(60, 5.0, seed=2, n_labels=4))


@pytest.fixture(scope="module")
def setup(graph):
    """Both packages' PNA smoke config and parameters (the reference's
    jax.random weights, carried across)."""
    rcfg = rconfigs.get_arch("pna").smoke()
    cfg = configs.get_arch("pna").smoke()
    rparams, _ = rgnn.init(jax.random.key(0), rcfg, D_FEAT, N_CLASSES)
    model = GNN(cfg, D_FEAT, N_CLASSES, device="cpu").load_jax_params(np_tree(rparams))
    return rcfg, cfg, rparams, param_tree(model)


def _port_value_and_grad(cfg, P, batch, n_local, params, wrt_x=False):
    loss_fn = gd.build_distributed_pna_loss(cfg, sim_prims(P, "cpu"), n_local)
    xs = {"layers": [{k: v.clone().requires_grad_(True) for k, v in lay.items()}
                     for lay in params["layers"]],
          "head": {k: v.clone().requires_grad_(True) for k, v in params["head"].items()}}
    if wrt_x:
        batch = dict(batch, x=batch["x"].clone().requires_grad_(True))
    loss, _ = loss_fn(xs, batch)
    leaves = [xs["head"]["b"], xs["head"]["w"]] + [
        lay[k] for lay in xs["layers"] for k in ("b", "w")]
    wrt = leaves + ([batch["x"]] if wrt_x else [])
    gs = torch.autograd.grad(loss, wrt)
    grads = {"head": {"b": gs[0], "w": gs[1]},
             "layers": [{"b": gs[2 + 2 * i], "w": gs[3 + 2 * i]}
                        for i in range(len(xs["layers"]))]}
    return float(loss.detach()), grads, (gs[-1] if wrt_x else None)


def _global_batch(g, batch, feats):
    """The reference's single-device batch of the partitioned one: the same
    features, labels and training mask by global vertex id."""
    n_local = batch["x"].shape[1]
    ids = np.arange(g.n)
    rows, cols = ids // n_local, ids % n_local
    return {"x": jnp.asarray(feats), "src": jnp.asarray(g.src), "dst": jnp.asarray(g.dst),
            "labels": jnp.asarray(batch["labels"].numpy()[rows, cols]),
            "train_mask": jnp.asarray(batch["train_mask"].numpy()[rows, cols]),
            "log_deg_avg": jnp.float32(batch["log_deg_avg"])}


@pytest.mark.parametrize("P", [1, 2, 4])
def test_partitioned_batch_equals_the_reference(graph, P):
    theirs, tfeats, tpart = rgd.partitioned_batch_from_graph(graph, D_FEAT, N_CLASSES, P,
                                                             seed=3)
    mine, feats, part = gd.partitioned_batch_from_graph(_tg(graph), D_FEAT, N_CLASSES, P,
                                                        seed=3, device="cpu")
    assert part.n_local == tpart.n_local and part.B == tpart.B
    np.testing.assert_array_equal(feats, tfeats)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        got = mine[k].numpy()
        want = np.asarray(v)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("shape_name", ["full_graph_sm", "minibatch_lg",
                                        "ogb_products", "molecule"])
def test_partitioned_batch_shapes_equal_the_reference(shape_name):
    s = configs.get_arch("pna").SHAPES[shape_name]
    for P in (1, 4, 256):
        mine = gd.partitioned_batch_shapes(s.n_nodes, s.n_edges, P, s.d_feat)
        theirs = rgd.partitioned_batch_shapes(s.n_nodes, s.n_edges, P, s.d_feat)
        assert set(mine) == set(theirs)
        for k, (shape, dt) in theirs.items():
            assert mine[k][0] == shape, k
            assert str(mine[k][1]).split(".")[-1] == jnp.dtype(dt).name, k


@pytest.mark.parametrize("message_dtype", ["float32", "bfloat16"])
def test_one_shard_equals_the_reference_distributed_loss(graph, setup, message_dtype):
    """P = 1 against the reference's shard_map loss on a one-device mesh."""
    rcfg, cfg, rparams, params = setup
    rcfg = dataclasses.replace(rcfg, message_dtype=message_dtype)
    cfg = dataclasses.replace(cfg, message_dtype=message_dtype)
    theirs, _, tpart = rgd.partitioned_batch_from_graph(graph, D_FEAT, N_CLASSES, 1, seed=1)
    mine, _, part = gd.partitioned_batch_from_graph(_tg(graph), D_FEAT, N_CLASSES, 1,
                                                    seed=1, device="cpu")
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("shards",))
    rloss = rgd.build_distributed_pna_loss(rcfg, mesh, ("shards",), tpart.n_local)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: rloss(p, b)[0]))(rparams, theirs)
    loss, grads, _ = _port_value_and_grad(cfg, 1, mine, part.n_local, params)
    if message_dtype == "float32":
        np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
        assert_grads_close(grads, want_grads)
    else:
        np.testing.assert_allclose(loss, float(want_loss), rtol=BF16_LOSS_RTOL)
        _assert_grads_within(grads, want_grads, BF16_GRAD_RTOL)


def _assert_grads_within(got, want, rtol):
    from repro_torch.optim.tree import leaves

    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rtol * float(np.abs(b).max(initial=0.0)))


@pytest.fixture(scope="module")
def single_device_reference(setup):
    """The reference's single-device loss, gradients and feature gradient."""
    rcfg = setup[0]
    fn = jax.jit(jax.value_and_grad(
        lambda p, x, b: rgnn.loss_fn(p, rcfg, {**b, "x": x})[0], argnums=(0, 1)))
    return fn


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_loss_and_gradients_equal_the_single_device_reference(
        graph, setup, single_device_reference, P):
    _, cfg, rparams, params = setup
    mine, feats, part = gd.partitioned_batch_from_graph(_tg(graph), D_FEAT, N_CLASSES, P,
                                                        seed=1, device="cpu")
    want_loss, (want_grads, _) = single_device_reference(
        rparams, jnp.asarray(feats), _global_batch(graph, mine, feats))
    loss, grads, _ = _port_value_and_grad(cfg, P, mine, part.n_local, params)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)


def test_bf16_messages_stay_within_their_bound(graph, setup, single_device_reference):
    """bf16 messages at P = 2 against the f32 single-device reference: the
    rounding of each message to bf16 (2^-9 relative) bounds the change."""
    _, cfg, rparams, params = setup
    cfg = dataclasses.replace(cfg, message_dtype="bfloat16")
    mine, feats, part = gd.partitioned_batch_from_graph(_tg(graph), D_FEAT, N_CLASSES, 2,
                                                        seed=1, device="cpu")
    want_loss, (want_grads, _) = single_device_reference(
        rparams, jnp.asarray(feats), _global_batch(graph, mine, feats))
    loss, grads, _ = _port_value_and_grad(cfg, 2, mine, part.n_local, params)
    np.testing.assert_allclose(loss, float(want_loss), rtol=5e-3)
    _assert_grads_within(grads, want_grads, 5e-2)


def test_a_tie_on_a_segment_max_splits_its_gradient_as_jax_does(
        graph, setup, single_device_reference):
    """Two in-neighbours of one vertex with the same features tie on its max
    and min in every column; JAX splits the gradient between them evenly,
    and so must the port (the feature gradient shows the split)."""
    _, cfg, rparams, params = setup
    mine, feats, part = gd.partitioned_batch_from_graph(_tg(graph), D_FEAT, N_CLASSES, 2,
                                                        seed=1, device="cpu")
    c = int(np.bincount(graph.dst, minlength=graph.n).argmax())
    a, b = graph.src[graph.dst == c][:2]
    feats = feats.copy()
    feats[b] = feats[a]
    nl = part.n_local
    mine["x"][b // nl, b % nl] = torch.from_numpy(feats[b])
    want_loss, (want_grads, want_dx) = single_device_reference(
        rparams, jnp.asarray(feats), _global_batch(graph, mine, feats))
    loss, grads, dx = _port_value_and_grad(cfg, 2, mine, nl, params, wrt_x=True)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)
    ids = np.arange(graph.n)
    got_dx = dx.numpy()[ids // nl, ids % nl]
    want_dx = np.asarray(want_dx)
    tol = 1e-6 + 1e-4 * float(np.abs(want_dx).max())
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=tol)


def _rank_main(rank, init, out, graph_arrays):
    """One rank of a two-rank gloo group: its shard's loss and gradients."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_shard_group

    torch.set_num_threads(1)
    group = make_shard_group(2, backend="gloo", init_method=init, rank=rank, timeout_s=60)
    n, src, dst, labels = graph_arrays
    g = Graph(n, src, dst, labels)
    cfg = configs.get_arch("pna").smoke()
    params = param_tree(GNN(cfg, D_FEAT, N_CLASSES, device="cpu", seed=5))
    batch, _, part = gd.partitioned_batch_from_graph(g, D_FEAT, N_CLASSES, 2, seed=1,
                                                     device="cpu")
    prims = gd.spmd_gnn_prims(group, 2, rank, "cpu")
    loss_fn = gd.build_distributed_pna_loss(cfg, prims, part.n_local)
    xs = [t.clone().requires_grad_(True) for t in _flat(params)]
    loss, _ = loss_fn(_unflat(params, xs), _shard_of(batch, rank))
    gs = torch.autograd.grad(loss, xs)
    np.savez(os.path.join(out, f"rank{rank}.npz"), loss=float(loss.detach()),
             **{f"g{i}": g_.numpy() for i, g_ in enumerate(gs)})
    dist.destroy_process_group()


def _shard_of(batch, rank):
    """Rank `rank`'s view of a full partitioned batch (its [1, ...] slices;
    log_deg_avg shared), as an spmd rank holds it."""
    return {k: (v if v.dim() == 0 else v[rank:rank + 1]) for k, v in batch.items()}


def _flat(params):
    from repro_torch.optim.tree import leaves
    return leaves(params)


def _unflat(params, xs):
    from repro_torch.optim.tree import unflatten
    return unflatten(params, xs)


def test_two_gloo_ranks_equal_the_sim(graph, tmp_path):
    g = _tg(graph)
    init = f"file://{tmp_path / 'rendezvous'}"
    spawn(_rank_main, 2, (init, str(tmp_path), (g.n, g.src, g.dst, g.labels)))
    cfg = configs.get_arch("pna").smoke()
    params = param_tree(GNN(cfg, D_FEAT, N_CLASSES, device="cpu", seed=5))
    batch, _, part = gd.partitioned_batch_from_graph(g, D_FEAT, N_CLASSES, 2, seed=1,
                                                     device="cpu")
    loss_fn = gd.build_distributed_pna_loss(cfg, sim_prims(2, "cpu"), part.n_local)
    xs = [t.clone().requires_grad_(True) for t in _flat(params)]
    loss, _ = loss_fn(_unflat(params, xs), batch)
    want = torch.autograd.grad(loss, xs)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(float(got["loss"]), float(loss.detach()), rtol=1e-6)
        for i, w in enumerate(want):
            tol = 1e-6 + 1e-5 * float(w.abs().max())
            np.testing.assert_allclose(got[f"g{i}"], w.numpy(), rtol=0, atol=tol)


def test_distributed_step_updates_as_adamw_on_its_gradients(graph, setup):
    """`build_distributed_pna_step`: the loss of the state it was given and
    one AdamW update of the sharded loss's gradients."""
    from repro_torch.optim import adamw

    _, cfg, _, params = setup
    mine, _, part = gd.partitioned_batch_from_graph(_tg(graph), D_FEAT, N_CLASSES, 2,
                                                    seed=1, device="cpu")
    oc = AdamWConfig(weight_decay=0.0)
    state = {"params": params, "opt": adamw.init_state(params, oc),
             "step": torch.zeros((), dtype=torch.int32)}
    step = gd.build_distributed_pna_step(cfg, sim_prims(2, "cpu"), part.n_local, oc)
    new, metrics = step(state, mine)
    loss, grads, _ = _port_value_and_grad(cfg, 2, mine, part.n_local, params)
    want_params, _, _ = adamw.update(grads, state["opt"], params, oc)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-6)
    assert int(new["step"]) == 1
    for a, b in zip(_flat(new["params"]), _flat(want_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7)


def _with_close_pairs(g, groups=8, seed=4):
    """g plus `groups` planted triples (u1, u2, v): u1 and u2 share their
    in-neighbours (three of g's vertices and v) and v has exactly u1 and u2
    (both arcs of each edge: the partition wants an undirected graph).
    With u2's features within 1e-4 of u1's, the first layer maps them
    within about as much of each other, so at v the second layer's variance
    is below what f32 resolves in E[x^2] - mean^2 in every column that ReLU
    did not zero. Returns the graph and the (u1, u2) pairs."""
    rng = np.random.default_rng(seed)
    src, dst = list(g.src), list(g.dst)
    pairs = []
    for i in range(groups):
        u1, u2, v = g.n + 3 * i, g.n + 3 * i + 1, g.n + 3 * i + 2
        for w in rng.choice(g.n, 3, replace=False):
            for u in (u1, u2):
                src += [w, u]
                dst += [u, w]
        for u in (u1, u2):
            src += [u, v]
            dst += [v, u]
        pairs.append((u1, u2))
    n = g.n + 3 * groups
    labels = np.concatenate([g.labels, np.zeros(3 * groups, g.labels.dtype)])
    return RGraph(n, np.asarray(src, np.int32), np.asarray(dst, np.int32), labels), pairs


def _perturbed(tree, seed):
    """Every weight times (1 + 1e-7 N(0, 1)): about one f32 rounding."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda t: (np.asarray(t) * (1 + 1e-7 * rng.standard_normal(
        np.shape(t)))).astype(np.float32), tree)


def _rel_move(got, want):
    """The largest relative L2 difference of a gradient leaf."""
    return max(float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                     / np.linalg.norm(np.asarray(b, np.float64)))
               for a, b in zip(got, want))


def test_gradient_near_a_variance_tie_moves_no_more_than_the_reference(
        graph, setup, single_device_reference):
    """At a vertex of two in-neighbours that are close in a column, PNA's
    variance E[x^2] - mean^2 cancels to f32 noise, and sqrt(var + 1e-12)
    makes d std / d var up to 5e5. The reference's compiled step keeps
    mean^2 exact (an FMA), so its noise is rarely an exact 0 (a tie of
    max(var, 0), where the 5e5 multiplies the residue of the backward's
    cancellation); a port that rounds mean^2 first ties there often.
    Under a 1e-7 change of the weights the port's gradient must move no
    more than 3x as far, relative L2, as the reference's (planted pairs,
    module docstring of `_with_close_pairs`)."""
    rcfg, cfg, rparams, _ = setup
    g, pairs = _with_close_pairs(graph)
    mine, feats, part = gd.partitioned_batch_from_graph(_tg(g), D_FEAT, N_CLASSES, 2,
                                                        seed=1, device="cpu")
    rng = np.random.default_rng(5)
    feats = feats.copy()
    nl = part.n_local
    for u1, u2 in pairs:
        feats[u2] = feats[u1] * (1 + 1e-4 * rng.standard_normal(D_FEAT)).astype(np.float32)
        mine["x"][u2 // nl, u2 % nl] = torch.from_numpy(feats[u2])
    ref_batch = _global_batch(g, mine, feats)
    model = GNN(cfg, D_FEAT, N_CLASSES, device="cpu")

    def both(tree):
        want = jax.tree.leaves(single_device_reference(
            tree, jnp.asarray(feats), ref_batch)[1][0])
        params = param_tree(model.load_jax_params(np_tree(tree)))
        got = _port_value_and_grad(cfg, 2, mine, nl, params)[1]
        return [got["head"]["b"], got["head"]["w"]] + [
            lay[k] for lay in got["layers"] for k in ("b", "w")], want

    got0, want0 = both(rparams)
    assert_grads_close(dict(zip(range(len(got0)), got0)), dict(zip(range(len(want0)), want0)))
    moves = []
    for s in range(3):
        got, want = both(_perturbed(rparams, s))
        moves.append((_rel_move(got, got0), _rel_move(want, want0)))
    port, reference = max(m[0] for m in moves), max(m[1] for m in moves)
    assert port <= 3 * reference, moves
