"""The port's GNN training path against the JAX package, on the CPU: the
loss and every gradient of the four architectures at step 0 against
`jax.value_and_grad` of the reference's `loss_fn`, five steps of
`build_train_step` against the jitted reference step, the sampled
GraphSAGE batch (gradients through `segment_agg`'s plain backward), PNA at
the ties of its variance (degree-1 vertices, zeroed columns), the
pattern-filtered PNA of examples/pattern_gnn.py, and the `segment_agg`
backward against `jax.vjp` of the reference oracle. Inputs are made with
numpy from a seed and handed to both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core.template import Template as RTemplate  # noqa: E402
from repro.data import graphs as rdata  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.structs import Graph as RGraph  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import gnn as rgnn  # noqa: E402
from repro.optim.adamw import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.train import step as rstep_mod  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import graphs as data  # noqa: E402
from repro_torch.graph.structs import Graph  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import pattern_gnn  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.gnn import GNN  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import TrainConfig, build_train_step, init_state  # noqa: E402
from torch_train_util import (  # noqa: E402,F401
    LOSS_RTOL, assert_grads_close, assert_trees_close, few_torch_threads,
    np_tree, port_value_and_grad, run_both)

GNN_ARCHS = ("pna", "graphsage-reddit", "gin-tu", "gat-cora")
D_FEAT, N_CLASSES = 8, 4
# segment_agg's backward: sums of at most four f32 terms in another order
AGG_GRAD_TOL = dict(rtol=1e-6, atol=1e-7)
OPT = dict(lr=5e-3, weight_decay=0.1, clip_norm=1.0)
# PNA's feature gradients at variance ties, as a share of the largest
# (test_pna_gradients_split_at_variance_ties_as_jax_does)
TIE_TOL = 1e-2


def _tg(g):
    return Graph(g.n, g.src, g.dst, g.labels)


def _configs(arch):
    return rconfigs.get_arch(arch).smoke(), configs.get_arch(arch).smoke()


def _ref_value_and_grad(rcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: rgnn.loss_fn(p, rcfg, b)[0]))


def _pair(arch, d_in=D_FEAT, n_classes=N_CLASSES, seed=0, **tc_kw):
    """The reference's train state and step, and the port's model, step and
    an init state (the layout `load_jax_state` checks against)."""
    rcfg, cfg = _configs(arch)
    rtc = rstep_mod.TrainConfig(optimizer=RAdamWConfig(**OPT), warmup_steps=2,
                                total_steps=10, **tc_kw)
    tc = TrainConfig(optimizer=AdamWConfig(**OPT), warmup_steps=2,
                     total_steps=10, **tc_kw)
    rstate, _ = rstep_mod.init_state(jax.random.key(seed), rcfg, rtc,
                                     d_in=d_in, n_classes=n_classes)
    model = GNN(cfg, d_in, n_classes, device="cpu").load_jax_params(
        np_tree(rstate["params"]))
    return (rcfg, rstate, jax.jit(rstep_mod.build_train_step(rcfg, rtc)),
            model, build_train_step(model, tc), init_state(model, tc))


def _without_degree_one(g):
    """g without the in-arc of each vertex that has exactly one: at such a
    vertex PNA's variance is exactly 0 and the reference's f32 gradient
    through it is the rounding residue of a cancellation of terms scaled by
    d std / d var = 5e5, in either package (against a float64 run, the
    reference's own f32 gradient is off by 0.1% of the leaf's largest and
    the port's by 0.5%); the tie test below holds PNA there."""
    deg = np.bincount(g.dst, minlength=g.n)
    keep = deg[g.dst] != 1
    return RGraph(g.n, g.src[keep], g.dst[keep], g.labels)


def _full_graph_batches(seed=0):
    g = rgen.erdos_renyi_graph(100, 5.0, seed=seed + 1, n_labels=4)
    g = _without_degree_one(RGraph(g.n + 3, g.src, g.dst,
                                   np.concatenate([g.labels, np.zeros(3, np.int32)])))
    theirs = rdata.full_graph_batch(g, d_feat=D_FEAT, n_classes=N_CLASSES, seed=seed)
    mine = data.full_graph_batch(_tg(g), D_FEAT, N_CLASSES, seed=seed, device="cpu")
    return theirs, mine


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_loss_grads_and_five_steps_match_the_reference(arch):
    rcfg, rstate, rstep, model, step, like = _pair(arch)
    theirs, mine = _full_graph_batches()
    want_loss, want_grads = _ref_value_and_grad(rcfg)(rstate["params"], theirs)
    loss, grads = port_value_and_grad(model, gnn.loss_fn, mine)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)
    rl, pl, rstate, state = run_both(rstep, rstate, step, like,
                                     [(theirs, mine)] * 5)
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    assert rl[-1] < rl[0]
    assert_trees_close(state["params"], rstate["params"])
    assert_trees_close(state["opt"]["mu"], rstate["opt"]["mu"])
    assert int(state["step"]) == int(rstate["step"]) == 5


def _sampled_batch(seed, b=12, f1=5, f2=3, d=D_FEAT, masked=True):
    rng = np.random.default_rng(seed)
    batch = {"x_self": rng.standard_normal((b, d)),
             "x_nbr": rng.standard_normal((b, f1, d)),
             "x_nbr2": rng.standard_normal((b, f1, f2, d))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    batch["labels"] = rng.integers(0, N_CLASSES, b).astype(np.int64)
    if masked:
        batch["m_nbr"] = rng.random((b, f1)) < 0.7
        batch["m_nbr"][0] = False         # a seed without neighbours
        batch["m_nbr2"] = rng.random((b, f1, f2)) < 0.7
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_sampled_graphsage_trains_as_the_reference():
    """Gradients through the three segment_agg calls (the plain backward)
    and three steps, with padding masks."""
    rcfg, rstate, rstep, model, step, like = _pair("graphsage-reddit")
    theirs, mine = _sampled_batch(0)
    want_loss, want_grads = _ref_value_and_grad(rcfg)(rstate["params"], theirs)
    loss, grads = port_value_and_grad(model, gnn.loss_fn, mine)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)
    batches = [_sampled_batch(s) for s in range(3)]
    rl, pl, rstate, state = run_both(rstep, rstate, step, like, batches)
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    assert_trees_close(state["params"], rstate["params"])


def _near_tie(rng, d):
    """Two f32 feature rows a, b != a whose f32 variance as PNA computes it,
    fl((a^2 + b^2) / 2) - ((a + b) / 2)^2 with the square exact (an FMA, as
    XLA compiles the reference's training step), is exactly 0 in every
    column, while their true variance is not: a tie of max(var, 0) at which
    d var / d a = (a - b) / 2 is not 0. b = 2m - a, for m the nearest
    12-bit value to a, so that m^2 is an f32 value."""
    a = rng.standard_normal(d).astype(np.float32)
    b = a.copy()
    for j in range(d):
        for k in range(2000):
            aj = np.float32(a[j] * np.float32(1 + k * 1e-7))
            m = np.float32(np.ldexp(np.round(np.ldexp(aj, 11 - np.frexp(aj)[1])),
                                    np.frexp(aj)[1] - 11))
            cand = np.float32(2 * m - aj)
            sq = aj * aj + cand * cand
            mean = (aj + cand) / np.float32(2)
            if cand != aj and float(sq / np.float32(2)) - float(mean) ** 2 == 0:
                a[j], b[j] = aj, cand
                break
    assert (b != a).all()
    return a, b


def test_pna_gradients_split_at_variance_ties_as_jax_does():
    """PNA's std is sqrt(max(var, 0) + 1e-12). var is exactly 0 at a vertex
    with one in-arc, in a feature column that is 0 everywhere, and at a
    vertex whose two neighbours differ by less than f32 can resolve in the
    variance. At such a tie jnp.maximum passes half the gradient; a maximum
    that passes all of it (clamp_min) doubles the term d std / d var (5e5)
    times d var / d x, which is not 0 at the third kind: the gradient with
    respect to those neighbours' features doubles.

    One PNA layer (the smoke config's widths), so that the gradient with
    respect to the features is compared: a second layer would put ties on
    its own inputs, which the test does not control. The parameters'
    gradients, which do not pass through the ties here, are held to the
    usual tolerance; the features' gradients to TIE_TOL of the largest:
    at a tie both packages' f32 values carry the residue of cancelling
    terms of the size of 5e5 x (here up to 0.2% of the largest), while
    clamp_min's doubling moves the largest, at the near tie, by 100%."""
    rcfg, cfg = _configs("pna")
    rcfg, cfg = (dataclasses.replace(c, n_layers=1) for c in (rcfg, cfg))
    rng = np.random.default_rng(7)
    g = rgen.erdos_renyi_graph(60, 4.0, seed=5, n_labels=4)
    # 60, 61 -> 62 only: the near tie; 63 -> 64 and 65 -> 66: one in-arc
    src = np.concatenate([g.src, [60, 61, 63, 65]]).astype(np.int32)
    dst = np.concatenate([g.dst, [62, 62, 64, 66]]).astype(np.int32)
    g = RGraph(67, src, dst, np.zeros(67, np.int32))
    theirs = rdata.full_graph_batch(g, d_feat=D_FEAT, n_classes=N_CLASSES, seed=1)
    x = np.asarray(theirs["x"]).copy()
    x[60], x[61] = _near_tie(rng, D_FEAT)
    x[:, 2] = 0.0                                   # a zeroed column
    theirs["x"] = jnp.asarray(x)
    mine = data.full_graph_batch(_tg(g), D_FEAT, N_CLASSES, seed=1, device="cpu")
    mine["x"] = torch.from_numpy(x)
    deg = np.bincount(dst, minlength=g.n)
    assert (deg == 1).sum() >= 2
    params = rgnn.init(jax.random.key(0), rcfg, D_FEAT, N_CLASSES)[0]
    model = GNN(cfg, D_FEAT, N_CLASSES, device="cpu").load_jax_params(np_tree(params))

    # the graph is an argument, as in the reference's train step: XLA then
    # contracts the variance into an FMA, as the port rounds it
    def rloss(p, xx, b):
        return rgnn.loss_fn(p, rcfg, {**b, "x": xx})[0]
    want_loss, (want_grads, want_gx) = jax.jit(
        jax.value_and_grad(rloss, argnums=(0, 1)))(params, theirs["x"], theirs)
    mine["x"].requires_grad_(True)
    loss, grads = port_value_and_grad(model, gnn.loss_fn, mine)
    gx = torch.autograd.grad(gnn.loss_fn(model, mine)[0], mine["x"])[0].numpy()
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want_grads)
    want_gx = np.asarray(want_gx)
    # the near tie carries the largest feature gradients
    top = np.abs(want_gx).max()
    assert np.abs(want_gx[[60, 61]]).max() == top
    np.testing.assert_allclose(gx, want_gx, rtol=0, atol=TIE_TOL * top)


def test_pattern_filtered_pna_trains_as_the_reference():
    """The scenario of examples/pattern_gnn.py (its graph, template, config
    and optimizer): five steps, losses equal to the reference's; the port's
    launcher gives the same losses."""
    g, template = pattern_gnn.scenario()
    rg = RGraph(g.n, g.src, g.dst, g.labels)
    theirs = rdata.PatternFilteredDataset(
        rg, RTemplate([4, 5, 3], [(0, 1), (1, 2), (2, 0)]),
        d_feat=pattern_gnn.D_FEAT, n_classes=pattern_gnn.N_CLASSES, seed=0)
    rcfg = rconfigs.get_arch("pna").smoke()
    rtc = rstep_mod.TrainConfig(optimizer=RAdamWConfig(lr=5e-3, weight_decay=0.0))
    rstate, _ = rstep_mod.init_state(jax.random.key(0), rcfg, rtc,
                                     d_in=pattern_gnn.D_FEAT + template.n0,
                                     n_classes=pattern_gnn.N_CLASSES)
    rstep = jax.jit(rstep_mod.build_train_step(rcfg, rtc))
    mine = data.PatternFilteredDataset(g, template, pattern_gnn.D_FEAT,
                                       pattern_gnn.N_CLASSES, seed=0, device="cpu")
    assert mine.prune_counts == theirs.prune_counts
    cfg = configs.get_arch("pna").smoke()
    tc = TrainConfig(optimizer=AdamWConfig(lr=5e-3, weight_decay=0.0))
    model = GNN(cfg, pattern_gnn.D_FEAT + template.n0, pattern_gnn.N_CLASSES,
                device="cpu").load_jax_params(np_tree(rstate["params"]))
    rl, pl, _, _ = run_both(rstep, rstate, build_train_step(model, tc),
                            init_state(model, tc),
                            [(theirs(i), mine(i)) for i in range(5)])
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    # the launcher draws its own weights: its losses fall
    losses = pattern_gnn.main(["--device", "cpu", "--steps", "5"])
    assert len(losses) == 5 and losses[-1] < losses[0]


def _agg_case(nt, d, f, seed, ties):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nt, d, f)).astype(np.float32)
    m = rng.random((nt, d)) < 0.7
    m[0] = False                              # a row without neighbours
    if ties:
        # rounded to a coarse grid, so minima and maxima tie within rows
        x = np.round(x).astype(np.float32)
        x[1, :, :] = 0.5                      # every valid slot ties
        m[1] = True
    x[~m] = np.nan                            # must not leak
    g = rng.standard_normal((nt, 4, f)).astype(np.float32)
    return x, m, g


@pytest.mark.parametrize("nt,d,f,dtype,ties", [
    (9, 6, 5, "f32", True), (16, 10, 128, "f32", True),
    (7, 4, 3, "bf16", True), (12, 25, 33, "f32", False)])
def test_segment_agg_backward_matches_jax_vjp(nt, d, f, dtype, ties):
    x, m, g = _agg_case(nt, d, f, nt * 10 + d, ties)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jx = jnp.asarray(x, jdt)
    _, vjp = jax.vjp(lambda a: rref.segment_agg_ref(a, jnp.asarray(m)), jx)
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).to(tdt)
    got = ref.segment_agg_backward(tx, torch.from_numpy(m), torch.from_numpy(g))
    assert got.dtype == tdt and got.shape == tx.shape
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    # JAX's autodiff gives 2 x NaN x 0 = NaN in a masked NaN slot; the port
    # gives 0 there (hazard (g)); the valid slots agree
    assert np.isnan(want[~m]).all() and (got[~m] == 0).all()
    tol = dict(rtol=2 ** -7, atol=1e-6) if dtype == "bf16" else AGG_GRAD_TOL
    np.testing.assert_allclose(got[m], want[m], **tol)
    # the autograd Function of the wrapper runs the same backward on the CPU
    tx.requires_grad_(True)
    (ops.segment_agg(tx, torch.from_numpy(m)) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tx.grad.float().numpy(), got)
