"""Helpers of the training tests (tests/test_torch_train_*.py,
tests/test_torch_trainer.py): the port's loss and gradients as a tree in
the JAX package's layout, and comparisons of trees against the
reference's, with the tolerances those files share; and the thread limit
that most port test files import (`few_torch_threads`)."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.models.common import nest
from repro_torch.optim.tree import leaves
from repro_torch.train.step import load_jax_state

# losses: f32 forward passes with sums in another order
LOSS_RTOL = 1e-5
# gradients: atol plus rtol of the leaf's largest |g|
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# parameters after K AdamW steps
PARAM_ATOL = 1e-5
# torch's intra-op threads while a port test file runs: its tensors are
# small, and the test workers share the machine's cores
TEST_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Imported by each port test file that runs torch in the test's
    process: TEST_THREADS torch threads for the file's tests, the worker's
    setting restored after them (the test workers share the machine's
    cores; with a thread per core in each, a file of small ops ran up to 50x
    slower under the tier-1 run than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_value_and_grad(model, loss_fn, batch, **kw):
    """(loss, gradient tree in the JAX layout) of loss_fn(model, batch)."""
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss, _ = loss_fn(model, batch, **kw)
        gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    finally:
        model.requires_grad_(False)
    flat = {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(named.items(), gs)}
    return float(loss.detach()), nest(flat, model.param_paths())


def _paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_grads_close(got, want):
    """Each leaf within GRAD_ATOL + GRAD_RTOL * max |reference leaf|."""
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for path, a, b in zip(_paths(want), g, w):
        b = np.asarray(b, np.float32)
        a = a.detach().float().numpy()
        assert a.shape == b.shape, path
        tol = GRAD_ATOL + GRAD_RTOL * float(np.abs(b).max(initial=0.0))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=path)


def assert_trees_close(got, want, atol=PARAM_ATOL):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for path, a, b in zip(_paths(want), g, w):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), rtol=0, atol=atol,
                                   err_msg=path)


def run_both(rstep, rstate, step, like, batches):
    """Steps of the reference (jitted) and of the port from the same state
    (the reference's, carried across with load_jax_state) -> (reference
    losses, port losses, reference state, port state)."""
    state = load_jax_state(np_tree(rstate), like=like)
    rl, pl = [], []
    for rb, pb in batches:
        rstate, rm = rstep(rstate, rb)
        state, m = step(state, pb)
        rl.append(float(rm["loss"]))
        pl.append(float(m["loss"]))
    return rl, pl, rstate, state
