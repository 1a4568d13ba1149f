#!/usr/bin/env python3
"""The JAX reference's side of `tools/pna_conditioning.py`: how far the
reference's own PNA gradients move under a rounding-level change of its
weights, at full width, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/pna_conditioning_reference.py [--seeds 3]

The reference's single-device `gnn.loss_fn` (pna's config, 4 layers,
d_hidden 75), jitted with `jax.value_and_grad`, on the same Erdos-Renyi
graph as chip_smoke.py phase 13a (2,708 vertices, 10,556 arcs, d_feat
1,433, 7 classes, seed 3) with the vertices of fewer than k edges stripped
of them for k in {2, 3}, at the reference's own initial weights for the
seed: the gradients at those weights, then at the weights times
(1 + 1e-7 N(0, 1)). Prints the same two readings as the port's tool: the
largest relative L2 difference of a gradient leaf, and the largest entry's
difference over 1e-6 + 1e-4 x its leaf's largest |g|; then the f32
gradient's largest relative L2 difference of a leaf from the same loss in
float64 (the weights and features of the f32 run, widened). It imports the
JAX package only, nothing of the port.
"""
import argparse

import numpy as np

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)  # for the float64 run; the rest is f32

from repro import configs  # noqa: E402
from repro.data.graphs import full_graph_batch  # noqa: E402
from repro.graph import generators as gen  # noqa: E402
from repro.graph.structs import Graph  # noqa: E402
from repro.models import gnn  # noqa: E402

SEED = 3  # chip_smoke.py's SEED
N_CLASSES = 7  # full_graph_sm's classes


def min_degree_core(g, k):
    """chip_smoke.py's `min_degree_core`: g without the edges of each vertex
    of fewer than k, repeated until every vertex keeps none or at least k."""
    src, dst = g.src, g.dst
    while True:
        deg = np.bincount(dst, minlength=g.n)
        keep = (deg[dst] >= k) & (deg[src] >= k)
        if keep.all():
            return Graph(n=g.n, src=src, dst=dst, labels=g.labels)
        src, dst = src[keep], dst[keep]


def rel_l2(got, want):
    return max(float(jnp.linalg.norm(a - b) / max(float(jnp.linalg.norm(b)), 1e-30))
               for a, b in zip(got, want))


def entry_excess(got, want):
    return max(float((jnp.abs(a - b) / (1e-6 + 1e-4 * jnp.abs(b).max())).max())
               for a, b in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args(argv)
    arch = configs.get_arch("pna")
    cfg, shape = arch.CONFIG, arch.SHAPES["full_graph_sm"]
    g0 = gen.erdos_renyi_graph(shape.n_nodes, shape.n_edges / shape.n_nodes,
                               seed=SEED, n_labels=N_CLASSES)
    params, _ = gnn.init(jax.random.key(SEED), cfg, shape.d_feat, N_CLASSES)
    params = jax.tree_util.tree_map(lambda t: t.astype(jnp.float32), params)
    value_and_grad = jax.jit(jax.value_and_grad(lambda p, b: gnn.loss_fn(p, cfg, b)[0]))
    for k in (2, 3):
        g = min_degree_core(g0, k)
        batch = full_graph_batch(g, shape.d_feat, N_CLASSES, seed=SEED)

        def grads(p):
            return jax.tree_util.tree_leaves(value_and_grad(p, batch)[1])

        base = grads(params)
        for s in range(args.seeds):
            rng = np.random.default_rng(s)
            moved = grads(jax.tree_util.tree_map(
                lambda t: t * (1 + 1e-7 * jnp.asarray(
                    rng.standard_normal(t.shape), jnp.float32)), params))
            print(f"k={k} ({g.m} arcs) perturbation {s}: gradients' relative L2 "
                  f"{rel_l2(moved, base):.3g}, largest entry "
                  f"{entry_excess(moved, base):.3g}x the CPU tests' tolerance",
                  flush=True)
        wide = jax.tree_util.tree_leaves(value_and_grad(
            jax.tree_util.tree_map(lambda t: t.astype(jnp.float64), params),
            {k_: (v.astype(jnp.float64) if getattr(v, "dtype", None) == jnp.float32 else v)
             for k_, v in batch.items()})[1])
        print(f"k={k}: the f32 gradient against float64: relative L2 "
              f"{rel_l2(base, wide):.3g}", flush=True)


if __name__ == "__main__":
    main()
