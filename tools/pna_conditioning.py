#!/usr/bin/env python3
"""How far PNA's gradients move under a rounding-level change of its
weights, at full width, on the CPU; and how far a planted fault moves the
AdamW update that chip_smoke.py phase 13a holds card vs CPU.

    PYTHONPATH=src python3 tools/pna_conditioning.py [--seeds 3] [--faults]

The sharded PNA of chip_smoke.py phase 13a (pna's config, 4 layers,
d_hidden 75) on full_graph_sm's Erdos-Renyi graph (2,708 vertices, 10,556
arcs, d_feat 1,433, 7 classes) at P = 2 on the sim backend, with the
vertices of fewer than k edges stripped of them (`min_degree_core`) for
k in {2, 3}: the loss and gradients at the seed's weights, then at the
same weights times (1 + 1e-7 N(0, 1)), about one f32 rounding. Prints, per
k and perturbation, the largest relative L2 difference of a gradient leaf
and the largest entry's difference over 1e-6 + 1e-4 x its leaf's largest
|g| (the CPU tests' tolerance). `tools/pna_conditioning_reference.py`
prints the same for the JAX reference.

With --faults, on phase 13a's graph (k = PNA_MIN_DEGREE): the largest
leaf's relative L2 of phase 13a's PNA_STEPS AdamW updates against the
sound run's, for each perturbation above (the sound readings), for each
layer whose gradient is dropped and for bf16 messages in place of f32 (the
fault readings). PNA_UPDATE_REL must lie between them.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def perturbed(params, seed):
    gen = torch.Generator().manual_seed(seed)
    return cs.tree_map(lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)),
                       params)


def update(cfg, part, params, batch, drop=None):
    """phase 13a's PNA_STEPS AdamW steps (`build_distributed_pna_step`'s
    update) -> the update of each leaf; `drop` names a layer ("layers.i" or
    "head") whose gradient is set to zero, a planted fault."""
    opt = cs.AdamWConfig(**cs.PNA_OPT)
    loss_fn = cs.gd.build_distributed_pna_loss(cfg, cs.sim_prims(2, "cpu"), part.n_local)
    state = {"params": params, "opt": cs.adamw.init_state(params, opt)}
    for _ in range(cs.PNA_STEPS):
        xs = cs.tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
        loss, _ = loss_fn(xs, batch)
        grads = cs.unflatten(xs, list(torch.autograd.grad(loss, cs.leaves(xs))))
        if drop == "head":
            grads["head"] = cs.tree_map(torch.zeros_like, grads["head"])
        elif drop is not None:
            i = int(drop.split(".")[1])
            grads["layers"][i] = cs.tree_map(torch.zeros_like, grads["layers"][i])
        new, opt_state, _ = cs.adamw.update(grads, state["opt"], state["params"], opt)
        state = {"params": new, "opt": opt_state}
    return [a - b for a, b in zip(cs.leaves(state["params"]), cs.leaves(params))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--faults", action="store_true",
                    help="also the AdamW update's sound and fault readings")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    cfg = cs.get_arch("pna").CONFIG
    shape = cs.get_arch("pna").SHAPES["full_graph_sm"]
    n_classes = cs.GNN_CLASSES["full_graph_sm"]
    g0 = cs.gen.erdos_renyi_graph(shape.n_nodes, shape.n_edges / shape.n_nodes,
                                  seed=cs.SEED, n_labels=n_classes)
    params = cs.param_tree(cs.GNN(cfg, shape.d_feat, n_classes, device="cpu",
                                  seed=cs.SEED))
    for k in (2, 3):
        g = cs.min_degree_core(g0, k)
        batch, _, part = cs.gd.partitioned_batch_from_graph(
            g, shape.d_feat, n_classes, 2, seed=cs.SEED, device="cpu")

        def grads(p):
            return cs.sharded_pna_grads(cfg, cs.sim_prims(2, "cpu"), part.n_local, p,
                                        batch)[1]

        base = grads(params)
        for s in range(args.seeds):
            moved = grads(perturbed(params, s))
            print(f"k={k} ({g.m} arcs) perturbation {s}: gradients' relative L2 "
                  f"{cs.grads_rel(moved, base):.3g}, largest entry "
                  f"{cs.grads_entry_excess(moved, base):.3g}x the CPU tests' "
                  "tolerance", flush=True)
        if not args.faults or k != cs.PNA_MIN_DEGREE:
            continue
        sound = update(cfg, part, params, batch)
        for s in range(args.seeds):
            print(f"k={k} AdamW update, perturbation {s}: the largest leaf's relative L2 "
                  f"{cs.grads_rel(update(cfg, part, perturbed(params, s), batch), sound):.3g}",
                  flush=True)
        for drop in [f"layers.{i}" for i in range(cfg.n_layers)] + ["head"]:
            print(f"k={k} AdamW update, {drop}'s gradient dropped: the largest leaf's "
                  f"relative L2 {cs.grads_rel(update(cfg, part, params, batch, drop), sound):.3g}",
                  flush=True)
        bf16 = dataclasses.replace(cfg, message_dtype="bfloat16")
        print(f"k={k} AdamW update, bf16 messages in place of f32: the largest leaf's "
              f"relative L2 {cs.grads_rel(update(bf16, part, params, batch), sound):.3g}",
              flush=True)


if __name__ == "__main__":
    main()
