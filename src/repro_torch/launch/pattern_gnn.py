"""The paper's pruning as the data-selection stage of GNN training, as the
JAX package's `examples/pattern_gnn.py` runs it, on the card unless
`--device cpu`.

  PYTHONPATH=src python -m repro_torch.launch.pattern_gnn [--device cpu]

1. Prune a labelled graph to the union of all matches of a template (the
   prune runs `bitset_spmm` and `bitset_wave`).
2. Train a PNA node classifier on the pruned subgraph, with the engine's
   per-vertex omega annotations as extra input features.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch
from repro_torch.core.template import Template
from repro_torch.data.graphs import PatternFilteredDataset
from repro_torch.graph import generators as gen
from repro_torch.graph.structs import Graph
from repro_torch.models.gnn import GNN
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, build_train_step, init_state

D_FEAT, N_CLASSES = 16, 4


def scenario():
    """(graph, template) of the example: 30 triangles planted in R-MAT."""
    bg = gen.rmat_graph(11, edge_factor=8, seed=0, labeler="random", n_labels=6)
    needle = Graph.from_undirected_pairs(3, [(0, 1), (1, 2), (2, 0)], [4, 5, 3])
    g = gen.planted_pattern_graph(bg, needle, n_copies=30, seed=2)
    return g, Template([4, 5, 3], [(0, 1), (1, 2), (2, 0)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)

    g, template = scenario()
    ds = PatternFilteredDataset(g, template, d_feat=D_FEAT, n_classes=N_CLASSES,
                                seed=0, device=args.device)
    print(f"background: n={g.n} m={g.m}; pruned to {ds.prune_counts} "
          f"(omega features: {ds.omega.shape[1]})")

    cfg = get_arch("pna").smoke()
    tc = TrainConfig(optimizer=AdamWConfig(lr=5e-3, weight_decay=0.0))
    model = GNN(cfg, D_FEAT + template.n0, N_CLASSES, device=args.device, seed=0)
    state, step = init_state(model, tc), build_train_step(model, tc)
    losses = []
    for i in range(args.steps):
        state, metrics = step(state, ds(i))
        losses.append(float(metrics["loss"]))
    print(f"PNA on the pruned graph ({model.device}): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the loss did not fall")
    print("OK")
    return losses


if __name__ == "__main__":
    main()
