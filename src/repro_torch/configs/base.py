"""Config dataclasses and input-shape descriptors of the GNN family.

One module per architecture lives next to this file; each exposes
  CONFIG  — the exact published configuration
  SHAPES  — the arch's own input-shape set
  smoke() — a reduced same-family config for CPU tests

The GNN fields of the JAX package's `configs/base.py` that the port reads.
Left out: the knobs of its sharded message passing (`distributed`,
`message_dtype`), which the one-device port does not have; `sample_sizes`,
since the sampled path takes its fanouts from `ShapeSpec.fanout`; and
`dtype`, since the port builds its models in f32 only. The LM and recsys
families come with their slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                 # "pna" | "graphsage" | "gin" | "gat"
    n_layers: int
    d_hidden: int
    n_heads: int = 1           # gat
    aggregators: Tuple[str, ...] = ("mean",)
    scalers: Tuple[str, ...] = ("identity",)
    eps_learnable: bool = False          # gin


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One cell: what program to run and with which sizes (GNN fields)."""

    name: str
    step: str                  # "train" | ...
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train", n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train", n_nodes=232965, n_edges=114615892,
        batch_nodes=1024, fanout=(15, 10), d_feat=602,
    ),
    "ogb_products": ShapeSpec("ogb_products", "train", n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": ShapeSpec("molecule", "train", n_nodes=30, n_edges=64, n_graphs=128, d_feat=16),
}

# classes per GNN shape (the JAX package's launch/cells.py)
GNN_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47, "molecule": 2}
