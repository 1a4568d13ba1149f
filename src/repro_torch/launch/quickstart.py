"""Quickstart: the paper's pipeline end to end on a small graph, as the JAX
package's `examples/quickstart.py` runs it, on the card unless
`--device cpu`.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

1. Build a labeled background graph (R-MAT) and plant a needle pattern.
2. Decompose the search template into constraints (Table 2).
3. Prune via LCC + NLCC to the exact solution subgraph (100% P/R).
4. Enumerate and count all matches on the pruned graph.
"""
from __future__ import annotations

import argparse

from repro_torch.core.enumerate import enumerate_matches
from repro_torch.core.pipeline import prune
from repro_torch.core.template import Template, generate_constraints
from repro_torch.graph import generators as gen
from repro_torch.graph.structs import Graph

N_NEEDLES = 5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    # 1. background graph + planted diamond pattern
    background = gen.rmat_graph(12, edge_factor=8, seed=0, labeler="random",
                                n_labels=8)
    needle = Graph.from_undirected_pairs(
        4, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)], [9, 8, 9, 8])
    g = gen.planted_pattern_graph(background, needle, n_copies=N_NEEDLES, seed=1)
    print(f"background graph: {g.n} vertices, {g.m} arcs, {g.n_labels} labels")

    # 2. the search template and its constraint decomposition
    template = Template([9, 8, 9, 8], [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)])
    for c in generate_constraints(template, label_freq=g.label_frequency()):
        print(f"  constraint: {c.kind:6s} walk={c.walk} complete={c.complete}")

    # 3. prune
    result = prune(g, template, device=args.device)
    print(f"solution subgraph on {result.dg.device}: {result.counts()} "
          f"(pruned from n={g.n}, m={g.m})")
    for p in result.phases:
        print(f"  {p.phase:12s} {str(p.constraint or ''):42s} "
              f"V*={p.active_vertices:6d} E*={p.active_edges:7d} "
              f"{p.seconds * 1e3:7.1f} ms")

    # 4. enumerate on the pruned graph
    enum = enumerate_matches(result)
    print(f"matches: {enum.n_embeddings} embeddings, "
          f"{enum.n_distinct_vertex_sets} distinct vertex sets, "
          f"|Aut|={enum.automorphisms}")
    if enum.n_embeddings < N_NEEDLES * enum.automorphisms:
        raise RuntimeError("the planted needles were not all found")
    print("OK")
    return enum


if __name__ == "__main__":
    main()
