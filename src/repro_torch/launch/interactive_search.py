"""Interactive scenarios of paper §5.4, as the JAX package's
`examples/interactive_search.py` runs them, on the card unless
`--device cpu`: incremental search (the user revises the template; the
system reuses the candidate set and past constraint work) and exploratory
search (an over-constrained template relaxed until matches appear).

  PYTHONPATH=src python -m repro_torch.launch.interactive_search [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.exploratory import exploratory_search
from repro_torch.core.incremental import IncrementalSession
from repro_torch.core.template import Template
from repro_torch.graph import generators as gen
from repro_torch.graph.structs import Graph

# incremental: edges added one at a time (Fig. 8 flavour)
LABELS = [4, 3, 5, 3, 4]
REVISIONS = [
    [(0, 1), (1, 2), (2, 3), (3, 4)],
    [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)],
    [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (1, 3)],
]
# exploratory: a 4-clique of label 44 over a background with three planted
# label-44 squares; rare labels, so the background holds no natural label-44
# cliques and the squares match only once both chords are relaxed away
CLIQUE = ([44, 44, 44, 44], [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (1, 3)])


def planted_squares(scale: int = 10, edge_factor: int = 6,
                    n_labels: int = 50) -> Graph:
    """The exploratory scenario's graph: a random-label R-MAT background
    (`n_labels` labels, 44 among them) with three planted label-44
    squares."""
    bg = gen.rmat_graph(scale, edge_factor=edge_factor, seed=3,
                        labeler="random", n_labels=n_labels)
    square = Graph.from_undirected_pairs(
        4, [(0, 1), (1, 2), (2, 3), (3, 0)], [44, 44, 44, 44])
    return gen.planted_pattern_graph(bg, square, n_copies=3, seed=4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    g = gen.rmat_graph(11, edge_factor=8, seed=0)  # degree labels
    session = IncrementalSession(g, Template(LABELS, REVISIONS[0]),
                                 device=args.device)
    print(f"incremental search on {session.dg.device}:")
    stats = []
    for es in REVISIONS:
        _, stat = session.search(Template(LABELS, es))
        stats.append(stat)
        print(f"  m0={stat.template_edges}: {stat.matched_vertices:6d} "
              f"vertices, {stat.seconds * 1e3:7.1f} ms, "
              f"{stat.constraints_reused}/{stat.constraints_checked} "
              f"constraints reused")

    res = exploratory_search(planted_squares(), Template(*CLIQUE),
                             device=args.device)
    print("exploratory search (4-clique query, only 4-cycles exist):")
    for lv in res.levels:
        print(f"  k={lv.k}: {lv.n_variants:3d} variants, matched="
              f"{lv.matched_vertices:5d}, "
              f"{lv.avg_seconds_per_variant * 1e3:6.1f} ms/variant")
    print(f"first matches at k={res.found_level}")
    if res.found_level is None or res.found_level < 1:
        raise RuntimeError("the planted squares were not found by relaxing")
    print("OK")
    return stats, res


if __name__ == "__main__":
    main()
