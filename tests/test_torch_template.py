"""Parity of the PyTorch port's template module with the JAX package's.

Constraint generation depends on the order in which the cycle basis and the
shortest paths come out, so the port's own graph routines must reproduce
networkx's. Every template named in benchmarks/*.py and 30 random templates
sampled from R-MAT graphs go through both packages from the same input.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import template as R  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro_torch.core import template as T  # noqa: E402

from conftest import sample_template_from  # noqa: E402


def _benchmark_templates():
    """(name, labels, edges) of every template the benchmarks define."""
    from benchmarks import (common, distributed_join, enumeration_compare,
                            frontier_edge_prune, incremental, multi_tenant,
                            precision_tradeoff, query_plan, rmat_distributions,
                            template_sensitivity, work_aggregation)

    out = []
    for mod, table in ((common, common.WDC_LIKE_TEMPLATES),
                       (distributed_join, distributed_join.PATTERNS),
                       (enumeration_compare, enumeration_compare.PATTERNS),
                       (frontier_edge_prune, frontier_edge_prune.PATTERNS),
                       (rmat_distributions, rmat_distributions.PATTERNS),
                       (work_aggregation, work_aggregation.PATTERNS)):
        out += [(f"{mod.__name__}:{k}", lab, e) for k, (lab, e) in table.items()]
    out += [(f"multi_tenant:{k}", lab, e) for k, lab, e in multi_tenant.TEMPLATES]
    out.append(("query_plan", query_plan.LABELS, query_plan.EDGES))
    built = dict(enumeration_compare.CLIQUES)
    built["precision_tradeoff"] = precision_tradeoff.TEMPLATE
    built.update({f"template_sensitivity:{k}": t
                  for k, t in template_sensitivity._family().items()})
    built.update({f"incremental:{i}": t
                  for i, t in enumerate(incremental._query_sequence())})
    out += [(k, t.labels.tolist(), sorted(t.edge_set)) for k, t in built.items()]
    # benchmarks/exploratory.py builds its 4-clique inside run()
    out.append(("exploratory:clique", [91, 92, 91, 92],
                [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (1, 3)]))
    return out


def _random_templates(count=30):
    out = []
    g = rgen.rmat_graph(7, edge_factor=6, seed=1, labeler="random", n_labels=3)
    seed = 0
    while len(out) < count:
        t = sample_template_from(g, 3 + seed % 6, seed=seed)
        out.append((f"random:{seed}", t.labels.tolist(), sorted(t.edge_set)))
        seed += 1
    return out


CASES = _benchmark_templates() + _random_templates()


def _both(labels, edges):
    return R.Template(labels, edges), T.Template(labels, edges)


@pytest.mark.parametrize("name,labels,edges", CASES, ids=[c[0] for c in CASES])
def test_template_matches_reference(name, labels, edges):
    rt, tt = _both(labels, edges)
    freq = rgen.rmat_graph(7, edge_factor=6, seed=2, labeler="random",
                           n_labels=10).label_frequency()
    for lf in (None, freq):
        for gp in (True, False):
            want = [c.key() for c in R.generate_constraints(
                rt, label_freq=lf, guarantee_precision=gp)]
            got = [c.key() for c in T.generate_constraints(
                tt, label_freq=lf, guarantee_precision=gp)]
            assert got == want
    assert tt.automorphisms() == rt.automorphisms()
    assert tt.symmetry_restrictions() == rt.symmetry_restrictions()
    assert tt.is_edge_monocyclic() == rt.is_edge_monocyclic()
    assert tt.multiplicity_requirements() == rt.multiplicity_requirements()
    got = [(v.labels.tolist(), sorted(v.edge_set)) for v in tt.edge_deletion_variants()]
    want = [(v.labels.tolist(), sorted(v.edge_set)) for v in rt.edge_deletion_variants()]
    assert got == want


def test_graph_routines_match_networkx_order():
    """The cycle basis and BFS paths come out in networkx's order."""
    nx = pytest.importorskip("networkx")
    for _, labels, edges in CASES:
        tt = T.Template(labels, edges)
        g = nx.Graph()
        g.add_nodes_from(range(tt.n0))
        g.add_edges_from(set((min(a, b), max(a, b)) for a, b in edges))
        assert tt._g.cycle_basis() == nx.cycle_basis(g)
        assert tt._g.all_pairs_shortest_path() == dict(nx.all_pairs_shortest_path(g))
        assert len(tt._g.biconnected_component_edges()) == len(
            list(nx.biconnected_component_edges(g)))


def test_template_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        T.Template([0, 1, 2, 3], [(0, 1), (2, 3)])  # disconnected
    with pytest.raises(ValueError):
        T.Template([0, 1], [(0, 0)])
    with pytest.raises(ValueError):
        T.Template(np.zeros(65, np.int32), [(i, i + 1) for i in range(64)])
