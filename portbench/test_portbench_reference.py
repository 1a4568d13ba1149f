"""The plain reference against brute-force enumeration on small graphs:
cycles, paths, stars, repeated labels, and the tori and unrolled cycle of
the paper's Fig. 2; and the generator's graphs."""
import itertools

import numpy as np
import pytest
import torch

from portbench import graphgen, reference


def _arcs(n, pairs, labels):
    pairs = np.asarray(sorted({(min(a, b), max(a, b)) for a, b in pairs
                               if a != b}), dtype=np.int64).reshape(-1, 2)
    arcs = np.concatenate([pairs, pairs[:, ::-1]])
    order = np.lexsort((arcs[:, 0], arcs[:, 1]))
    return (n, torch.tensor(arcs[order, 0]), torch.tensor(arcs[order, 1]),
            torch.tensor(labels, dtype=torch.int32))


def _brute(n, src, dst, labels, tl, te):
    adj = set(zip(src.tolist(), dst.tolist()))
    n0 = len(tl)
    cands = [np.flatnonzero(labels.numpy() == l) for l in tl]
    omega, arcs, count = set(), set(), 0
    for combo in itertools.product(*cands):
        if len(set(combo)) < n0:
            continue
        if all((combo[a], combo[b]) in adj for a, b in te):
            count += 1
            omega |= {combo[q] * n0 + q for q in range(n0)}
            for a, b in te:
                arcs |= {combo[a] * n + combo[b], combo[b] * n + combo[a]}
    return (np.array(sorted(omega), np.int64),
            np.array(sorted(arcs), np.int64), count)


def _assert_exact(g, tl, te, block_rows=1 << 24):
    n, src, dst, labels = g
    sol = reference.solution(n, src, dst, labels, tl, te,
                             block_rows=block_rows)
    omega, arcs, count = _brute(n, src, dst, labels, tl, te)
    np.testing.assert_array_equal(sol.omega_keys, omega)
    np.testing.assert_array_equal(sol.arc_keys, arcs)
    if sol.count is not None:
        assert sol.count == count
    local = reference.local_answer(n, src, dst, labels, tl, te)
    assert set(omega) <= set(local.omega_keys)
    assert set(arcs) <= set(local.arc_keys)
    return sol, count


TEMPLATES = {
    "triangle": ([0, 1, 2], [(0, 1), (1, 2), (2, 0)]),
    "square": ([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    "path": ([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3)]),
    "star": ([1, 0, 2, 3], [(0, 1), (0, 2), (0, 3)]),
    "counted-triangle": ([0, 0, 1], [(0, 1), (1, 2), (2, 0)]),
    "repeated-square": ([0, 1, 0, 1], [(0, 1), (1, 2), (2, 3), (3, 0)]),
    "repeated-path": ([0, 1, 2, 0], [(0, 1), (1, 2), (2, 3)]),
    "diamond": ([0, 1, 2, 3], [(0, 1), (1, 2), (2, 0), (1, 3), (3, 2)]),
}


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_reference_equals_brute_force_on_random_graphs(name):
    tl, te = TEMPLATES[name]
    rng = np.random.default_rng(7)
    total = 0
    for _ in range(12):
        n = 13
        g = _arcs(n, rng.integers(0, n, (34, 2)).tolist(),
                  rng.integers(0, 4, n))
        _, count = _assert_exact(g, tl, te, block_rows=5)
        total += count
    assert total > 0  # the cases hold matches


def test_fig2_unrolled_cycle_has_no_triangle():
    g = _arcs(6, [(i, (i + 1) % 6) for i in range(6)], [0, 1, 2, 0, 1, 2])
    sol, count = _assert_exact(g, [0, 1, 2], [(0, 1), (1, 2), (2, 0)])
    assert count == 0 and sol.omega_keys.size == 0
    # a local check keeps every vertex: the case LCC alone gets wrong
    local = reference.local_answer(*g, [0, 1, 2], [(0, 1), (1, 2), (2, 0)])
    assert local.omega_keys.size == 6


def _torus(rows, cols):
    vid = np.arange(rows * cols).reshape(rows, cols)
    return [(vid[r, c], vid[r, (c + 1) % cols]) for r in range(rows)
            for c in range(cols)] + [(vid[r, c], vid[(r + 1) % rows, c])
                                     for r in range(rows) for c in range(cols)]


def test_fig2_torus():
    g = _arcs(12, _torus(4, 3), np.tile([0, 1, 2, 3], 3))
    _assert_exact(g, [0, 1, 2, 3], [(0, 1), (1, 2), (2, 0), (1, 3), (3, 2)])
    _assert_exact(g, [0, 1, 2, 3], [(0, 1), (1, 2), (2, 3), (3, 0)])


def test_reference_on_an_rmat_graph():
    g = graphgen.rmat_graph(9, 16, seed=3, device="cpu")
    sol = reference.solution(g.n, g.src, g.dst, g.labels, [3, 4, 5],
                             [(0, 1), (1, 2), (2, 0)])
    omega, arcs, count = _brute(g.n, g.src, g.dst, g.labels, [3, 4, 5],
                                [(0, 1), (1, 2), (2, 0)])
    assert count > 0 and sol.count == count
    np.testing.assert_array_equal(sol.arc_keys, arcs)


def test_generator_is_deterministic_for_a_seed():
    a = graphgen.rmat_graph(10, 8, seed=2**31 + 5, device="cpu")
    b = graphgen.rmat_graph(10, 8, seed=2**31 + 5, device="cpu")
    c = graphgen.rmat_graph(10, 8, seed=2**31 + 6, device="cpu")
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.labels, b.labels),
                 (a.dst_ptr, b.dst_ptr)):
        assert torch.equal(x, y)
    assert not (a.m == c.m and torch.equal(a.src, c.src))


def test_the_run_seed_permutes_the_vertices():
    a = graphgen.rmat_graph(10, 16, seed=1, device="cpu", permute_seed=5)
    b = graphgen.rmat_graph(10, 16, seed=1, device="cpu", permute_seed=6)
    assert a.m == b.m and not torch.equal(a.src, b.src)
    assert torch.equal(torch.sort(a.labels).values, torch.sort(b.labels).values)
    # the same matches, under other vertex ids
    tl, te = [4, 5, 6], [(0, 1), (1, 2), (2, 0)]
    sa = reference.solution(a.n, a.src, a.dst, a.labels, tl, te)
    sb = reference.solution(b.n, b.src, b.dst, b.labels, tl, te)
    assert sa.count == sb.count > 0
    assert sa.arc_keys.size == sb.arc_keys.size
    assert not np.array_equal(sa.arc_keys, sb.arc_keys)


def test_generator_builds_a_simple_undirected_dst_sorted_graph():
    g = graphgen.rmat_graph(10, 16, seed=1, device="cpu")
    src, dst = g.src.long(), g.dst.long()
    keys = dst * g.n + src
    assert torch.all(keys[1:] > keys[:-1])            # sorted, no duplicates
    assert not torch.any(src == dst)                  # no self loops
    rev = torch.sort(src * g.n + dst).values
    assert torch.equal(rev, keys)                     # both arcs of each edge
    deg = g.dst_ptr[1:] - g.dst_ptr[:-1]
    assert torch.equal(deg, torch.bincount(dst, minlength=g.n))
    want = np.ceil(np.log2(deg.numpy() + 1)).astype(np.int32)
    np.testing.assert_array_equal(g.labels.numpy(), want)
    # Graph500's skew: a few vertices hold many arcs
    assert int(deg.max()) > 20 * float(deg.float().mean())
