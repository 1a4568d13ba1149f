"""The kernel probes' yardstick pinned on a small graph, so that no change
moves it unseen."""
import types

import pytest
import torch

from portbench import cost


def _graph():
    pairs = [(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 5), (5, 3), (1, 4)]
    arcs = sorted(pairs + [(b, a) for a, b in pairs], key=lambda x: (x[1], x[0]))
    src = torch.tensor([a for a, _ in arcs], dtype=torch.int32)
    dst = torch.tensor([b for _, b in arcs], dtype=torch.int32)
    ptr = torch.zeros(7, dtype=torch.int64)
    ptr[1:] = torch.cumsum(torch.bincount(dst.long(), minlength=6), 0)
    return types.SimpleNamespace(n=6, m=len(arcs), src=src, dst=dst,
                                 dst_ptr=ptr)


def test_cost_formulas_are_pinned():
    g = _graph()
    ea = torch.tensor([i % 3 != 2 for i in range(g.m)])
    assert cost.spmm_cost(g, ea, 1) == (160, 11)
    assert cost.spmm_cost(g, torch.ones(g.m, dtype=torch.bool), 2) == (232, 32)
    cand = torch.tensor([[-1, 0, -1, 0, -1, 0], [0, -1, 0, -1, 0, -1],
                         [-1, -1, 0, 0, 0, 0]], dtype=torch.int32)
    assert cost.wave_cost(g, ea, cand, 32) == (1508, 736)
    assert (cost.HBM_BW, cost.PEAK_FLOPS, cost.PEAK_FLOPS_F32) == (
        3.35e12, 989e12, 67e12)
    ms, by = cost.bound((10**9, 10**9))
    assert by == "bytes" and ms == pytest.approx(0.2985074626865672)
    ms, by = cost.bound((10**6, 10**12))
    assert by == "operations" and ms == pytest.approx(14.925373134328359)
