"""`bitset_spmm`'s share of its roofline at the cell's first LCC sweep: the
OR-aggregation (`kernels/ops.py` `bitset_or_aggregate`) of the first
template's label candidacy, packed one bit a template vertex, over every
arc. The benchmark builds the inputs itself; the frozen `cost.spmm_cost`
gives the bound, the time is by CUDA events."""
import torch

from portbench import cost


def probe(ctx):
    from repro_torch.kernels import ops

    g, t = ctx.graph, ctx.mix.templates[0]
    w = -(-len(t.labels) // 32)
    vals = torch.zeros((g.n, w), dtype=torch.int32, device=g.device)
    for q, label in enumerate(t.labels):
        bit = (1 << (q % 32)) - ((1 << 32) if q % 32 == 31 else 0)
        vals[:, q // 32] |= torch.where(g.labels == label, bit, 0).to(torch.int32)
    active = torch.ones(g.m, dtype=torch.bool, device=g.device)
    dg = ctx.device_graph()
    ms = ctx.time_ms(lambda: ops.bitset_or_aggregate(vals, dg, active))
    if ms is None:
        return None
    bound_ms, by = cost.bound(cost.spmm_cost(g, active, w))
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": by}


def read(record):
    p = record["probes"].get("bitset_spmm_roofline")
    return None if p is None else 100.0 * p["bound_ms"] / p["ms"]
