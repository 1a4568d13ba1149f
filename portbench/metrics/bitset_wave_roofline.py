"""`bitset_wave`'s share of its roofline at the first wave of the mix's
first cyclic template that keeps candidates after the initial LCC (a
template that arc consistency empties sends no wave): W = 32 words (1,024 sources, the first candidates of
the walk's head) and L = the cycle's length in hops, over the candidacy and
arcs that arc consistency leaves, as the initial LCC leaves them. The
benchmark builds the inputs itself (`reference.narrowed`); the frozen
`cost.wave_cost` gives the bound, the time is by CUDA events."""
import torch

from portbench import cost

SOURCES = 1024


def _cycle_walk(t):
    adj = {q: [] for q in range(len(t.labels))}
    for a, b in t.edges:
        adj[a].append(b)
        adj[b].append(a)
    if len(t.edges) != len(t.labels) or any(len(v) != 2 for v in adj.values()):
        return None
    walk, prev = [0], None
    while len(walk) <= len(t.labels):
        cur = walk[-1]
        nxt = adj[cur][0] if adj[cur][0] != prev else adj[cur][1]
        walk.append(nxt)
        prev = cur
    return walk


def probe(ctx):
    from repro_torch.kernels import ops

    g = ctx.graph
    for t in ctx.mix.templates:
        walk = _cycle_walk(t)
        if walk is None:
            continue
        cand, active = ctx.narrowed(t)
        heads = torch.nonzero(cand[walk[0]]).flatten()[:SOURCES]
        if heads.numel():
            break
    else:
        return None
    w = -(-heads.numel() // 32)
    i = torch.arange(heads.numel(), device=g.device)
    bits = torch.bitwise_left_shift(torch.ones_like(i), i % 32)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    vals = torch.zeros((g.n, w), dtype=torch.int32, device=g.device)
    vals[heads, i // 32] = bits
    hops = torch.stack([torch.where(cand[q], -1, 0) for q in walk[1:]]
                       ).to(torch.int32)
    dg = ctx.device_graph()
    ms = ctx.time_ms(lambda: ops.bitset_wave(vals, dg, active, hops))
    if ms is None:
        return None
    bound_ms, by = cost.bound(cost.wave_cost(g, active, hops, w))
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
            "template": t.name, "W": w, "L": len(walk) - 1}


def read(record):
    p = record["probes"].get("bitset_wave_roofline")
    return None if p is None else 100.0 * p["bound_ms"] / p["ms"]
