#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and `nvcc`:

1. device   prints the card and its power limit, builds the CUDA kernels
            from `src/repro_torch/kernels/csrc/` and prints the build time;
2. kernels  holds `bitset_spmm` and `bitset_wave` against their plain
            PyTorch versions on the card (bit-exact), then times both at the
            shapes of the R-MAT scale-20 main path beside their bounds;
3. parity   runs prune + count on R-MAT scale 14 on the card (kernels) and
            on the CPU (plain versions) and requires identical omega, edge
            mask, phase trajectory and match count; the three NLCC routes on
            the card must agree too;
4. full     the main path at R-MAT Graph500 scale 20 (edge factor 16, degree
            labels, seed 3): prune and count-mode enumeration on the card,
            with per-phase seconds, peak device memory and the launch count
            of each prune kernel, which must be nonzero; then the
            planted-needle quickstart scenario.
5. GNN      the GNN inference path (GraphSAGE's sampled forward):
            a. `segment_agg` against its plain version on the card over
               NT x D x F in {1,7,16,33} x {1,4,10,25} x {1,3,128,602}, f32
               and bf16, with all-False rows and NaN / Inf in masked slots:
               min and max bit-exact, sum and sum of squares within
               rtol = atol = 1e-5;
            b. its times and the plain version's beside the bound at the
               three shapes of the full-width forward;
            c. card against CPU, logits within rtol = atol = 1e-4: the
               graphsage-reddit config on a small graph (one batch of 64
               seeds), and the pattern-filtered PNA scenario of
               examples/pattern_gnn.py (identical pruned graph and omega);
            d. full width: graphsage-reddit on the minibatch_lg shape
               (1024 seeds, fanouts 15-10, 602 features, 41 classes) over an
               Erdos-Renyi graph of the shape's size (232,965 vertices,
               114,615,892 arcs), the feature table resident on the card:
               ten batches with host sampling and device seconds, the loss,
               peak device memory, and `segment_agg` launches, which must be
               3 per batch; the first batch's logits equal a CPU forward;
               then device time by kernel and the device's busy share over
               three more batches (torch.profiler).

The line before the last is a JSON object listing each kernel with its
launches on its path's run, its error against the plain version and its
times; the last line is {"ok": true, "device": {...}}. Without a CUDA device,
or when any check fails, the script exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import GNN_CLASSES  # noqa: E402
from repro_torch.core import nlcc  # noqa: E402
from repro_torch.core.enumerate import count_matches, enumerate_matches  # noqa: E402
from repro_torch.core.lcc import TemplateDev, lcc_fixpoint  # noqa: E402
from repro_torch.core.pipeline import prune  # noqa: E402
from repro_torch.core.state import init_state, pack_bits  # noqa: E402
from repro_torch.core.template import Template, generate_constraints  # noqa: E402
from repro_torch.data.graphs import PatternFilteredDataset, SampledBatchStream  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structs import DeviceGraph, Graph  # noqa: E402
from repro_torch.kernels import build, ops, ref, registry  # noqa: E402
from repro_torch.models.gnn import GNN  # noqa: E402

SEED = 3
EDGE_FACTOR = 16
SCALE_PARITY = 14
SCALE_FULL = 20
# The main path's template: the unique-label 6-cycle "hex-unique" of
# benchmarks/frontier_edge_prune.py. RMAT-2 (benchmarks/rmat_distributions.py)
# is pruned empty by the first LCC on degree-labelled R-MAT, so no NLCC wave
# would run; phase 4 reports that too.
HEX = ([3, 4, 5, 6, 7, 8], [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)])
RMAT2 = ([2, 3, 4, 5, 6, 7, 1],
         [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (1, 6)])
WAVE = 1024
DEVICE = "cuda"
# Phase 5: graphsage-reddit on the minibatch_lg shape, over an Erdos-Renyi
# graph of that shape's size (Reddit: 232,965 vertices, 114,615,892 arcs).
GNN_ARCH = "graphsage-reddit"
GNN_SHAPE = "minibatch_lg"
GNN_BATCHES = 10
GNN_PARITY_N = 3000
GNN_PARITY_SEEDS = 64
AGG_TOL = 1e-5   # segment_agg sums: f32, another order of the same terms
LOGIT_TOL = 1e-4  # forward passes: f32 matmuls in another order
# H100 SXM (NVIDIA data sheet, 700 W): device memory rate, and the float32
# rate outside the tensor cores, taken as the peak for 32-bit bitwise ops.
HBM_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg=""):
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers
def random_words(rng, n, w, device):
    """int32[n, w] words drawn over all 32 bits (bit 31 included)."""
    raw = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    return torch.from_numpy(raw.view(np.int32)).to(device)


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def time_ms(fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events, after one
    warm-up call."""
    fn()
    sync()
    if DEVICE != "cuda":  # a rehearsal on the CPU: no device time exists
        return float("nan")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spmm_cost(dg, edge_active, w):
    """(bytes, operations) that one bitset_spmm call must at least spend on
    these inputs, each input read once: the active flag of every arc, the
    source of every active arc, the dst offsets, each vals row an active arc
    reads, and n rows written; one OR per word per active arc."""
    active = int(edge_active.sum())
    rows = int(torch.unique(dg.src[edge_active]).numel())
    nbytes = dg.m + active * 4 + (dg.n + 1) * 8 + rows * 4 * w + dg.n * 4 * w
    return nbytes, active * w


def wave_cost(dg, edge_active, cand, w):
    """(bytes, operations) that the L hops of bitset_wave must at least spend
    on these inputs, each input read once: the L candidacy rows, the offsets
    and in-arcs (active flag, and source if active) of every vertex that is a
    candidate in some hop, the vals rows the first hop reads, and the [n, W]
    output written once. The frontiers between hops are the function's own
    and need not leave the chip, so they count no bytes. Operations: per hop,
    one OR per word per active in-arc of a candidate and one AND per word per
    candidate."""
    live = cand != 0                                        # bool[L, n]
    any_live = live.any(0)
    deg = dg.dst_ptr[1:] - dg.dst_ptr[:-1]
    active_in = torch.bincount(dg.dst[edge_active].long(), minlength=dg.n)
    first = edge_active & live[0][dg.dst.long()]
    rows = int(torch.unique(dg.src[first]).numel())
    nbytes = (dg.n * 4 * w + cand.numel() * 4 + int(any_live.sum()) * 16
              + int(deg[any_live].sum()) + int(active_in[any_live].sum()) * 4
              + rows * 4 * w)
    ops = sum((int(active_in[live[r]].sum()) + int(live[r].sum())) * w
              for r in range(cand.shape[0]))
    return nbytes, ops


def bound(cost):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    nbytes, ops = cost
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trajectory(res):
    return [(p.phase, p.active_vertices, p.active_edges, p.omega_bits)
            for p in res.phases]


def first_wave_inputs(dg, template, state, label_freq):
    """The packed frontier and candidacy words of the main path's first NLCC
    wave (first walk of the first cycle constraint) from `state`."""
    c = next(c for c in generate_constraints(template, label_freq=label_freq)
             if c.kind == "cycle")
    walk = nlcc.expand_walks(c)[0]
    omega = state.omega
    sources = np.flatnonzero(omega[:, walk[0]].cpu().numpy())
    check(sources.size > 0, "no wave sources after the initial LCC")
    ids, _ = next(nlcc.wave_batches(sources, WAVE))
    ids = torch.from_numpy(ids.astype(np.int64)).to(omega.device)
    safe = ids.clamp(0, dg.n - 1)
    cand_bool = torch.stack([omega[:, q] for q in walk], dim=0)
    packed = nlcc._initial_frontier_packed(dg.n, cand_bool[0], ids, safe)
    cand = torch.where(cand_bool[1:], -1, 0).to(torch.int32)
    return packed, cand


# ------------------------------------------------------------------- phases
def phase_device():

    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"torch.cuda.get_device_name: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name})")
    for line in build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return name


def phase_kernels_small():
    """Bit-exact kernel-vs-plain checks on the card at small shapes."""
    log("== phase 2a: kernels vs plain versions (bit-exact)")
    g0 = gen.rmat_graph(12, edge_factor=8, seed=SEED)
    # 100 extra vertices with no arcs at all
    g = Graph(g0.n + 100, g0.src, g0.dst,
              np.concatenate([g0.labels, np.zeros(100, np.int32)]))
    dev = DEVICE
    dg = DeviceGraph.from_host(g, dev)
    rng = np.random.default_rng(SEED)
    n_checks = 0
    some = torch.from_numpy(rng.random(dg.m) < 0.6).to(dev)
    none = torch.zeros(dg.m, dtype=torch.bool, device=dev)
    for w in (1, 2, 4, 32):
        vals = random_words(rng, dg.n, w, dev)
        check(bool((vals < 0).any()), "test words must set bit 31")
        for ea in (some, none):
            got = ops.bitset_or_aggregate(vals, dg, ea)
            want = ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, ea)
            sync()
            check(torch.equal(got, want), f"bitset_spmm W={w} differs")
            n_checks += 1
        for hops in (0, 1, 3, 6):
            cand_np = np.where(rng.random((hops, dg.n)) < 0.8, -1, 0).astype(np.int32)
            cand = torch.from_numpy(cand_np).to(dev)
            for ea in (some, none):
                got = ops.bitset_wave(vals, dg, ea, cand)
                want = ref.bitset_wave_ref(vals, dg.src, dg.dst, dg.n, ea, cand)
                sync()
                check(torch.equal(got, want),
                      f"bitset_wave W={w} L={hops} differs")
                n_checks += 1
    check(not ops.bitset_or_aggregate(
        random_words(rng, dg.n, 2, dev), dg, some)[-100:].any(),
        "vertices without in-arcs must aggregate to 0")
    log(f"{n_checks} kernel/plain comparisons bit-exact "
        f"(n={dg.n}, m={dg.m}, W in 1/2/4/32, L in 0/1/3/6)")


def phase_kernel_timing(dg, template, label_freq):
    """Kernel, plain and bound times at the scale-20 main-path shapes."""
    log("== phase 2b: kernel times at the scale-20 main-path shapes")
    state0 = init_state(dg, template)
    # LCC sweep input: omega packed to W = 1 word, every arc active
    vals = pack_bits(state0.omega)
    ea0 = state0.edge_active
    out_k = ops.bitset_or_aggregate(vals, dg, ea0)
    out_p = ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, ea0)
    spmm = {
        "max_abs_err": max_abs_err(out_k, out_p),
        "ms": time_ms(lambda: ops.bitset_or_aggregate(vals, dg, ea0), 20),
        "plain_ms": time_ms(
            lambda: ref.bitset_spmm_ref(vals, dg.src, dg.dst, dg.n, ea0), 2),
    }
    spmm["bound_ms"], spmm["bound_by"] = bound(spmm_cost(dg, ea0, vals.shape[1]))
    check(spmm["max_abs_err"] == 0, "bitset_spmm differs at scale 20")
    log(f"bitset_spmm  W={vals.shape[1]} n={dg.n} m={dg.m}: "
        f"{spmm['ms']:.4f} ms kernel, {spmm['plain_ms']:.4f} ms plain, "
        f"{spmm['bound_ms']:.4f} ms bound ({spmm['bound_by']})")

    # NLCC wave input: the first wave after the initial LCC fixpoint
    state1 = lcc_fixpoint(dg, TemplateDev(template, dg.device), state0,
                          route=registry.ROUTE_PACKED)
    packed, cand = first_wave_inputs(dg, template, state1, label_freq)
    ea1 = state1.edge_active
    out_k = ops.bitset_wave(packed, dg, ea1, cand)
    out_p = ref.bitset_wave_ref(packed, dg.src, dg.dst, dg.n, ea1, cand)
    wave = {
        "max_abs_err": max_abs_err(out_k, out_p),
        "ms": time_ms(lambda: ops.bitset_wave(packed, dg, ea1, cand), 20),
        "plain_ms": time_ms(lambda: ref.bitset_wave_ref(
            packed, dg.src, dg.dst, dg.n, ea1, cand), 2),
    }
    wave["bound_ms"], wave["bound_by"] = bound(
        wave_cost(dg, ea1, cand, packed.shape[1]))
    check(wave["max_abs_err"] == 0, "bitset_wave differs at scale 20")
    live = [int((cand[r] != 0).sum()) for r in range(cand.shape[0])]
    log(f"bitset_wave  W={packed.shape[1]} L={cand.shape[0]} "
        f"active arcs={int(ea1.sum())} candidates per hop={live}: "
        f"{wave['ms']:.4f} ms kernel, {wave['plain_ms']:.4f} ms plain, "
        f"{wave['bound_ms']:.4f} ms bound ({wave['bound_by']})")
    return {"bitset_spmm": spmm, "bitset_wave": wave}


def phase_parity():
    """Scale-14 prune + count: card (kernels) against CPU (plain versions),
    and the three NLCC routes on the card."""
    log(f"== phase 3: R-MAT scale {SCALE_PARITY}, card vs CPU")
    g = gen.rmat_graph(SCALE_PARITY, edge_factor=EDGE_FACTOR, seed=SEED)
    tmpl = Template(*HEX)
    runs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        res = prune(g, tmpl, device=dev)
        cnt = count_matches(res)
        runs[dev] = (res, cnt)
        log(f"{dev}: {time.perf_counter() - t0:.2f} s, {res.counts()}, "
            f"matches {cnt.n_embeddings}, routes {res.stats['dispatch_routes']}, "
            f"lcc_iterations {res.stats['lcc_iterations']}")
    (rc, cc), (rp, cp) = runs[DEVICE], runs["cpu"]
    check(np.array_equal(rc.omega, rp.omega), "omega differs card vs CPU")
    check(np.array_equal(rc.edge_mask, rp.edge_mask), "edge mask differs")
    check(trajectory(rc) == trajectory(rp), "phase trajectory differs")
    check(rc.stats["lcc_iterations"] == rp.stats["lcc_iterations"],
          "lcc_iterations differ")
    check(cc.n_embeddings == cp.n_embeddings, "match count differs")
    check(rc.stats.get("dispatch_routes") == {"prune.lcc": "packed",
                                              "prune.nlcc": "fused"},
          "the default routes must be the kernels' routes")
    for route in ("packed", "unpacked"):
        r2 = prune(g, tmpl, device=DEVICE, nlcc_route=route)
        check(np.array_equal(r2.omega, rc.omega)
              and np.array_equal(r2.edge_mask, rc.edge_mask),
              f"NLCC route {route} differs from fused on the card")
    sync()
    log(f"card == CPU: omega, edge mask, {len(rc.phases)}-phase trajectory, "
        f"lcc_iterations, match count; NLCC fused == packed == unpacked")


def phase_full(g, dg):
    """The main path at full size, with launch counts read around it."""
    log(f"== phase 4: R-MAT scale {SCALE_FULL} main path on the card")
    tmpl = Template(*HEX)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    res = prune(dg, tmpl, label_freq=g.label_frequency())
    t_prune = time.perf_counter() - t0
    t1 = time.perf_counter()
    cnt = count_matches(res)
    sync()
    t_count = time.perf_counter() - t1
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    for p in res.phases:
        log(f"  {p.phase:11s} {str(p.constraint or ''):28s} {p.seconds:9.4f} s "
            f"V*={p.active_vertices:8d} E*={p.active_edges:9d} "
            f"waves={p.extra.get('nlcc_waves', '-')}")
    log(f"prune {t_prune:.3f} s, count {t_count:.3f} s; {res.counts()}, "
        f"matches {cnt.n_embeddings} (|Aut|={cnt.automorphisms}), "
        f"lcc_iterations {res.stats['lcc_iterations']}, "
        f"routes {res.stats['dispatch_routes']}")
    log(f"max_memory_allocated {peak / 2**30:.3f} GiB; launches {launches}")
    for name in registry.PRUNE_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(cnt.n_embeddings > 0, "the scale-20 main path found no match")

    r2 = prune(dg, Template(*RMAT2), label_freq=g.label_frequency())
    log(f"RMAT-2 on the same graph: after the first LCC V*="
        f"{r2.phases[0].active_vertices} E*={r2.phases[0].active_edges}; "
        f"final {r2.counts()}")

    # quickstart: planted diamond needles in a random-label R-MAT background
    background = gen.rmat_graph(12, edge_factor=8, seed=0, labeler="random",
                                n_labels=8)
    needle = Graph.from_undirected_pairs(
        4, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)], [9, 8, 9, 8])
    gq = gen.planted_pattern_graph(background, needle, n_copies=5, seed=1)
    tq = Template([9, 8, 9, 8], [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)])
    rq = prune(gq, tq, device=DEVICE)
    eq = enumerate_matches(rq)
    log(f"quickstart: {rq.counts()}, {eq.n_embeddings} embeddings, "
        f"|Aut|={eq.automorphisms}")
    check(eq.n_embeddings >= 5 * eq.automorphisms, "planted needles missing")
    return launches

# ------------------------------------------------------------- phase 5: GNN
def gnn_setup():
    """(config, shape, classes) of the GNN path."""
    mod = get_arch(GNN_ARCH)
    return mod.CONFIG, mod.SHAPES[GNN_SHAPE], GNN_CLASSES[GNN_SHAPE]


def agg_shapes(shape, cfg):
    """The [NT, D, F] of the three segment_agg calls of one sampled forward:
    second-hop neighbours, first-hop neighbours, layer-1 representations."""
    b, (f1, f2) = shape.batch_nodes, shape.fanout
    return [(b * f1, f2, shape.d_feat), (b, f1, shape.d_feat),
            (b, f1, cfg.d_hidden)]


def agg_close(got, want):
    """min and max bit-exact, sum and sum of squares within AGG_TOL."""
    return (torch.equal(got[:, 1:3], want[:, 1:3])
            and torch.allclose(got[:, 0::3], want[:, 0::3],
                               rtol=AGG_TOL, atol=AGG_TOL))


def phase_segment_agg_small():
    """segment_agg against its plain version on the card."""
    log("== phase 5a: segment_agg vs its plain version")
    rng = np.random.default_rng(SEED)
    dev = DEVICE
    n_checks = 0
    for nt in (1, 7, 16, 33):
        for d in (1, 4, 10, 25):
            for f in (1, 3, 128, 602):
                for dtype in (torch.float32, torch.bfloat16):
                    x = rng.standard_normal((nt, d, f), dtype=np.float32)
                    m = rng.random((nt, d)) < 0.7
                    m[nt // 2] = False            # a row with no neighbour
                    x[~m] = np.nan if n_checks % 2 else np.inf  # must not leak
                    xt = torch.from_numpy(x).to(dev).to(dtype)
                    mt = torch.from_numpy(m).to(dev)
                    got = ops.segment_agg(xt, mt)
                    want = ref.segment_agg_ref(xt, mt)
                    sync()
                    check(agg_close(got, want) and bool(torch.isfinite(got).all()),
                          f"segment_agg [{nt},{d},{f}] {dtype} differs")
                    n_checks += 1
    # base pointers that are not aligned to a vector load (V falls to 1)
    for f, dtype in ((128, torch.float32), (602, torch.bfloat16)):
        flat = torch.randn(7 * 5 * f + 1, device=dev).to(dtype)
        xt = flat[1:].view(7, 5, f)
        mt = torch.from_numpy(rng.random((7, 5)) < 0.7).to(dev)
        check(agg_close(ops.segment_agg(xt, mt), ref.segment_agg_ref(xt, mt)),
              f"segment_agg on an unaligned [7,5,{f}] {dtype} view differs")
        n_checks += 1
    try:
        ops.segment_agg(torch.ones((2, 3, 4), device=dev, requires_grad=True),
                        torch.ones((2, 3), dtype=torch.bool, device=dev))
    except RuntimeError:
        pass
    else:
        check(DEVICE != "cuda", "segment_agg ran on an input that requires grad")
    log(f"{n_checks} kernel/plain comparisons: min/max bit-exact, sum/sumsq "
        f"within {AGG_TOL}, NaN/Inf in masked slots did not leak")


def segment_agg_cost(nt, d, f, elem_bytes):
    """(bytes, operations) of one segment_agg call: feats and mask read
    once, the f32 [NT, 4, F] output written once; per valid element an
    add, a min, a max, a multiply and an add."""
    return (nt * d * f * elem_bytes + nt * d + nt * 4 * f * 4,
            5 * nt * d * f)


def phase_segment_agg_timing(shapes):
    """Kernel, plain and bound times at the full-width forward's shapes
    (f32, every neighbour valid, as the sampled forward calls it)."""
    log("== phase 5b: segment_agg times at the full-width forward's shapes")
    gen_t = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for nt, d, f in shapes:
        x = torch.randn((nt, d, f), generator=gen_t, device=DEVICE)
        m = torch.ones((nt, d), dtype=torch.bool, device=DEVICE)
        got, want = ops.segment_agg(x, m), ref.segment_agg_ref(x, m)
        check(agg_close(got, want), f"segment_agg [{nt},{d},{f}] differs")
        t = {"shape": [nt, d, f],
             "max_abs_err": float((got - want).abs().max()),
             "ms": time_ms(lambda: ops.segment_agg(x, m), 20),
             "device_ms": kernel_device_ms(lambda: ops.segment_agg(x, m), 20,
                                           "segment_agg_kernel"),
             "plain_ms": time_ms(lambda: ref.segment_agg_ref(x, m), 5)}
        cost = segment_agg_cost(nt, d, f, x.element_size())
        t["bound_ms"], t["bound_by"] = bound(cost)
        log(f"segment_agg [{nt},{d},{f}] f32: {t['ms']:.4f} ms kernel "
            f"({t['device_ms']:.4f} ms on the device, profiler), "
            f"{t['plain_ms']:.4f} ms plain, {t['bound_ms']:.4f} ms bound "
            f"({t['bound_by']}, {cost[0] / 1e6:.1f} MB), "
            f"{t['ms'] / t['bound_ms']:.2f}x bound, max_abs_err "
            f"{t['max_abs_err']:.3g}")
        rows.append(t)
        del x, m, got, want
    return rows


def gnn_features(n, d_feat, n_classes, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d_feat), dtype=np.float32),
            rng.integers(0, n_classes, n))


def logits_close(a, b):
    return torch.allclose(a.cpu(), b.cpu(), rtol=LOGIT_TOL, atol=LOGIT_TOL)


def phase_gnn_parity(shape=None):
    """Card against CPU: the sampled graphsage-reddit forward on a small
    graph, and the pattern-filtered PNA scenario of examples/pattern_gnn.py."""
    cfg, full_shape, n_classes = gnn_setup()
    shape = shape or full_shape
    log(f"== phase 5c: GNN card vs CPU ({cfg.name}, {GNN_PARITY_SEEDS} seeds; "
        f"pattern-filtered PNA)")
    g = gen.erdos_renyi_graph(GNN_PARITY_N, 20.0, seed=SEED)
    feats, labels = gnn_features(g.n, shape.d_feat, n_classes, SEED)
    out = {}
    for dev in (DEVICE, "cpu"):
        stream = SampledBatchStream(g, feats, labels, shape.fanout,
                                    GNN_PARITY_SEEDS, seed=SEED, device=dev)
        batch = stream(0)
        model = GNN(cfg, shape.d_feat, n_classes, device=dev, seed=SEED)
        logits = model.forward_sampled(batch)
        out[dev] = (batch, logits, float(model.loss(batch, logits)))
    (bc, lc, lossc), (bp, lp, lossp) = out[DEVICE], out["cpu"]
    for k in bp:
        check(torch.equal(bc[k].cpu(), bp[k]), f"sampled batch {k} differs")
    check(logits_close(lc, lp), "sampled GraphSAGE logits differ card vs CPU")
    log(f"graphsage-reddit sampled forward: batch identical, logits "
        f"{list(lc.shape)} max |card - CPU| {float((lc.cpu() - lp).abs().max()):.3g}, "
        f"loss {lossc:.6f} (CPU {lossp:.6f})")

    bg = gen.rmat_graph(11, edge_factor=8, seed=0, labeler="random", n_labels=6)
    needle = Graph.from_undirected_pairs(3, [(0, 1), (1, 2), (2, 0)], [4, 5, 3])
    gp = gen.planted_pattern_graph(bg, needle, n_copies=30, seed=2)
    template = Template([4, 5, 3], [(0, 1), (1, 2), (2, 0)])
    pna = get_arch("pna").smoke()
    runs = {}
    for dev in (DEVICE, "cpu"):
        ds = PatternFilteredDataset(gp, template, 16, 4, seed=0, device=dev)
        model = GNN(pna, 16 + template.n0, 4, device=dev, seed=0)
        logits = model(ds(0))
        runs[dev] = (ds, logits, float(model.loss(ds(0), logits)))
    (dc, lc, lossc), (dp, lp, lossp) = runs[DEVICE], runs["cpu"]
    check(dc.prune_counts == dp.prune_counts and dc.pruned.n == dp.pruned.n
          and np.array_equal(dc.pruned.src, dp.pruned.src)
          and np.array_equal(dc.pruned.dst, dp.pruned.dst)
          and np.array_equal(dc.omega, dp.omega), "pruned graph differs")
    check(logits_close(lc, lp), "pattern-filtered PNA logits differ")
    log(f"pattern-filtered PNA: background n={gp.n} m={gp.m}, pruned to "
        f"{dc.prune_counts} on both; logits max |card - CPU| "
        f"{float((lc.cpu() - lp).abs().max()):.3g}, loss {lossc:.6f} "
        f"(CPU {lossp:.6f})")


def phase_gnn_full(shape=None):
    """The GNN main path at full width, with launch counts read around it."""
    cfg, full_shape, n_classes = gnn_setup()
    shape = shape or full_shape
    n, avg_degree = shape.n_nodes, shape.n_edges / shape.n_nodes
    log(f"== phase 5d: {cfg.name} on {shape.name} (B={shape.batch_nodes}, "
        f"fanouts {shape.fanout}, d_feat {shape.d_feat}, {n_classes} classes)")
    t0 = time.perf_counter()
    g = gen.erdos_renyi_graph(n, avg_degree, seed=SEED)
    t1 = time.perf_counter()
    feats, labels = gnn_features(g.n, shape.d_feat, n_classes, SEED)
    t2 = time.perf_counter()
    stream = SampledBatchStream(g, feats, labels, shape.fanout,
                                shape.batch_nodes, seed=SEED, device=DEVICE)
    sync()
    t3 = time.perf_counter()
    log(f"background: n={g.n} m={g.m} (generated on the host in "
        f"{t1 - t0:.1f} s; features {feats.nbytes / 1e6:.0f} MB made in "
        f"{t2 - t1:.1f} s; CSR built and table staged on the device in "
        f"{t3 - t2:.1f} s)")
    del feats
    model = GNN(cfg, shape.d_feat, n_classes, device=DEVICE, seed=SEED)
    model.forward_sampled(stream(GNN_BATCHES))  # warm-up, outside the count
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    rows, first = [], None
    for step in range(GNN_BATCHES):
        ta = time.perf_counter()
        layers = stream.sample_ids(step)
        tb = time.perf_counter()
        batch = stream.gather(layers)
        sync()
        tc = time.perf_counter()
        logits = model.forward_sampled(batch)
        loss = model.loss(batch, logits)
        sync()
        td = time.perf_counter()
        lv = float(loss)
        check(logits.shape == (shape.batch_nodes, n_classes)
              and bool(torch.isfinite(logits).all()) and np.isfinite(lv),
              f"batch {step}: logits not finite or of the wrong shape")
        rows.append((tb - ta, tc - tb, td - tc, lv))
        log(f"  batch {step}: sample {tb - ta:.6f} s (host), gather "
            f"{tc - tb:.6f} s, forward+loss {td - tc:.6f} s, loss {lv:.6f}")
        if first is None:
            first = ({k: v.cpu() for k, v in batch.items()}, logits.cpu())
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    med = [float(np.median([r[i] for r in rows])) for i in range(3)]
    log(f"median per batch: sample {med[0]:.6f} s, gather {med[1]:.6f} s, "
        f"forward+loss {med[2]:.6f} s; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    check(launches["segment_agg"] == 3 * GNN_BATCHES,
          f"segment_agg launched {launches['segment_agg']} times, "
          f"expected {3 * GNN_BATCHES}")
    cpu_model = GNN(cfg, shape.d_feat, n_classes, device="cpu", seed=SEED)
    lp = cpu_model.forward_sampled(first[0])
    check(logits_close(first[1], lp), "full-width logits differ card vs CPU")
    log(f"batch 0 at full width: logits max |card - CPU| "
        f"{float((first[1] - lp).abs().max()):.3g}")
    profile_batches(stream, model, range(GNN_BATCHES, GNN_BATCHES + 3))
    return launches


def device_events(prof):
    """The profiler's averages of device activity (kernels, copies)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def kernel_device_ms(fn, reps, name):
    """Mean device milliseconds per launch of the kernels whose name holds
    `name`, over `reps` calls of fn() under torch.profiler: the kernel's own
    time, without the host's launch cost between calls."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return float("nan")
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    ev = [e for e in device_events(prof) if name in e.key]
    check(ev and sum(e.count for e in ev) == reps,
          f"profiler saw {sum(e.count for e in ev)} {name} launches, not {reps}")
    return sum(e.self_device_time_total for e in ev) / 1e3 / reps


def profile_batches(stream, model, steps):
    """Device time by kernel and the device's busy share over whole batches
    (host sampling, gather, forward, loss), read from torch.profiler's CUDA
    activity. The profiler's own cost lands in the wall time."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in steps:
            batch = stream(step)
            model.loss(batch, model.forward_sampled(batch))
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n = len(steps)
    if not kern:
        log("profiler: no device activity recorded; device time not measured")
        return
    log(f"profiler over {n} batches: wall {wall_ms / n:.3f} ms per batch, "
        f"device busy {busy_ms / n:.3f} ms per batch "
        f"({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% idle)")
    for e in kern[:12]:
        log(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/batch "
            f"x{e.count // n:<3d} {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    # f32 products in full f32 on the card, as on the CPU (PyTorch's
    # defaults, stated): TF32 would move the GNN logits past LOGIT_TOL
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind = phase_device()
    phase_kernels_small()

    t0 = time.perf_counter()
    g = gen.rmat_graph(SCALE_FULL, edge_factor=EDGE_FACTOR, seed=SEED)
    t1 = time.perf_counter()
    dg = DeviceGraph.from_host(g, DEVICE)
    sync()
    log(f"R-MAT scale {SCALE_FULL}: n={g.n} m={g.m}, max in-degree "
        f"{int((dg.dst_ptr[1:] - dg.dst_ptr[:-1]).max())} (generated on the "
        f"host in {t1 - t0:.1f} s, dst-sorted and staged in "
        f"{time.perf_counter() - t1:.1f} s)")
    timing = phase_kernel_timing(dg, Template(*HEX), g.label_frequency())
    phase_parity()
    launches = phase_full(g, dg)
    del g, dg

    cfg, shape, _ = gnn_setup()
    phase_segment_agg_small()
    agg_rows = phase_segment_agg_timing(agg_shapes(shape, cfg))
    phase_gnn_parity()
    gnn_launches = phase_gnn_full()
    for name in registry.GNN_KERNELS:
        launches[name] = gnn_launches[name]

    kernels = []
    for name, replaces in (("bitset_spmm", "src/repro/kernels/bitset_spmm.py:77"),
                           ("bitset_wave", "src/repro/kernels/bitset_wave.py:89")):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bitset.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "bit_exact": True,
        })
    t = agg_rows[0]  # the largest call: second-hop neighbours
    kernels.append({
        "name": "segment_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_agg.cu",
        "replaces": "src/repro/kernels/segment_agg.py:47",
        "launches": launches["segment_agg"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
        "tolerance": f"min/max bit-exact, sum/sumsq rtol=atol={AGG_TOL}",
        "device_ms": t["device_ms"],
        "other_shapes": [{k: r[k] for k in ("shape", "ms", "device_ms",
                                            "plain_ms", "bound_ms")}
                         for r in agg_rows[1:]],
    })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
