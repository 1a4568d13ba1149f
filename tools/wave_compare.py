#!/usr/bin/env python3
"""Time this checkout's bitset_wave against another checkout's on one card,
on the same inputs.

    python3 tools/wave_compare.py OTHER_ROOT [--reps 20] [--rounds 2]

OTHER_ROOT is an unpacked checkout of the port, e.g. a `git archive` of an
earlier commit. The script makes the main-path wave of chip_smoke.py phase
2b (R-MAT scale 20, "hex-unique", the first wave after the initial LCC) and
the same wave with every vertex a candidate in every hop, with their plain
versions' outputs, and saves them to a temporary file. Then, in the order
other, this, this, other in each round, it starts a worker process with
that checkout's `src` first on the path, which calls that checkout's
`repro_torch.kernels.ops.bitset_wave` on the saved inputs (so any checkout
whose wrapper takes (vals, DeviceGraph, edge_active, cand) works, whatever
its kernel's C interface), checks it bit-exact against the plain output and
prints device ms a call: CUDA events around calls queued behind a device
spin. The first worker of each checkout also reads its wave by kernel and
memset with torch.profiler. Prints the card's name and power limit, then
one JSON line. Needs one GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def device_ms(fn, reps, spin_cycles):
    """Mean device ms a call: CUDA events around `reps` calls queued behind
    a device spin (chip_smoke.kernel_device_ms without the launch count)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_parts(fn, calls):
    """Device ms a call of each kernel and memset fn() runs, by
    torch.profiler over `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: {"device_ms": e.self_device_time_total / 1e3 / calls,
                         "per_call": e.count / calls}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def worker(args):
    """Time `args.worker`'s bitset_wave on the saved inputs -> one JSON line."""
    sys.path.insert(0, str(Path(args.worker).resolve() / "src"))
    from repro_torch.graph.structs import DeviceGraph
    from repro_torch.kernels import ops

    d = torch.load(args.inputs)
    dev = "cuda"
    dg = DeviceGraph(n=d["n"], src=d["src"].to(dev), dst=d["dst"].to(dev),
                     dst_ptr=d["dst_ptr"].to(dev),
                     labels=torch.zeros(d["n"], dtype=torch.int32, device=dev))
    vals, ea = d["vals"].to(dev), d["edge_active"].to(dev)
    result = {}
    for label, case in d["cases"].items():
        cand = case["cand"].to(dev)

        def fn():
            return ops.bitset_wave(vals, dg, ea, cand)

        if not torch.equal(fn(), case["want"].to(dev)):
            raise RuntimeError(f"{args.worker}: bitset_wave differs from the plain "
                               f"version ({label})")
        result[label] = {"device_ms": device_ms(fn, args.reps, args.spin)}
        if args.profile:
            result[label]["parts"] = profile_parts(fn, 10)
    print(json.dumps(result))
    return 0


def main(args):
    if not torch.cuda.is_available():
        print("wave_compare: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.lcc import TemplateDev, lcc_fixpoint
    from repro_torch.core.state import init_state
    from repro_torch.core.template import Template
    from repro_torch.graph import generators as gen
    from repro_torch.graph.structs import DeviceGraph
    from repro_torch.kernels import ref, registry

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    g = gen.rmat_graph(cs.SCALE_FULL, edge_factor=cs.EDGE_FACTOR, seed=cs.SEED)
    dg = DeviceGraph.from_host(g, "cuda")
    tmpl = Template(*cs.HEX)
    state1 = lcc_fixpoint(dg, TemplateDev(tmpl, dg.device), init_state(dg, tmpl),
                          route=registry.ROUTE_PACKED)
    packed, cand = cs.first_wave_inputs(dg, tmpl, state1, g.label_frequency())
    ea = state1.edge_active
    cases, bounds = {}, {}
    for label, c in (("main-path wave", cand),
                     ("every vertex a candidate", torch.full_like(cand, -1))):
        want = ref.bitset_wave_ref(packed, dg.src, dg.dst, dg.n, ea, c)
        cases[label] = {"cand": c.cpu(), "want": want.cpu()}
        bounds[label], _ = cs.bound(cs.wave_cost(dg, ea, c, packed.shape[1]))
    print(f"inputs in {time.perf_counter() - t0:.1f} s: n={dg.n} m={dg.m} "
          f"W={packed.shape[1]} L={cand.shape[0]}", flush=True)
    roots = {"other": Path(args.other).resolve(), "this": ROOT}
    times = {label: {"other": [], "this": []} for label in cases}
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "wave_inputs.pt")
        torch.save({"n": dg.n, "src": dg.src.cpu(), "dst": dg.dst.cpu(),
                    "dst_ptr": dg.dst_ptr.cpu(), "edge_active": ea.cpu(),
                    "vals": packed.cpu(), "cases": cases}, inputs)
        del cases, dg, state1, packed, cand, ea
        torch.cuda.empty_cache()
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                cmd = [sys.executable, __file__, "--worker", str(roots[name]),
                       "--inputs", inputs, "--reps", str(args.reps),
                       "--spin", str(cs.SPIN_CYCLES)]
                if name not in parts:
                    cmd.append("--profile")
                run = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
                if run.returncode != 0:
                    print(run.stdout, run.stderr, file=sys.stderr)
                    raise RuntimeError(f"the worker for {roots[name]} failed")
                res = json.loads(run.stdout.strip().splitlines()[-1])
                for label, r in res.items():
                    times[label][name].append(r["device_ms"])
                    if "parts" in r:
                        parts.setdefault(name, {})[label] = r["parts"]
    result = {"card": card, "other": str(roots["other"]), "cases": {
        label: {"device_ms": times[label], "bound_ms": bounds[label]}
        for label in times}, "parts": parts}
    for label, t in times.items():
        print(f"{label}: device ms a call, other {t['other']}, this {t['this']}; "
              f"bound {bounds[label]:.4f} ms ({card})", flush=True)
    for name, by_case in parts.items():
        print(f"{name}, main-path wave by kernel: {by_case['main-path wave']}",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--spin", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is None and a.other is None:
        ap.error("give the root of the other checkout")
    sys.exit(worker(a) if a.worker else main(a))
