#!/usr/bin/env python3
"""Time this checkout's graph-query serving drain against another
checkout's on one card, on the same graph and queries.

    python3 tools/serve_compare.py OTHER_ROOT [--reps 5] [--rounds 1]

OTHER_ROOT is an unpacked checkout of the port, e.g. a `git archive` of an
earlier commit. The script makes chip_smoke.py phase 8b's graph (R-MAT
scale 20, edge factor 16, seed 3, degree labels) once and saves it to a
temporary file. Then, in the order other, this, this, other in each round,
it starts a worker process with that checkout's `src` first on the path,
which stages the graph on the card and has that checkout's
`GraphQueryEngine` serve `example_workload(32, seed=1)` in prune mode at
`max_batch=8` without the complete-walk TDS (phase 8b's drain): once to
build the kernels and warm up, then `--reps` times, each drain timed on
the host clock up to a device sync. Prints the card's name and power
limit, each worker's drain seconds, then one JSON line. Needs one GPU.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def worker(args):
    sys.path.insert(0, str(Path(args.worker) / "src"))
    import torch
    from repro_torch.graph.structs import Graph
    from repro_torch.serve.graph_query import (GraphQueryEngine, MODE_PRUNE,
                                               example_workload)

    d = np.load(args.inputs)
    g = Graph(n=int(d["n"]), src=d["src"], dst=d["dst"], labels=d["labels"])
    templates = example_workload(32, seed=1, labels_max=int(g.labels.max()))
    eng = GraphQueryEngine(g, max_batch=8, device="cuda",
                           guarantee_precision=False)
    secs = []
    for rep in range(args.reps + 1):
        for t in templates:
            eng.submit(t, mode=MODE_PRUNE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.drain()
        torch.cuda.synchronize()
        if len(results) != len(templates) or any(r.status != "ok"
                                                  for r in results):
            raise RuntimeError("a query of the workload was dropped or missed")
        if rep:  # the first drain builds the kernels
            secs.append(time.perf_counter() - t0)
    print(json.dumps({"drain_s": secs}))


def main(args):
    import torch

    if not torch.cuda.is_available():
        print("serve_compare: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.graph import generators as gen

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = gen.rmat_graph(cs.SCALE_FULL, edge_factor=cs.EDGE_FACTOR, seed=cs.SEED)
    roots = {"other": Path(args.other).resolve(), "this": ROOT}
    drains = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "graph.npz")
        np.savez(inputs, n=g.n, src=g.src, dst=g.dst, labels=g.labels)
        del g
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                run = subprocess.run(
                    [sys.executable, __file__, "--worker", str(roots[name]),
                     "--inputs", inputs, "--reps", str(args.reps)],
                    capture_output=True, text=True, timeout=900)
                if run.returncode != 0:
                    print(run.stdout, run.stderr, file=sys.stderr)
                    raise RuntimeError(f"the worker for {roots[name]} failed")
                secs = json.loads(run.stdout.strip().splitlines()[-1])["drain_s"]
                drains[name].extend(secs)
                print(f"{name}: drains of 32 queries {secs} s ({card})",
                      flush=True)
    print(json.dumps({"card": card, "other": str(roots["other"]), **{
        name: {"drain_s": d, "median_s": statistics.median(d)}
        for name, d in drains.items()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker")
    ap.add_argument("--inputs")
    a = ap.parse_args()
    if a.worker:
        worker(a)
    else:
        if not a.other:
            ap.error("OTHER_ROOT is required")
        sys.exit(main(a))
