"""Run cells of the benchmark several times, one process a run, and report
each metric's median and spread.

    python -m portbench.measure --workload <cell> --seeds 11,12,13 --seconds 40
        [--trace 0|1] [--sets 2] [--control] [--out results.jsonl]

Runs every seed once per set, in order (the sets repeat the same seeds),
writes each run's result line (with its seconds, exit code and the end of
its standard error) to --out, and prints per metric the median and the
spread of each set: the distance between the first and third quartile by
`statistics.quantiles(values, n=4)`, as a share of the median. The card's
name and power limit lead the report.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def spread(values: List[float]) -> float:
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else 0.0


def one_run(workload: str, seed: int, seconds: float, trace: int,
            control: bool = False) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)] + (["--control"] if control else [])
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "rc": p.returncode, "run_s": time.perf_counter() - t0,
           "stderr_tail": p.stderr[-2000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(f"card: {card()}", flush=True)
    sets: List[Dict[str, List[float]]] = []
    for k in range(args.sets):
        values: Dict[str, List[float]] = {}
        for seed in seeds:
            rec = one_run(args.workload, seed, args.seconds, args.trace,
                          args.control)
            rec["set"] = k
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            res = rec.get("result")
            brief = ({n: m["value"] for n, m in res["metrics"].items()}
                     if res else rec["stderr_tail"][-600:])
            print(f"set {k} seed {seed} rc {rec['rc']} run_s "
                  f"{rec['run_s']:.1f} correct "
                  f"{res['correct'] if res else None} "
                  f"attempted {res['attempted'] if res else None} "
                  f"checks {res['checks'] if res else None} {brief}",
                  flush=True)
            if res:
                for n, m in res["metrics"].items():
                    values.setdefault(n, []).append(m["value"])
                values.setdefault("memory_peak_bytes", []).append(
                    res["device"]["memory_peak_bytes"])
        sets.append(values)
    for n in sorted({n for s in sets for n in s}):
        parts = []
        for k, s in enumerate(sets):
            v = s.get(n, [])
            if v:
                parts.append(f"set {k}: median {statistics.median(v)!r} "
                             f"spread {spread(v):.4f} (n {len(v)})")
        print(f"{n}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
