"""Run one cell of the benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the cell's graph on the card from the
seed, builds (or loads) the program's kernel library, warms up the cell's
own templates through the run path its configuration names
(`paths/<path>.py`), measures for --seconds, judges every query of the
window against the plain reference (the path's own, where it brings one),
and prints one JSON line last on standard output. With --trace 1 the line holds the per-layer metrics, read from the
counters of the window and from a device trace of its first seconds.

The program under test is the PyTorch and CUDA port, `repro_torch`, from
`src/`. Without a CUDA card, or with fewer cards than the cell asks for, it
exits with an error and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from portbench import graphgen, judge, loadgen, reference, spec, trace  # noqa: E402
from portbench.paths.base import Context, _Loop  # noqa: E402

ROOT = spec.ROOT
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# seconds of the window that the traced run records with the profiler
TRACE_CAP_S = 10.0


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _program_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    program builds its kernel library into its own `kernels/_build`."""
    base = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _percentile(values: List[float], q: int) -> float:
    """The q-th percentile by `statistics.quantiles` (exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def end_to_end(names: List[str], loop: _Loop, window_s: float,
               setup_s: float, peak: int) -> Dict[str, dict]:
    done = len(loop.queries)
    lat = [q["latency_s"] for q in loop.queries]
    values = {
        "setup_s": (setup_s, "s"),
        "query_s": (window_s / max(done, 1), "s/query"),
        "queries_per_s": (done / window_s, "queries/s"),
        "query_p95_s": (_percentile(lat, 95) if lat else None, "s"),
        "peak_gib": (peak / 2**30, "GiB"),
    }
    out = {}
    for name in names:
        v, unit = values[name]
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def _solution(graph: graphgen.Arcs,
              t: loadgen.TemplateSpec) -> reference.Solution:
    return reference.solution(graph.n, graph.src, graph.dst, graph.labels,
                              t.labels, t.edges)


def _control(graph: graphgen.Arcs, t: loadgen.TemplateSpec,
             count: Optional[int]) -> reference.Solution:
    return reference.local_answer(graph.n, graph.src, graph.dst,
                                  graph.labels, t.labels, t.edges,
                                  count=count)


def run_cell(cell: dict, cfg: dict, traffic: dict, e2e: List[dict],
             per_layer: List[dict], seed: int, seconds: float, trace_on: bool,
             device="cuda", t_start: Optional[float] = None,
             control: bool = False, trace_cap_s: float = TRACE_CAP_S,
             root: Path = ROOT) -> dict:
    """One run of a cell -> the result's fields (`correct`, `attempted`,
    `failed`, `metrics`, `device`, `breakdown` when traced, `checks` last).
    The configuration's path, graph maker and metric readers are the files
    under `root`. `control=True` judges the control (by default arc
    consistency alone, put in the program's place) instead of the
    program's answers."""
    path = spec.path_module(cfg["path"], root)
    from repro_torch.core.template import Template
    from repro_torch.kernels import build, registry

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        build.library()
    mix = loadgen.load_mix(traffic)
    g = graphgen.from_config(cfg, seed, dev, root)
    templates = [Template(list(t.labels), [tuple(e) for e in t.edges])
                 for t in mix.templates]
    ctx = Context(g, mix, dev)
    outputs = judge.Outputs(g.n)
    loop = path.Loop(cfg, mix, templates, seed, dev, outputs)
    loop.setup(g, ctx)
    n, host = g.n, None
    if loop.stages_graph:
        # the program staged its own copy: hold the graph on the host until
        # the reference needs it, so that the peak is the program's
        host = [x.cpu() for x in (g.src, g.dst, g.dst_ptr, g.labels)]
        g = ctx.graph = None
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launches()
    tracer = trace.Tracer(trace_on, trace_cap_s, dev, registry.launch_counts,
                          getattr(path, "SPANS", ()))
    tracer.start()
    window_s = loop.run(seconds, tracer)
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loop.drain()
    loop.close()
    if host is not None:
        g = ctx.graph = graphgen.Arcs(n, *(x.to(dev) for x in host))
    # the reference: once per distinct template the window ran
    solution = getattr(path, "solution", _solution)
    refs = {}
    for i in outputs.templates():
        t = mix.templates[i]
        t0 = time.perf_counter()
        refs[i] = solution(g, t)
        print(f"reference {t.name}: omega {refs[i].omega_keys.size} arcs "
              f"{refs[i].arc_keys.size} matches {refs[i].count} in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    if control:
        control_of = getattr(path, "control", _control)
        outputs.substitute({i: control_of(g, mix.templates[i], refs[i].count)
                            for i in refs})
    count = bool(cfg["guarantees"].get("count"))
    checks = outputs.judge(refs, with_count=count)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(cell.get("chips", 1)),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": loop.attempted,
              "failed": loop.failed}
    if not trace_on:
        result["metrics"] = end_to_end([m["name"] for m in e2e], loop,
                                       window_s, setup_s, peak)
    else:
        red = tracer.reduce(trace.hand_written_kernels(
            ROOT / "src" / "repro_torch" / "kernels" / "csrc"))
        record = {"queries": loop.queries, "batches": loop.batches,
                  "window_s": window_s, "trace": red,
                  "probes": {}}
        metrics = {}
        for m in per_layer:
            mod = spec.reader(m["name"], root)
            if hasattr(mod, "probe"):
                record["probes"][m["name"]] = mod.probe(ctx)
            v = mod.read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        if red is not None:
            device_info["busy_s"] = red["busy_s"]
            device_info["window_s"] = red["window_s"]
            result["breakdown"] = {
                "device_ops": [list(x) for x in red["device_ops"]],
                "idle_gaps": [list(x) for x in red["idle_gaps"]]}
    result["device"] = device_info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the control (arc consistency alone) in the "
                         "program's place; it must come out not correct")
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    _cache_dirs()
    _program_path()
    result = run_cell(
        cell, spec.config(bench, cell["config"]), spec.traffic(cell["traffic"]),
        spec.metrics_of(bench, "end_to_end", cell["name"]),
        spec.metrics_of(bench, "per_layer", cell["name"]),
        args.seed, args.seconds, bool(args.trace), t_start=T_START,
        control=args.control)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
