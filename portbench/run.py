"""Run one cell of the benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the cell's graph on the card from the
seed, builds (or loads) the program's kernel library, warms up the cell's
own templates, measures for --seconds, judges every query of the window
against the plain reference, and prints one JSON line last on standard
output. With --trace 1 the line holds the per-layer metrics, read from the
counters of the window and from a device trace of its first seconds.

The program under test is the PyTorch and CUDA port, `repro_torch`, from
`src/`. Without a CUDA card, or with fewer cards than the cell asks for, it
exits with an error and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import graphgen, judge, loadgen, reference, spec, trace  # noqa: E402

ROOT = spec.ROOT
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# seconds of the window that the traced run records with the profiler
TRACE_CAP_S = 10.0
# kernel probes: timed launches after three untimed ones
PROBE_REPS = 20


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


class Context:
    """What a cell's run hands its per-layer probes."""

    def __init__(self, graph: graphgen.Arcs, mix: loadgen.Mix, device):
        self.graph = graph
        self.mix = mix
        self.device = device

    def device_graph(self):
        from repro_torch.graph.structs import DeviceGraph

        g = self.graph
        return DeviceGraph(n=g.n, src=g.src, dst=g.dst, dst_ptr=g.dst_ptr,
                           labels=g.labels)

    def narrowed(self, t: loadgen.TemplateSpec):
        g = self.graph
        return reference.narrowed(g.n, g.src, g.dst, g.labels, t.labels,
                                  t.edges)

    def time_ms(self, fn) -> Optional[float]:
        """ms a call of fn takes on the card by CUDA events, over
        PROBE_REPS calls back to back after three untimed ones; None off
        the card."""
        if self.device.type != "cuda":
            return None
        for _ in range(3):
            fn()
        torch.cuda.synchronize(self.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(PROBE_REPS):
            fn()
        e1.record()
        torch.cuda.synchronize(self.device)
        return e0.elapsed_time(e1) / PROBE_REPS


class _Loop:
    """The program driven by one mix's clients. Subclasses set up the
    program, run the window and free the program's state."""

    def __init__(self, cfg: dict, mix: loadgen.Mix, templates, seed: int,
                 dev: torch.device, outputs: judge.Outputs):
        self.cfg = cfg
        self.mix = mix
        self.templates = templates
        self.stream = mix.stream(seed)
        self.dev = dev
        self.outputs = outputs
        self.queries: List[dict] = []
        self.batches: List[dict] = []
        self.attempted = 0
        self.failed = 0


class PruneLoop(_Loop):
    """One analyst: `pipeline.prune` on the resident `DeviceGraph`, then
    `count_matches` of its result, one query after another."""

    def setup(self, g: graphgen.Arcs, ctx: Context) -> None:
        self.dg = ctx.device_graph()
        # a template label that no vertex carries has frequency 0
        top = max(max(t.labels.tolist()) for t in self.templates)
        self.label_freq = np.bincount(g.labels.cpu().numpy(),
                                      minlength=top + 1)
        guar = self.cfg["guarantees"]
        self.kw = dict(guarantee_precision=guar["guarantee_precision"],
                       edge_elimination=guar["edge_elimination"],
                       work_aggregation=guar["work_aggregation"],
                       **self.cfg["engine"])
        self.count = bool(guar.get("count"))
        for i in range(len(self.templates)):
            self._query(i, None, record=False)

    def _query(self, i: int, tracer, record: bool = True) -> None:
        from repro_torch.core import enumerate as enum_mod
        from repro_torch.core import pipeline

        span = tracer.span if tracer is not None else _no_span
        t0 = time.perf_counter()
        with span("prune"):
            res = pipeline.prune(self.dg, self.templates[i],
                                 label_freq=self.label_freq, **self.kw)
        t1 = time.perf_counter()
        n_emb = None
        if self.count:
            with span("count"):
                n_emb = int(enum_mod.count_matches(
                    res, label_freq=self.label_freq).n_embeddings)
        t2 = time.perf_counter()
        if not record:
            return
        self.outputs.take(i, res.state.omega, res.state.edge_active,
                          res.dg.src, res.dg.dst, n_emb)
        self.queries.append({
            "template": i, "prune_s": t1 - t0, "count_s": t2 - t1,
            "latency_s": t2 - t0,
            "phases": [(p.phase, p.seconds) for p in res.phases],
            "lcc_iterations": res.stats.get("lcc_iterations", 0)})

    def run(self, seconds: float, tracer) -> float:
        t0 = time.perf_counter()
        while True:
            self.attempted += 1
            self._query(next(self.stream), tracer)
            tracer.tick()
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    def drain(self) -> None:
        pass

    def close(self) -> None:
        del self.dg


class ServeLoop(_Loop):
    """Many analysts in a closed loop on one `GraphQueryEngine`: each client
    submits its next query as soon as its last one returns from `pump`."""

    def setup(self, g: graphgen.Arcs, ctx: Context) -> None:
        from repro_torch.graph.structs import Graph
        from repro_torch.serve import graph_query

        self.gq = graph_query
        host = Graph(g.n, g.src.cpu().numpy(), g.dst.cpu().numpy(),
                     g.labels.cpu().numpy())
        guar = self.cfg["guarantees"]
        self.mode = guar["mode"]
        self.engine = graph_query.GraphQueryEngine(
            host, device=self.dev,
            guarantee_precision=guar["guarantee_precision"],
            **self.cfg["engine"])
        self.pending: Dict[int, tuple] = {}
        for i in range(len(self.templates)):
            self.engine.submit(self.templates[i], mode=self.mode)
        for qr in self.engine.drain():
            qr.result = None

    def _submit(self, tracer) -> None:
        i = next(self.stream)
        with tracer.span("engine.submit"):
            qid = self.engine.submit(self.templates[i], mode=self.mode)
        self.pending[qid] = (i, time.perf_counter())
        self.attempted += 1

    def _take(self, results, t_back: float, record: bool) -> None:
        batch_seen = set()
        for qr in results:
            i, t_sub = self.pending.pop(qr.query_id)
            if qr.status != self.gq.STATUS_OK or qr.result is None:
                self.failed += 1
                self.outputs.missing += 1
                continue
            res = qr.result
            self.outputs.take(i, res.state.omega, res.state.edge_active,
                              res.dg.src, res.dg.dst)
            if record:
                self.queries.append({"template": i, "wait_s": qr.wait_s,
                                     "latency_s": t_back - t_sub})
                if qr.batch_id not in batch_seen:
                    batch_seen.add(qr.batch_id)
                    st = res.stats
                    self.batches.append({
                        "B": qr.batch_size, "seconds": qr.seconds,
                        "lcc_iterations": st.get("lcc_iterations", 0),
                        "nlcc_tokens": st.get("nlcc_tokens", 0),
                        "nlcc_lockstep_padded": st.get(
                            "nlcc_lockstep_padded", 0),
                        "wave": self.engine.wave})
            # the client is done with it: release its device state
            qr.result = None

    def run(self, seconds: float, tracer) -> float:
        t0 = time.perf_counter()
        for _ in range(self.mix.clients):
            self._submit(tracer)
        while True:
            with tracer.span("engine.pump"):
                results = self.engine.pump()
            t = time.perf_counter()
            self._take(results, t, record=True)
            tracer.tick()
            if t - t0 >= seconds:
                return t - t0
            if not results:
                time.sleep(0.001)  # nothing due yet: the batcher waits
            for _ in results:
                self._submit(tracer)

    def drain(self) -> None:
        """Queries still queued at the window's close: answered and judged,
        outside the window's numbers."""
        if self.pending:
            self._take(self.engine.drain(), time.perf_counter(), record=False)

    def close(self) -> None:
        del self.engine


def _no_span(name):
    return contextlib.nullcontext()


LOOPS = {"prune": PruneLoop, "serve": ServeLoop}


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


def run_cell(cell: dict, cfg: dict, traffic: dict, e2e: List[dict],
             per_layer: List[dict], seed: int, seconds: float, trace_on: bool,
             device="cuda", t_start: Optional[float] = None,
             control: bool = False, trace_cap_s: float = TRACE_CAP_S) -> dict:
    """One run of a cell -> the result's fields (`correct`, `attempted`,
    `failed`, `metrics`, `device`, `breakdown` when traced, `checks` last).
    `control=True` judges the control (arc consistency alone, put in the
    program's place) instead of the program's answers."""
    from repro_torch.core.template import Template
    from repro_torch.kernels import build, registry

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        build.library()
    mix = loadgen.load_mix(traffic)
    g = graphgen.from_config(cfg, seed, dev)
    templates = [Template(list(t.labels), [tuple(e) for e in t.edges])
                 for t in mix.templates]
    ctx = Context(g, mix, dev)
    outputs = judge.Outputs(g.n)
    loop = LOOPS[cfg["path"]](cfg, mix, templates, seed, dev, outputs)
    loop.setup(g, ctx)
    n, host = g.n, None
    if cfg["path"] == "serve":
        # the engine staged its own copy: hold the graph on the host until
        # the reference needs it, so that the peak is the program's
        host = [x.cpu() for x in (g.src, g.dst, g.dst_ptr, g.labels)]
        g = ctx.graph = None
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launches()
    tracer = trace.Tracer(trace_on, trace_cap_s, dev, registry.launch_counts)
    tracer.start()
    window_s = loop.run(seconds, tracer)
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loop.drain()
    loop.close()
    if host is not None:
        g = ctx.graph = graphgen.Arcs(n, *(x.to(dev) for x in host))
    # the reference: once per distinct template the window ran
    refs = {}
    for i in outputs.templates():
        t = mix.templates[i]
        t0 = time.perf_counter()
        refs[i] = reference.solution(g.n, g.src, g.dst, g.labels, t.labels,
                                     t.edges)
        print(f"reference {t.name}: omega {refs[i].omega_keys.size} arcs "
              f"{refs[i].arc_keys.size} matches {refs[i].count} in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    if control:
        outputs.substitute({i: reference.local_answer(
            g.n, g.src, g.dst, g.labels, mix.templates[i].labels,
            mix.templates[i].edges, count=refs[i].count) for i in refs})
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
            mod = spec.reader(m["name"])
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
