"""The harness without a card: it finds every file `BENCHMARK.json` names,
prints the contract's last line, refuses to run without CUDA, and neither
it nor what it runs imports JAX or the JAX package. A configuration of a
new kind (its run path, graph maker and reference all new files) runs and
is judged without an edit to the harness."""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from portbench import spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = str(ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from portbench import graphgen, run, trace  # noqa: E402

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_every_named_file_is_found():
    bench = spec.load_benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["name"] == c["name"]
        assert hasattr(spec.path_module(cfg["path"]), "Loop")
        assert c["file"].startswith("portbench/configs/")
    for w in bench["workloads"]:
        assert w["config"] in names
        assert spec.traffic_path(w["traffic"]).is_file()
        run.loadgen.load_mix(spec.traffic(w["traffic"]))
        e2e = spec.metrics_of(bench, "end_to_end", w["name"])
        layers = spec.metrics_of(bench, "per_layer", w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layers
        for m in layers:
            assert m["moves"] in {x["name"] for x in e2e}
    for m in bench["per_layer"]:
        assert hasattr(spec.reader(m["name"]), "read")


def _small(cell_name, scale=9):
    bench = spec.load_benchmark()
    cell = spec.workload(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    cfg["scale"] = scale
    return (bench, cell, cfg, spec.traffic(cell["traffic"]),
            spec.metrics_of(bench, "end_to_end", cell_name),
            spec.metrics_of(bench, "per_layer", cell_name))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["g500-22-exact.hex6", "g500-22-serve.acyc"])
def test_result_line_has_the_contract_keys(cell, trace):
    _, c, cfg, traffic, e2e, layers = _small(cell)
    traffic["clients"] = min(traffic["clients"], 8)
    res = run.run_cell(c, cfg, traffic, e2e, layers, seed=2**31 + 3,
                       seconds=0.2, trace_on=bool(trace), device="cpu")
    assert RESULT_KEYS <= set(res) <= RESULT_KEYS | {"breakdown"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    want = {m["name"] for m in (layers if trace else e2e)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert "setup_s" in res["metrics"]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for p in files:
        bad = set(_imports(p)) & {"jax", "jaxlib", "flax", "repro",
                                  "benchmarks"}
        assert not bad, f"{p} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_cli_refuses_to_run_without_a_card():
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "g500-22-exact.hex6", "--seed", "5", "--seconds", "1"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "from portbench import run, spec\n"
        "b = spec.load_benchmark()\n"
        "for name in ('g500-22-exact.hex6', 'g500-22-serve.cyc'):\n"
        "    c = spec.workload(b, name)\n"
        "    cfg = spec.config(b, c['config']); cfg['scale'] = 8\n"
        "    t = spec.traffic(c['traffic']); t['clients'] = 8\n"
        "    run.run_cell(c, cfg, t, spec.metrics_of(b, 'end_to_end', name),\n"
        "                 spec.metrics_of(b, 'per_layer', name), 1, 0.1, True,\n"
        "                 device='cpu')\n"
        "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


# A configuration of a new kind, as a later change would add it: a graph
# maker, a run path with its own spans and its own plain reference, a
# configuration and a traffic mix, all new files under a benchmark root.
_NEW_FILES = {
    "portbench/graphs/ring.py": '''
        """A ring of n vertices labelled v % 3, with a chord that closes a
        triangle at every sixth vertex; the seed permutes the vertex ids."""
        import torch

        from portbench import graphgen


        def make(cfg, seed, device):
            n = int(cfg["vertices"])
            dev = torch.device(device)
            v = torch.arange(n, device=dev)
            a = torch.cat([v, v[::6]])
            b = torch.cat([(v + 1) % n, (v[::6] + 2) % n])
            perm = torch.randperm(n, generator=graphgen.generator(seed, dev),
                                  device=dev)
            a, b = perm[a], perm[b]
            keys = torch.sort(torch.cat([a * n + b, b * n + a])).values
            dst, src = (keys // n).to(torch.int32), (keys % n).to(torch.int32)
            dst_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
            dst_ptr[1:] = torch.cumsum(torch.bincount(dst.long(), minlength=n), 0)
            labels = torch.empty(n, dtype=torch.int32, device=dev)
            labels[perm] = (v % 3).to(torch.int32)
            return graphgen.Arcs(n=n, src=src, dst=dst, dst_ptr=dst_ptr,
                                 labels=labels)
    ''',
    "portbench/paths/scan.py": '''
        """One client: prune, then count, each query in a span of its own;
        judged against a brute-force enumeration."""
        import itertools
        import time

        import numpy as np

        from portbench import reference
        from portbench.paths.base import _Loop

        SPANS = ("scan.query",)


        class Loop(_Loop):
            def setup(self, g, ctx):
                from repro_torch.core import pipeline

                self.dg = ctx.device_graph()
                for t in self.templates:
                    pipeline.prune(self.dg, t)

            def run(self, seconds, tracer):
                from repro_torch.core import enumerate as enum_mod
                from repro_torch.core import pipeline

                t0 = time.perf_counter()
                while True:
                    i = next(self.stream)
                    self.attempted += 1
                    t1 = time.perf_counter()
                    with tracer.span("scan.query"):
                        res = pipeline.prune(self.dg, self.templates[i])
                        count = int(enum_mod.count_matches(res).n_embeddings)
                    self.outputs.take(i, res.state.omega, res.state.edge_active,
                                      res.dg.src, res.dg.dst, count)
                    t = time.perf_counter()
                    self.queries.append({"template": i, "latency_s": t - t1})
                    tracer.tick()
                    if t - t0 >= seconds:
                        return t - t0

            def drain(self):
                pass

            def close(self):
                del self.dg


        def solution(graph, t):
            n, n0 = graph.n, len(t.labels)
            arcs = set(zip(graph.src.tolist(), graph.dst.tolist()))
            labels = graph.labels.cpu().numpy()
            omega, keys, count = set(), set(), 0
            for m in itertools.product(
                    *[np.flatnonzero(labels == l).tolist() for l in t.labels]):
                if len(set(m)) == n0 and all((m[a], m[b]) in arcs
                                             for a, b in t.edges):
                    count += 1
                    omega.update(v * n0 + q for q, v in enumerate(m))
                    for a, b in t.edges:
                        keys.update((m[a] * n + m[b], m[b] * n + m[a]))
            return reference.Solution(
                omega_keys=np.array(sorted(omega), dtype=np.int64),
                arc_keys=np.array(sorted(keys), dtype=np.int64), count=count)
    ''',
    "portbench/configs/ring-scan.json": {
        "name": "ring-scan", "generator": "ring", "vertices": 48,
        "path": "scan",
        "guarantees": {"guarantee_precision": True, "count": True}},
    "portbench/traffic/tri.json": {
        "loop": "closed", "clients": 1,
        "templates": [
            {"name": "tri", "labels": [0, 1, 2],
             "edges": [[0, 1], [1, 2], [2, 0]]},
            {"name": "path", "labels": [0, 1, 2], "edges": [[0, 1], [1, 2]]}]},
    "BENCHMARK.json": {
        "configs": [{"name": "ring-scan",
                     "file": "portbench/configs/ring-scan.json"}],
        "workloads": [{"name": "ring-scan.tri", "config": "ring-scan",
                       "traffic": "tri", "chips": 1}],
        "end_to_end": [
            {"name": "query_s", "unit": "s/query", "bound": 0.1},
            {"name": "setup_s", "unit": "s", "bound": 0.25}],
        "per_layer": []},
}


@pytest.fixture
def new_root(tmp_path):
    for rel, body in _NEW_FILES.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(body) if isinstance(body, dict)
                     else textwrap.dedent(body).lstrip())
    return tmp_path


@pytest.mark.parametrize("control", [False, True])
def test_a_configuration_of_new_files_is_judged(new_root, control):
    bench = spec.load_benchmark(new_root)
    cell = spec.workload(bench, "ring-scan.tri")
    res = run.run_cell(
        cell, spec.config(bench, "ring-scan", new_root),
        spec.traffic("tri", new_root),
        spec.metrics_of(bench, "end_to_end", cell["name"]), [],
        seed=2**31 + 7, seconds=0.5, trace_on=False, device="cpu",
        control=control, root=new_root)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"omega_diff", "arc_diff", "count_diff",
                                  "missing"}
    assert res["correct"] is not control
    if control:
        # arc consistency keeps every arc between two labelled vertices:
        # the chords, which no path uses, and ring arcs on no triangle
        assert res["checks"]["arc_diff"]["value"] > 0


def test_a_new_graph_maker_permutes_by_the_seed(new_root):
    cfg = spec.config(spec.load_benchmark(new_root), "ring-scan", new_root)
    a = graphgen.from_config(cfg, 3, "cpu", new_root)
    b = graphgen.from_config(cfg, 4, "cpu", new_root)
    assert a.m == b.m == 2 * (48 + 8)
    assert torch.equal(torch.bincount(a.labels), torch.bincount(b.labels))
    assert not torch.equal(a.labels, b.labels)


def test_a_missing_file_is_named(new_root, monkeypatch):
    bench = spec.load_benchmark(new_root)
    cell = spec.workload(bench, "ring-scan.tri")
    cfg = spec.config(bench, "ring-scan", new_root)
    monkeypatch.setattr(graphgen, "from_config", None)  # set-up never starts
    with pytest.raises(FileNotFoundError, match="portbench/paths/sweep.py"):
        run.run_cell(cell, dict(cfg, path="sweep"), spec.traffic("tri", new_root),
                     [], [], seed=1, seconds=0.1, trace_on=False,
                     device="cpu", root=new_root)
    monkeypatch.undo()
    with pytest.raises(FileNotFoundError, match="portbench/graphs/grid.py"):
        graphgen.from_config(dict(cfg, generator="grid"), 1, "cpu", new_root)


class _Event:
    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name

    def activity_type(self):
        return "kernel"


def test_a_paths_spans_reach_the_trace(new_root):
    spans = spec.path_module("scan", new_root).SPANS
    tracer = trace.Tracer(True, 1.0, torch.device("cpu"), dict, spans)
    assert tracer.spans == trace.SPANS + ("scan.query",)
    assert trace._annotation(_Event("scan.query"), tracer.spans)
    assert not trace._annotation(_Event("scan.query"))
    assert not trace._annotation(_Event("bitset_wave_kernel"), tracer.spans)
    for name in trace.SPANS:
        assert trace._annotation(_Event(name))


def test_count_mode_serving_is_judged_on_its_counts():
    _, c, cfg, traffic, e2e, layers = _small("g500-22-serve.cyc")
    traffic["clients"] = 8
    cfg["guarantees"] = dict(cfg["guarantees"], mode="count", count=True)
    res = run.run_cell(c, cfg, traffic, e2e, layers, seed=2**31 + 5,
                       seconds=0.2, trace_on=False, device="cpu")
    assert res["checks"]["count_diff"] == {"value": 0, "limit": 0}
    assert res["correct"] is True
