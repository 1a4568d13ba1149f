"""The harness without a card: it finds every file `BENCHMARK.json` names,
prints the contract's last line, refuses to run without CUDA, and neither
it nor what it runs imports JAX or the JAX package."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = str(ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from portbench import run  # noqa: E402

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_every_named_file_is_found():
    bench = spec.load_benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["name"] == c["name"] and cfg["path"] in run.LOOPS
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
