"""What `BENCHMARK.json` names, found by name: a cell's configuration file,
its traffic mix (`traffic/<mix>.json`), and a reader per metric
(`metrics/<metric>.py`). Adding a configuration, a mix or a metric adds a
file and an entry; no code here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_path(mix: str) -> Path:
    return HERE / "traffic" / f"{mix}.json"


def traffic(mix: str) -> dict:
    with open(traffic_path(mix)) as f:
        return json.load(f)


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def reader(name: str):
    """The module that reads per-layer metric `name`: `read(record)`, and
    `probe(ctx)` where the metric needs a measurement of its own."""
    path = metric_path(name)
    mod_name = "portbench.metrics._" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, kind: str, cell: str) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics cell `cell` reports: those
    that list it, or list no cells (for a per-layer metric with no list:
    every cell that reports the end-to-end metric it moves)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out
