"""What `BENCHMARK.json` names, found by name: a cell's configuration file,
its traffic mix (`traffic/<mix>.json`), a reader per metric
(`metrics/<metric>.py`), the run path a configuration names
(`paths/<path>.py`, with its reference where it brings one) and the graph
maker of any generator but the built-in R-MAT (`graphs/<generator>.py`).
Adding a configuration, a mix, a path, a graph maker or a metric adds a
file and an entry; no code here changes. Each finder takes the
benchmark's root, so that a test can place new files under another."""
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


def traffic_path(mix: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "traffic" / f"{mix}.json"


def traffic(mix: str, root: Path = ROOT) -> dict:
    with open(traffic_path(mix, root)) as f:
        return json.load(f)


def _module(folder: str, name: str, root: Path):
    """The module in `<root>/portbench/<folder>/<name>.py`, loaded from its
    file. A name with no file raises an error that names the file."""
    rel = f"portbench/{folder}/{name}.py"
    path = root / rel
    if not path.is_file():
        raise FileNotFoundError(f"no file {rel} under {root}")
    mod_name = f"portbench.{folder}._" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The module that reads per-layer metric `name`: `read(record)`, and
    `probe(ctx)` where the metric needs a measurement of its own."""
    return _module("metrics", name, root)


def path_module(name: str, root: Path = ROOT):
    """The run path `name` of a configuration: `Loop`, and optionally
    `solution`, `control` and `SPANS` (see `paths/__init__.py`)."""
    return _module("paths", name, root)


def graph_maker(generator: str, root: Path = ROOT):
    """The maker of generator `generator`'s graphs: `make(cfg, seed,
    device) -> graphgen.Arcs`."""
    return _module("graphs", generator, root)


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
