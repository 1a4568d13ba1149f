"""`correct` comes out false when it should: for the control (arc
consistency alone, put in the program's place) and for faults planted
underneath the timed path, each run through the rest of a run on the CPU
at a small scale. The exchange between chips has no fault to plant: every
cell runs on one chip.

`test_control_on_the_card` runs the control on the card at scale 18, each
cell's traffic as it is: `python -m pytest -m cuda portbench` there."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from portbench import run, spec  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.state import PruneState, init_state  # noqa: E402
from repro_torch.serve import graph_query  # noqa: E402

SEED = 2**31 + 11


def _run(cell_name, scale=9, seconds=0.2, control=False, device="cpu",
         clients=8):
    bench = spec.load_benchmark()
    cell = spec.workload(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    cfg["scale"] = scale
    traffic = spec.traffic(cell["traffic"])
    traffic["clients"] = min(traffic["clients"], clients)
    return run.run_cell(cell, cfg, traffic,
                        spec.metrics_of(bench, "end_to_end", cell_name),
                        spec.metrics_of(bench, "per_layer", cell_name),
                        seed=SEED, seconds=seconds, trace_on=False,
                        device=device, control=control)


def _unchanged(res):
    return dataclasses.replace(res, state=init_state(res.dg, res.template))


def _altered(res):
    omega = res.state.omega.clone()
    hit = torch.nonzero(omega)
    if hit.numel():
        omega[hit[0, 0], hit[0, 1]] = False
    else:
        omega[0, 0] = True
    return dataclasses.replace(
        res, state=PruneState(omega=omega, edge_active=res.state.edge_active))


def _emptied(res):
    st = res.state
    return dataclasses.replace(res, state=PruneState(
        omega=torch.zeros_like(st.omega),
        edge_active=torch.zeros_like(st.edge_active)))


def _patch_prune(monkeypatch, fault):
    real = pipeline.prune
    monkeypatch.setattr(pipeline, "prune",
                        lambda *a, **kw: fault(real(*a, **kw)))


def _patch_batch(monkeypatch, fault):
    """fault(lane, result, batch size) -> the lane's result as returned."""
    real = graph_query.prune_batch

    def patched(graph, templates, **kw):
        bres = real(graph, templates, **kw)
        bres.results = [fault(i, r, len(templates))
                        for i, r in enumerate(bres.results)]
        return bres

    monkeypatch.setattr(graph_query, "prune_batch", patched)


def test_sound_runs_are_correct():
    assert _run("g500-22-exact.hex6")["correct"]
    assert _run("g500-22-serve.cyc")["correct"]


@pytest.mark.parametrize("cell", ["g500-22-exact.hex6", "g500-22-serve.cyc",
                                  "g500-22-serve.acyc"])
def test_control_is_not_correct(cell):
    res = _run(cell, control=True)
    assert not res["correct"]
    assert res["checks"]["arc_diff"]["value"] > 0


@pytest.mark.parametrize("fault", [_unchanged, _altered])
def test_prune_faults_are_caught(monkeypatch, fault):
    _patch_prune(monkeypatch, fault)
    assert not _run("g500-22-exact.hex6")["correct"]


def test_a_wrong_count_is_caught(monkeypatch):
    from repro_torch.core import enumerate as enum_mod

    real = enum_mod.count_matches

    def off_by_one(*a, **kw):
        r = real(*a, **kw)
        return dataclasses.replace(r, n_embeddings=r.n_embeddings + 1)

    monkeypatch.setattr(enum_mod, "count_matches", off_by_one)
    res = _run("g500-22-exact.hex6")
    assert not res["correct"] and res["checks"]["count_diff"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_serving_faults_are_caught(monkeypatch, fault):
    faults = {
        "unchanged": lambda i, r, b: _unchanged(r),
        "half_left_out": lambda i, r, b: _emptied(r) if i >= b // 2 else r,
        "altered": lambda i, r, b: _altered(r) if i == 0 else r,
    }
    _patch_batch(monkeypatch, faults[fault])
    assert not _run("g500-22-serve.cyc")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["g500-22-exact.hex6", "g500-22-serve.cyc",
                                  "g500-22-serve.acyc"])
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(cell, scale=18, seconds=2.0, control=True, device="cuda",
               clients=32)
    assert not res["correct"]
