"""Dry run of every (architecture x input shape) cell on the meta device
(the JAX package's `launch/dryrun.py`).

For each cell (`launch/cells.py`): builds its state and inputs on the meta
device (shapes and dtypes, no storage), runs its step there under the cost
counter (`launch/op_cost.py`), and writes one JSON record,

  experiments/dryrun_torch/<mesh>/<arch>__<shape>.json

with the state, batch and output bytes and whether they fit the card's 80
GiB (temporaries are not known on meta, where the reference reads XLA's
`memory_analysis()`), the counted FLOPs (tensor-core and f32), bytes,
collective bytes and kernel calls, the model FLOPs, the three roofline
terms on the H100 (`launch/roofline.py`) and the resolved specs. A cell
whose shape is marked skipped gets a record with the reason. Per-device
numbers divide the counts by the shards the cell runs in one process (the
distributed GNN's sim backend).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--chips N] [--jobs J] [--out DIR] [--set K=V ...] [--set-shape K=V ...]

--set and --set-shape replace fields of the config and of the shape (a
cut: `--set n_layers=12 --set train_microbatches=2 --set-shape
global_batch=2`), and the records then go under DIR/cut/.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

CARD_MEMORY_GIB = 80
OUT_DIR = os.path.join("experiments", "dryrun_torch")


def mesh_name(chips: int) -> str:
    return "one_card" if chips == 1 else f"sim_{chips}"


def measure_cell(cell) -> Dict:
    """Runs `cell` under the counter -> (its record's measured fields)."""
    from repro_torch.launch.cells import tree_bytes, tree_ids
    from repro_torch.launch.op_cost import OpCounter, counted_step
    from repro_torch.launch.roofline import Roofline

    t0 = time.perf_counter()
    step = counted_step(cell)
    with OpCounter() as counter:
        out = step(*cell.args)
    trace_s = time.perf_counter() - t0
    counted = counter.summary()
    sh = cell.shards
    state_b, batch_b = tree_bytes(cell.args[0]), tree_bytes(cell.args[1:])
    # an output that is an argument (a cache updated in place) is counted once
    out_b = tree_bytes(out, skip=tree_ids(cell.args))
    resident = (state_b + batch_b + out_b) / 2**30
    rl = Roofline(
        arch=cell.arch, shape=cell.shape, mesh=mesh_name(sh), chips=sh,
        flops_tc_per_device=counted["flops_tc"] / sh,
        flops_f32_per_device=counted["flops_f32"] / sh,
        bytes_per_device=counted["bytes"] / sh,
        collective_bytes_per_device=counted["collectives"]["total"],
        model_flops=cell.model_flops_fn() if cell.model_flops_fn else None)
    return {
        "step_kind": cell.step_kind, "trace_s": trace_s,
        "memory": {
            "state_bytes": state_b, "batch_bytes": batch_b, "output_bytes": out_b,
            "arguments_and_outputs_gib": resident,
            "temp_bytes": None,
            "fits_80gib": resident <= CARD_MEMORY_GIB,
            "note": "temporaries are not known on the meta device",
        },
        "counted": counted,
        "model_flops": rl.model_flops,
        "roofline": rl.to_dict(),
        "specs": cell.shardings,
        "note": cell.note,
    }


def parse_val(v: str):
    """A --set value: a bool, an int, a float or else the string."""
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def parse_sets(pairs) -> Dict:
    """["k=v", ...] -> {k: parse_val(v)}."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        out[k] = parse_val(v)
    return out


def run_cell(arch: str, shape_name: str, chips: int = 1, out_dir: Optional[str] = OUT_DIR,
             cfg_overrides: Optional[Dict] = None,
             shape_overrides: Optional[Dict] = None) -> Dict:
    """The record of one cell (written under out_dir unless it is None)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import build_cell

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(chips), "chips": chips}
    if cfg_overrides or shape_overrides:
        rec.update(overrides=cfg_overrides or {}, shape_overrides=shape_overrides or {})
    cell = build_cell(arch, shape_name, chips=chips, cfg_overrides=cfg_overrides,
                      shape_overrides=shape_overrides)
    if cell is None:
        rec.update(status="skipped", reason=get_arch(arch).SHAPES[shape_name].skip)
    else:
        rec.update(status="ok", **measure_cell(cell))
    if out_dir is not None:
        d = os.path.join(out_dir, rec["mesh"])
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def line(rec: Dict) -> str:
    """One printed line per cell."""
    tag = f"{rec['mesh']} {rec['arch']} x {rec['shape']}"
    if rec["status"] == "skipped":
        return f"[skipped] {tag}: {rec['reason']}"
    if rec["status"] != "ok":
        return f"[FAIL] {tag}: {rec['error']}"
    r, m = rec["roofline"], rec["memory"]
    return (f"[ok] {tag}: {rec['step_kind']} flops={r['flops_tc_per_device'] + r['flops_f32_per_device']:.4e} "
            f"bytes={r['bytes_per_device']:.4e} coll={r['collective_bytes_per_device']:.4e} "
            f"args+out={m['arguments_and_outputs_gib']:.3f}GiB "
            f"{'fits' if m['fits_80gib'] else 'does not fit'} 80GiB "
            f"compute={r['compute_s']:.4e}s memory={r['memory_s']:.4e}s "
            f"coll={r['collective_s']:.4e}s -> {r['bottleneck']} "
            f"(traced in {rec['trace_s']:.1f} s)")


def _job(args):
    arch, shape, chips, out_dir, sets, shape_sets = args
    import torch

    torch.set_num_threads(1)
    try:
        return run_cell(arch, shape, chips, out_dir, sets, shape_sets)
    except Exception as e:  # a failing cell is a fault of the port: reported
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name(chips),
                "status": "failed", "error": repr(e)}


def _cost_order(cell_id) -> int:
    """Train cells first: they take the longest to trace."""
    from repro_torch.configs import get_arch

    return 0 if get_arch(cell_id[0]).SHAPES[cell_id[1]].step == "train" else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--chips", type=int, default=1,
                    help="chips of the cells (pads the GNN arrays; the "
                         "distributed GNN's shard count)")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--set", action="append", default=[],
                    help="config field override key=value (a cut)")
    ap.add_argument("--set-shape", action="append", default=[],
                    help="shape field override key=value (a cut)")
    args = ap.parse_args(argv)
    sets, shape_sets = parse_sets(args.set), parse_sets(args.set_shape)

    from repro_torch.configs import ARCH_IDS, get_arch

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    cells = [(a, s) for a in archs
             for s in ([args.shape] if args.shape else list(get_arch(a).SHAPES))]
    out = os.path.join(args.out, "cut") if sets or shape_sets else args.out
    jobs = [(a, s, args.chips, out, sets, shape_sets)
            for a, s in sorted(cells, key=_cost_order)]
    t0 = time.perf_counter()
    if args.jobs > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(args.jobs) as pool:
            recs = []
            for rec in pool.imap_unordered(_job, jobs):
                print(line(rec), flush=True)
                recs.append(rec)
    else:
        recs = []
        for job in jobs:
            recs.append(_job(job))
            print(line(recs[-1]), flush=True)
    failures = [r for r in recs if r["status"] == "failed"]
    print(f"{len(recs)} cells ({sum(r['status'] == 'ok' for r in recs)} ok, "
          f"{sum(r['status'] == 'skipped' for r in recs)} skipped, "
          f"{len(failures)} failed) in {time.perf_counter() - t0:.1f} s; "
          f"records in {out}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
