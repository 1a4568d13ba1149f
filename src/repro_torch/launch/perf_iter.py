"""One cell of the dry run with config overrides (the JAX package's
`launch/perf_iter.py`): the hypothesis -> change -> measure loop on the
counted work, against the cell's record from `launch/dryrun.py`.

  PYTHONPATH=src python -m repro_torch.launch.perf_iter --arch pna \\
      --shape ogb_products --chips 2 --set distributed=true \\
      --set message_dtype=bfloat16 --tag bf16

writes experiments/perf_torch/<arch>__<shape>__<tag>.json and prints the
three roofline terms beside the baseline's. It is the only way to reach the
distributed GNN cell (`distributed=true`), as in the reference.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import OUT_DIR, mesh_name, parse_sets, run_cell

PERF_DIR = os.path.join("experiments", "perf_torch")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="config field override key=value")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--tag", default="iter")
    ap.add_argument("--out", default=PERF_DIR)
    ap.add_argument("--baseline", default=OUT_DIR,
                    help="the dry run's records to compare with")
    args = ap.parse_args(argv)

    overrides = parse_sets(args.set)
    rec = run_cell(args.arch, args.shape, args.chips, out_dir=None,
                   cfg_overrides=overrides)
    rec.update(tag=args.tag, overrides=overrides)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.arch}__{args.shape}__{args.tag}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] != "ok":
        print(f"{args.tag}: {args.arch} x {args.shape} skipped: {rec['reason']}")
        return rec
    r = rec["roofline"]
    print(f"{args.tag}: compute={r['compute_s']:.4e}s memory={r['memory_s']:.4e}s "
          f"coll={r['collective_s']:.4e}s -> {r['bottleneck']} "
          f"(args+out {rec['memory']['arguments_and_outputs_gib']:.3f} GiB, "
          f"roofline_fraction={r['roofline_fraction']})")
    base_path = os.path.join(args.baseline, mesh_name(args.chips),
                             f"{args.arch}__{args.shape}.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            b = json.load(f)["roofline"]
        for term in ("compute_s", "memory_s", "collective_s"):
            if b[term] > 0 and r[term] > 0:
                print(f"  {term}: {b[term]:.4e} -> {r[term]:.4e} "
                      f"({b[term] / r[term]:.2f}x better)")
    return rec


if __name__ == "__main__":
    main()
