#!/bin/bash
# Shows that chip_smoke.py's bitset_wave checks (phase 2a, `wave_checks`)
# catch a kernel that reads or leaves a stale row. For each of three faults
# it copies chip_smoke.py and src/ into a temporary directory, plants the
# fault in the copy of csrc/bitset.cu, builds it and runs the checks:
#   gate     a hop reads its sources' rows without the previous hop's
#            candidacy gate, so non-candidate rows (leftovers) are ORed in;
#   split    a hop kernel no longer zeroes the next hop's split rows, so
#            their atomicOr lands on leftovers;
#   out      `out` is not zeroed before the hops, so its rows that the last
#            hop does not store keep leftovers.
# Exits 0 when every fault fails the checks, as it must.
# Needs one GPU; run from the repo root: bash tools/wave_fault_check.sh
set -u
root=$(pwd)
status=0
for fault in gate split out; do
  copy=$(mktemp -d)
  cp -r "$root/chip_smoke.py" "$root/src" "$copy/" || exit 1
  rm -rf "$copy/src/repro_torch/kernels/_build"
  FAULT=$fault python3 - "$copy" <<'PY' || exit 1
import os, sys
p = os.path.join(sys.argv[1], "src/repro_torch/kernels/csrc/bitset.cu")
s = open(p).read()
edits = {
    "gate": [("if (s[j] >= 0 && prev_cand[s[j]] == 0u) s[j] = -1;", "(void)0;")],
    "split": [("if (item.y == 0) zero_row(next_after, item.x, W);", "")],
    "out": [("err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * W * 4, st);",
             "err = cudaSuccess;")],
}[os.environ["FAULT"]]
for a, b in edits:
    assert s.count(a) == 1, f"the kernel line moved: update the fault: {a}"
    s = s.replace(a, b)
open(p, "w").write(s)
PY
  (cd "$copy" && python3 -c "
import numpy as np, chip_smoke as cs
from repro_torch.graph.structs import DeviceGraph
cs.phase_device()
rng = np.random.default_rng(cs.SEED)
hub = cs.spmm_edge_graphs(rng)['hub']
cs.wave_checks(rng, DeviceGraph.from_host(hub, 'cuda'), 0)
" > "$copy/run.log" 2>&1)
  rc=$?
  line=$(grep -a "RuntimeError: chip_smoke check failed" "$copy/run.log" | head -n 1 | cut -c1-300)
  if [ $rc -eq 0 ]; then
    echo "$fault: FAULT NOT CAUGHT: the checks passed"
    status=1
  elif [ -n "$line" ]; then
    echo "$fault: caught: $line"
  else
    echo "$fault: the run failed without a check failing:"
    tail -n 20 "$copy/run.log"
    status=1
  fi
  rm -rf "$copy"
done
exit $status
