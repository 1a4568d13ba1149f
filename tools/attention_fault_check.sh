#!/bin/bash
# Shows that chip_smoke.py's bf16 flash_attention checks catch a wrong
# kernel: copies chip_smoke.py and src/ into a temporary directory, plants
# a fault in the copy of the tensor-core kernel (one kv tile dropped for the
# last two q tiles of every head), builds it and runs the phase 6b check at
# the prefill_32k shape [1,12/2,32768,128]. Exits 0 when the check fails as
# it must, printing its max |diff| and the share of each allowance used.
# Needs one GPU; run from the repo root: bash tools/attention_fault_check.sh
set -u
root=$(pwd)
copy=$(mktemp -d)
trap 'rm -rf "$copy"' EXIT
cp -r "$root/chip_smoke.py" "$root/src" "$copy/" && cd "$copy" || exit 1
rm -rf src/repro_torch/kernels/_build
python3 - <<'PY' || exit 1
p = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
s = open(p).read()
a = "const float p = exp2f(s[4 * j + 2 * i + c] - m[i]);"
assert s.count(a) == 1, "the kernel's p line moved: update the fault"
s = s.replace(a, "const float p = (qi >= n_qtiles - 2 && t == n_tiles / 2) "
                 "? 0.f : exp2f(s[4 * j + 2 * i + c] - m[i]);")
open(p, "w").write(s)
PY
python3 -c "
import torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_device()
cs.phase_attention_timing([(1, 12, 2, 32768, 128, 1)])
" > "$copy/run.log" 2>&1
rc=$?
grep -a "check failed\|flash_attention \[" "$copy/run.log" | cut -c1-600
if [ $rc -eq 0 ]; then
  echo "FAULT NOT CAUGHT: the check passed a kernel that drops a kv tile"
  exit 1
fi
grep -aq "chip_smoke check failed: flash_attention \[1,12,32768,128\] differs" "$copy/run.log" \
  || { tail -n 20 "$copy/run.log"; exit 1; }
echo "fault caught"
