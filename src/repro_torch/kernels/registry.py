"""Kernel routing: route names, the kernel-or-plain choice, launch counts.

A wrapper in `ops.py` runs its CUDA kernel for a tensor on a CUDA device and
its plain PyTorch version (`ref.py`) for a tensor on the CPU, and raises for
any other device. The choice follows the tensor's device only: there is no
fallback from a kernel to its plain version.

Each kernel has a plain-integer launch count that its wrapper raises by one
for every kernel launch, and nowhere else, so a run can show that it went
through the kernels. A kernel with more than one variant (`flash_attention`:
"bf16_tc" on the tensor cores, "f32" on the CUDA cores) also counts each
variant's launches.

Route names are the JAX package's. Without a pin, the LCC sweep takes the
packed route (`bitset_spmm`) and NLCC waves take the fused route
(`bitset_wave`); the capability gates of `core/lcc.py` and `core/nlcc.py`
send a run to the boolean planes where the packed words cannot express it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

ROUTE_PACKED = "packed"
ROUTE_UNPACKED = "unpacked"
ROUTE_FUSED = "fused"

LCC_ROUTES = (ROUTE_PACKED, ROUTE_UNPACKED)
NLCC_ROUTES = (ROUTE_PACKED, ROUTE_UNPACKED, ROUTE_FUSED)

# the kernels of the prune path, the GNN path, the LM path and the recsys path
PRUNE_KERNELS = ("bitset_spmm", "bitset_wave")
GNN_KERNELS = ("segment_agg",)
LM_KERNELS = ("flash_attention",)
RECSYS_KERNELS = ("embedding_bag",)
KERNELS = PRUNE_KERNELS + GNN_KERNELS + LM_KERNELS + RECSYS_KERNELS
VARIANTS = {"flash_attention": ("bf16_tc", "f32")}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_variant_launches: Dict[str, Dict[str, int]] = {
    name: {v: 0 for v in variants} for name, variants in VARIANTS.items()}


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def count_launch(name: str, k: int = 1, variant: Optional[str] = None) -> None:
    _launches[name] += k
    if variant is not None:
        _variant_launches[name][variant] += k


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0
    for counts in _variant_launches.values():
        for variant in counts:
            counts[variant] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def variant_counts(name: str) -> Dict[str, int]:
    """Launches of each variant of kernel `name` since the last reset."""
    return dict(_variant_launches[name])


def check_route(route: str, allowed) -> str:
    if route not in allowed:
        raise ValueError(f"unknown route {route!r}; expected one of {allowed}")
    return route
