"""Three-term roofline of one cell on the card (the JAX package's
`launch/roofline.py`, with the H100's figures in place of the TPU's).

  compute term    = tensor-core FLOPs / PEAK_FLOPS
                    + other FLOPs and operations / PEAK_FLOPS_F32
  memory term     = bytes / HBM_BW
  collective term = collective bytes per device / LINK_BW

The counts come from `launch/op_cost.py` (per device: a cell runs on one
card, or on one of `chips` shards). The rates are the NVIDIA H100 SXM data
sheet's at its 700 W power limit: the memory and compute rates of the
kernel layer (`kernels/cost.py`: 3.35 TB/s HBM3, 989 TFLOP/s dense bf16,
67 TFLOP/s f32) and NVLink's 450 GB/s a direction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.kernels.cost import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_F32  # noqa: F401

LINK_BW = 450e9           # NVLink bytes/s a direction


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_tc_per_device: float      # bf16 / f16 products
    flops_f32_per_device: float     # f32 products and kernel operations
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: Optional[float]    # 6*N*D / 2*N*D analytic, global

    @property
    def flops_per_device(self) -> float:
        return self.flops_tc_per_device + self.flops_f32_per_device

    @property
    def compute_s(self) -> float:
        return (self.flops_tc_per_device / PEAK_FLOPS
                + self.flops_f32_per_device / PEAK_FLOPS_F32)

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs (global): a detector of remat and
        redundant work."""
        if not self.model_flops:
            return None
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else None

    @property
    def roofline_fraction(self) -> Optional[float]:
        """The share of the card's bf16 peak that the dominant term's time
        would realize on useful model FLOPs."""
        if not self.model_flops or self.bound_s <= 0:
            return None
        return (self.model_flops / self.chips) / (self.bound_s * PEAK_FLOPS)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_tc_per_device": self.flops_tc_per_device,
            "flops_f32_per_device": self.flops_f32_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
