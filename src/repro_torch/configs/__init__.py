"""Architecture registry: arch id -> (CONFIG, SHAPES, smoke()).

The ids of the architectures the port runs: the four GNNs, qwen2-1.5b (LM)
and bert4rec (recsys). The JAX package's other LM ids (starcoder2, qwen3,
the deepseek MLA/MoE models) need code paths the port does not have yet.
"""
from __future__ import annotations

import importlib
from typing import Dict

_MODULES: Dict[str, str] = {
    "pna": "repro_torch.configs.pna",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "gin-tu": "repro_torch.configs.gin_tu",
    "gat-cora": "repro_torch.configs.gat_cora",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "bert4rec": "repro_torch.configs.bert4rec",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    """Returns the arch's config module (CONFIG, SHAPES, smoke())."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])

