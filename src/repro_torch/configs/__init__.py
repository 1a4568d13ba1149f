"""Architecture registry: arch id -> (CONFIG, SHAPES, smoke()).

The ids of the JAX package's registry, all of which the port runs: the four
GNNs, the five LMs (qwen2-1.5b and qwen3-8b with GQA, starcoder2-15b with a
sliding window, LayerNorm and the GELU MLP, and the deepseek MLA + MoE
models, v3 with MTP) and bert4rec (recsys).
"""
from __future__ import annotations

import importlib
from typing import Dict

_MODULES: Dict[str, str] = {
    "pna": "repro_torch.configs.pna",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "gin-tu": "repro_torch.configs.gin_tu",
    "gat-cora": "repro_torch.configs.gat_cora",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "bert4rec": "repro_torch.configs.bert4rec",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    """Returns the arch's config module (CONFIG, SHAPES, smoke())."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str):
    """The arch's full-size config."""
    return get_arch(arch_id).CONFIG


def get_shapes(arch_id: str):
    """The arch's input shapes by name."""
    return get_arch(arch_id).SHAPES
