"""Architecture registry: arch id -> (CONFIG, SHAPES, smoke()).

The GNN ids only; the LM and recsys ids come with their slices of the port.
"""
from __future__ import annotations

import importlib
from typing import Dict

_MODULES: Dict[str, str] = {
    "pna": "repro_torch.configs.pna",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "gin-tu": "repro_torch.configs.gin_tu",
    "gat-cora": "repro_torch.configs.gat_cora",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    """Returns the arch's config module (CONFIG, SHAPES, smoke())."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])

