"""Allocation-free state construction and sharding resolution (the JAX
package's `launch/abstract.py`).

`abstract_init` builds a cell's state on the meta device: every tensor has
its shape and dtype and no storage, so a production-size state costs
nothing to make (the models draw no weights there, `models/common.py`
`generator`). The init function returns the logical spec tree beside the
tensors, as the reference's `init` does.

`shardings_for` resolves a tree's logical axes against a `MeshShape`, with
the divisibility guard of `sharding.resolve_axis_spec` (a mesh axis that
does not divide the dimension is dropped).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.sharding import MeshShape, is_spec_leaf, resolve_axis_spec

META = torch.device("meta")


def abstract_init(fn: Callable, *args, **kwargs) -> Tuple[Any, Any]:
    """fn(*args, device=..., **kwargs) must return (tensor tree, spec
    tree); it is called with the meta device, so nothing is allocated."""
    return fn(*args, device=META, **kwargs)


def resolve_spec(t, logical, mesh: MeshShape, rules=None) -> Tuple:
    """Logical axes -> the mesh axes of each of t's dimensions, dropping
    those that do not divide them."""
    return resolve_axis_spec(tuple(getattr(t, "shape", ())), logical, mesh, rules)


def shardings_for(tree, spec_tree, mesh: MeshShape, rules=None):
    """The tree of resolved specs matching `tree`'s structure; a leaf whose
    spec is missing (or not a logical spec) is replicated."""
    if isinstance(tree, dict):
        return {k: shardings_for(v, _child(spec_tree, k), mesh, rules)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shardings_for(v, _child(spec_tree, i), mesh, rules)
                          for i, v in enumerate(tree))
    logical = spec_tree if is_spec_leaf(spec_tree) else ()
    return resolve_spec(tree, logical, mesh, rules)


def _child(spec_tree, key):
    if isinstance(spec_tree, dict):
        return spec_tree.get(key)
    if isinstance(spec_tree, (list, tuple)) and not is_spec_leaf(spec_tree):
        return spec_tree[key] if key < len(spec_tree) else None
    return None
