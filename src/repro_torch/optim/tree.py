"""Trees of tensors: nested dicts, lists and tuples, as the JAX package's
pytrees. Leaves are visited in `jax.tree_util`'s order (dict keys sorted,
lists and tuples in order), so a reduction over the leaves (the global
gradient norm) adds them in the reference's order. `checkpoint/ckpt.py`
flattens and rebuilds its trees here too: this order is also the order of
the arrays in a checkpoint, which both packages read."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def keyed_leaves(tree, path: Tuple[str, ...] = (), is_leaf=None) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in `jax.tree.leaves` order, each key the leaf's
    path as the JAX package's checkpoints spell it (`'opt'/'mu'/0`);
    `is_leaf(node)` may stop the walk at a container (a spec tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return [("/".join(path), tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in keyed_leaves(tree[k], path + (repr(k),), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in keyed_leaves(v, path + (str(i),), is_leaf)]
    return [("/".join(path), tree)]


def leaves(tree, is_leaf=None) -> List[Any]:
    """The leaves in `jax.tree.leaves` order."""
    return [x for _, x in keyed_leaves(tree, is_leaf=is_leaf)]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`, which
    share its structure -> a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, flat: List[Any]):
    """A tree of `like`'s structure holding `flat` in `leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)
