"""Logical-axis sharding rules, resolved against a mesh's axis names and
sizes (the JAX package's `sharding.py`).

Every parameter and activation of the JAX package is annotated with a tuple
of *logical* axis names; `logical_to_physical` maps them onto mesh axes by a
rule table. The port keeps the table and its resolution as data: a mesh is
a `MeshShape` (axis names and sizes, no devices), and a resolved spec is a
tuple with one entry per dimension (a mesh axis name, a tuple of them, or
None), where the reference returns a `PartitionSpec`. On one card every
rule resolves to None.

On a mesh of ranks (`launch/mesh.py`'s `RankMesh`), `shard_leaf` and
`shard_tree` place a global tensor as `jax.device_put(x, NamedSharding)`
does, keeping this rank's block, and `gather_leaf` and `gather_tree`
rebuild the global tensor from every rank's block.

Parallelism encoded by the default rules (on the reference's meshes):
  FSDP  -- parameter "embed"/"ff_in" dims sharded over the data axis(es)
  TP    -- "heads" / "ff_out" / "vocab" sharded over the model axis
  EP    -- "expert" over the model axis
  SP    -- "seq" over the model axis for sequence-parallel activations
  DP    -- "batch" over (pod, data)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
DEFAULT_RULES: Dict[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",         # sequence-parallel regions
    "act_embed": None,
    "act_heads": "model",
    "act_kv": "model",
    "act_ff": "model",         # Megatron TP: ff activation column-sharded
    "act_tokens": ("pod", "data"),  # flattened token dim (MoE dispatch)
    # params: attention
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_rope": None,
    "kv_lora": None,
    # params: mlp
    "embed": "data",           # FSDP shard dim
    "ff": "model",             # TP shard dim (column for in-proj, row for out-proj)
    # moe
    "expert": "model",
    "expert_ff": None,
    "expert_embed": "data",
    # embeddings
    "vocab": "model",
    "item": "model",
    "candidates": "model",
    # gnn / engine
    "nodes": ("pod", "data"),
    "edges": ("pod", "data", "model"),
    "feat": None,
    "words": None,
    "classes": None,
    # misc
    "table_rows": "model",     # recsys embedding tables: row (vocab)-sharded
    "table_dim": None,
}

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as the rules see it: its axis names and their sizes."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.shape)} sizes")


# the reference's production meshes (launch/mesh.py), and one card: no
# mesh axis, so every rule resolves to None
SINGLE_POD = MeshShape(("data", "model"), (16, 16))
MULTI_POD = MeshShape(("pod", "data", "model"), (2, 16, 16))
ONE_CARD = MeshShape((), ())


def is_spec_leaf(x) -> bool:
    """A logical spec: a tuple of axis names or None."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def logical_to_physical(logical: Sequence[Optional[str]], mesh: MeshShape,
                        rules: Optional[Dict[str, object]] = None) -> Spec:
    """A tuple of logical axis names -> the mesh axes each dimension is
    sharded over (a name, a tuple of names, or None); a mesh axis is used at
    most once, by the first dimension that asks for it."""
    rules = rules or DEFAULT_RULES
    avail = set(mesh.axis_names)
    used = set()
    out = []
    for name in logical:
        phys = None if name is None else rules.get(name)
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        sel = tuple(a for a in phys if a in avail and a not in used)
        used.update(sel)
        out.append(None if not sel else sel[0] if len(sel) == 1 else sel)
    return tuple(out)


def resolve_axis_spec(shape, logical: Sequence[Optional[str]], mesh: MeshShape,
                      rules=None) -> Spec:
    """Logical axes -> a spec of len(shape) entries with a divisibility
    guard: mesh axes that do not divide the dimension are dropped (the
    longest dividing prefix is kept for a tuple)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    spec = logical_to_physical(logical, mesh, rules)
    fixed = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            fixed.append(None)
            continue
        kept = ()
        for a in (ax,) if isinstance(ax, str) else tuple(ax):
            size = math.prod(sizes[b] for b in kept + (a,))
            if shape[i] % size == 0 and shape[i] > 0:
                kept = kept + (a,)
            else:
                break
        fixed.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    fixed = fixed[: len(shape)]
    fixed += [None] * (len(shape) - len(fixed))
    return tuple(fixed)


def tree_shardings(spec_tree, mesh: MeshShape, rules=None):
    """A tree (dicts and lists) of logical-axis tuples -> the same tree of
    resolved specs (the reference's NamedShardings, as their specs)."""
    if is_spec_leaf(spec_tree):
        return logical_to_physical(spec_tree, mesh, rules)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, mesh, rules) for k, v in spec_tree.items()}
    return [tree_shardings(v, mesh, rules) for v in spec_tree]


# ------------------------------------------------------------ active mesh
# The reference installs a mesh here while it traces a cell, so that the
# models' constrain() annotations become sharding constraints. The port
# keeps the context for its callers; nothing in the port reads it.
_ACTIVE_MESH: Optional[MeshShape] = None


def set_active_mesh(mesh: Optional[MeshShape]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


class active_mesh:
    def __init__(self, mesh: Optional[MeshShape]):
        self.mesh = mesh

    def __enter__(self):
        self.prev = _ACTIVE_MESH
        set_active_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_active_mesh(self.prev)


def constrain(x, *logical: Optional[str], rules=None):
    """Returns x unchanged. The reference applies a sharding constraint
    against the active mesh here and GSPMD realises it; the port has no
    GSPMD: on a mesh of ranks the layout is realised by the model's explicit
    collectives (`models/transformer.py` with `launch/mesh.py`), not by the
    constraint."""
    return x


# ------------------------------------------------- placing and gathering
def _block_index(spec_entry, mesh) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dimension sharded
    over a mesh axis or a tuple of them (row-major over the tuple)."""
    axes = (spec_entry,) if isinstance(spec_entry, str) else tuple(spec_entry)
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.size(a) + mesh.index(a)
        n *= mesh.size(a)
    return idx, n


def shard_leaf(x, spec: Spec, mesh):
    """This rank's block of the global tensor x under a resolved spec (the
    counterpart of `jax.device_put(x, NamedSharding(mesh, spec))`): a view
    of x, narrowed on each sharded dimension."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = _block_index(entry, mesh)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
    return x


def gather_leaf(local, spec: Spec, mesh):
    """The global tensor from every rank's block under a resolved spec
    (collective: every rank of the mesh calls it)."""
    from repro_torch.launch.mesh import all_gather

    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in reversed(axes):
            local = all_gather(local, mesh, a, dim)
    return local


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec_leaf(specs):
        return type(tree)(_map_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, spec_tree, mesh):
    """`shard_leaf` over a tree and its resolved specs (the structure of
    `launch/abstract.shardings_for`'s)."""
    return _map_specs(lambda x, s: shard_leaf(x, s, mesh), tree, spec_tree)


def gather_tree(tree, spec_tree, mesh):
    """`gather_leaf` over a tree and its resolved specs, leaf by leaf in the
    tree's order on every rank."""
    return _map_specs(lambda x, s: gather_leaf(x, s, mesh), tree, spec_tree)
