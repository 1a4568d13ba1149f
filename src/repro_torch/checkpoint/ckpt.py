"""Fault-tolerant checkpointing, the JAX package's `checkpoint/ckpt.py` on
host numpy arrays.

  - atomic: written to a temporary directory `<dir>/.tmp<step>_*`, then
    `os.replace`d to `<dir>/step_<k>` (a crashed writer never corrupts the
    newest checkpoint);
  - self-describing: a JSON manifest records the tree's keys, each array's
    global shape and dtype, and the caller's metadata (the pipeline records
    the backend and the shard count there);
  - elastic: arrays are saved as global host arrays, so a restore may
    target another shard count or device (the paper's LB-16 / LB-1);
  - retention: the newest `keep` checkpoints stay, older ones are deleted;
  - torn-write safe: the manifest is written and fsynced last, so a
    directory whose manifest parses is complete by construction;
    `restore_checkpoint(step=None)` also validates each candidate (manifest
    against arrays.npz shapes and dtypes) and skips a corrupt or partial
    directory with a warning, falling back to the newest valid one.

The on-disk layout and the manifest keys are the JAX package's: a tree is
flattened as `jax.tree_util` flattens it (dict keys sorted, lists and
tuples in order; `optim/tree.py`, the port's one walk), its leaves saved as `a0, a1, ...` in that order under
keys like `'omega'` or `'z'/1/'a'`, so a directory written by either
package restores in the other. Trees are nested dicts, lists and tuples of
arrays (numpy arrays or torch tensors, saved from the host).

bf16 leaves. numpy has no bf16 of its own, so the two packages write one
differently, and what crosses depends on the direction:
  - port to reference: the port writes a bf16 tensor as f32, which holds it
    exactly, with "float32" in the manifest; the reference restores it as
    f32 (it casts nothing);
  - reference to port: the reference writes `ml_dtypes`' bf16, which npz
    stores as the 2-byte void dtype `V2`, with "bfloat16" in the manifest.
    The port reads such a leaf as bf16 bits (a uint16 view, then
    `torch.bfloat16`) and restores it as a bf16 tensor (on the CPU when no
    device is given), bit for bit;
  - the reference cannot restore its own bf16 checkpoint: its manifest check
    compares "bfloat16" with the `V2` it reads back and skips the directory
    as corrupt. That side belongs to the JAX package.
A `V2` leaf whose manifest says anything but "bfloat16", or any other
mismatch of shape or dtype, is still corrupt.

On a mesh of ranks (`mesh=`, a `launch/mesh.RankMesh`, with `specs` the
tree's resolved specs), `save_checkpoint` gathers every leaf to its global
array and the mesh's first rank alone writes, so a checkpoint saved on a
mesh reads like one saved on one card; `restore_checkpoint(mesh=)` reads
the global arrays on every rank and keeps each rank's block of the
caller's mesh, which may be another than the one that saved (the
reference's `shardings=`).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import types
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.optim.tree import keyed_leaves, unflatten


def _treedef(tree) -> str:
    """The structure as `str(PyTreeDef)` spells it, for the manifest."""
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        leaf = leaf.detach().cpu()
        if str(leaf.dtype) == "torch.bfloat16":  # numpy has none: f32 holds it
            leaf = leaf.float()
        leaf = leaf.numpy()
    return np.asarray(leaf)


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    extra_meta: Optional[Dict] = None,
    keep: int = 3,
    mesh=None,
    specs=None,
) -> str:
    """Write `tree` as step `step` -> the checkpoint's directory. With
    `mesh`, every rank of the mesh calls it with its blocks (`specs`, their
    resolved specs): the leaves are gathered, the first rank writes, and
    every rank returns once the checkpoint is complete."""
    final = os.path.join(directory, f"step_{step:012d}")
    if mesh is not None:
        from repro_torch.launch.mesh import barrier
        from repro_torch.sharding import gather_tree

        tree = gather_tree(tree, specs, mesh)
        if mesh.is_first:
            save_checkpoint(directory, step, tree, extra_meta, keep)
        barrier(mesh)
        return final
    os.makedirs(directory, exist_ok=True)
    pairs = keyed_leaves(tree)
    arrays = {f"a{i}": _host(leaf) for i, (_, leaf) in enumerate(pairs)}
    manifest = {
        "step": step,
        "keys": [k for k, _ in pairs],
        "shapes": [list(arrays[f"a{i}"].shape) for i in range(len(pairs))],
        "dtypes": [str(arrays[f"a{i}"].dtype) for i in range(len(pairs))],
        "treedef": f"PyTreeDef({_treedef(tree)})",
        "meta": extra_meta or {},
    }
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp{step}_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        # manifest last and fsynced: its presence certifies the arrays landed
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def _all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_"))


def latest_step(directory: str) -> Optional[int]:
    steps = _all_steps(directory)
    return steps[-1] if steps else None


# the manifest's name of a bf16 leaf, which npz holds as 2-byte void (`V2`)
BF16 = "bfloat16"


def _is_bf16_bits(arr: np.ndarray, recorded: str) -> bool:
    """A leaf the reference wrote as ml_dtypes' bf16: npz's `V2` with the
    manifest's "bfloat16"."""
    return recorded == BF16 and arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def _dtype_matches(arr: np.ndarray, recorded: str) -> bool:
    return str(arr.dtype) == recorded or _is_bf16_bits(arr, recorded)


def _bf16_tensor(arr: np.ndarray):
    """bf16 bits held as `V2` -> a CPU torch.bfloat16 tensor of those bits."""
    import torch

    bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
    return torch.from_numpy(bits.reshape(arr.shape)).view(torch.bfloat16)


# every way a torn or truncated checkpoint can fail to read: unparseable
# JSON, a truncated or missing npz, manifest keys absent, or shape and dtype
# records that contradict the arrays
_CORRUPT_ERRORS = (OSError, ValueError, KeyError, EOFError,
                   json.JSONDecodeError, zipfile.BadZipFile)


def checkpoint_valid(path: str) -> bool:
    """Deep-validate one checkpoint directory: the manifest parses and every
    array of arrays.npz reads with the recorded shape and dtype (reading
    each member walks its compressed payload, so a truncated file fails
    here rather than in the middle of a restore)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        keys, shapes, dtypes = (manifest["keys"], manifest["shapes"],
                                manifest["dtypes"])
        with np.load(os.path.join(path, "arrays.npz"),
                     allow_pickle=False) as data:
            for i in range(len(keys)):
                arr = data[f"a{i}"]
                if list(arr.shape) != list(shapes[i]):
                    return False
                if not _dtype_matches(arr, dtypes[i]):
                    return False
        return True
    except _CORRUPT_ERRORS:
        return False


def latest_valid_step(directory: str) -> Optional[int]:
    """The newest step whose checkpoint passes deep validation; a corrupt or
    partial directory is skipped with a warning (a torn write costs one
    checkpoint of progress, never the run)."""
    for step in reversed(_all_steps(directory)):
        path = os.path.join(directory, f"step_{step:012d}")
        if checkpoint_valid(path):
            return step
        warnings.warn(
            f"skipping corrupt/partial checkpoint {path} (failed "
            "manifest/array validation)", RuntimeWarning, stacklevel=2)
    return None


def _global_shape(like, spec, mesh) -> Tuple[int, ...]:
    """The global shape of a block of `like`'s shape under a resolved spec."""
    from repro_torch.sharding import _block_index

    shape = list(getattr(like, "shape", ()))
    for dim, entry in enumerate(spec):
        if entry is not None:
            shape[dim] *= _block_index(entry, mesh)[1]
    return tuple(shape)


def restore_checkpoint(
    directory: str,
    like_tree: Any,
    step: Optional[int] = None,
    device=None,
    mesh=None,
    specs=None,
) -> Tuple[Any, Dict]:
    """Restore into the structure of `like_tree` -> (tree, meta with
    "step"). Leaves come back as host numpy arrays, or as torch tensors on
    `device` when one is given: the caller re-shards them for its own shard
    count. A bf16 leaf of the reference's comes back as a torch.bfloat16
    tensor of its bits, on the CPU without a device. Each restored global shape is checked against `like_tree`, so a
    configuration or topology mismatch fails here with the leaf's name.

    With step=None the newest valid checkpoint is used, skipping corrupt or
    partial directories with a warning; an explicit step is restored as it
    is and raises on corruption.

    With `mesh` (every rank of the mesh calls it), like_tree holds this
    rank's blocks under `specs`: the checkpoint's global leaves are checked
    against the global shapes they stand for, and each rank gets its block
    of the caller's mesh, a torch tensor on `device` (None: the CPU). The
    first rank chooses the step."""
    if mesh is not None:
        from repro_torch.launch.mesh import broadcast_int
        from repro_torch.sharding import is_spec_leaf, shard_leaf

        if step is None:
            found = latest_valid_step(directory) if mesh.is_first else None
            step = broadcast_int(-1 if found is None else found, mesh)
            if step < 0:
                raise FileNotFoundError(f"no valid checkpoints under {directory}")
        spec_list = [s for _, s in keyed_leaves(specs, is_leaf=is_spec_leaf)]
        globals_like = unflatten(like_tree, [
            types.SimpleNamespace(shape=_global_shape(l, sp, mesh)) for (_, l), sp
            in zip(keyed_leaves(like_tree), spec_list)])
        tree, meta = restore_checkpoint(directory, globals_like, step)
        blocks = [_own_block(shard_leaf(_to_device(a, "cpu"), sp, mesh), device)
                  for (_, a), sp in zip(keyed_leaves(tree), spec_list)]
        return unflatten(like_tree, blocks), meta
    if step is None:
        step = latest_valid_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    likes = [leaf for _, leaf in keyed_leaves(like_tree)]
    keys = manifest["keys"]
    if len(likes) != len(keys):
        raise ValueError(f"checkpoint has {len(keys)} leaves, expected "
                         f"{len(likes)}")
    shapes, dtypes = manifest.get("shapes"), manifest.get("dtypes")
    leaves = []
    for i, like in enumerate(likes):
        arr = data[f"a{i}"]
        # manifest against npz: on-disk corruption, whatever the caller asks
        if shapes is not None and list(arr.shape) != list(shapes[i]):
            raise ValueError(
                f"checkpoint leaf {keys[i]!r}: arrays.npz has shape "
                f"{tuple(arr.shape)} but the manifest recorded "
                f"{tuple(shapes[i])}: corrupt checkpoint")
        if dtypes is not None and not _dtype_matches(arr, dtypes[i]):
            raise ValueError(
                f"checkpoint leaf {keys[i]!r}: arrays.npz has dtype "
                f"{arr.dtype} but the manifest recorded {dtypes[i]}: corrupt "
                "checkpoint")
        # checkpoint against the restore target: a configuration mismatch
        want = getattr(like, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"checkpoint leaf {keys[i]!r} has global shape "
                f"{tuple(arr.shape)}, expected {tuple(want)}: the restore "
                "target was built from a different config")
        leaves.append(_bf16_tensor(arr) if dtypes is not None
                      and _is_bf16_bits(arr, dtypes[i]) else arr)
    if device is not None:
        leaves = [_to_device(a, device) for a in leaves]
    return (unflatten(like_tree, leaves),
            manifest["meta"] | {"step": manifest["step"]})


def _own_block(block, device):
    """A block (a view of a global leaf) as its own contiguous tensor on
    `device` (None: the CPU), so that the global leaf can be freed."""
    import torch

    return torch.empty(block.shape, dtype=block.dtype,
                       device=device or "cpu").copy_(block)


def _to_device(a, device):
    """A host array or CPU tensor as a torch tensor on `device` (None: as
    it is)."""
    if device is None:
        return a
    import torch

    return (a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a).reshape(a.shape))).to(device)


class CheckpointManager:
    """Step-cadence manager: `maybe_save` every `interval` steps, keeping
    the newest `keep`."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.directory = directory
        self.interval = interval
        self.keep = keep

    def maybe_save(self, step: int, tree: Any,
                   extra_meta: Optional[Dict] = None, mesh=None, specs=None):
        if self.interval > 0 and step % self.interval == 0:
            return save_checkpoint(self.directory, step, tree, extra_meta,
                                   self.keep, mesh=mesh, specs=specs)
        return None

    def restore_latest(self, like_tree: Any, device=None, mesh=None, specs=None):
        return restore_checkpoint(self.directory, like_tree, device=device,
                                  mesh=mesh, specs=specs)
