"""The process group the `spmd` backend shards over, and the (data, model)
mesh of ranks the LM train step runs on (the JAX package's
`launch/mesh.py`, with ranks for devices).

    group = make_shard_group(P, backend="gloo", init_method="file:///tmp/x",
                             rank=r)
    res = prune(g, t, mesh=group, device="cpu")   # on every rank

    mesh = make_rank_mesh((2, 2))                 # after make_shard_group(4, ...)
    step = build_train_step(model, tc, mesh=mesh)

Nothing here reads a cluster's environment on its own beyond the usual
`RANK` / `WORLD_SIZE` / `MASTER_ADDR` variables `torch.distributed` knows:
a caller on one machine gives the address (`tcp://localhost:<port>` or a
`file://` path), the rank and the size itself. Under NCCL each rank runs on
`cuda:<local rank>`; NCCL refuses two ranks on one GPU, so a one-card
machine runs an NCCL group of one, and several ranks on one card use gloo
(a collective's CUDA tensors staged through host memory, `_staged`).

The mesh's collectives (`all_reduce`, `all_gather`, `reduce_scatter` over
one axis) and their autograd (`copy_to_model`, `reduce_from_model`,
`gather_from_model`, `gather_data`) are at the end of the module. A
collective that fails raises: nothing falls back to one rank.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch

from repro_torch.sharding import MeshShape


def make_shard_group(P: Optional[int] = None, *, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = 60.0):
    """A `torch.distributed` process group whose size is the shard count P
    (the JAX package's `make_shard_mesh`): the default group, initialised
    here when there is none. `backend` defaults to "nccl" where CUDA is
    available, else "gloo"; `rank` to `RANK`; the world size to P (else
    `WORLD_SIZE`)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        world = P if P is not None else int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    world = dist.get_world_size()
    if P is not None and int(P) != world:
        raise ValueError(f"asked for {P} shards but the world has {world} ranks")
    return dist.group.WORLD


def sub_group(group, P_new: int):
    """The first P_new ranks of `group` as a group of their own, for an spmd
    restart onto fewer shards (the JAX package's `_mesh_for`: a torch group
    cannot shrink in place). Collective: every rank of the job calls it
    together, as `torch.distributed.new_group` requires, so `group` is the
    default group or every other rank calls it too. A rank outside the new
    group gets None."""
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)[:int(P_new)]
    sub = dist.new_group(ranks=ranks, backend=dist.get_backend(group))
    if sub == dist.GroupMember.NON_GROUP_MEMBER or dist.get_rank(sub) < 0:
        return None
    return sub


# --------------------------------------------------------------- rank mesh
MESH_AXES = ("data", "model")


class RankMesh:
    """A (data, model) mesh of `torch.distributed` ranks (the JAX package's
    `make_local_mesh` mesh, with ranks for devices).

    The mesh's ranks are ordered row-major, as `jax.make_mesh` orders its
    devices: the rank at coordinates (d, m) is ranks[d * model + m]. Each
    axis has one subgroup per line of the grid, the ranks that share the
    other coordinate; this rank holds the group of its own line
    (`group(axis)`). An axis of size 1 has no group and its collectives are
    identities, so a (1, 1) mesh runs the single-process step.

    `shape` is the `sharding.MeshShape` the rules resolve against; the
    collectives of `launch/mesh.py` take the mesh and an axis name."""

    def __init__(self, shape: MeshShape, ranks, rank: int, groups, whole,
                 backend: str):
        self.shape = shape
        self.ranks = list(ranks)
        self.rank = rank
        self._groups = groups
        self.whole = whole
        self.backend = backend
        pos = self.ranks.index(rank)
        coords = []
        for size in reversed(shape.shape):
            coords.append(pos % size)
            pos //= size
        self.coords = dict(zip(shape.axis_names, reversed(coords)))

    def size(self, axis: str) -> int:
        return dict(zip(self.shape.axis_names, self.shape.shape)).get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    @property
    def n_ranks(self) -> int:
        return len(self.ranks)

    @property
    def is_first(self) -> bool:
        """The mesh's first rank: the one that writes (checkpoints)."""
        return self.rank == self.ranks[0]

    def __repr__(self):
        dims = ", ".join(f"{a}={s}" for a, s in zip(self.shape.axis_names,
                                                   self.shape.shape))
        return f"RankMesh({dims}; rank {self.rank} at {self.coords})"


def make_rank_mesh(shape=(1, 1), *, ranks=None,
                   axis_names=MESH_AXES) -> Optional[RankMesh]:
    """A `RankMesh` of `shape` over `ranks` (default: every rank of the
    default group, which must be initialised, e.g. by `make_shard_group`).

    Collective: every rank of the default group calls it with the same
    arguments, as `torch.distributed.new_group` requires, and every one
    creates every subgroup in the same order. A rank outside `ranks` gets
    None."""
    import numpy as np
    import torch.distributed as dist

    shape = tuple(int(s) for s in shape)
    mesh_shape = MeshShape(tuple(axis_names), shape)
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"given {len(ranks)}")
    me = dist.get_rank()
    backend = dist.get_backend()
    grid = np.asarray(ranks).reshape(shape)
    groups = {}
    for i, name in enumerate(axis_names):
        if shape[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]).tolist():
            g = dist.new_group(ranks=line, backend=backend)
            if me in line:
                groups[name] = g
    whole = (dist.group.WORLD if ranks == list(range(world))
             else dist.new_group(ranks=ranks, backend=backend))
    if me not in ranks:
        return None
    return RankMesh(mesh_shape, ranks, me, groups, whole, backend)


def local_mesh() -> RankMesh:
    """The (1, 1) mesh of one process, made without torch.distributed:
    every collective on it is the identity."""
    return RankMesh(MeshShape(MESH_AXES, (1, 1)), [0], 0, {}, None, "local")


# ------------------------------------------------------ collectives on a mesh
# The multi-rank runs on one card use gloo (NCCL refuses two ranks on one
# GPU). Gloo's collectives take host tensors, so a CUDA tensor is staged
# through host memory for the collective and copied back: the transport,
# not a change of where the computation runs. The staging buffers are
# page-locked and kept between calls (one for what is sent, one for what
# comes back, per dtype, grown to the largest collective), so each copy is
# one DMA at the link's rate. A tensor travels in its own dtype; gloo adds
# bf16 in f32 and rounds each sum, which over two ranks is the sum rounded
# once.
_PINNED: dict = {}


def _pinned(slot: str, shape, dtype) -> torch.Tensor:
    n = math.prod(shape)
    buf = _PINNED.get((slot, dtype))
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
        _PINNED[(slot, dtype)] = buf
    return buf[:n].view(shape)


def _staged(mesh: RankMesh, x: torch.Tensor):
    """(the tensor the backend sends, a function that brings a result back
    to x's device)."""
    x = x.detach().contiguous()
    if mesh.backend != "gloo" or not x.is_cuda:
        return x, (lambda r: r)
    y = _pinned("send", tuple(x.shape), x.dtype)
    y.copy_(x)
    return y, (lambda r: r.to(x.device))


def _receive_buffer(mesh: RankMesh, like: torch.Tensor, shape) -> torch.Tensor:
    """Where a collective's result lands: page-locked host memory for a
    staged CUDA tensor, else a new tensor beside `like`."""
    if mesh.backend == "gloo" and like.is_pinned():
        return _pinned("receive", tuple(shape), like.dtype)
    return like.new_empty(shape)


def _all_gather_single():
    """`all_gather_single` (the name of torch >= 2.13), else its older name
    `all_gather_into_tensor`: one collective under two names."""
    import torch.distributed as dist

    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _reduce_scatter_single():
    import torch.distributed as dist

    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_reduce(x: torch.Tensor, mesh: RankMesh, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (or "max") of x over `axis`, as a new tensor."""
    import torch.distributed as dist

    if mesh.size(axis) == 1:
        return x
    y, back = _staged(mesh, x)
    out = _receive_buffer(mesh, y, y.shape)
    out.copy_(y)
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=mesh.group(axis))
    return back(out)


def all_gather(x: torch.Tensor, mesh: RankMesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The chunks of `axis`'s ranks concatenated along `dim`, in the axis's
    order."""
    import torch.distributed as dist

    n = mesh.size(axis)
    if n == 1:
        return x
    y, back = _staged(mesh, x.movedim(dim, 0))
    out = _receive_buffer(mesh, y, (n * y.shape[0],) + tuple(y.shape[1:]))
    _all_gather_single()(out, y, group=mesh.group(axis))
    return back(out).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh: RankMesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of x over `axis`."""
    import torch.distributed as dist

    n = mesh.size(axis)
    if n == 1:
        return x
    y, back = _staged(mesh, x.movedim(dim, 0))
    out = _receive_buffer(mesh, y, (y.shape[0] // n,) + tuple(y.shape[1:]))
    _reduce_scatter_single()(out, y, group=mesh.group(axis))
    return back(out).movedim(0, dim)


def chunk(x: torch.Tensor, mesh: RankMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's chunk of x along `dim`, split evenly over `axis`."""
    n = mesh.size(axis)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * size, size)


def broadcast_int(value: int, mesh: RankMesh) -> int:
    """The first rank's `value` on every rank of the mesh."""
    import torch.distributed as dist

    if mesh.n_ranks == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    if mesh.backend != "gloo":
        t = t.cuda()
    dist.broadcast(t, src=mesh.ranks[0], group=mesh.whole)
    return int(t.item())


def any_rank(flag: bool, mesh: RankMesh) -> bool:
    """Whether `flag` holds on any rank of the mesh (collective)."""
    import torch.distributed as dist

    if mesh.n_ranks == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    if mesh.backend != "gloo":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.whole)
    return bool(t.item())


def barrier(mesh: RankMesh) -> None:
    import torch.distributed as dist

    if mesh.n_ranks > 1:
        dist.barrier(group=mesh.whole)


# --------------------------------------- the collectives' autograd (Megatron)
# The conjugate pairs of Megatron-LM (Shoeybi et al., arXiv:1909.08053) on
# the model axis, and FSDP's gather on the data axis. A tensor replicated
# over `model` that enters a computation split over `model` passes through
# `copy_to_model`; partial results leaving it pass through
# `reduce_from_model`. With the pair at every such crossing, everything
# computed outside the split parts is replicated over `model`, forward and
# backward, and a leaf replicated over `model` gets its whole gradient, the
# same on every model rank.
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the cotangent summed over `model` backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over `model` forward; identity backward (the cotangent of a
    replicated result is already replicated: summing it again would count
    it `model` times)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather over `model` along `dim` forward, feeding a computation
    replicated over `model`; this rank's chunk of the (replicated)
    cotangent backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.mesh, "model", ctx.dim).contiguous(), None, None


class _GatherData(torch.autograd.Function):
    """All-gather over `data` along `dim` forward (FSDP's gather of a
    leaf at use, or the tokens of every data rank); backward, the cotangent
    reduce-scattered over `data` when the data ranks saw different rows
    (their contributions are summed: the data-parallel sum), or this rank's
    chunk when they saw the same rows."""

    @staticmethod
    def forward(ctx, x, mesh, dim, summed):
        ctx.mesh, ctx.dim, ctx.summed = mesh, dim, summed
        return all_gather(x, mesh, "data", dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter(g, ctx.mesh, "data", ctx.dim), None, None, None
        return chunk(g, ctx.mesh, "data", ctx.dim).contiguous(), None, None, None


def copy_to_model(x, mesh):
    return x if mesh.size("model") == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    return x if mesh.size("model") == 1 else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh, dim):
    return x if mesh.size("model") == 1 else _GatherFromModel.apply(x, mesh, dim)


def gather_data(x, mesh, dim, summed):
    return x if mesh.size("data") == 1 else _GatherData.apply(x, mesh, dim, summed)
