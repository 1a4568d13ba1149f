"""The process group the `spmd` backend shards over.

    group = make_shard_group(P, backend="gloo", init_method="file:///tmp/x",
                             rank=r)
    res = prune(g, t, mesh=group, device="cpu")   # on every rank

Nothing here reads a cluster's environment on its own beyond the usual
`RANK` / `WORLD_SIZE` / `MASTER_ADDR` variables `torch.distributed` knows:
a caller on one machine gives the address (`tcp://localhost:<port>` or a
`file://` path), the rank and the size itself. Under NCCL each rank runs on
`cuda:<local rank>`; NCCL refuses two ranks on one GPU, so a one-card
machine runs a group of one.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch


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
