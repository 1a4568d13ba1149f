"""Counts the work of a program as it runs: floating-point operations,
bytes, collective bytes and hand-written kernel calls (the counterpart of
the JAX package's `launch/hlo_cost.py` and `launch/hlo_analysis.py`).

PyTorch has no HLO to read, so `OpCounter`, a `TorchDispatchMode`, counts
the aten ops that run, on the card or on the meta device (the dry run,
where nothing is computed):

  flops       `torch.utils.flop_counter`'s formulas (a product of [m, k] x
              [k, n] is 2mkn), split into tensor-core work (bf16 / f16
              operands) and the rest (f32: TF32 stays off)
  bytes       each op's operands and outputs, once each; a view moves
              none. This is `hlo_cost`'s rule without fusion: eager
              PyTorch fuses nothing
  collectives bytes per device by kind, recorded where a program marks
              them (`counted_prims`: the exchange and psum of the sharded
              GNN and, in its backward, the parameter gradients' reduction)
              -- `hlo_analysis.collective_bytes`' job. Only the counted run
              carries the marks: `counted_step` rebuilds a cell's step on
              marked prims, and the cell's own step has none
  kernels     each call of a kernel wrapper (`kernels/ops.py`) counts the
              (bytes, operations) of `kernels/cost.py` for its shapes, and
              the ops of the plain version inside it are not counted, so a
              kernel's work reads the same whether the kernel or its plain
              version ran

`hlo_cost`'s loop-trip correction (XLA counting a `while` body once) has
no counterpart: eager code counts every iteration as it runs it.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.engine import Prims
from repro_torch.kernels import registry

_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)
# ops that allocate or relabel without moving data
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "lift_fresh", "detach",
               "_local_scalar_dense", "set_", "resize_"}
_ACTIVE: Optional["OpCounter"] = None


def _moves_no_data(func) -> bool:
    if func._overloadpacket.__name__ in _NO_TRAFFIC:
        return True
    # a view: an output aliases an input without writing it
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """with OpCounter() as c: run(); c.summary() -> the counts of run()."""

    def __init__(self):
        super().__init__()
        self.flops_tc = 0
        self.flops_f32 = 0
        self.bytes = 0
        self.n_ops = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.collective_calls: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._in_kernel = 0

    def __enter__(self):
        global _ACTIVE
        self._prev = (_ACTIVE, registry.get_cost_hook())
        _ACTIVE = self
        registry.set_cost_hook(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE, hook = self._prev
        registry.set_cost_hook(hook)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def _kernel(self, name: str, cost, tensor_core: bool):
        """The cost hook: counts one kernel call by its formula and none of
        the ops inside it (a kernel called inside another's plain version
        is part of that version)."""
        if self._in_kernel:
            yield
            return
        nbytes, ops = cost
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0, "operations": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["operations"] += ops
        self.bytes += nbytes
        if tensor_core:
            self.flops_tc += ops
        else:
            self.flops_f32 += ops
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_kernel:
            return out
        self.n_ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            first = next(t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor))
            if first.dtype in _TENSOR_CORE_DTYPES:
                self.flops_tc += flops
            else:
                self.flops_f32 += flops
        if not _moves_no_data(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def record_collective(self, kind: str, nbytes: int) -> None:
        self.collectives[kind] += nbytes
        self.collective_calls[kind] += 1

    def summary(self) -> Dict:
        coll = dict(self.collectives)
        return {
            "flops_tc": self.flops_tc, "flops_f32": self.flops_f32,
            "flops": self.flops_tc + self.flops_f32, "bytes": self.bytes,
            "n_ops": self.n_ops,
            "collectives": {**coll, "total": sum(coll.values()),
                            **{f"n_{k}": v for k, v in self.collective_calls.items()}},
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


class _Mark(torch.autograd.Function):
    """The identity, recording a collective's bytes per device on the
    active counter: x's in the forward (unless `forward` is False) and its
    cotangent's in the backward, 1 / `shards` of each (x holds a slice per
    shard of this process)."""

    @staticmethod
    def forward(ctx, x, kind, shards, forward):
        ctx.kind, ctx.shards = kind, shards
        if forward:
            _record(kind, x, shards)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.kind, g, ctx.shards)
        return g, None, None, None


def _record(kind: str, t: torch.Tensor, shards: int) -> None:
    if _ACTIVE is not None:
        _ACTIVE.record_collective(kind, t.numel() * t.element_size() // shards)


def counted_prims(prims: Prims, P: int) -> Prims:
    """`prims` with the sharded GNN's collectives marked for the counter:
    each exchange as an all-to-all (forward, and its transpose in the
    backward), each psum as an all-reduce, and each parameter's gradient
    as the all-reduce that sums it over the shards (the transpose of a
    replicated input), per device. One shard moves nothing over a link, so
    P = 1 marks nothing."""
    if P == 1:
        return prims

    def exchange(x):  # [Pl, P, B, F]
        return prims.exchange(_Mark.apply(x, "all-to-all", x.shape[0], True))

    def psum(x):  # [Pl]
        return prims.psum(_Mark.apply(x, "all-reduce", x.shape[0], True))

    def grads(t):  # a parameter: its gradient's reduction, in the backward
        return _Mark.apply(t, "all-reduce", 1, False)

    replicate = prims.replicate
    return prims._replace(
        exchange=exchange, psum=psum,
        replicate=(grads if replicate is None else lambda t: replicate(grads(t))))


def counted_step(cell) -> Callable:
    """The step to run under the counter: a `launch/cells.Cell`'s `fn`, or,
    for a cell built on collectives, its step rebuilt on `counted_prims`."""
    if cell.prims is None:
        return cell.fn
    return cell.build_fn(counted_prims(cell.prims, cell.shards))
