"""Kernel routing: route names, the kernel-or-plain choice, launch counts.

A wrapper in `ops.py` runs its CUDA kernel for a tensor on a CUDA device and
its plain PyTorch version (`ref.py`) for a tensor on the CPU, and raises for
any other device. The choice follows the tensor's device only, with one
exception that is not a fallback: the degradation ladder's ref rung
(`core/resilience.py`), reached only after an injected kernel fault has
spent its retries, runs the plain versions on the card under
`mode_override(MODE_REF)`. Those calls are counted apart from kernel
launches (`plain_counts`), so a run shows whether it took that rung.

Each kernel has a plain-integer launch count that its wrapper raises by one
for every kernel launch, and nowhere else, so a run can show that it went
through the kernels. A kernel with more than one variant (`flash_attention`:
"bf16_tc" on the tensor cores, "f32" on the CUDA cores) also counts each
variant's launches. Launches made while the autograd engine runs a backward
(the forwards that `remat` recomputes there) are also counted apart
(`backward_launch_counts`).

Route names are the JAX package's. Without a pin or a tuned policy, the LCC
sweep takes the packed route (`bitset_spmm`), NLCC waves take the fused
route (`bitset_wave`) and enumeration the host join; the capability gates of
`core/lcc.py` and `core/nlcc.py` send a run to the boolean planes where the
packed words cannot express it.

Dispatch policy
---------------

Above the kernels sits a measured-cost policy (`DispatchPolicy`): a table of
route decisions per (route name, backend, shape bucket), produced by `tune()`
(which times each candidate route) and persisted to a JSON cache
(`policy_path()`, overridable by ``REPRO_TORCH_DISPATCH_POLICY``), plus a
table of tuned query plans (`core/planner.py`). The backend is the device
type, "cuda" or "cpu". `resolve_route` serves route decisions to
`core/lcc.py`, `core/nlcc.py` and `core/enumerate.py`; with no policy, or no
entry for the bucket, it returns the caller's default, so an untuned run
routes as above. The policy chooses among routes only: which of a kernel and
its plain version runs still follows the tensor's device, and no entry can
send a CUDA tensor to a plain version.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

ROUTE_PACKED = "packed"
ROUTE_UNPACKED = "unpacked"
ROUTE_FUSED = "fused"
# the enumeration join (route name ``enumerate.join``, core/enumerate.py):
# host = the numpy row-table join over the compacted subgraph, device = the
# device-resident join (core/join.py)
ROUTE_HOST = "host"
ROUTE_DEVICE = "device"
# row placements of the sharded device join, which the port has not yet:
# naming them on the local backend raises, as in the JAX package
ROUTE_REPLICATED = "replicated"
ROUTE_ROWSHARDED = "rowsharded"

LCC_ROUTES = (ROUTE_PACKED, ROUTE_UNPACKED)
NLCC_ROUTES = (ROUTE_PACKED, ROUTE_UNPACKED, ROUTE_FUSED)

# the kernels of the prune path, the GNN path, the LM path and the recsys path
PRUNE_KERNELS = ("bitset_spmm", "bitset_wave")
GNN_KERNELS = ("segment_agg",)
LM_KERNELS = ("flash_attention",)
RECSYS_KERNELS = ("embedding_bag",)
KERNELS = PRUNE_KERNELS + GNN_KERNELS + LM_KERNELS + RECSYS_KERNELS
VARIANTS = {"flash_attention": ("bf16_tc", "f32")}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_variant_launches: Dict[str, Dict[str, int]] = {
    name: {v: 0 for v in variants} for name, variants in VARIANTS.items()}
_backward_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


# ------------------------------------------------------------ cost seam
# `set_cost_hook` installs the cost counter of `launch/op_cost.py`: each
# kernel wrapper of `kernels/ops.py` on this slice's paths calls
# hook(name, (bytes, operations), tensor_core) around its work, which
# counts the call by `kernels/cost.py` and not the plain version's ops
_COST_HOOK: Optional[Callable] = None


def set_cost_hook(hook: Optional[Callable]) -> None:
    global _COST_HOOK
    _COST_HOOK = hook


def get_cost_hook() -> Optional[Callable]:
    return _COST_HOOK


# ------------------------------------------------------ resilience seam
# MODE_KERNEL runs a CUDA tensor's kernel; MODE_REF the plain version
MODE_KERNEL = "kernel"
MODE_REF = "ref"
MODES = (MODE_KERNEL, MODE_REF)
# `mode_override` is the ladder's ref rung: every wrapper call inside the
# context runs the plain version, on the card too
_MODE_OVERRIDE: Optional[str] = None
# `set_dispatch_hook` installs a callable invoked as hook(name, mode) by each
# wrapper before it runs; it may raise (the fault-injection seam). One hook
# at a time
_DISPATCH_HOOK: Optional[Callable[[str, str], None]] = None
# plain-version calls on CUDA tensors (the ref rung), by kernel
_plain_calls: Dict[str, int] = {name: 0 for name in KERNELS}


@contextlib.contextmanager
def mode_override(mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    global _MODE_OVERRIDE
    prev = _MODE_OVERRIDE
    _MODE_OVERRIDE = mode
    try:
        yield
    finally:
        _MODE_OVERRIDE = prev


def set_dispatch_hook(hook: Optional[Callable[[str, str], None]]) -> None:
    global _DISPATCH_HOOK
    _DISPATCH_HOOK = hook


def get_dispatch_hook() -> Optional[Callable[[str, str], None]]:
    return _DISPATCH_HOOK


@contextlib.contextmanager
def dispatch_hook(hook: Callable[[str, str], None]):
    prev = _DISPATCH_HOOK
    set_dispatch_hook(hook)
    try:
        yield
    finally:
        set_dispatch_hook(prev)


def resolve_mode(t: torch.Tensor) -> str:
    """MODE_KERNEL for a CUDA tensor, MODE_REF for a CPU tensor, MODE_REF
    for either under `mode_override(MODE_REF)`."""
    kernel = uses_kernel(t)
    return MODE_KERNEL if kernel and _MODE_OVERRIDE != MODE_REF else MODE_REF


def use_kernel(name: str, t: torch.Tensor) -> bool:
    """The wrappers' routing: resolve the mode for `t`, report it to the
    dispatch hook (which may raise), count a plain-version call on a CUDA
    tensor, and return True to launch kernel `name`."""
    mode = resolve_mode(t)
    if _DISPATCH_HOOK is not None:
        _DISPATCH_HOOK(name, mode)
    if mode == MODE_REF and t.is_cuda:
        _plain_calls[name] += 1
    return mode == MODE_KERNEL


def plain_counts() -> Dict[str, int]:
    """Plain-version calls on CUDA tensors (the ref rung) since the last
    `reset_launches`, by kernel."""
    return dict(_plain_calls)


def count_launch(name: str, k: int = 1, variant: Optional[str] = None) -> None:
    _launches[name] += k
    if variant is not None:
        _variant_launches[name][variant] += k
    # -1 outside a backward; the engine's threads carry the id of its task
    if torch._C._current_graph_task_id() != -1:
        _backward_launches[name] += k


def reset_launches() -> None:
    """Zero the launch counts and the plain-version counts."""
    for name in _launches:
        _launches[name] = 0
        _plain_calls[name] = 0
        _backward_launches[name] = 0
    for counts in _variant_launches.values():
        for variant in counts:
            counts[variant] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def backward_launch_counts() -> Dict[str, int]:
    """Launches made inside a backward since the last reset, by kernel: the
    forwards that activation checkpointing recomputes. They are part of
    `launch_counts` too."""
    return dict(_backward_launches)


def variant_counts(name: str) -> Dict[str, int]:
    """Launches of each variant of kernel `name` since the last reset."""
    return dict(_variant_launches[name])


def check_route(route: str, allowed) -> str:
    if route not in allowed:
        raise ValueError(f"unknown route {route!r}; expected one of {allowed}")
    return route


# ------------------------------------------------------------------ buckets
# wildcard bucket: one decision for every shape of a (route, backend) pair
BUCKET_ANY = "*"


def shape_bucket(*dims: int) -> Tuple[int, ...]:
    """Round each dimension up to the next power of two: calls whose dims land
    in one bucket share one tuned decision."""
    out = []
    for d in dims:
        d = max(int(d), 1)
        b = 1
        while b < d:
            b <<= 1
        out.append(b)
    return tuple(out)


def shard_bucket(P: int, *dims: int) -> Tuple:
    """Shape bucket of a decision made for one shard of a P-way partition:
    the shard count and the shard-local dims, each rounded up to a power of
    two ("p1x1048576x1024" in policy keys). One shard holds the whole graph,
    so at P = 1 the local vertex count is n."""
    return (f"p{int(P)}",) + shape_bucket(*dims)


def batch_bucket(B: int, bucket) -> Tuple:
    """A bucket of the template-batched executor: a leading "b<B>" segment
    (the batch size rounded up to a power of two), so that batched routes
    tune apart from single-query ones ("b8xp1x1048576x1024"). A "b1" key
    with no entry of its own resolves to the unbatched entry
    (`DispatchPolicy.route_entry_for`)."""
    b = shape_bucket(B)[0]
    if bucket == BUCKET_ANY:
        return (f"b{b}",)
    return (f"b{b}",) + tuple(bucket)


def bucket_key(bucket) -> str:
    """A shape bucket as policy-table keys spell it ("2048x32", "*",
    "scalar")."""
    if bucket == BUCKET_ANY:
        return BUCKET_ANY
    return "x".join(str(b) for b in tuple(bucket)) or "scalar"


def _entry_key(name: str, backend: str, bucket) -> str:
    return f"{name}|{backend}|{bucket_key(bucket)}"


# ------------------------------------------------------------------- policy
@dataclasses.dataclass
class PolicyEntry:
    """One tuned decision: the winning candidate and the measurements behind
    it (candidate -> best wall seconds over the tuning repeats)."""

    choice: str
    measured_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {"choice": self.choice, "measured_s": self.measured_s}

    @staticmethod
    def from_json(d: Dict) -> "PolicyEntry":
        return PolicyEntry(
            choice=str(d["choice"]),
            measured_s={k: float(v) for k, v in d.get("measured_s", {}).items()},
        )


@dataclasses.dataclass
class PlanEntry:
    """One tuned query plan for a (template-signature, graph-stats) bucket:
    the ordered phases -- each a dict with the constraint signature
    (``"cycle:0,1,2,0"``), the engine (``"nlcc"``/``"tds"``) and the walk
    direction -- plus the cost model's prediction and any measurements."""

    phases: List[Dict] = dataclasses.field(default_factory=list)
    predicted_s: float = 0.0
    measured_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def signatures(self) -> List[str]:
        return [str(p["sig"]) for p in self.phases]

    def to_json(self) -> Dict:
        return {
            "phases": self.phases,
            "predicted_s": self.predicted_s,
            "measured_s": self.measured_s,
        }

    @staticmethod
    def from_json(d: Dict) -> "PlanEntry":
        phases = [dict(p) for p in d["phases"]]
        for p in phases:
            p["sig"]  # KeyError on a malformed phase: the caller skips the entry
        return PlanEntry(
            phases=phases,
            predicted_s=float(d.get("predicted_s", 0.0)),
            measured_s={k: float(v) for k, v in d.get("measured_s", {}).items()},
        )


# plan keys render as ``prune.plan|<backend>|<template-sig>x<stats-bucket>``
PLAN_ROUTE = "prune.plan"

POLICY_SCHEMA_VERSION = 1


@dataclasses.dataclass
class DispatchPolicy:
    """Measured-cost route table keyed "<name>|<backend>|<bucket>", and the
    plan table. Route lookup tries the exact bucket, then (for a "b1"
    batched bucket) the unbatched one, then the ``*`` wildcard."""

    routes: Dict[str, PolicyEntry] = dataclasses.field(default_factory=dict)
    plans: Dict[str, PlanEntry] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def route_entry_for(self, name: str, backend: str, bucket
                        ) -> Optional[PolicyEntry]:
        """The tuned entry (choice and measurements) for a bucket: the exact
        key first; for a batch-size-1 key ("b1x..."), the unbatched key next,
        since a single-query decision is the B = 1 decision; then the
        wildcard."""
        entry = self.routes.get(_entry_key(name, backend, bucket))
        if (entry is None and isinstance(bucket, tuple)
                and bucket[:1] == ("b1",)):
            unbatched = bucket[1:] if len(bucket) > 1 else BUCKET_ANY
            entry = self.routes.get(_entry_key(name, backend, unbatched))
        if entry is None and bucket != BUCKET_ANY:
            entry = self.routes.get(_entry_key(name, backend, BUCKET_ANY))
        return entry

    def route_for(self, name: str, backend: str, bucket) -> Optional[str]:
        entry = self.route_entry_for(name, backend, bucket)
        return entry.choice if entry is not None else None

    def plan_for(self, backend: str, bucket) -> Optional[PlanEntry]:
        """The plan for a (template-sig, stats-bucket) bucket, exact key
        only: a plan never transfers across templates or graph classes."""
        return self.plans.get(_entry_key(PLAN_ROUTE, backend, bucket))

    def set_route(self, name: str, backend: str, bucket, choice: str,
                  measured_s: Optional[Dict[str, float]] = None):
        self.routes[_entry_key(name, backend, bucket)] = PolicyEntry(
            choice, dict(measured_s or {}))

    def set_plan(self, backend: str, bucket, entry: PlanEntry):
        self.plans[_entry_key(PLAN_ROUTE, backend, bucket)] = entry

    def to_json(self) -> Dict:
        out = {
            "schema_version": POLICY_SCHEMA_VERSION,
            "meta": self.meta,
            "routes": {k: e.to_json() for k, e in sorted(self.routes.items())},
        }
        if self.plans:
            out["plans"] = {k: e.to_json() for k, e in sorted(self.plans.items())}
        return out

    @staticmethod
    def from_json(d: Dict) -> "DispatchPolicy":
        ver = d.get("schema_version")
        if ver != POLICY_SCHEMA_VERSION:
            raise ValueError(
                f"dispatch policy schema_version {ver!r} != "
                f"{POLICY_SCHEMA_VERSION}; re-run registry.tune()")
        plans: Dict[str, PlanEntry] = {}
        for k, e in d.get("plans", {}).items():
            try:
                plans[k] = PlanEntry.from_json(e)
            except (KeyError, TypeError, ValueError) as err:
                # a malformed plan entry must not take down the route table
                warnings.warn(f"ignoring malformed plan cache entry {k!r}: {err}",
                              RuntimeWarning, stacklevel=2)
        return DispatchPolicy(
            routes={k: PolicyEntry.from_json(e)
                    for k, e in d.get("routes", {}).items()},
            plans=plans,
            meta=dict(d.get("meta", {})),
        )

    def save(self, path: Optional[str] = None) -> str:
        path = path or policy_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        return path

    @staticmethod
    def load(path: Optional[str] = None) -> "DispatchPolicy":
        with open(path or policy_path()) as f:
            return DispatchPolicy.from_json(json.load(f))


# the port's own cache, apart from the JAX package's dispatch_policy.json
DEFAULT_POLICY_PATH = os.path.join("experiments", "policy",
                                   "torch_dispatch_policy.json")
POLICY_ENV = "REPRO_TORCH_DISPATCH_POLICY"


def policy_path() -> str:
    """Where the persisted policy cache lives (the environment variable
    ``REPRO_TORCH_DISPATCH_POLICY`` wins)."""
    return os.environ.get(POLICY_ENV, DEFAULT_POLICY_PATH)


_POLICY_UNSET = object()
_POLICY: Any = _POLICY_UNSET


def set_policy(policy: Optional[DispatchPolicy]) -> None:
    """Install `policy` as the active one (None: explicitly no policy, and no
    lazy load of the cache)."""
    global _POLICY
    _POLICY = policy


def clear_policy() -> None:
    """Forget the active policy; the next lookup reads the cache again."""
    global _POLICY
    _POLICY = _POLICY_UNSET


def get_policy() -> Optional[DispatchPolicy]:
    """The active policy: what `set_policy` installed, else the cache at
    `policy_path()` if one exists (loaded once), else None. An unreadable
    cache warns and counts as none."""
    global _POLICY
    if _POLICY is _POLICY_UNSET:
        path = policy_path()
        _POLICY = None
        if os.path.exists(path):
            try:
                _POLICY = DispatchPolicy.load(path)
            except (ValueError, KeyError, TypeError, OSError) as e:
                warnings.warn(
                    f"ignoring unreadable dispatch policy cache {path!r}: {e}",
                    RuntimeWarning, stacklevel=2)
    return _POLICY


def resolve_route(name: str, bucket=BUCKET_ANY, *, default: str, backend: str,
                  allowed: Optional[Sequence[str]] = None) -> str:
    """The tuned choice for (name, backend, bucket) when the active policy
    has one inside `allowed`, else `default` -- which callers set to their
    untuned route, so an untuned run routes exactly as before. A cache entry
    outside `allowed` (a typo, a stale candidate) falls back to `default`."""
    policy = get_policy()
    if policy is not None:
        choice = policy.route_for(name, backend, bucket)
        if choice is not None and (allowed is None or choice in allowed):
            return choice
    return default


def resolve_plan(bucket, signatures: Sequence[str], *,
                 backend: str) -> Optional[PlanEntry]:
    """The tuned plan for a (template-sig, stats-bucket) bucket, checked
    against the constraint signatures the template generates now. None when
    there is no policy, no plan for the bucket, or the plan is stale (its
    phase signatures differ: a plan that drops or invents a constraint is
    unsound), the last with a warning."""
    policy = get_policy()
    if policy is None or not policy.plans:
        return None
    entry = policy.plan_for(backend, bucket)
    if entry is None:
        return None
    want = sorted(str(s) for s in signatures)
    if sorted(entry.signatures()) != want:
        warnings.warn(
            f"ignoring stale plan cache entry for bucket {bucket_key(bucket)!r}: "
            f"cached constraint signatures {sorted(entry.signatures())} != "
            f"current {want}; re-run the planner", RuntimeWarning, stacklevel=2)
        return None
    return entry


# ---------------------------------------------------------------- autotune
def _time_thunk(thunk: Callable[[], Any], repeat: int, backend: str) -> float:
    """Best wall seconds over `repeat` runs after one warm-up run; on the
    card the device is synchronized before and after each run, so a run's
    time holds its device work."""

    def sync():
        if backend == "cuda":
            torch.cuda.synchronize()

    sync()
    thunk()
    sync()
    best = float("inf")
    for _ in range(max(repeat, 1)):
        t0 = time.perf_counter()
        thunk()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def tune(
    routes: Iterable[Tuple[str, Any, Dict[str, Callable[[], Any]]]] = (),
    *,
    backend: str,
    repeat: int = 3,
    policy: Optional[DispatchPolicy] = None,
    path: Optional[str] = None,
    persist: bool = True,
) -> DispatchPolicy:
    """Time candidate routes and record the winners in a `DispatchPolicy`.

    routes  iterable of (route_name, bucket, {candidate: thunk}); each thunk
            is timed as it is, and the fastest candidate becomes the route
            decision for (route_name, backend, bucket).
    backend the device type the thunks run on ("cuda" or "cpu").
    policy  extend this policy; when omitted, a readable cache at the target
            path is loaded and extended, so decisions not measured again
            survive (an unreadable cache is replaced).
    path/persist  where (and whether) to save the JSON cache; the tuned
            policy is installed as the active one either way.

    Only routes are tuned: which of a kernel and its plain version runs
    follows the tensor's device and is never a policy decision."""
    pol = policy
    if pol is None:
        target = path or policy_path()
        if os.path.exists(target):
            try:
                pol = DispatchPolicy.load(target)
            except (ValueError, KeyError, TypeError, OSError):
                pol = None  # unreadable cache: tune from scratch, overwrite
    if pol is None:
        pol = DispatchPolicy()
    pol.meta.update({"backend": backend, "torch": torch.__version__,
                     "repeat": int(repeat), "tuned_unix": time.time()})
    if backend == "cuda":
        pol.meta["device"] = torch.cuda.get_device_name(0)
    for name, bucket, candidates in routes:
        measured = {cand: _time_thunk(thunk, repeat, backend)
                    for cand, thunk in candidates.items()}
        winner = min(measured, key=measured.get)
        pol.set_route(name, backend, bucket, winner, measured)
    if persist:
        pol.save(path)
    set_policy(pol)
    return pol
