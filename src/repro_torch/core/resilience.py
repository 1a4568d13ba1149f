"""Fault-tolerant elastic execution (paper §4 / §5.3), the JAX package's
`core/resilience.py`.

The pruning pipeline is a sequence of monotone phases (LCC fixpoints and
NLCC / TDS constraint sweeps: omega and edge bits only ever clear), so every
phase boundary is a consistency point: a snapshot taken there and replayed
through the remaining phases lands on the fixpoint a fault-free run reaches,
bit for bit. This module supplies what `pipeline.prune` threads through the
backends:

  FaultInjector      a deterministic, seedable harness that raises simulated
                     failures (shard loss, collective timeout, transient
                     kernel failure, TdsOverflow-style resource exhaustion)
                     at chosen phase and wave indices. Backends report
                     `injector.event(site, ...)` at their host dispatch seams
                     (constraint entry, each NLCC wave, the TDS bridge), the
                     kernel wrappers through the registry's dispatch hook,
                     and `instrument_prims` wraps the collective layer.
  run_phase_with_ladder
                     the degradation ladder around one phase: retry (from an
                     in-memory snapshot, with backoff) -> the plain versions
                     of the kernels (`registry.mode_override(MODE_REF)`) ->
                     chunk back-off (a smaller TDS chunk) -> PhaseFailed.
                     Shard loss is never absorbed here: it escapes to the
                     pipeline's elastic restart.
  ResilienceConfig   checkpoint cadence, retry policy and elastic restart
                     (restore the last phase checkpoint onto another, as a
                     rule smaller, shard count, or compact and reshuffle at
                     a phase boundary when the per-shard counts show skew).

Faults are Python exceptions raised from host code between device
dispatches, where a rank lost between bulk steps would surface. The ladder
catches only the classes below (and TdsOverflow): any other error, a kernel
that fails to build or launch among them, fails the run.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.tds import TdsOverflow


# ---------------------------------------------------------------- fault kinds
FAULT_SHARD_LOSS = "shard_loss"
FAULT_COLLECTIVE_TIMEOUT = "collective_timeout"
FAULT_TRANSIENT_KERNEL = "transient_kernel"
FAULT_RESOURCE_EXHAUSTED = "resource_exhausted"
FAULT_KINDS = (FAULT_SHARD_LOSS, FAULT_COLLECTIVE_TIMEOUT,
               FAULT_TRANSIENT_KERNEL, FAULT_RESOURCE_EXHAUSTED)


class InjectedFault(RuntimeError):
    """Base of every simulated failure the harness raises."""

    kind = "injected"

    def __init__(self, site: str, phase: Optional[int], wave: Optional[int]):
        super().__init__(
            f"injected {self.kind} at site={site!r} phase={phase} wave={wave}")
        self.site = site
        self.phase = phase
        self.wave = wave


class ShardLost(InjectedFault):
    """A shard's device state is gone and cannot be recovered in place: the
    pipeline restores the last phase checkpoint (possibly onto fewer
    shards)."""

    kind = FAULT_SHARD_LOSS


class CollectiveTimeout(InjectedFault):
    """A collective failed transiently: retried in place from the
    phase-entry snapshot."""

    kind = FAULT_COLLECTIVE_TIMEOUT


class TransientKernelFailure(InjectedFault):
    """A kernel reported an error: retried, then run on the kernels' plain
    versions."""

    kind = FAULT_TRANSIENT_KERNEL


class ResourceExhausted(InjectedFault):
    """TdsOverflow-style resource exhaustion: handled by chunk back-off."""

    kind = FAULT_RESOURCE_EXHAUSTED


_EXC_OF_KIND = {
    FAULT_SHARD_LOSS: ShardLost,
    FAULT_COLLECTIVE_TIMEOUT: CollectiveTimeout,
    FAULT_TRANSIENT_KERNEL: TransientKernelFailure,
    FAULT_RESOURCE_EXHAUSTED: ResourceExhausted,
}


class PhaseFailed(RuntimeError):
    """The degradation ladder ran out of rungs for one phase. The pipeline
    treats it like shard loss: checkpoint restore, or give up."""


class ResilienceExhausted(RuntimeError):
    """No recovery path left: no checkpoint directory, or the restart budget
    is spent. Carries the original failure as __cause__."""


class PlanMismatch(RuntimeError):
    """A checkpoint was written under another query plan (another constraint
    order or phase identity) than the recovering run executes. Phases are
    keyed by constraint signature, engine and direction, not by position:
    replaying phase k of plan A inside plan B would run the wrong constraint,
    so recovery refuses instead. Prune from scratch or restore the original
    plan."""


# ---------------------------------------------------------------- fault specs
# Ladder rungs in escalation order. A spec's `cleared_by` names the rung that
# makes the fault stop firing: cleared_by="retry" is a hiccup a re-run fixes,
# cleared_by="ref" a kernel fault the plain version sidesteps. None: the
# fault fires whenever it matches (a hard fault).
RUNG_FIRST = "first"
RUNG_RETRY = "retry"
RUNG_REF = "ref"
RUNG_CHUNK = "chunk"
RUNGS = (RUNG_FIRST, RUNG_RETRY, RUNG_REF, RUNG_CHUNK)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fire `times` times (<= 0: every match) at
    events matching (site, phase, wave), after skipping the first `after`
    matches.

    Sites are the host dispatch seams: "lcc", "nlcc", "wave" (per NLCC wave,
    with a 0-based `wave` index within the constraint), "tds", "dispatch"
    (any kernel wrapper call; `kernel` narrows to one kernel name), and
    "prim:<name>" (a collective, through `instrument_prims`). site=None
    matches any event."""

    kind: str
    phase: Optional[int] = None
    site: Optional[str] = None
    wave: Optional[int] = None
    kernel: Optional[str] = None
    after: int = 0
    times: int = 1
    cleared_by: Optional[str] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.cleared_by is not None and self.cleared_by not in RUNGS[1:]:
            raise ValueError(
                f"cleared_by={self.cleared_by!r} is not a ladder rung "
                f"{RUNGS[1:]}")


@dataclasses.dataclass
class _Armed:
    spec: FaultSpec
    seen: int = 0   # matching events observed (drives `after`)
    fired: int = 0  # times raised


class FaultInjector:
    """A deterministic fault plan evaluated at the host dispatch seams.

    The pipeline announces phase starts (`begin_phase`) and the current
    ladder rung (`set_rung`); backends and the dispatch hook report events
    (`event`). A spec whose filters match raises its InjectedFault. All
    state is explicit: the same prune under the same plan fires the same
    faults at the same events."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.armed: List[_Armed] = [_Armed(s) for s in specs]
        self.phase: Optional[int] = None
        self.rung: str = RUNG_FIRST
        self.fired: List[Dict] = []        # audit log of raised faults
        self.events: Counter = Counter()   # every event seen, by site
        self.prim_trace: Counter = Counter()  # collective calls, by prim

    # -- plan construction
    @staticmethod
    def random(seed: int, n_phases: int, *, n_faults: int = 1,
               kinds: Sequence[str] = (FAULT_SHARD_LOSS,),
               sites: Sequence[str] = ("lcc", "nlcc", "wave", "tds")
               ) -> "FaultInjector":
        """A seeded random fault plan: the same seed gives the same plan,
        and the JAX package's plan for that seed (the same generator calls
        in the same order)."""
        import numpy as np

        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            site = sites[int(rng.integers(len(sites)))]
            specs.append(FaultSpec(
                kind=kinds[int(rng.integers(len(kinds)))],
                phase=int(rng.integers(n_phases)),
                site=site,
                wave=int(rng.integers(2)) if site == "wave" else None,
            ))
        return FaultInjector(specs)

    # -- pipeline-driven context
    def begin_phase(self, phase: int) -> None:
        self.phase = phase

    def set_rung(self, rung: str) -> None:
        self.rung = rung

    # -- event seams
    def event(self, site: str, *, wave: Optional[int] = None,
              kernel: Optional[str] = None) -> None:
        """Report one host-seam event; raises if an armed spec matches."""
        self.events[site] += 1
        for a in self.armed:
            s = a.spec
            if s.site is not None and s.site != site:
                continue
            if s.phase is not None and s.phase != self.phase:
                continue
            if s.wave is not None and s.wave != wave:
                continue
            if s.kernel is not None and s.kernel != kernel:
                continue
            a.seen += 1
            if a.seen <= s.after:
                continue
            if s.times > 0 and a.fired >= s.times:
                continue
            if s.cleared_by is not None and (
                    RUNGS.index(self.rung) >= RUNGS.index(s.cleared_by)):
                continue  # the ladder escalated past this fault's cause
            a.fired += 1
            self.fired.append({"kind": s.kind, "site": site,
                               "phase": self.phase, "wave": wave,
                               "kernel": kernel, "rung": self.rung})
            raise _EXC_OF_KIND[s.kind](site, self.phase, wave)

    def on_dispatch(self, name: str, mode: str) -> None:
        """The registry's dispatch hook: every kernel wrapper call is an
        event."""
        self.event("dispatch", kernel=name)

    def trace_prim(self, name: str) -> None:
        """Collective accounting and the prim-seam injection point."""
        self.prim_trace[name] += 1
        self.event(f"prim:{name}")


def instrument_prims(prims, injector: FaultInjector):
    """Wrap every collective of a `Prims` bundle so that the injector sees
    each use. Returns the same NamedTuple type.

    PyTorch has no tracing: the wrapper runs on every call of a prim, so
    `prim_trace` counts calls, where the JAX package counts the uses it
    traces once per compiled program. Which prims are seen, and how a fault
    injected at one recovers, are the same in both."""

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            injector.trace_prim(name)
            return fn(*args, **kwargs)

        return wrapped

    return type(prims)(*(wrap(f, getattr(prims, f)) for f in prims._fields))


# ------------------------------------------------------------- configuration
@dataclasses.dataclass
class RetryPolicy:
    """Bounds of the degradation ladder."""

    max_retries: int = 2
    backoff_s: float = 0.0  # sleep before retry r is backoff_s * factor**(r-1)
    backoff_factor: float = 2.0
    chunk_backoff_factor: int = 4  # TDS chunk divisor per back-off step
    max_chunk_backoffs: int = 2


@dataclasses.dataclass
class ElasticConfig:
    """Elastic restart and rebalance targets.

    restart_P          shard count to restore onto after a fatal fault
                       (None: keep the current count), the paper's recovery
                       onto a smaller deployment (LB-16 / LB-1).
    imbalance_trigger  max-over-mean active-arc threshold, checked from the
                       per-shard device counts at every phase boundary;
                       above it the active subgraph is compacted and
                       reshuffled with no fault (None: off).
    rebalance_P        shard count after a triggered rebalance (None: keep;
                       1 runs the rest on the local backend).
    seed               the balanced_shuffle seed.
    """

    restart_P: Optional[int] = None
    imbalance_trigger: Optional[float] = None
    rebalance_P: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class ResilienceConfig:
    """What `pipeline.prune(..., resilience=...)` needs."""

    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1  # phases between checkpoints
    keep: int = 3  # checkpoint retention
    injector: Optional[FaultInjector] = None
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    elastic: Optional[ElasticConfig] = None
    max_restarts: int = 4


# --------------------------------------------------------- degradation ladder
def run_phase_with_ladder(
    run: Callable[[], None],
    *,
    snapshot: Callable[[], object],
    restore: Callable[[object], None],
    retry: RetryPolicy,
    injector: Optional[FaultInjector] = None,
    on_chunk_backoff: Optional[Callable[[int], None]] = None,
    ladder_log: Optional[List[Tuple[str, str]]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> None:
    """Execute one phase under the degradation ladder.

    retry      a transient collective or kernel fault re-runs the phase from
               the phase-entry snapshot, with bounded backoff;
    ref        when the retries are spent, one more attempt runs the
               kernels' plain versions (`registry.mode_override(MODE_REF)`,
               on the card too; the registry counts those calls apart);
    chunk      resource exhaustion (TdsOverflow or injected) restores the
               snapshot and shrinks the TDS chunk through `on_chunk_backoff`;
    raise      anything still failing surfaces as PhaseFailed: the caller
               restores the previous checkpoint and restarts, or gives up.

    ShardLost is never absorbed: lost device state cannot be retried in
    place, so it propagates to the pipeline's restore path. Only the
    classes named here are caught."""
    from repro_torch.kernels import registry

    set_rung = injector.set_rung if injector is not None else (lambda r: None)
    snap = snapshot()
    retries = 0
    chunk_backoffs = 0
    tried_ref = False
    rung = RUNG_FIRST
    try:
        while True:
            set_rung(rung)
            try:
                if rung == RUNG_REF:
                    with registry.mode_override(registry.MODE_REF):
                        run()
                else:
                    run()
                return
            except ShardLost:
                raise
            except (TdsOverflow, ResourceExhausted) as e:
                if chunk_backoffs >= retry.max_chunk_backoffs:
                    raise PhaseFailed(
                        f"chunk back-off exhausted after {chunk_backoffs} "
                        f"steps: {e!r}") from e
                chunk_backoffs += 1
                if ladder_log is not None:
                    ladder_log.append((RUNG_CHUNK, repr(e)))
                restore(snap)
                if on_chunk_backoff is not None:
                    on_chunk_backoff(retry.chunk_backoff_factor)
                rung = RUNG_CHUNK
            except (CollectiveTimeout, TransientKernelFailure) as e:
                if retries < retry.max_retries:
                    retries += 1
                    if ladder_log is not None:
                        ladder_log.append((RUNG_RETRY, repr(e)))
                    restore(snap)
                    if retry.backoff_s > 0:
                        sleep(retry.backoff_s
                              * retry.backoff_factor ** (retries - 1))
                    rung = RUNG_RETRY
                elif not tried_ref:
                    tried_ref = True
                    if ladder_log is not None:
                        ladder_log.append((RUNG_REF, repr(e)))
                    restore(snap)
                    rung = RUNG_REF
                else:
                    raise PhaseFailed(
                        f"retries and ref fallback exhausted: {e!r}") from e
    finally:
        set_rung(RUNG_FIRST)
