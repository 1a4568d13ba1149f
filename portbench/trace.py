"""Spans around the calls into each layer, and the reading of the device
trace of a traced run.

Spans are recorded from the benchmark's own code: `prune`, `count`,
`engine.submit` and `engine.pump`, inside a `window` span, and the spans
that a run path names in its `SPANS`. With tracing on,
each is also a `record_function` range in `torch.profiler`'s trace, so the
device's idle gaps can be labelled by the span the host was in. The
profiler runs from the start of the window for at most `cap_s` seconds
(the traced window); the counters the per-layer metrics read cover the
whole window.
"""
from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

SPANS = ("window", "prune", "count", "engine.submit", "engine.pump")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def hand_written_kernels(csrc: Path) -> set:
    """The `__global__` functions of the program's CUDA sources: the device
    names of its hand-written kernels."""
    names = set()
    for p in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(p.read_text()))
    return names


def _ident(name: str) -> str:
    """A device kernel's function name, without its return type, scope,
    template arguments and parameters."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else ""


def _annotation(e, spans=SPANS) -> bool:
    """A span's range as the profiler mirrors it onto the device's
    timeline, not an operation the device ran."""
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return True
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return "annotation" in str(kind).lower() or e.name() in spans


class Tracer:
    """The traced window of a run: the profiler, the spans (`SPANS` and a
    run path's own), and the launch counts the program made meanwhile."""

    def __init__(self, enabled: bool, cap_s: float, device: torch.device,
                 launch_counts, path_spans: Tuple[str, ...] = ()):
        self.enabled = enabled and device.type == "cuda"
        self.spans = SPANS + tuple(path_spans)
        self.cap_s = cap_s
        self.device = device
        self._launch_counts = launch_counts
        self.prof = None
        self.window = None
        self.t0 = None
        self.seconds = None
        self.launches: Dict[str, int] = {}

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._l0 = self._launch_counts()
        self.window = torch.profiler.record_function("window")
        self.window.__enter__()
        self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.window is not None and self.seconds is None

    def span(self, name: str):
        if self.running:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def tick(self) -> None:
        """Close the traced window once it has lasted cap_s."""
        if self.running and time.perf_counter() - self.t0 >= self.cap_s:
            self.stop()

    def stop(self) -> None:
        if not self.running:
            return
        torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self.t0
        self.window.__exit__(None, None, None)
        l1 = self._launch_counts()
        self.launches = {k: l1[k] - self._l0.get(k, 0) for k in l1}
        self.prof.__exit__(None, None, None)

    def reduce(self, kernel_names: set) -> Optional[dict]:
        """busy_s, window_s, the hand-written launches the trace shows
        against those the program counted, the device operations that took
        most time and the idle gaps by span."""
        if self.prof is None:
            return None
        self.stop()
        dev_iv: List[Tuple[int, int]] = []
        by_op: Dict[str, float] = {}
        spans: List[Tuple[int, int, str]] = []
        seen = 0
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start, end = _start_ns(e), _end_ns(e)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if end <= start or _annotation(e, self.spans):
                    continue
                dev_iv.append((start, end))
                op = _short(name)
                by_op[op] = by_op.get(op, 0.0) + (end - start) * 1e-9
                if _ident(name) in kernel_names:
                    seen += 1
            elif name in self.spans:
                spans.append((start, end, name))
        win = [s for s in spans if s[2] == "window"]
        if not win:
            return None
        w0, w1 = win[0][0], win[0][1]
        busy, gaps = _union(sorted(dev_iv), w0, w1)
        inner = sorted((s for s in spans if s[2] != "window"),
                       key=lambda s: s[0])
        idle: Dict[str, float] = {}
        for g0, g1 in gaps:
            label = _label((g0 + g1) // 2, inner)
            idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
        counted = sum(self.launches.values())
        return {
            "busy_s": busy * 1e-9,
            "window_s": (w1 - w0) * 1e-9,
            "hand_written_seen": seen,
            "hand_written_counted": counted,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
        }


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _end_ns(e) -> int:
    if hasattr(e, "end_ns"):
        return e.end_ns()
    return _start_ns(e) + int(e.duration_us() * 1000)


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def _union(iv: List[Tuple[int, int]], w0: int, w1: int):
    """(ns covered by the intervals inside [w0, w1], the uncovered gaps)."""
    busy, gaps, cur = 0, [], w0
    for s, e in iv:
        s, e = max(s, w0), min(e, w1)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps


def _label(t: int, spans: List[Tuple[int, int, str]]) -> str:
    """The innermost span open at time t (the latest to start), or
    `harness` between spans."""
    label = "harness"
    for s, e, name in spans:
        if s > t:
            break
        if e >= t:
            label = name
    return label


def idle_share(red: Optional[dict]) -> Optional[float]:
    """% of the traced window with no device operation running; None (not
    measured) without a trace, or where the trace shows another number of
    hand-written kernel launches than the program counted: then the
    profiler missed launches and the busy time is not the whole."""
    if red is None or red["window_s"] <= 0:
        return None
    if red["hand_written_seen"] != red["hand_written_counted"]:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
