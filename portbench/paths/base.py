"""What every run path shares: the context the per-layer probes get, the
loop's fields, and a span that records nothing."""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from portbench import graphgen, judge, loadgen, reference

# kernel probes: timed launches after three untimed ones
PROBE_REPS = 20


class Context:
    """What a cell's run hands its per-layer probes."""

    def __init__(self, graph: graphgen.Arcs, mix: loadgen.Mix, device):
        self.graph = graph
        self.mix = mix
        self.device = device

    def device_graph(self):
        from repro_torch.graph.structs import DeviceGraph

        g = self.graph
        return DeviceGraph(n=g.n, src=g.src, dst=g.dst, dst_ptr=g.dst_ptr,
                           labels=g.labels)

    def narrowed(self, t: loadgen.TemplateSpec):
        g = self.graph
        return reference.narrowed(g.n, g.src, g.dst, g.labels, t.labels,
                                  t.edges)

    def time_ms(self, fn) -> Optional[float]:
        """ms a call of fn takes on the card by CUDA events, over
        PROBE_REPS calls back to back after three untimed ones; None off
        the card."""
        if self.device.type != "cuda":
            return None
        for _ in range(3):
            fn()
        torch.cuda.synchronize(self.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(PROBE_REPS):
            fn()
        e1.record()
        torch.cuda.synchronize(self.device)
        return e0.elapsed_time(e1) / PROBE_REPS


class _Loop:
    """The program driven by one mix's clients. Subclasses set up the
    program, run the window and free the program's state."""

    # True where setup stages the program's own copy of the graph
    stages_graph = False

    def __init__(self, cfg: dict, mix: loadgen.Mix, templates, seed: int,
                 dev: torch.device, outputs: judge.Outputs):
        self.cfg = cfg
        self.mix = mix
        self.templates = templates
        self.stream = mix.stream(seed)
        self.dev = dev
        self.outputs = outputs
        self.queries: List[dict] = []
        self.batches: List[dict] = []
        self.attempted = 0
        self.failed = 0


def _no_span(name):
    return contextlib.nullcontext()
