"""The run path `prune`: one analyst's exact search."""
from __future__ import annotations

import time

import numpy as np

from portbench import graphgen
from portbench.paths.base import Context, _Loop, _no_span


class PruneLoop(_Loop):
    """One analyst: `pipeline.prune` on the resident `DeviceGraph`, then
    `count_matches` of its result, one query after another."""

    def setup(self, g: graphgen.Arcs, ctx: Context) -> None:
        self.dg = ctx.device_graph()
        # a template label that no vertex carries has frequency 0
        top = max(max(t.labels.tolist()) for t in self.templates)
        self.label_freq = np.bincount(g.labels.cpu().numpy(),
                                      minlength=top + 1)
        guar = self.cfg["guarantees"]
        self.kw = dict(guarantee_precision=guar["guarantee_precision"],
                       edge_elimination=guar["edge_elimination"],
                       work_aggregation=guar["work_aggregation"],
                       **self.cfg["engine"])
        self.count = bool(guar.get("count"))
        for i in range(len(self.templates)):
            self._query(i, None, record=False)

    def _query(self, i: int, tracer, record: bool = True) -> None:
        from repro_torch.core import enumerate as enum_mod
        from repro_torch.core import pipeline

        span = tracer.span if tracer is not None else _no_span
        t0 = time.perf_counter()
        with span("prune"):
            res = pipeline.prune(self.dg, self.templates[i],
                                 label_freq=self.label_freq, **self.kw)
        t1 = time.perf_counter()
        n_emb = None
        if self.count:
            with span("count"):
                n_emb = int(enum_mod.count_matches(
                    res, label_freq=self.label_freq).n_embeddings)
        t2 = time.perf_counter()
        if not record:
            return
        self.outputs.take(i, res.state.omega, res.state.edge_active,
                          res.dg.src, res.dg.dst, n_emb)
        self.queries.append({
            "template": i, "prune_s": t1 - t0, "count_s": t2 - t1,
            "latency_s": t2 - t0,
            "phases": [(p.phase, p.seconds) for p in res.phases],
            "lcc_iterations": res.stats.get("lcc_iterations", 0)})

    def run(self, seconds: float, tracer) -> float:
        t0 = time.perf_counter()
        while True:
            self.attempted += 1
            self._query(next(self.stream), tracer)
            tracer.tick()
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    def drain(self) -> None:
        pass

    def close(self) -> None:
        del self.dg


Loop = PruneLoop
