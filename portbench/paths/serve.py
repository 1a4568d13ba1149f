"""The run path `serve`: many analysts on one resident graph."""
from __future__ import annotations

import time
from typing import Dict

from portbench import graphgen
from portbench.paths.base import Context, _Loop


class ServeLoop(_Loop):
    """Many analysts in a closed loop on one `GraphQueryEngine`: each client
    submits its next query as soon as its last one returns from `pump`."""

    # the engine stages its own copy of the graph
    stages_graph = True

    def setup(self, g: graphgen.Arcs, ctx: Context) -> None:
        from repro_torch.graph.structs import Graph
        from repro_torch.serve import graph_query

        self.gq = graph_query
        host = Graph(g.n, g.src.cpu().numpy(), g.dst.cpu().numpy(),
                     g.labels.cpu().numpy())
        guar = self.cfg["guarantees"]
        self.mode = guar["mode"]
        self.engine = graph_query.GraphQueryEngine(
            host, device=self.dev,
            guarantee_precision=guar["guarantee_precision"],
            **self.cfg["engine"])
        self.pending: Dict[int, tuple] = {}
        for i in range(len(self.templates)):
            self.engine.submit(self.templates[i], mode=self.mode)
        for qr in self.engine.drain():
            qr.result = None

    def _submit(self, tracer) -> None:
        i = next(self.stream)
        with tracer.span("engine.submit"):
            qid = self.engine.submit(self.templates[i], mode=self.mode)
        self.pending[qid] = (i, time.perf_counter())
        self.attempted += 1

    def _take(self, results, t_back: float, record: bool) -> None:
        batch_seen = set()
        for qr in results:
            i, t_sub = self.pending.pop(qr.query_id)
            if qr.status != self.gq.STATUS_OK or qr.result is None:
                self.failed += 1
                self.outputs.missing += 1
                continue
            res = qr.result
            self.outputs.take(i, res.state.omega, res.state.edge_active,
                              res.dg.src, res.dg.dst, qr.n_embeddings)
            if record:
                self.queries.append({"template": i, "wait_s": qr.wait_s,
                                     "latency_s": t_back - t_sub})
                if qr.batch_id not in batch_seen:
                    batch_seen.add(qr.batch_id)
                    st = res.stats
                    self.batches.append({
                        "B": qr.batch_size, "seconds": qr.seconds,
                        "lcc_iterations": st.get("lcc_iterations", 0),
                        "nlcc_tokens": st.get("nlcc_tokens", 0),
                        "nlcc_lockstep_padded": st.get(
                            "nlcc_lockstep_padded", 0),
                        "wave": self.engine.wave})
            # the client is done with it: release its device state
            qr.result = None

    def run(self, seconds: float, tracer) -> float:
        t0 = time.perf_counter()
        for _ in range(self.mix.clients):
            self._submit(tracer)
        while True:
            with tracer.span("engine.pump"):
                results = self.engine.pump()
            t = time.perf_counter()
            self._take(results, t, record=True)
            tracer.tick()
            if t - t0 >= seconds:
                return t - t0
            if not results:
                time.sleep(0.001)  # nothing due yet: the batcher waits
            for _ in results:
                self._submit(tracer)

    def drain(self) -> None:
        """Queries still queued at the window's close: answered and judged,
        outside the window's numbers."""
        if self.pending:
            self._take(self.engine.drain(), time.perf_counter(), record=False)

    def close(self) -> None:
        del self.engine


Loop = ServeLoop
