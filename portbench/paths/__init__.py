"""The run paths of the benchmark's configurations, one file each.

A configuration names its path (`"path": "<name>"`), and the harness loads
`paths/<name>.py` by that name (`spec.path_module`); a name with no file
stops the run before set-up. A path module gives:

- `Loop`: the program driven by one mix's clients, built as
  `Loop(cfg, mix, templates, seed, dev, outputs)` (`base._Loop` keeps the
  arguments and the fields). `setup(g, ctx)` sets the program up and warms
  every shape the cell uses; `run(seconds, tracer) -> window_s` measures;
  `drain()` answers what was still queued at the close, outside the
  window's numbers; `close()` frees the program's state. Each answer goes
  to `outputs.take`. The fields `queries` (one dict a query of the window,
  with its `latency_s`), `batches`, `attempted` and `failed` feed the
  metrics. `stages_graph = True` says that `setup` staged a copy of its
  own, so the harness holds its graph on the host through the window.

and may give:

- `solution(graph, t) -> reference.Solution`: the plain reference of this
  path's answers, in place of `reference.solution`;
- `control(graph, t, count) -> reference.Solution`: what `--control`
  judges in the program's place, in place of `reference.local_answer`;
- `SPANS`: the names of the spans its loop records, by which the traced
  run labels the device's idle gaps, beside `trace.SPANS`.
"""
