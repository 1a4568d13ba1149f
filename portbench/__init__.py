"""The benchmark of the PyTorch and CUDA port (`repro_torch`): exact
single-analyst search and batched multi-analyst serving on graph500-22.

`BENCHMARK.json` at the repository's root names the cells; `run.py` runs one
(`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`). Configurations, traffic mixes, run paths, graph makers and
per-layer metrics are files of their own under `configs/`, `traffic/`,
`paths/`, `graphs/` and `metrics/`, found by name (`spec.py`)."""
