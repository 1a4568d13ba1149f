from repro_torch.serve.graph_query import (  # noqa: F401
    GraphQueryEngine, GraphQuery, QueryResult, example_workload,
    MODE_PRUNE, MODE_COUNT, MODE_STREAM,
)
