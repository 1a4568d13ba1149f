"""GraphSAGE-Reddit [arXiv:1706.02216]: 2 layers, d_hidden=128, mean
aggregator, fanouts 25-10 (minibatch_lg uses the assignment's 15-10)."""
from repro_torch.configs.base import GNNConfig, GNN_SHAPES

CONFIG = GNNConfig(
    name="graphsage-reddit", model="graphsage", n_layers=2, d_hidden=128,
    aggregators=("mean",),
)

SHAPES = dict(GNN_SHAPES)


def smoke():
    return GNNConfig(
        name="graphsage-smoke", model="graphsage", n_layers=2, d_hidden=16,
        aggregators=("mean",),
    )
