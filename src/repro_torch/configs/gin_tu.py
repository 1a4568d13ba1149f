"""GIN [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator, learnable eps."""
from repro_torch.configs.base import GNNConfig, GNN_SHAPES

CONFIG = GNNConfig(
    name="gin-tu", model="gin", n_layers=5, d_hidden=64,
    aggregators=("sum",), eps_learnable=True,
)

SHAPES = dict(GNN_SHAPES)


def smoke():
    return GNNConfig(
        name="gin-smoke", model="gin", n_layers=2, d_hidden=8,
        aggregators=("sum",), eps_learnable=True,
    )
