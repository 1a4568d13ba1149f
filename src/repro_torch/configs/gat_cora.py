"""GAT-Cora [arXiv:1710.10903]: 2 layers, d_hidden=8, 8 heads, attention
aggregator (final layer averages heads)."""
from repro_torch.configs.base import GNNConfig, GNN_SHAPES

CONFIG = GNNConfig(
    name="gat-cora", model="gat", n_layers=2, d_hidden=8, n_heads=8,
    aggregators=("attn",),
)

SHAPES = dict(GNN_SHAPES)


def smoke():
    return GNNConfig(
        name="gat-smoke", model="gat", n_layers=2, d_hidden=4, n_heads=2,
        aggregators=("attn",),
    )
