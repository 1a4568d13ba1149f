"""PNA [arXiv:2004.05718]: 4 layers, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation."""
from repro_torch.configs.base import GNNConfig, GNN_SHAPES

CONFIG = GNNConfig(
    name="pna", model="pna", n_layers=4, d_hidden=75,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
)

SHAPES = dict(GNN_SHAPES)


def smoke():
    return GNNConfig(
        name="pna-smoke", model="pna", n_layers=2, d_hidden=8,
        aggregators=("mean", "max", "min", "std"),
        scalers=("identity", "amplification", "attenuation"),
    )
