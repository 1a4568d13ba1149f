"""BERT4Rec [arXiv:1904.06690]: embed 64, 2 blocks, 2 heads, seq 200,
bidirectional self-attention. Table sized 1M items (retrieval_cand cell)."""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="bert4rec", embed_dim=64, n_blocks=2, n_heads=2, seq_len=200,
    n_items=1_000_000,
)

SHAPES = dict(RECSYS_SHAPES)


def smoke():
    return RecsysConfig(
        name="bert4rec-smoke", embed_dim=32, n_blocks=2, n_heads=2, seq_len=16,
        n_items=500, dtype="float32",
    )
