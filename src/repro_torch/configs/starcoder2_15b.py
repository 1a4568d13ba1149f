"""StarCoder2-15B [arXiv:2402.19173; hf:bigcode/starcoder2-15b].

GQA (4 kv heads), RoPE, sliding-window attention (4096), GELU MLP with bias,
LayerNorm. The sliding window makes decode sub-quadratic -> this is the ONLY
LM arch that runs the long_500k cell (ring-buffer KV cache of window size).
"""
from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    window=4096, mlp="gelu", norm="layernorm", qkv_bias=True,
    rope_theta=100_000.0,
)

SHAPES = dict(LM_SHAPES)  # all four cells, including long_500k


def smoke():
    return LMConfig(
        name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=128, window=16, mlp="gelu", norm="layernorm",
        qkv_bias=True, dtype="float32",
    )
