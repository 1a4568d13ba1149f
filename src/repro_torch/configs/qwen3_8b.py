"""Qwen3-8B [hf:Qwen/Qwen3-8B].

GQA (8 kv heads), qk-norm (RMSNorm on per-head q/k), head_dim=128, SwiGLU,
no biases. Full quadratic attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)

SHAPES = {
    k: (v if k != "long_500k" else dataclasses.replace(v, skip="full quadratic attention"))
    for k, v in LM_SHAPES.items()
}


def smoke():
    return LMConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab=128, qk_norm=True, dtype="float32",
    )
