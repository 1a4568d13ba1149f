"""Qwen2-1.5B [arXiv:2407.10671; hf:Qwen/Qwen2-1.5B].

GQA (2 kv heads), QKV bias, SwiGLU, RMSNorm, tied embeddings.
Full quadratic attention -> long_500k is skipped.
"""
import dataclasses

from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="qwen2-1.5b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

SHAPES = {
    k: (v if k != "long_500k" else dataclasses.replace(v, skip="full quadratic attention"))
    for k, v in LM_SHAPES.items()
}


def smoke():
    return LMConfig(
        name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=128, qkv_bias=True, tie_embeddings=True, dtype="float32",
    )
