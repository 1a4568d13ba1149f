"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite].

MLA (no q compression, kv_lora 512, rope 64), MoE 2 shared + 64 routed top-6
(expert d_ff 1408; first layer dense with d_ff 10944). 64 routed experts, as
the cited paper and the HF config give them. long_500k skipped (quadratic).
"""
import dataclasses

from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    attention="mla", q_lora_rank=None, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe=True, n_routed=64, n_shared=2, top_k=6,
    first_dense_layers=1, dense_d_ff=10944,
    rope_theta=10_000.0,
)

SHAPES = {
    k: (v if k != "long_500k" else dataclasses.replace(v, skip="full quadratic (MLA) attention"))
    for k, v in LM_SHAPES.items()
}


def smoke():
    return LMConfig(
        name="deepseek-v2-lite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=128, attention="mla", kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe=True, n_routed=8, n_shared=2, top_k=2, first_dense_layers=1,
        dense_d_ff=64, dtype="float32",
        capacity_factor=8.0,  # dropless at smoke scale
    )
