"""DeepSeek-V3 671B [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

MLA (q_lora 1536, kv_lora 512, decoupled rope 64), MoE with 1 shared + 256
routed experts top-8 (expert d_ff 2048; first 3 layers dense with d_ff 18432),
MTP head. 128 heads. Full quadratic attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    attention="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe=True, n_routed=256, n_shared=1, top_k=8,
    first_dense_layers=3, dense_d_ff=18432,
    mtp=True, rope_theta=10_000.0,
)

SHAPES = {
    k: (v if k != "long_500k" else dataclasses.replace(v, skip="full quadratic (MLA) attention"))
    for k, v in LM_SHAPES.items()
}


def smoke():
    return LMConfig(
        name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=128, attention="mla", q_lora_rank=24, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe=True, n_routed=8, n_shared=1, top_k=2, first_dense_layers=1,
        dense_d_ff=64, mtp=True, dtype="float32",
        capacity_factor=8.0,  # dropless at smoke scale
    )
