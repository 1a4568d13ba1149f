"""Config dataclasses and input-shape descriptors of the GNN, LM and recsys
families.

One module per architecture lives next to this file; each exposes
  CONFIG  — the exact published configuration
  SHAPES  — the arch's own input-shape set
  smoke() — a reduced same-family config for CPU tests

`LMConfig` is the JAX package's field for field: GQA (qk-norm, biases, a
sliding window), MLA, MoE and MTP, and the training knobs. Of the MoE perf
knobs, `moe_groups` selects the per-group dispatch (`models/transformer.py`);
`moe_gather_weights` is a sharding constraint in the JAX package and does
nothing on one card. `RecsysConfig` is the JAX package's field for field. Of
`GNNConfig` the port keeps the fields it reads, the knobs of the sharded
message passing among them (`distributed`, `message_dtype`:
`models/gnn_distributed.py`, reached through `launch/cells.py`). Left out:
`sample_sizes`, since the sampled path takes its fanouts from
`ShapeSpec.fanout`; and `dtype`, since the port builds its GNNs in f32 only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# ---------------------------------------------------------------- LM family
@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    attention: str = "gqa"                  # "gqa" | "mla"
    qkv_bias: bool = False                  # qwen2
    qk_norm: bool = False                   # qwen3
    window: Optional[int] = None            # starcoder2 sliding window
    mlp: str = "swiglu"                     # "swiglu" | "gelu"
    norm: str = "rmsnorm"                   # "rmsnorm" | "layernorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MLA (deepseek)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE (deepseek)
    moe: bool = False
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 0
    first_dense_layers: int = 0
    dense_d_ff: Optional[int] = None        # d_ff of the leading dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_groups: int = 0          # >1: dispatch within groups of T / G tokens
    moe_gather_weights: bool = False  # a sharding constraint; none on one card
    fused_ce: int = 0            # >0: blockwise cross-entropy (training)
    remat_policy: str = "full"   # "full" | "dots" (save matmul outputs)
    train_microbatches: int = 0  # 0 = launcher default
    # MTP (deepseek-v3)
    mtp: bool = False
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def n_params(self) -> int:
        """Total parameter count, as the JAX package counts it: projections,
        experts and routers; biases, norms and the MTP block left out."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            if self.q_lora_rank:
                per_layer += d * self.q_lora_rank
                per_layer += self.q_lora_rank * self.n_heads * qk
            else:
                per_layer += d * self.n_heads * qk
            per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * d
        else:
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            per_layer += self.n_heads * hd * d
        mlp_mult = 3 if self.mlp == "swiglu" else 2
        total = emb + self.n_layers * per_layer
        if self.moe:
            n_dense = self.first_dense_layers
            n_moe = self.n_layers - n_dense
            total += n_dense * mlp_mult * d * (self.dense_d_ff or self.d_ff)
            total += n_moe * (self.n_routed + self.n_shared) * mlp_mult * d * self.d_ff
            total += n_moe * d * self.n_routed  # router
        else:
            total += self.n_layers * mlp_mult * d * self.d_ff
        return total

    def n_active_params(self) -> int:
        """Parameters a token activates (MoE: its top-k routed experts and
        the shared ones), as the JAX package counts them."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        mlp_mult = 3 if self.mlp == "swiglu" else 2
        n_moe = self.n_layers - self.first_dense_layers
        return (self.n_params()
                - n_moe * (self.n_routed + self.n_shared) * mlp_mult * d * self.d_ff
                + n_moe * (self.top_k + self.n_shared) * mlp_mult * d * self.d_ff)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                 # "pna" | "graphsage" | "gin" | "gat"
    n_layers: int
    d_hidden: int
    n_heads: int = 1           # gat
    aggregators: Tuple[str, ...] = ("mean",)
    scalers: Tuple[str, ...] = ("identity",)
    eps_learnable: bool = False          # gin
    # full-graph message passing over the engine's edge partition, one
    # bucketed exchange a layer (`models/gnn_distributed.py`), in place of
    # the local segment ops; the cells take it where it is set
    distributed: bool = False
    message_dtype: str = "float32"  # "bfloat16" halves the exchange's payload


# ------------------------------------------------------------ RecSys family
@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    n_items: int = 1_000_000   # embedding table rows
    dtype: str = "bfloat16"
    # the JAX package's training knobs: 0 = full-catalog softmax
    fused_ce: int = 0          # >0: blockwise CE over item chunks (exact)
    n_negatives: int = 0       # >0: sampled-softmax with shared negatives

    def n_params(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 8 * d * d  # attn + 4x ffn
        return self.n_items * d + self.n_blocks * per_block + self.seq_len * d


# ------------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One cell: what program to run and with which sizes."""

    name: str
    step: str                  # "train" | "prefill" | "decode" | "serve" | "retrieval"
    # lm
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0
    # recsys
    batch: int = 0
    n_candidates: int = 0
    skip: Optional[str] = None  # reason this cell is skipped


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
}


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train", n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train", n_nodes=232965, n_edges=114615892,
        batch_nodes=1024, fanout=(15, 10), d_feat=602,
    ),
    "ogb_products": ShapeSpec("ogb_products", "train", n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": ShapeSpec("molecule", "train", n_nodes=30, n_edges=64, n_graphs=128, d_feat=16),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
}

# classes per GNN shape (the JAX package's launch/cells.py)
GNN_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47, "molecule": 2}
