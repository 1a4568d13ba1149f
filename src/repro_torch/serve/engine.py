"""Batched LM serving: prefill and greedy decode with a static KV cache
(the JAX package's `serve/engine.py`). Recsys serving calls the model's
`serve_scores` and `retrieval_scores`, directly or through
`build_recsys_scorer`.

`build_prefill` runs one full-sequence forward (`Transformer.forward_hidden`,
one `flash_attention` launch per layer) that also writes each layer's roped
K and V (MLA: its latent) into the cache, and returns the last position's
logits. The JAX package's `build_prefill` fills the cache with a
teacher-forced scan of decode steps instead; both give the same cache and
logits for the same weights and tokens (`tests/test_torch_lm.py`,
`tests/test_torch_lm_archs.py`): a sliding-window ring keeps the prompt's
last s_cache positions at slot p % s_cache, as the scan leaves them, and
MoE layers dispatch dropless, as each decode step of the scan does (a
capacity-bound forward would drop tokens where an expert overflows).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.bert4rec import Bert4Rec
from repro_torch.models.transformer import Transformer


# ------------------------------------------------------------------ LM decode
def build_decode_step(model: Transformer) -> Callable:
    """(cache, token int[B]) -> (next_token int32[B], logits, cache); the
    cache is updated in place."""

    def serve_step(cache, token):
        logits, cache = model.decode_step(token, cache)
        return logits.argmax(-1).to(torch.int32), logits, cache

    return serve_step


def build_prefill(model: Transformer) -> Callable:
    """(tokens [B, S], max_seq) -> (cache, last logits [B, V]): one forward
    over the prompt, its K and V written into a fresh cache of max_seq
    positions, pos = S. All prompts of a batch have one length."""

    def prefill(tokens: torch.Tensor, max_seq: int):
        b, s = tokens.shape
        cache = model.init_cache(b, max_seq)
        h, _ = model.forward_hidden(tokens, cache=cache)
        cache["pos"] = s
        return cache, model.logits_from_hidden(h[:, -1:])[:, 0]

    return prefill


def greedy_generate(model: Transformer, prompt: torch.Tensor, max_new: int,
                    max_seq: int) -> torch.Tensor:
    """Greedy generation: prefill, then max_new - 1 decode steps ->
    int32[B, max_new]. Ties take the first maximum, as `jnp.argmax` does."""
    cache, logits = build_prefill(model)(prompt, max_seq)
    step = build_decode_step(model)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for _ in range(max_new - 1):
        tok, _, cache = step(cache, tok)
        out.append(tok)
    return torch.stack(out, dim=1)



# --------------------------------------------------------------- recsys
def build_recsys_scorer(model: Bert4Rec, kind: str) -> Callable:
    """The scorer of a recsys serving cell: "serve" -> (items [B, L]) ->
    top-k catalog scores (`serve_scores`); "retrieval" -> (items, cands
    [C]) -> [B, C] (`retrieval_scores`). The model stands in for the
    reference's (params, cfg)."""
    if kind == "serve":
        return model.serve_scores
    if kind == "retrieval":
        return model.retrieval_scores
    raise ValueError(kind)
