"""Serving entry point of the port: batched greedy generation (LM) or
catalog scoring (recsys) on an arch's smoke config, as the JAX package's
`launch/serve.py --arch` does, on the card unless `--device cpu`. The LM
smoke config's head dim (16) is raised to 64, the least that
`flash_attention` takes (`serve_config`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 16 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bert4rec --device cpu

Graph-query serving (`--graph-queries`) waits for the port's batched prune.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import LMConfig, RecsysConfig
from repro_torch.data.recsys import MaskedSequenceStream
from repro_torch.kernels.ops import ATTENTION_HEAD_DIMS
from repro_torch.models.bert4rec import Bert4Rec
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import greedy_generate

SERVED_ARCHS = ("qwen2-1.5b", "bert4rec")


def serve_config(arch: str):
    """The config served for `arch`: its smoke config, with an LM's head dim
    raised to the least one the `flash_attention` kernel takes (the qwen2
    smoke config's is 16), on the CPU too, so that both devices serve one
    model."""
    cfg = get_arch(arch).smoke()
    if isinstance(cfg, LMConfig) and cfg.hd not in ATTENTION_HEAD_DIMS:
        cfg = dataclasses.replace(
            cfg, head_dim=min(d for d in ATTENTION_HEAD_DIMS if d >= cfg.hd))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=SERVED_ARCHS, required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch)
    if isinstance(cfg, LMConfig):
        model = Transformer(cfg, device=args.device)
        rng = np.random.default_rng(1)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)).to(model.device)
        t0 = time.perf_counter()
        out = greedy_generate(model, prompt, args.max_new,
                              args.prompt_len + args.max_new)
        out = out.cpu()
        dt = time.perf_counter() - t0
        toks = args.batch * args.max_new
        print(f"generated {tuple(out.shape)} on {model.device} in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s batched greedy)")
        print(out[:2, :16])
        return out
    assert isinstance(cfg, RecsysConfig)
    model = Bert4Rec(cfg, device=args.device)
    items = MaskedSequenceStream(cfg.n_items, args.batch, cfg.seq_len,
                                 device=model.device)(0)["items"]
    t0 = time.perf_counter()
    scores = model.serve_scores(items)
    top = torch.topk(scores.float(), 10).indices.cpu()
    print(f"scored {tuple(scores.shape)} on {model.device} in "
          f"{time.perf_counter() - t0:.2f}s; top-10 for user 0: {top[0].tolist()}")
    return top


if __name__ == "__main__":
    main()
