"""Serving entry point of the port, as the JAX package's `launch/serve.py`,
on the card unless `--device cpu`: graph-query serving (the paper's
multi-tenant pattern-matching scenario), batched greedy generation (LM) or
catalog scoring (recsys) on an arch's smoke config. An LM smoke config's
head dims are raised to a pair that `flash_attention` takes
(`serve_config`): GQA's 16 to 64, MLA's (16 + 8, 16) to (128 + 64, 128).

  PYTHONPATH=src python -m repro_torch.launch.serve --graph-queries 32 \\
      --graph-scale 9 --max-batch 8 [--max-wait S] [--timeout S] \\
      [--policy PATH] [--partition P]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 16 --max-new 32
      (or qwen3-8b, starcoder2-15b, deepseek-v2-lite-16b, deepseek-v3-671b)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bert4rec --device cpu

`--graph-queries N` serves N templates of `example_workload` in count mode
against an R-MAT graph of 2^scale vertices through `GraphQueryEngine`
(template-batched prunes); `--policy` loads a tuned dispatch-policy cache,
under which batched wave routes resolve by b<B>-prefixed bucket keys.
`--partition P` shards the background graph P ways and serves on the sim
prims (every shard in this process, `ShardedBatchedEngine`).
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
from repro_torch.kernels import registry
from repro_torch.kernels.ops import ATTENTION_HEAD_DIMS, ATTENTION_HEAD_DIM_PAIRS
from repro_torch.models.bert4rec import Bert4Rec
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import greedy_generate

SERVED_ARCHS = ("qwen2-1.5b", "qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b",
                "deepseek-v3-671b", "bert4rec")
# MLA's head dims at full width (qk_nope, qk_rope, v), the one MLA pair of
# the kernel: (128 + 64, 128)
MLA_HEAD_DIMS = (128, 64, 128)


def serve_config(arch: str):
    """The config served for `arch`: its smoke config, with an LM's head
    dims raised to a pair the `flash_attention` kernel takes, on the CPU
    too, so that both devices serve one model: GQA's head dim to the least
    of ATTENTION_HEAD_DIMS above it (the smoke configs' is 16), MLA's
    (qk_nope, qk_rope, v) to MLA_HEAD_DIMS (the smoke configs' are 16, 8,
    16)."""
    cfg = get_arch(arch).smoke()
    if not isinstance(cfg, LMConfig):
        return cfg
    if cfg.attention == "mla":
        dn, dr, dv = MLA_HEAD_DIMS
        if (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) not in ATTENTION_HEAD_DIM_PAIRS:
            cfg = dataclasses.replace(cfg, qk_nope_dim=dn, qk_rope_dim=dr, v_head_dim=dv)
    elif cfg.hd not in ATTENTION_HEAD_DIMS:
        cfg = dataclasses.replace(
            cfg, head_dim=min(d for d in ATTENTION_HEAD_DIMS if d >= cfg.hd))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=SERVED_ARCHS,
                    help="LM/recsys smoke-config serving (mutually "
                         "exclusive with --graph-queries)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--graph-queries", type=int, default=0, metavar="N",
                    help="serve N template queries against a synthetic "
                         "metadata graph through the batched prune engine")
    ap.add_argument("--graph-scale", type=int, default=9,
                    help="rmat graph scale (2^scale vertices)")
    ap.add_argument("--partition", type=int, default=None,
                    help="shard the background graph P ways (the sim "
                         "backend, every shard in this process)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="batcher max wait (seconds) before launching a "
                         "partial batch")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-query serving deadline in seconds")
    ap.add_argument("--policy", default=None, metavar="PATH",
                    help="dispatch-policy cache to serve under (default: "
                         "the registry's lazy load of policy_path())")
    args = ap.parse_args(argv)

    if args.policy:
        registry.set_policy(registry.DispatchPolicy.load(args.policy))
        print(f"dispatch policy: {args.policy} "
              f"({len(registry.get_policy().routes)} tuned routes)")
    if args.graph_queries:
        return serve_graph(args)
    if not args.arch:
        raise SystemExit("pass --arch (LM/recsys) or --graph-queries N")

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


def serve_graph(args):
    """Serve `--graph-queries` templates in count mode through
    `GraphQueryEngine`; returns the results."""
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.serve import GraphQueryEngine, MODE_COUNT, example_workload

    g = rmat_graph(args.graph_scale, edge_factor=8, seed=5)
    print(f"background graph: n={g.n} m={g.m} "
          f"(rmat scale {args.graph_scale})")
    eng = GraphQueryEngine(
        g, partition=args.partition, max_batch=args.max_batch,
        max_wait_s=args.max_wait, device=args.device)
    templates = example_workload(args.graph_queries, seed=1,
                                 labels_max=int(g.labels.max()))
    t0 = time.perf_counter()
    ids = [eng.submit(t, mode=MODE_COUNT, timeout_s=args.timeout)
           for t in templates]
    results = eng.drain()
    dt = time.perf_counter() - t0
    assert len(results) == len(ids)
    ok = [r for r in results if r.status == "ok"]
    missed = len(results) - len(ok)
    where = (f"{eng.dg.device}, P={eng.partition.P} shards"
             if eng.partition is not None else f"{eng.dg.device}")
    print(f"served {len(results)} queries on {where} in {dt:.2f}s "
          f"({len(results) / dt:.1f} q/s) across "
          f"{eng.stats['n_batches']} batches; deadline_missed={missed}")
    for b in eng.stats["batches"]:
        print(f"  batch {b['batch_id']}: B={b['B']} bucket={b['bucket']} "
              f"{b['seconds']:.2f}s")
    for r in ok[:4]:
        print(f"  query {r.query_id}: {r.n_embeddings} matches "
              f"(batch {r.batch_id}, waited {r.wait_s * 1e3:.0f}ms)")
    return results


if __name__ == "__main__":
    main()
