"""Training entry point of the port, as the JAX package's
`launch/train.py`, on the card unless `--device cpu`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 100 [--device cpu] [--ckpt-dir DIR] [--batch 8] [--seq 128]

It trains the arch's smoke config (`--smoke`, the only choice, as in the
reference) with the fault-tolerant trainer (checkpoint/restart,
deterministic skip-ahead). An LM's head dim is raised to 64, the least that
`flash_attention` takes, on the CPU too, so that both devices train one
model (`launch/serve.py:serve_config`).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import GNNConfig, LMConfig
from repro_torch.data.graphs import full_graph_batch
from repro_torch.data.recsys import MaskedSequenceStream
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.graph import generators as gen
from repro_torch.launch.serve import serve_config
from repro_torch.models.bert4rec import Bert4Rec
from repro_torch.models.gnn import GNN
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, build_train_step, init_state, trainer

GNN_FEATURES, GNN_CLASSES = 32, 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch) if args.smoke else get_arch(args.arch).CONFIG
    tc = TrainConfig(optimizer=AdamWConfig(lr=args.lr),
                     warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    if isinstance(cfg, LMConfig):
        model = Transformer(cfg, device=args.device, seed=0)
        batch_fn = SyntheticTokenStream(cfg.vocab, args.batch, args.seq, seed=0,
                                        device=model.device)
    elif isinstance(cfg, GNNConfig):
        model = GNN(cfg, GNN_FEATURES, GNN_CLASSES, device=args.device, seed=0)
        g = gen.rmat_graph(11, edge_factor=8, seed=0)
        batch = full_graph_batch(g, d_feat=GNN_FEATURES, n_classes=GNN_CLASSES,
                                 seed=0, device=model.device)
        batch_fn = lambda step: batch  # noqa: E731
    else:
        model = Bert4Rec(cfg, device=args.device, seed=0)
        batch_fn = MaskedSequenceStream(cfg.n_items, args.batch, cfg.seq_len,
                                        seed=0, device=model.device)

    report = trainer.run(
        init_state(model, tc), build_train_step(model, tc), batch_fn,
        num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval, log_every=args.log_every)
    print(f"done on {model.device}: {report.steps_run} steps, loss "
          f"{report.losses[0]:.4f} -> {report.losses[-1]:.4f}, "
          f"{1e3 * sum(report.step_times) / max(len(report.step_times), 1):.1f} "
          f"ms/step")
    return report


if __name__ == "__main__":
    main()
