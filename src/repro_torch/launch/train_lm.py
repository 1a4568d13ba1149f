"""A ~100M-parameter LM trained with the whole training substrate -- the
microbatched train step, remat, AdamW with the cosine schedule, and a
checkpoint/restart in the middle of the run -- as the JAX package's
`examples/train_lm.py` runs it, on the card unless `--device cpu`.

  PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] [--device cpu]

12 layers x d_model 768 x GQA 12/4 heads x d_ff 2048, vocab 8k, f32.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs.base import LMConfig
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, build_train_step, init_state, trainer

CONFIG = LMConfig(
    name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab=8192, dtype="float32",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = CONFIG
    print(f"model: {cfg.n_params() / 1e6:.1f}M params")
    tc = TrainConfig(
        optimizer=AdamWConfig(lr=3e-4, weight_decay=0.01),
        microbatches=2, remat=True,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
    )
    model = Transformer(cfg, device=args.device, seed=0)
    stream = SyntheticTokenStream(cfg.vocab, args.batch, args.seq, seed=0,
                                  device=model.device)
    half = args.steps // 2
    armed = [True]

    def fail_once(s):
        if s == half and armed[0]:
            armed[0] = False
            raise trainer.SimulatedFailure("node failure injected")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # train the first half, simulate a crash, resume for the second half
        report = trainer.run(
            init_state(model, tc), build_train_step(model, tc), stream,
            num_steps=args.steps, ckpt_dir=ckpt_dir,
            ckpt_interval=max(half // 2, 1), fail_hook=fail_once, log_every=10)
    print(f"restarts survived: {report.restarts}")
    print(f"loss: {report.losses[0]:.4f} -> {report.losses[-1]:.4f}")
    if not report.losses[-1] < report.losses[0]:
        raise RuntimeError("the loss did not fall")
    print("OK")
    return report


if __name__ == "__main__":
    main()
