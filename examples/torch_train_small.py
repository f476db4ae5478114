"""Train a small LM on the synthetic stream with the port's Trainer.

    PYTHONPATH=src python examples/torch_train_small.py --steps 200 [--device cpu]

Twin of `examples/train_small.py`: the reduced config of ``--arch`` trained
on one device by `repro_torch.runtime.Trainer` (AdamW with f32 masters,
asynchronous checkpoints, the straggler monitor, deterministic data), at a
size a CPU finishes in minutes. On the card the attention runs kernel B3
forward and B3-bwd backward. The reference's mesh plan has no counterpart:
the port trains on one device. Runs on ``cuda`` unless ``--device cpu`` is
given; checkpoints go to ``--ckpt-dir`` (default: under the temporary
directory), from which a later run resumes.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.runtime import AdamWConfig, Trainer, TrainerConfig  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train; returns the Trainer's result (losses, final step, recoveries,
    straggler flags)."""
    cfg = get_config(args.arch).reduced()
    shape = ShapeConfig("example", seq_len=args.seq, global_batch=args.batch, kind="train")
    trainer = Trainer(
        cfg, shape, None,
        TrainerConfig(num_steps=args.steps, ckpt_every=max(args.steps // 4, 10),
                      ckpt_dir=args.ckpt_dir, log_every=20),
        AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps), device=args.device)
    return trainer.train()


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    out = run(args)
    losses = out["losses"]
    print(f"\nloss: start {np.mean(losses[:10]):.3f} → end {np.mean(losses[-10:]):.3f}"
          f" over {out['final_step']} steps "
          f"(recoveries={out['recoveries']}, straggler flags={out['straggler_flags']})")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "loss should decrease"


if __name__ == "__main__":
    main()
