"""Training launcher of the port: random weights, synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --shape train_4k --steps 200 --local --device cpu   # CPU smoke

Trains one model on one device through `runtime.trainer.Trainer`, with
checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir`` (resumed from
when it holds one). ``--local`` trains the reduced model at the reduced
shape, as the reference launcher does; without it, the full config at the
named shape. ``--device`` defaults to ``cuda``; pass ``cpu`` to run the
kernels' plain versions. The reference's ``--multi-pod`` has no
counterpart: multi-GPU training is later work.
"""

from __future__ import annotations

import argparse
import logging

from repro_torch.configs import ARCH_NAMES, get_config, get_shape
from repro_torch.runtime.optimizer import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--local", action="store_true",
                    help="reduced model and shape (smoke mode)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(num_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, seed=args.seed, reduced_shapes=args.local)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps)
    out = Trainer(cfg, get_shape(args.shape), tcfg, opt, device=args.device).train()
    print(f"done: step={out['final_step']} last_loss={out['losses'][-1]:.4f} "
          f"recoveries={out['recoveries']} stragglers={out['straggler_flags']}")


if __name__ == "__main__":
    main()
