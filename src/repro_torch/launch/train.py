"""Training launcher of the port: random weights, synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --shape train_4k --steps 200 --local --device cpu   # CPU smoke
    PYTHONPATH=src torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.train \\
        --arch qwen3-0.6b --local --device cpu              # (1, 2) over 2 gloo ranks

Trains through `runtime.trainer.Trainer`, with checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir`` (resumed from when it holds
one). ``--local`` trains the reduced model at the reduced shape, as the
reference launcher does; without it, the full config at the named shape.
``--device`` defaults to ``cuda``; pass ``cpu`` to run the kernels' plain
versions.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set) every
rank joins the process group (``nccl`` on the card, ``gloo`` on the CPU;
``--dist-init`` names the rendezvous, ``env://`` by default, or a
``file://`` path on a shared file system) and takes ``cuda:LOCAL_RANK``.
With ``--local`` it trains on the reference's local mesh, (1, N) over
("data", "model") (`launch.mesh.make_local_mesh`: tensor, sequence and
context parallelism over every rank); without it on a data mesh of every
rank, (N, 1) (`launch.mesh.make_data_mesh`: FSDP), since no machine here
holds the production meshes' 256 or 512 ranks. Without those variables it
is a world of one on one device. The enc-dec family refuses a model axis
above 1.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, get_config, get_shape
from repro_torch.distributed.sharding import BACKEND
from repro_torch.launch.mesh import make_data_mesh, make_local_mesh
from repro_torch.runtime.optimizer import AdamWConfig
from repro_torch.runtime.steps import MeshPlan
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
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's rendezvous under torchrun")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    device, plan = torch.device(args.device), None
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group(BACKEND[device.type], init_method=args.dist_init,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
        plan = MeshPlan.for_mesh((make_local_mesh if args.local else make_data_mesh)(device))
    if plan is not None:
        print(f"mesh: {plan.mesh.shape}", flush=True)
    tcfg = TrainerConfig(num_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, seed=args.seed, reduced_shapes=args.local)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps)
    out = Trainer(cfg, get_shape(args.shape), plan, tcfg, opt, device=device).train()
    print(f"done: step={out['final_step']} last_loss={out['losses'][-1]:.4f} "
          f"recoveries={out['recoveries']} stragglers={out['straggler_flags']}")
    if plan is not None:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
