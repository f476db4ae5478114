"""Train a model on a (data × model) mesh for a few steps and print what a
step costs: the loss of each step, ms a step, peak device memory a rank, and
the collectives of a step with their bytes.

    torchrun --standalone --nproc_per_node 4 scripts/torch_train_tp.py \\
        --arch qwen3-8b --mesh 1x4 --seq 4096 --batch 4 --steps 4
    torchrun --standalone --nproc_per_node 4 scripts/torch_train_tp.py \\
        --arch granite-moe-3b-a800m --mesh 2x2 --steps 5 [--moe-strategy tp]

One process a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` from torchrun):
``nccl`` on ``cuda:LOCAL_RANK``, or ``gloo`` with ``--device cpu`` (with
``--reduced`` for the reduced config: a rehearsal on the CPU). Random
weights from ``--seed`` (the whole tree made on every rank, then cut to its
blocks, as `runtime.trainer.Trainer` does), `runtime.data.make_batch`'s
synthetic batches, `runtime.steps.make_train_step` under a
`runtime.steps.MeshPlan` of the mesh; no checkpoints. An MoE config trains
under its ``moe_strategy`` (``--moe-strategy`` replaces it: ``ep``, experts
over "model", or ``tp``, their d_ff), and each step also reports the share
of (token, choice) pairs that the expert capacity dropped over every rank's
routings (`models.moe.positions`; the checkpointed recomputation's count
twice, which leaves the share as it is). Rank 0 prints one line a step and
a JSON summary, which it also writes to ``--out``: the last step's
collectives by kind (`distributed.sharding.COLLECTIVES`), their wire bytes
(`analysis.collectives.TRACE`) and, by group ("data", "model" or "world"),
their count and result bytes, this rank's.

    torchrun --standalone --nproc_per_node 4 scripts/torch_train_tp.py \
        --arch mamba2-2.7b --mesh 1x4 --seq 4096 --batch 4 --steps 5
    torchrun --standalone --nproc_per_node 4 scripts/torch_train_tp.py \
        --arch recurrentgemma-2b --mesh 2x2 --seq 4096 --batch 4 --steps 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.collectives import TRACE  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import BACKEND, COLLECTIVES  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.runtime.data import make_batch, to_device  # noqa: E402
from repro_torch.runtime.optimizer import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.runtime.steps import MeshPlan, make_train_step  # noqa: E402
from repro_torch.weights import init_lm_params  # noqa: E402


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return " | ".join(out.stdout.strip().splitlines())


def _count_moe_pairs(device) -> torch.Tensor:
    """Route `models.moe.positions` through a counter: (kept pairs, pairs)
    as a float64 tensor on ``device`` that each routing adds to."""
    from repro_torch.models import moe
    acc = torch.zeros(2, dtype=torch.float64, device=device)
    real = moe.positions

    def counting(*args, **kw):
        r = real(*args, **kw)
        acc[0] += r.keep.sum()
        acc[1] += r.keep.numel()
        return r

    moe.positions = counting
    return acc


class GroupCounter:
    """A step's collectives by group and kind: ``torch.distributed``'s
    all-gather, reduce-scatter and all-reduce wrapped to count each call
    and its result's bytes under the name of the mesh group it ran over
    ("data" or "model", marked where the group spans every rank or holds
    one; "world" for the whole process group otherwise)."""

    OPS = {"all_gather_into_tensor": "all_gather", "reduce_scatter_tensor": "reduce_scatter",
           "all_reduce": "all_reduce"}

    def __init__(self, mesh):
        names = {}
        for axes, label in ((("data",), "data"), ("model", "model")):
            g = mesh.group(axes)
            names[id(g.group)] = (f"{label} (world)" if g is mesh.ctx else
                                  f"{label} (one rank)" if g.world_size == 1 else label)
        self.names, self.seen, self.real = names, {}, {}
        for fn, kind in self.OPS.items():
            self.real[fn] = getattr(dist, fn)
            setattr(dist, fn, self._wrap(self.real[fn], kind))

    def _wrap(self, real, kind):
        def call(*args, **kw):
            key = f"{self.names.get(id(kw.get('group')), 'world')}/{kind}"
            t = args[0]                 # the result (all-gather, reduce-scatter) or x
            n, b = self.seen.get(key, (0, 0))
            self.seen[key] = (n + 1, b + t.numel() * t.element_size())
            return real(*args, **kw)
        return call

    def take(self) -> dict:
        out = {k: dict(count=n, result_bytes=b) for k, (n, b) in sorted(self.seen.items())}
        self.seen = {}
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_NAMES)
    ap.add_argument("--mesh", default="1x4", help="data x model, e.g. 1x4 or 2x2")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4, help="global batch (sequences)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (a rehearsal)")
    ap.add_argument("--moe-strategy", choices=("ep", "tp"), default=None,
                    help="an MoE config's layout over the model axis (default: the config's)")
    ap.add_argument("--out", default="chiprun_out/torch_train_tp.json")
    args = ap.parse_args()

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(BACKEND[device.type], rank=rank, world_size=world)
    if device.type == "cuda":         # training's two kernels, built once for every rank
        from repro_torch.kernels import common
        if rank == 0:
            print(f"build: {common.build_kernels(['flash_prefill', 'flash_prefill_bwd']):.1f} s",
                  flush=True)
        dist.barrier()
    shape = tuple(int(x) for x in args.mesh.split("x"))
    mesh = make_mesh(shape, ("data", "model"), device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if args.moe_strategy:
        cfg = dataclasses.replace(cfg, moe_strategy=args.moe_strategy)
    pairs = _count_moe_pairs(device) if cfg.moe else None
    groups = GroupCounter(mesh)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=1, total_steps=args.steps)
    step = make_train_step(cfg, MeshPlan.for_mesh(mesh), opt_cfg, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.time()
    params = step.shard(init_lm_params(cfg, gen, device))
    opt = init_opt_state(params, opt_cfg)
    init_s = time.time() - t0
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tshape = ShapeConfig(name="tp", seq_len=args.seq, global_batch=args.batch, kind="train")
    steps, per_step, wire, by_group = [], {}, {}, {}
    for s in range(args.steps):
        batch = to_device(step.local_batch(make_batch(cfg, tshape, args.seed, s)), device)
        COLLECTIVES.clear()
        TRACE.reset()
        groups.take()
        if pairs is not None:
            pairs.zero_()
        sync()
        t = time.time()
        params, opt, m = step(params, opt, batch)
        sync()
        ms = (time.time() - t) * 1e3
        per_step, wire, by_group = dict(COLLECTIVES), TRACE.summary(), groups.take()
        steps.append(dict(step=s, ms=ms, **{k: float(v) for k, v in m.items()}))
        if pairs is not None:
            dist.all_reduce(pairs)
            steps[-1]["dropped_pairs_share"] = float(1.0 - pairs[0] / pairs[1])
        if rank == 0:
            print(f"step {s}: loss {steps[-1]['loss']:.4f} grad_norm "
                  f"{steps[-1]['grad_norm']:.4f} {ms:.1f} ms", flush=True)
    peak = (torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda"
            else None)
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    if rank == 0:
        tokens = args.seq * args.batch
        later = sorted(x["ms"] for x in steps[1:]) or [steps[0]["ms"]]
        out = dict(arch=cfg.name, mesh=mesh.shape, seq=args.seq, global_batch=args.batch,
                   moe_strategy=cfg.moe_strategy if cfg.moe else None,
                   device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu"),
                   gpus=gpu_line() if device.type == "cuda" else None, init_s=init_s,
                   steps=steps, median_ms_after_first=later[len(later) // 2],
                   tokens_per_s=tokens / (later[len(later) // 2] / 1e3),
                   peak_gb_per_rank=peaks, collectives_per_step=per_step,
                   collective_bytes_per_step=wire, collectives_by_group=by_group)
        print(json.dumps(out), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
