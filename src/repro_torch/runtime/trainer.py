"""Fault-tolerant training loop, on one device or over a mesh's data axes.

Port of the reference `runtime/trainer.py`, with its behaviours:

* periodic **asynchronous checkpoints** (atomic, keep-N), save on SIGTERM
  (preemption) and save on exit (unless that step was just saved: the
  reference writes it a second time);
* **auto-resume** from the latest checkpoint at start;
* **failure recovery**: a non-finite loss (`NaNGuard`: twice in a row) or a
  step that raises restores the last checkpoint and continues, at most
  ``max_recoveries`` times;
* **straggler monitoring** (`StepMonitor`, an EWMA of step time);
* deterministic data: the batch of a step is a pure function of (seed,
  step), so a resume or a recovery replays the exact stream.

Parameters come from `weights.init_lm_params` with a generator seeded by
``TrainerConfig.seed`` (on the trainer's device), or from ``init_params``
(a function returning a parameter tree, e.g. the reference's tree through
`weights.params_from_numpy`).

With a `runtime.steps.MeshPlan` (``plan``; None: one device) the trainer
runs the sharded step (`runtime.steps.ShardedTrainStep`, FSDP over the
plan's data axes) on every rank of the mesh:

* each rank makes the whole parameters from the seeded generator and keeps
  its blocks (the values of the reference's ``jit(api.init,
  out_shardings=...)``); the AdamW state is made from the blocks;
* each rank draws `make_batch`'s global batch of a step and keeps its rows,
  so the stream is still a pure function of (seed, step);
* checkpoints are saved whole (gathered; the first rank writes) and
  auto-resume and recovery restore through `restore(shardings=)`, so a run
  may resume on another number of ranks;
* every decision that ends or repeats a step is the same on every rank:
  after each step one all-reduce (max) of two flags, "this rank's step
  raised" and "this rank got SIGTERM". A step that raised on any rank is
  dropped on every rank (its parameters kept, its loss NaN for the guard);
  the loss itself is the ranks' mean, the same bits everywhere.
"""

from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import PrefetchIterator, make_batch
from repro_torch.runtime.monitor import NaNGuard, StepMonitor
from repro_torch.runtime.optimizer import AdamWConfig, init_opt_state
from repro_torch.runtime.steps import MeshPlan, make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep_n: int = 3
    seed: int = 0
    max_recoveries: int = 3
    log_every: int = 10
    reduced_shapes: bool = False     # CPU smoke mode


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, plan: MeshPlan | None = None,
                 tcfg: TrainerConfig | None = None, opt_cfg: AdamWConfig | None = None,
                 device="cuda", init_params: Callable[[], dict] | None = None):
        self.cfg = cfg
        self.shape = shape
        self.plan = plan
        self.tcfg = tcfg or TrainerConfig()
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=self.tcfg.num_steps)
        self.device = resolve_device(device)
        self.init_params = init_params
        self.step_fn = make_train_step(cfg, plan, self.opt_cfg, self.device)
        self._sharded = self.step_fn if plan is not None else None   # its specs and blocks
        self.ckpt = CheckpointManager(self.tcfg.ckpt_dir, keep_n=self.tcfg.keep_n)
        self.monitor = StepMonitor()
        self.nan_guard = NaNGuard()
        self.recoveries = 0
        self.losses: list[float] = []
        self.metrics: list[dict] = []      # per completed step: loss, grad_norm, lr
        self._stop = False

    def init_state(self):
        if self.init_params is not None:
            params = self.init_params()
        else:
            from repro_torch.weights import init_lm_params
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            params = init_lm_params(self.cfg, gen, self.device)
        if self._sharded is not None:
            params = self._sharded.shard(params)
        return params, init_opt_state(params, self.opt_cfg)

    def _shardings(self):
        """The checkpointed tree's shardings (None on one device)."""
        if self._sharded is None:
            return None
        from repro_torch.distributed.sharding import named
        sctx = self._sharded.sctx
        return {"params": named(sctx, self._sharded.pspec), "opt": named(sctx, self._sharded.ospec)}

    def _save(self, step, params, opt, block=False):
        self.ckpt.save(step, {"params": params, "opt": opt}, meta={"arch": self.cfg.name},
                       block=block, shardings=self._shardings())

    def _restore(self, params, opt):
        step, tree = self.ckpt.restore({"params": params, "opt": opt}, device=self.device,
                                       shardings=self._shardings())
        return step, tree["params"], tree["opt"]

    def _batch(self, step: int) -> dict:
        batch = make_batch(self.cfg, self.shape, self.tcfg.seed, step,
                           reduced=self.tcfg.reduced_shapes)
        return batch if self._sharded is None else self._sharded.local_batch(batch)

    def _batches(self, start: int) -> PrefetchIterator:
        return PrefetchIterator(self._batch, start_step=start, device=self.device)

    def _agree(self, failed: bool) -> tuple[bool, bool]:
        """(a rank's step raised, a rank got SIGTERM): over the mesh's ranks
        under a plan (one all-reduce), this process's own flags without."""
        if self._sharded is None:
            return failed, self._stop
        import torch.distributed as dist
        flags = torch.tensor([float(failed), float(self._stop)], device=self.device)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.plan.mesh.ctx.group)
        return bool(flags[0]), bool(flags[1])

    def train(self, num_steps: int | None = None) -> dict:
        num_steps = num_steps or self.tcfg.num_steps
        params, opt = self.init_state()
        start, saved = 0, None
        if self.ckpt.latest_step() is not None:          # auto-resume
            start, params, opt = self._restore(params, opt)
            saved = start
            log.info("resumed from step %d", start)

        def on_sigterm(signum, frame):      # preemption: save and stop cleanly
            log.warning("SIGTERM: checkpointing and stopping")
            self._stop = True
        old = signal.signal(signal.SIGTERM, on_sigterm)

        it = self._batches(start)
        last_good = start
        stopping = self._stop
        try:
            step = start
            while step < num_steps and not stopping:
                _, batch = next(it)
                t0 = time.time()
                try:
                    new = self.step_fn(params, opt, batch)
                    loss, failed = float(new[2]["loss"]), False
                except (FloatingPointError, RuntimeError) as e:
                    log.error("step %d failed: %s", step, e)
                    failed = True
                failed, stopping = self._agree(failed)
                if failed:          # dropped on every rank: the parameters stay
                    loss, metrics = float("nan"), None
                else:
                    params, opt, metrics = new
                dt = time.time() - t0
                self.monitor.record(step, dt, loss)
                if self.nan_guard.check(loss):
                    # failure recovery: reload the last checkpoint, replay its stream
                    self.recoveries += 1
                    if self.recoveries > self.tcfg.max_recoveries:
                        raise RuntimeError("too many recoveries; aborting")
                    log.error("recovering from checkpoint at step %d", last_good)
                    params, opt = self.init_state()
                    self.ckpt.wait()        # every rank sees the same checkpoints
                    if self.ckpt.latest_step() is not None:
                        _, params, opt = self._restore(params, opt)
                    it.close()
                    it = self._batches(last_good)
                    step = last_good
                    continue
                self.losses.append(loss)
                self.metrics.append({"step": step, "seconds": dt, **{
                    k: float(v) for k, v in (metrics or {"loss": loss}).items()}})
                if step % self.tcfg.log_every == 0:
                    log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
                step += 1
                if step % self.tcfg.ckpt_every == 0:
                    self._save(step, params, opt)
                    last_good = saved = step
            if saved != step:      # save on exit (the step just saved is not written twice)
                self._save(step, params, opt, block=True)
        finally:
            signal.signal(signal.SIGTERM, old)
            it.close()
            self.ckpt.wait()
        return {"final_step": step, "losses": self.losses,
                "recoveries": self.recoveries,
                "straggler_flags": self.monitor.flagged_steps}
