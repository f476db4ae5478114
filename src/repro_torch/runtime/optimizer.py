"""AdamW with float32 master weights and global-norm clipping.

Port of the reference `runtime/optimizer.py` on torch tensors, in its order
of operations: the clip scale from the global norm of the gradients, the
bias corrections ``1 - b**step`` in float32, weight decay on every leaf,
the update applied to the float32 master and the parameters cast from it
(bf16 parameters round once per step). The state is a tree of the
parameters' structure (`runtime.tree`); nothing is updated in place, so a
step's inputs stay as they were.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.runtime.tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    use_master: bool = True        # f32 master copy of bf16 params


class AdamWState(NamedTuple):
    step: torch.Tensor              # () int32
    m: Any
    v: Any
    master: Any                     # f32 params (or an empty tuple)


def init_opt_state(params: Any, cfg: AdamWConfig) -> AdamWState:
    """Zero moments and, with ``use_master``, an f32 copy of every leaf — a
    copy even of an f32 leaf (the reference's rule: the master never
    aliases the parameters)."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
              if cfg.use_master else ())
    step = torch.zeros((), dtype=torch.int32, device=next(leaves(params))[1].device)
    return AdamWState(step=step, m=zeros, v=tree_map(torch.clone, zeros), master=master)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (f32)."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    total = None
    for _, g in leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(params: Any, grads: Any, state: AdamWState, cfg: AdamWConfig,
                 gnorm: torch.Tensor | None = None):
    """One step → (new_params, new_state, {"grad_norm", "lr"}), device
    scalars, no host sync. ``gnorm``: the global norm of the whole
    gradients where ``grads`` are this rank's shards of them (the sharded
    train step); by default `global_norm` of ``grads``."""
    with torch.no_grad():
        step = state.step + 1
        gnorm = global_norm(grads) if gnorm is None else gnorm
        scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-12), 1.0)
        grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
        lr = lr_schedule(cfg, step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device),
                            stepf)
        b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device),
                            stepf)
        new_m = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state.m, grads)
        new_v = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state.v, grads)
        ref = state.master if cfg.use_master else params

        def upd(p, m, v):
            u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            p32 = p.to(torch.float32)
            return p32 - lr * (u + cfg.weight_decay * p32)

        new_ref = tree_map(upd, ref, new_m, new_v)
        # a copy even where the dtype is f32: a parameter never aliases the master
        new_params = tree_map(lambda r, p: r.to(p.dtype, copy=True), new_ref, params)
        new_master = new_ref if cfg.use_master else ()
    return new_params, AdamWState(step, new_m, new_v, new_master), {"grad_norm": gnorm,
                                                                   "lr": lr}
