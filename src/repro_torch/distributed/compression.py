"""Compressed gradient all-reduce with error feedback (EF21), port of the
reference `distributed/compression.py`.

int8 quantization cuts a gradient all-reduce's bytes 4× (f32) where the
links are slow. Plain quantized reduction biases training, so each worker
keeps an error-feedback residual:

    c_t   = Q(g_t + e_t)
    e_t+1 = (g_t + e_t) − c_t
    ĝ_t   = psum(c_t) / N

Q is per-leaf symmetric int8 with ``scale = max(amax / 127, 1e-12)``. As in
the reference, the reduction sums the dequantized f32 values (the same sum
the int8 codes and per-rank scales would give on the wire), so
`analysis.collectives.TRACE` records the f32 all-reduce the port really
issues; an int8 wire format is later work. The reference runs under
``jit``, where XLA turns each division by a constant (``amax / 127`` and
the mean over N) into a multiplication by its f32 reciprocal; the port
multiplies by the same reciprocals, on the CPU and on the card alike, and
so gives the jitted reference's scales and codes bit for bit (an eager
``amax / 127`` parts from them by an ulp of the scale in ~4 % of leaves).
XLA also fuses the new error ``corrected − codes·scale`` into one
multiply-add, rounded once; the port takes the difference in f64 (where
the product is exact) and rounds it once to f32, the same bits.

`compressed_psum` reduces over a process group (a `DecodeCtx`, the
counterpart of the reference's axis name); `make_compressed_grad_fn` is the
reference's shard_map DDP step: parameters replicated, each rank's rows of
the batch, → (loss mean, gradient mean, new errors).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import DecodeCtx, P, local_block, psum
from repro_torch.runtime.tree import leaves, tree_map


def _quantize_leaf(g: torch.Tensor):
    """Per-leaf symmetric int8: (codes int8, scale f32 0-dim)."""
    g32 = g.to(torch.float32)
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp_min(amax * (1.0 / 127.0), 1e-12)     # XLA's form of amax / 127
    codes = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compressed_psum(grads: Any, ctx: DecodeCtx, errors: Any | None = None):
    """int8-compressed psum over ``ctx``'s group with error feedback →
    (mean_grads, new_errors), trees of ``grads``' structure in f32
    (``errors``: f32, zeros when None)."""
    n = float(ctx.world_size)
    if errors is None:
        errors = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                          grads)

    means, new_errors = [], []

    def leaf(g, e):
        corrected = g.to(torch.float32) + e
        codes, scale = _quantize_leaf(corrected)
        deq = _dequantize_leaf(codes, scale)
        # corrected − codes·scale rounded once, as XLA's fused multiply-add
        # gives it under jit (the product is exact in f64)
        new_errors.append((corrected.double() - codes.double() * scale.double()).float())
        means.append(psum(deq.clone(), ctx) * (1.0 / n))

    with torch.no_grad():
        tree_map(leaf, grads, errors)
    means, new_errors = iter(means), iter(new_errors)
    return tree_map(lambda _: next(means), grads), tree_map(lambda _: next(new_errors), grads)


def make_compressed_grad_fn(loss_fn: Callable, mesh, dp_axis: str = "data") -> Callable:
    """DDP with compressed gradients over the mesh's ``dp_axis`` (every
    other axis of size 1): f(params, batch, errors) → (loss_mean,
    grads_mean, new_errors). ``params`` replicated, ``batch`` the global
    batch (a dict of tensors; each rank computes on its rows, split on the
    leading dim over ``dp_axis``), ``errors`` this rank's residuals (None:
    zeros). ``loss_fn(params, batch)`` → scalar."""
    if mesh.shape[dp_axis] != mesh.ctx.world_size:
        raise NotImplementedError(f"compressed DDP over {dp_axis!r} ({mesh.shape[dp_axis]} "
                                  f"ranks) in a world of {mesh.ctx.world_size}")
    ctx = mesh.ctx

    def step(params, batch, errors=None):
        rows = {k: v[local_block(mesh, P(dp_axis), v.shape)] for k, v in batch.items()}
        full = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = loss_fn(full, rows)
        grads = iter(torch.autograd.grad(loss, [t for _, t in leaves(full)],
                                         allow_unused=True, materialize_grads=True))
        grads = tree_map(lambda _: next(grads), params)
        mean_grads, new_errors = compressed_psum(grads, ctx, errors)
        loss_mean = psum(loss.detach().clone(), ctx) * (1.0 / ctx.world_size)
        return loss_mean, mean_grads, new_errors

    return step
