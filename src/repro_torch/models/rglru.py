"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427): the prefill
forward and the O(1) decode step.

    r_t = σ(W_r x_t);  i_t = σ(W_i x_t)
    a_t = a^{c·r_t}          with a = σ(Λ) per channel, c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Port of the reference `models/rglru.py` (``RGLRUState``, ``_causal_conv``,
``_gates``, the prefill form of ``rglru_train`` with its final state,
``rglru_init_state`` and ``rglru_decode``). The prefill scan over the
tokens is `associative_scan`, the odd/even recursion of
``jax.lax.associative_scan`` written in torch ops: log depth, and the same
pairing of terms as the reference's. ``w_r``, ``w_i`` and ``lam`` are
float32 and their products run in float32. In training under a model axis
the block runs on the rank's channels (`rglru_train`).

No TPU kernel computes the RG-LRU: the reference writes it as XLA ops and
an associative scan, and so do these torch ops, on the CPU and on the card
alike. They are the mixer itself, not a plain version standing in for a
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    gather_from_sequence, model_group, model_part, reduce_scatter_channels,
    reduce_scatter_to_sequence, sequence_shard)
from repro_torch.models.common import cdtype
from repro_torch.models.ssm import causal_conv, softplus

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor        # (B, W) f32: the recurrence state
    conv: torch.Tensor     # (B, conv_width-1, W), model dtype: the raw conv window


def _gates(params: dict, x: torch.Tensor, reduce=None):
    """x (..., W) f32 → (a, beta·i·x), the diagonal recurrence's terms.
    ``reduce`` takes the gate matrices' products to the gates' inputs (under
    a model axis: x this rank's channels, ``w_r`` / ``w_i`` its row blocks,
    and `reduce_scatter_channels` sums the partials to its channels)."""
    zr, zi = x @ params["w_r"], x @ params["w_i"]
    if reduce is not None:
        zr, zi = reduce(zr), reduce(zi)
    return gate_terms(params, x, zr, zi)


def gate_terms(params: dict, x: torch.Tensor, zr: torch.Tensor, zi: torch.Tensor):
    """(a, beta·i·x) from x (..., W) f32 and the gates' inputs zr = x @ w_r,
    zi = x @ w_i (under a model axis: this rank's channels of each)."""
    r = torch.sigmoid(zr)
    i = torch.sigmoid(zi)
    log_a = -_C * r * softplus(-params["lam"])
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return a, beta * (i * x)


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` at 0, 2, 4, ... and of ``odd`` at 1, 3, ... along dim 1."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t along dim 1 (h_{-1} = 0),
    as ``jax.lax.associative_scan`` computes it: combine adjacent pairs,
    scan the half-length sequence recursively (the odd positions), then
    combine each odd result with the next element (the even positions).
    Returns (the products of a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_train(params: dict, u: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
                split: bool = False):
    """u (B, T, D) → (B, T, D) [, final `RGLRUState`]. The returned conv
    window is the reference's ``x_raw[:, -(W-1):]``: the raw inputs of the
    last W-1 tokens, or of all T < W-1 of them, unpadded (so the slot write
    broadcasts a 1-token prompt's row and refuses a 2-token prompt's, as the
    reference's does).

    In training under a model axis above 1, u and the output are in the
    residual's layout (the sequence split over "model" where ``split``) and
    the block takes the reference's specs: the sequence is gathered whole,
    ``w_x``, ``w_gate_out``, ``conv_w`` and ``lam`` give this rank's W/M
    channels (the depthwise conv and the scan act per channel: no
    exchange), the row blocks of ``w_r`` and ``w_i`` give partials over all
    W gate inputs, reduce-scattered to the rank's channels (two f32
    (B, T, W) reduce-scatters), and ``w_out``'s row block a partial output,
    reduced back into the residual's layout. Where the spec leaves W whole
    every rank runs the whole block and keeps its rows."""
    if model_group() is None:
        return _rglru(params, u, return_state)
    if return_state:
        raise NotImplementedError("the RG-LRU's prompt state under a model axis")
    ug = gather_from_sequence(u, split)
    if model_part(cfg.rnn_width or cfg.d_model)[1] == 1:
        return sequence_shard(_rglru(params, ug), split)
    return reduce_scatter_to_sequence(_rglru(params, ug, reduce=reduce_scatter_channels), split)


def _rglru(params: dict, u: torch.Tensor, return_state: bool = False, reduce=None):
    """`rglru_train` on u (B, T, D) whole, the gates' products taken to
    their inputs by ``reduce`` (`_gates`)."""
    x_raw = u @ params["w_x"]
    x, _ = causal_conv(x_raw, params["conv_w"])
    a, b = _gates(params, x.float(), reduce)
    _, h = associative_scan(a, b)
    y = h.to(u.dtype) * F.gelu(u @ params["w_gate_out"], approximate="tanh")
    out = y @ params["w_out"]
    if not return_state:
        return out
    w1 = params["conv_w"].shape[0] - 1
    # copies, not views: a view would keep the whole (B, T, W) scan and
    # projection alive in every layer's state until the slot write
    return out, RGLRUState(h=h[:, -1].clone(), conv=x_raw[:, -w1:].clone())


def rglru_init_state(batch: int, cfg: ModelConfig, device) -> RGLRUState:
    w = cfg.rnn_width or cfg.d_model
    return RGLRUState(h=torch.zeros((batch, w), dtype=torch.float32, device=device),
                      conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=cdtype(cfg),
                                       device=device))


def rglru_decode(params: dict, u: torch.Tensor, state: RGLRUState, cfg: ModelConfig):
    """One-token update: u (B, D) → (out (B, D), new `RGLRUState`). The
    state passed in is read, not written (`blocks.merge_masked_state`
    writes the new one back for the active slots)."""
    x, new_conv = causal_conv((u @ params["w_x"])[:, None], params["conv_w"], state.conv)
    a, b = _gates(params, x[:, 0].float())
    h = a * state.h + b
    y = h.to(u.dtype) * F.gelu(u @ params["w_gate_out"], approximate="tanh")
    return y @ params["w_out"], RGLRUState(h=h, conv=new_conv)
