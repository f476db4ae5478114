"""Mamba-2 SSD (state-space duality) mixer: the chunked prefill forward and the
O(1) decode step.

Port of the reference `models/ssm.py` (``SSMState``, ``_dims``,
``_project``, ``_causal_conv``, the prefill form of ``ssd_train`` with its
final state, ``ssd_init_state`` and ``ssd_decode``). Within a chunk the
output is a dense attention-like product; states pass between chunks by an
exponential-decay recurrence (a Python loop over the chunks, as the
reference's ``lax.scan``). The decode step is the pure recurrence. In
training under a model axis the mixer runs on the rank's heads
(`ssd_train`).

No TPU kernel computes the SSD: the reference writes it as XLA einsums and
a scan, and so do these torch ops, on the CPU and on the card alike. They
are the mixer itself, not a plain version standing in for a kernel.

Shapes: d_inner = expand·d_model; nheads = d_inner / head_dim; x (B, T,
d_inner) viewed as (B, T, NH, HD); B and C (B, T, DS), one group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    gather_from_sequence, model_group, model_part, reduce_scatter_to_sequence, sequence_shard)
from repro_torch.models.common import cdtype, parallel_rmsnorm, rmsnorm


class SSMState(NamedTuple):
    h: torch.Tensor        # (B, NH, HD, DS) f32: the inter-chunk / decode state
    conv: torch.Tensor     # (B, W-1, conv_dim), model dtype: the raw conv window


def _dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return di, nh, cfg.ssm_head_dim, cfg.ssm_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
    (torch's softplus is log1p(exp(x)) below a threshold, which rounds
    apart from it.)"""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _project(params: dict, u: torch.Tensor):
    """u (..., D) → (x (..., di), B (..., ds), C (..., ds), dt (..., nh))."""
    return u @ params["w_x"], u @ params["w_B"], u @ params["w_C"], u @ params["w_dt"]


def causal_conv(seq: torch.Tensor, w: torch.Tensor, prior: torch.Tensor | None = None):
    """Depthwise causal conv1d, summed tap by tap from tap 0 in the input's
    dtype: seq (B, T, C), w (W, C), prior (B, W-1, C) (zeros when None) →
    (out (B, T, C), the last W-1 rows of [prior; seq]). No activation."""
    width, t = w.shape[0], seq.shape[1]
    if prior is None:
        prior = seq.new_zeros((seq.shape[0], width - 1, seq.shape[2]))
    padded = torch.cat([prior, seq], dim=1)
    out = padded[:, 0:t] * w[0]
    for i in range(1, width):
        out = out + padded[:, i:i + t] * w[i]
    return out, padded[:, -(width - 1):]


def ssd_train(params: dict, u: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
              split: bool = False):
    """Chunked SSD forward: u (B, T, D) → (B, T, D) [, final `SSMState`].

    The chunk is min(ssm_chunk, T); a prompt that is not a multiple pads
    with zero rows whose dt is zeroed, so they neither decay nor update the
    state. The returned conv window holds the raw (pre-activation) inputs of
    the last W-1 real tokens, left-padded with zeros for a shorter prompt.

    In training under a model axis above 1, u and the output are in the
    residual's layout (the sequence split over "model" where ``split``) and
    the mixer takes the reference's specs: the sequence is gathered whole,
    this rank's ``w_x`` / ``z_gate`` columns are its nh/M heads, B and C are
    computed whole from the replicated ``w_B`` / ``w_C``, and ``w_dt``,
    ``dt_bias``, ``A_log``, ``D`` and the conv's x columns are cut to the
    rank's heads, so that each replicated leaf's gradient is this rank's
    part of it. The gated norm over the split d_inner sums the ranks' sums
    of squares; ``w_out``'s row block gives a partial output, reduced back
    into the residual's layout. Where the spec leaves d_inner whole every
    rank runs the whole mixer and keeps its rows."""
    if model_group() is None:
        return _ssd(params, u, cfg, return_state)
    if return_state:
        raise NotImplementedError("the SSD's prompt state under a model axis")
    di, nh, _, _ = _dims(cfg)
    ug = gather_from_sequence(u, split)
    i, parts = model_part(di)
    if parts == 1:
        return sequence_shard(_ssd(params, ug, cfg), split)
    y, up, _, _ = ssd_scan(head_block(params, cfg, i, parts), ug, cfg,
                           (di // parts, nh // parts))
    y = parallel_rmsnorm(params["norm"], y, cfg.norm_eps, di)
    return reduce_scatter_to_sequence(gated_out(params, y, up)[:, :ug.shape[1]], split)


def head_block(params: dict, cfg: ModelConfig, i: int, parts: int) -> dict:
    """The SSD leaves of model rank ``i`` of ``parts`` as its scan takes
    them: ``params`` holds its blocks of the split leaves (``w_x``,
    ``z_gate``, ``norm``, ``w_out``) and the replicated ones whole; ``w_dt``,
    ``dt_bias``, ``A_log`` and ``D`` are cut to its heads and ``conv_w`` to
    its x columns beside the B and C columns."""
    di, nh, _, _ = _dims(cfg)
    heads = slice(i * nh // parts, (i + 1) * nh // parts)
    cols = slice(i * di // parts, (i + 1) * di // parts)
    conv = params["conv_w"]
    return dict(params, w_dt=params["w_dt"][:, heads], dt_bias=params["dt_bias"][heads],
                A_log=params["A_log"][heads], D=params["D"][heads],
                conv_w=torch.cat([conv[:, cols], conv[:, di:]], dim=1))


def gated_out(params: dict, y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The normed scan output y (..., di) gated by silu(u @ z_gate) and
    projected out by ``w_out``."""
    return (y * F.silu(u @ params["z_gate"])) @ params["w_out"]


def _ssd(params: dict, u: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """`ssd_train` on u (B, T, D) whole."""
    t_in = u.shape[1]
    y, up, conv_in, h = ssd_scan(params, u, cfg)
    out = gated_out(params, rmsnorm(params["norm"], y, cfg.norm_eps), up)[:, :t_in]
    if not return_state:
        return out
    w1 = cfg.conv_width - 1
    # a copy, not a view: a view would keep the whole (B, T, conv_dim)
    # projection alive in every layer's state until the slot write
    raw_tail = conv_in[:, max(t_in - w1, 0):t_in].clone()
    if raw_tail.shape[1] < w1:
        raw_tail = F.pad(raw_tail, (0, 0, w1 - raw_tail.shape[1], 0))
    return out, SSMState(h=h, conv=raw_tail)


def ssd_scan(params: dict, u: torch.Tensor, cfg: ModelConfig, dims: tuple | None = None):
    """The SSD up to its gated norm on u (B, T, D), over ``dims`` = (d_inner,
    heads) of the weights given (all of them by default) → (y (B, T', di)
    in u's dtype before the norm, u padded to T' (a multiple of the chunk),
    the conv's raw input (B, T', di + 2·ds), the final state h)."""
    b, t_in, _ = u.shape
    di, nh, hd, ds = _dims(cfg)
    if dims is not None:
        di, nh = dims
    cs = min(cfg.ssm_chunk, t_in)
    if t_in % cs:
        u = F.pad(u, (0, 0, 0, cs - t_in % cs))
    t = u.shape[1]
    nc = t // cs
    xr, br, cr, dtr = _project(params, u)
    conv_in = torch.cat([xr, br, cr], dim=-1)
    conv_out, _ = causal_conv(conv_in, params["conv_w"])
    conv_out = F.silu(conv_out)
    x = conv_out[..., :di].reshape(b, t, nh, hd)
    dt = softplus(dtr.float() + params["dt_bias"])                     # (B, T, NH)
    if t != t_in:
        dt = dt * (torch.arange(t, device=u.device) < t_in)[None, :, None]
    a = -torch.exp(params["A_log"])
    da = dt * a

    # chunk views, heads ahead of the token axes
    xc = x.reshape(b, nc, cs, nh, hd).float()
    bc = conv_out[..., di:di + ds].reshape(b, nc, cs, ds).float()
    cc = conv_out[..., di + ds:].reshape(b, nc, cs, ds).float()
    dtc = dt.reshape(b, nc, cs, nh)
    cum = torch.cumsum(da.reshape(b, nc, cs, nh), dim=2)               # (B, NC, CS, NH)

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j; masked BEFORE
    # the exp (the above-diagonal differences are positive and overflow)
    cum_h = cum.transpose(2, 3)                                        # (B, NC, NH, CS)
    seg = cum_h[..., :, None] - cum_h[..., None, :]                    # (B, NC, NH, i, j)
    causal = torch.ones((cs, cs), dtype=torch.bool, device=u.device).tril()
    lmat = torch.exp(seg.masked_fill_(~causal, -1e9))
    del seg
    cb = cc @ bc.transpose(-1, -2)                                     # (B, NC, i, j)
    if lmat.requires_grad:          # training: exp saved its output for the backward
        att = lmat * cb[:, :, None] * dtc.transpose(2, 3)[..., None, :]
    else:                           # serving: in place, the same bits
        att = lmat.mul_(cb[:, :, None]).mul_(dtc.transpose(2, 3)[..., None, :])
    y_intra = (att @ xc.transpose(2, 3)).transpose(2, 3)              # (B, NC, CS, NH, HD)
    del lmat, att

    # chunk-final states: S_n = Σ_j exp(cum_end - cum_j)·dt_j·B_j ⊗ x_j
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc                   # (B, NC, CS, NH)
    sxb = torch.einsum("bnjs,bnjhd->bnhds", bc, xc * w_end[..., None])
    chunk_decay = torch.exp(da.reshape(b, nc, cs, nh).sum(dim=2))      # (B, NC, NH)

    # inter-chunk recurrence: the state before each chunk
    h = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=u.device)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + sxb[:, n]
    h_prev = torch.stack(h_prev, dim=1)                                # (B, NC, NH, HD, DS)
    y_inter = torch.einsum("bnjs,bnhds->bnjhd", cc, h_prev) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, t, nh, hd)
    y = y + params["D"][None, None, :, None] * x.float()
    return y.reshape(b, t, di).to(u.dtype), u, conv_in, h


def ssd_init_state(batch: int, cfg: ModelConfig, device) -> SSMState:
    di, nh, hd, ds = _dims(cfg)
    return SSMState(
        h=torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, di + 2 * ds), dtype=cdtype(cfg),
                         device=device))


def ssd_decode(params: dict, u: torch.Tensor, state: SSMState, cfg: ModelConfig):
    """One-token recurrence: u (B, D) → (out (B, D), new `SSMState`). The
    state passed in is read, not written (`blocks.merge_masked_state`
    writes the new one back for the active slots)."""
    b = u.shape[0]
    di, nh, hd, ds = _dims(cfg)
    xr, br, cr, dtr = _project(params, u)
    conv_in = torch.cat([xr, br, cr], dim=-1)[:, None]                 # (B, 1, conv)
    conv_out, new_conv = causal_conv(conv_in, params["conv_w"], state.conv)
    conv_out = F.silu(conv_out[:, 0])
    x = conv_out[:, :di].reshape(b, nh, hd).float()
    bm = conv_out[:, di:di + ds].float()                               # (B, DS)
    cm = conv_out[:, di + ds:].float()
    dt = softplus(dtr.float() + params["dt_bias"])                     # (B, NH)
    dec = torch.exp(dt * -torch.exp(params["A_log"]))
    h = state.h * dec[..., None, None] + (dt[:, :, None, None] * x[..., None]) * bm[:, None, None]
    y = (h @ cm[:, None, :, None])[..., 0] + params["D"][None, :, None] * x
    y = y.reshape(b, di).to(u.dtype)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * F.silu(u @ params["z_gate"])
    return y @ params["w_out"], SSMState(h=h, conv=new_conv)
