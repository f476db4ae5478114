"""Kernel B3: dense causal flash attention for prefill, and its plain version.

Replaces `repro/kernels/flash_prefill/kernel.py::flash_attention_pallas`
(the JAX model runs its XLA twin `models/attention.py::flash_attention_xla`).
Query rows sit at absolute positions [q_offset, q_offset+T) over keys
[0, S); ``window`` > 0 keeps only keys with ``kpos > qpos - window``. GQA
is index arithmetic: query row-group bh reads K/V row-group bh // G.
CUDA source: ``repro_torch/csrc/flash_prefill.cu``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import common

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain version (mirrors the reference `flash_attention_ref`), f32 math.
    q (BH, T, HD); k/v (BKV, S, HD) with BH a multiple of BKV → (BH, T, HD)."""
    bh, t, hd = q.shape
    bkv, s_len = k.shape[:2]
    g = bh // bkv
    qf = q.float().reshape(bkv, g, t, hd)
    s = torch.einsum("bgtd,bsd->bgts", qf, k.float()) / math.sqrt(hd)
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones((t, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgts,bsd->bgtd", p, v.float())
    return out.reshape(bh, t, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal / windowed attention in the (BH, T, HD) layout; output in q's
    dtype. CPU tensors take the plain version; CUDA tensors launch B3."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    bh, t, hd = q.shape
    bkv, s_len = k.shape[:2]
    dev = q.device
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS or bh % bkv:
        raise ValueError(f"kernel B3 takes f32/bf16, HD in {_HEAD_DIMS} and BH a "
                         f"multiple of BKV; got {q.dtype}, HD={hd}, BH={bh}, BKV={bkv}")
    common.require(q, "q", q.dtype, (bh, t, hd), dev)
    common.require(k, "k", q.dtype, (bkv, s_len, hd), dev)
    common.require(v, "v", q.dtype, (bkv, s_len, hd), dev)
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("kernel B3 (bf16) copies q, k and v in 16-byte units: they "
                         "must start 16-byte aligned")
    out = torch.empty_like(q)
    fn = common.load("flash_prefill", "flash_prefill",
                     [common.P] * 4 + [common.I] * 9 + [common.F, common.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], bh, t, s_len, hd, bh // bkv, int(causal), window,
             q_offset, 1.0 / math.sqrt(hd), common.stream_ptr(out))
    common.check(err, "flash_prefill")
    common.LAUNCHES["flash_prefill"] += 1
    return out
