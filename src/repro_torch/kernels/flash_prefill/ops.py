"""Kernel B3: dense causal flash attention for prefill, and its plain version.

Replaces `repro/kernels/flash_prefill/kernel.py::flash_attention_pallas`
(the JAX model runs its XLA twin `models/attention.py::flash_attention_xla`)
and, for chunked prefill, the reference's `flash_attention_chunked`
(`repro/kernels/flash_prefill/ops.py`). Query rows sit at absolute
positions [q_offset, q_offset+T) over keys [0, S); ``window`` > 0 keeps
only keys with ``kpos > qpos - window``. GQA is index arithmetic: query
row-group bh reads K/V row-group bh // G. CUDA source:
``repro_torch/csrc/flash_prefill.cu``.

Training differentiates B3 through `FlashAttentionFn`: its forward is B3
with the per-row log-sum-exp as a second output, its backward kernel B3-bwd
(``repro_torch/csrc/flash_prefill_bwd.cu``), both at any query offset (a
context-parallel rank's query rows [q_offset, q_offset+T) over the gathered
keys [0, S), S ≥ q_offset+T). B3-bwd replaces no TPU kernel —
the reference takes this gradient by XLA's autodiff of
`models/attention.py::flash_attention_xla`. Each has its plain version
beside it (`flash_attention_lse_plain`, `flash_attention_backward_plain`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import common

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_TENSOR_MAP_ERROR = 10000   # B3-bwd's return for a TMA map it could not make, + the CUresult


def _scores(q, k, causal: bool, window: int, q_offset: int):
    """Scaled scores (BKV, G, T, S) in f32 with masked entries at NEG_INF,
    and the mask (T, S)."""
    bh, t, hd = q.shape
    bkv, s_len = k.shape[:2]
    qf = q.float().reshape(bkv, bh // bkv, t, hd)
    s = torch.einsum("bgtd,bsd->bgts", qf, k.float()) / math.sqrt(hd)
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones((t, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def _attend(s, v, q) -> torch.Tensor:
    """softmax(s) V over the scores of `_scores` → (BH, T, HD), q dtype."""
    out = torch.einsum("bgts,bsd->bgtd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(q.shape).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain version (mirrors the reference `flash_attention_ref`), f32 math.
    q (BH, T, HD); k/v (BKV, S, HD) with BH a multiple of BKV → (BH, T, HD)."""
    return _attend(_scores(q, k, causal, window, q_offset)[0], v, q)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True, window: int = 0,
                              q_offset: int = 0):
    """`flash_attention_plain` and each row's log-sum-exp of its scaled,
    masked scores (BH, T) f32: the forward that training saves."""
    s, _ = _scores(q, k, causal, window, q_offset)
    return _attend(s, v, q), torch.logsumexp(s, dim=-1).reshape(q.shape[:2])


def flash_attention_backward_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                                   window: int = 0, q_offset: int = 0):
    """Plain version of B3-bwd: the explicit gradient of `flash_attention`
    (query rows at positions [q_offset, q_offset+T)), f32 math. P
    recomputed from the forward's ``lse``, D = rowsum(dO∘O), dV = Pᵀ dO,
    dS = P∘(dO Vᵀ − D), dQ = dS K / √HD, dK = dSᵀ Q / √HD, with dK and dV
    summed over the G query heads of a KV head. Returns (dq, dk, dv) in the
    inputs' dtypes."""
    bh, t, hd = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    s, mask = _scores(q, k, causal, window, q_offset)
    p = torch.where(mask, torch.exp(s - lse.reshape(bkv, g, t, 1)), torch.zeros_like(s))
    do = dout.float().reshape(bkv, g, t, hd)
    d = (do * out.float().reshape(bkv, g, t, hd)).sum(-1, keepdim=True)
    dv = torch.einsum("bgts,bgtd->bsd", p, do)
    ds = p * (torch.einsum("bgtd,bsd->bgts", do, v.float()) - d)
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bgts,bsd->bgtd", ds, k.float()) * scale
    dk = torch.einsum("bgts,bgtd->bsd", ds, q.float().reshape(bkv, g, t, hd)) * scale
    return dq.reshape(bh, t, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal / windowed attention in the (BH, T, HD) layout; output in q's
    dtype. CPU tensors take the plain version; CUDA tensors launch B3."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return _b3(q, k, v, causal, window, q_offset, None)


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """`flash_attention` and each row's log-sum-exp (BH, T) f32: B3 with its
    LSE output on CUDA tensors (one store per row; the output's bits are
    those of `flash_attention`), the plain version on CPU tensors."""
    _check_offset(q, k, q_offset)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return _b3(q, k, v, causal, window, q_offset, lse), lse


def _check_offset(q, k, q_offset: int) -> None:
    """Queries at an offset attend keys through their last position (at
    offset 0 any S: the enc-dec cross-attention's Tq ≠ S)."""
    if q_offset < 0 or (q_offset > 0 and k.shape[1] < q_offset + q.shape[1]):
        raise ValueError(f"queries at [{q_offset}, {q_offset + q.shape[1]}) need keys through "
                         f"their last position; k holds {k.shape[1]}")


def _check_operands(name: str, q, k, v) -> None:
    bh, t, hd = q.shape
    bkv, s_len = k.shape[:2]
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS or bh % bkv:
        raise ValueError(f"kernel {name} takes f32/bf16, HD in {_HEAD_DIMS} and BH a "
                         f"multiple of BKV; got {q.dtype}, HD={hd}, BH={bh}, BKV={bkv}")
    common.require(q, "q", q.dtype, (bh, t, hd), q.device)
    common.require(k, "k", q.dtype, (bkv, s_len, hd), q.device)
    common.require(v, "v", q.dtype, (bkv, s_len, hd), q.device)


def _b3(q, k, v, causal: bool, window: int, q_offset: int, lse) -> torch.Tensor:
    bh, t, hd = q.shape
    bkv, s_len = k.shape[:2]
    _check_operands("B3", q, k, v)
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("kernel B3 (bf16) copies q, k and v in 16-byte units: they "
                         "must start 16-byte aligned")
    out = torch.empty_like(q)
    fn = common.load("flash_prefill", "flash_prefill",
                     [common.P] * 4 + [common.I] * 9 + [common.F, common.P, common.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], bh, t, s_len, hd, bh // bkv, int(causal), window,
             q_offset, 1.0 / math.sqrt(hd), None if lse is None else lse.data_ptr(),
             common.stream_ptr(out))
    common.check(err, "flash_prefill")
    common.LAUNCHES["flash_prefill"] += 1
    return out


def flash_attention_backward(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0):
    """The gradient (dq, dk, dv) of `flash_attention` (query rows at
    positions [q_offset, q_offset+T) over keys [0, S)), from the forward's
    ``out`` and ``lse`` and the output's gradient ``dout``.
    CPU tensors take the plain version; CUDA tensors launch B3-bwd (three
    kernels: D, then dK/dV, then dQ, each counted). Its bf16 branch reads q,
    k, v and dout by TMA, which needs each to start 16-byte aligned: a
    misaligned one is refused, never copied."""
    _check_offset(q, k, q_offset)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, dout, lse, causal=causal,
                                              window=window, q_offset=q_offset)
    bh, t, hd = q.shape
    bkv, s_len = k.shape[:2]
    _check_operands("B3-bwd", q, k, v)
    common.require(out, "out", q.dtype, (bh, t, hd), q.device)
    common.require(dout, "dout", q.dtype, (bh, t, hd), q.device)
    common.require(lse, "lse", torch.float32, (bh, t), q.device)
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v, dout)):
        raise ValueError("kernel B3-bwd (bf16) reads q, k, v and dout by TMA: they must "
                         "start 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    fn = common.load("flash_prefill_bwd", "flash_prefill_bwd",
                     [common.P] * 10 + [common.I] * 9 + [common.F, common.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _DTYPES[q.dtype], bh, t, s_len, hd, bh // bkv, int(causal), window, q_offset,
             1.0 / math.sqrt(hd), common.stream_ptr(dq))
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash_prefill_bwd: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - _TENSOR_MAP_ERROR}")
    common.check(err, "flash_prefill_bwd")
    common.LAUNCHES["flash_prefill_bwd"] += 3
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable B3: ``FlashAttentionFn.apply(q, k, v, causal, window,
    q_offset)`` in B3's layout, query rows at positions [q_offset,
    q_offset+T) over keys [0, S) (q_offset 0 when omitted). The forward is
    `flash_attention_lse` and saves q, k, v, out and the LSE; the backward is
    `flash_attention_backward` at the same offset. Each takes its kernel on
    CUDA tensors and its plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout.contiguous(), lse,
                                              causal=ctx.causal, window=ctx.window,
                                              q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention_chunked(q, k, v, *, q_offset: int, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """Chunked-prefill attention: a chunk of queries q (BH, C, HD) at
    absolute positions [q_offset, q_offset+C) over the prompt's key buffers
    k/v (BKV, S, HD), filled through row q_offset+C (later rows are never
    weighed: B3 stops at the chunk's last query position, the plain version
    masks them). Each output row equals the row at the same position of
    `flash_attention` over the whole prompt: the row visits the same key
    tiles in the same order, and a masked key adds an exact zero."""
    if k.shape[1] < q_offset + q.shape[1]:
        raise ValueError(f"chunk at [{q_offset}, {q_offset + q.shape[1]}) needs keys through "
                         f"its last position; the buffer holds {k.shape[1]}")
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
