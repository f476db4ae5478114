"""GQA attention layer: QKV projection and prefill attention through kernel B3,
causal (whole or by chunks) or bidirectional (the enc-dec family's encoder
and cross-attention), and the training forward (`attention_train`), which
B3-bwd differentiates (`FlashAttentionFn`).

Port of the reference `models/attention.py`. Weight
layouts are the reference's: wq (D, H, HD), wk/wv (D, KV, HD), wo (H·HD, D).

Under a model axis above 1 (an ambient `distributed.sharding.ShardingCtx`
in training) `attention_train` takes the reference's two strategies, on x
in the residual's layout (its sequence split over "model" where
``split``):

* ``tp``: the sequence is gathered whole, then projected onto this rank's
  heads (wq/wk/wv column blocks over heads, wo a row block); each rank's
  part of the output projection is reduced back into the residual's layout.
  Where the spec replicates wk/wv (KV not divisible by M), a rank takes the
  KV heads that its query heads map to;
* ``cp``: each rank projects its own rows (RoPE at their absolute
  positions), gathers K and V along the sequence (their backward
  reduce-scatters dK and dV) and attends through `FlashAttentionFn` at
  ``q_offset`` = its first row's position over keys [0, q_offset + T/M);
  wo is replicated, so the output stays in the rank's rows. A sequence the
  axis does not split is attended whole on every rank.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    constrain_qkv, current_ctx, gather_from_sequence, model_group, model_part,
    reduce_scatter_to_sequence)
from repro_torch.kernels.flash_prefill.ops import (
    FlashAttentionFn, flash_attention, flash_attention_chunked)
from repro_torch.models.common import rmsnorm, rope


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ w (D, N, HD) → (..., N, HD)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).reshape(x.shape[:-1] + (n, hd))


def qkv_project(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x (..., T, D) → q (..., T, H, HD), k/v (..., T, KV, HD), after the
    q/k norms and RoPE. For one decode token per slot pass x (S, 1, D)."""
    q, k, v = proj(x, params["wq"]), proj(x, params["wk"]), proj(x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def fold_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, N, HD) → (B·N, T, HD), contiguous: kernel B3's operand layout."""
    b, t, n, hd = x.shape
    return x.transpose(1, 2).reshape(b * n, t, hd).contiguous()


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Causal attention of q (B, T, H, HD), at absolute positions
    [q_offset, q_offset+T), over keys k/v (B·KV, S, HD) in B3's layout
    (`fold_heads`), filled through row q_offset+T: the whole prompt
    (q_offset 0, S = T) or one chunk of it over the prompt's buffers
    (`flash_attention_chunked`). Returns (B, T, H, HD), q dtype."""
    b, t, h, hd = q.shape
    o = flash_attention_chunked(fold_heads(q), k, v, q_offset=q_offset, causal=True,
                                window=window)
    return o.reshape(b, h, t, hd).transpose(1, 2)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention with no mask (the reference's ``flash_attention_xla(causal=
    False)``) of q (B, Tq, H, HD) over k/v (B, S, KV, HD), any Tq and S:
    the enc-dec encoder over its frames (Tq = S; the reference's
    ``attention_train(causal=False)``), or the decoder's cross-attention
    prefill (Td queries over T_enc keys). Kernel B3 with ``causal=False``.
    Returns (B, Tq, H, HD), q dtype."""
    b, t, h, hd = q.shape
    o = flash_attention(fold_heads(q), fold_heads(k), fold_heads(v), causal=False)
    return o.reshape(b, h, t, hd).transpose(1, 2)


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Differentiable attention of q (B, Tq, H, HD), at positions
    [q_offset, q_offset + Tq), over k/v (B, S, KV, HD) (the reference's
    ``flash_attention_xla``): causal, windowed or unmasked, through
    `FlashAttentionFn` (B3, then B3-bwd). Returns (B, Tq, H, HD), q dtype."""
    b, t, h, hd = q.shape
    o = FlashAttentionFn.apply(fold_heads(q), fold_heads(k), fold_heads(v), causal, window,
                               q_offset)
    return o.reshape(b, h, t, hd).transpose(1, 2)


def attention_train(params: dict, x: torch.Tensor, cfg: ModelConfig, *, window: int = 0,
                    causal: bool = True, split: bool = False) -> torch.Tensor:
    """Self-attention over a full training sequence (the reference's
    `attention_train`): x (B, T, D) → (B, T, D). ``window`` > 0 masks to
    the sliding window; ``causal=False`` is the enc-dec encoder's form.
    Under a model axis above 1, x and the output are in the residual's
    layout (the module docstring: ``tp`` or ``cp``)."""
    if model_group() is not None:
        if current_ctx().strategy == "tp":
            return _attention_tp(params, x, cfg, window, causal, split)
        if split:
            return _attention_cp(params, x, cfg, window, causal)
    b, t, _ = x.shape
    q, k, v = qkv_project(params, x, cfg, torch.arange(t, device=x.device))
    return train_attention(q, k, v, causal=causal, window=window).reshape(b, t, -1) @ params["wo"]


def _local_kv(params: dict, cfg: ModelConfig) -> dict:
    """The attention weights of this rank's heads under ``tp``: wk/wv as
    the spec gives them where it splits KV over "model"; where it
    replicates them, the KV heads that this rank's query heads map to (a
    slice when they map onto whole groups, else one KV head per query
    head)."""
    h_index, h_parts = model_part(cfg.num_heads)
    if model_part(cfg.num_kv_heads)[1] > 1:
        return params
    h_local = cfg.num_heads // h_parts
    g = cfg.num_heads // cfg.num_kv_heads
    kv_of = (h_index * h_local + torch.arange(h_local)) // g
    lo, n = int(kv_of[0]), int(kv_of[-1]) - int(kv_of[0]) + 1
    if h_local % n == 0 and torch.equal(kv_of - lo, torch.arange(h_local) // (h_local // n)):
        pick = lambda w: w[:, lo:lo + n]          # noqa: E731
    else:
        pick = lambda w: w[:, kv_of]              # noqa: E731
    return {**params, "wk": pick(params["wk"]), "wv": pick(params["wv"])}


def _attention_tp(params, x, cfg, window: int, causal: bool, split: bool) -> torch.Tensor:
    xw = gather_from_sequence(x, split)
    b, t, _ = xw.shape
    q, k, v = qkv_project(_local_kv(params, cfg), xw, cfg, torch.arange(t, device=x.device))
    q, k, v = constrain_qkv(q, k, v, split)
    o = train_attention(q, k, v, causal=causal, window=window)
    return reduce_scatter_to_sequence(o.reshape(b, t, -1) @ params["wo"], split)


def _attention_cp(params, x, cfg, window: int, causal: bool) -> torch.Tensor:
    b, t, _ = x.shape
    q_offset = model_group().rank * t
    q, k, v = qkv_project(params, x, cfg, q_offset + torch.arange(t, device=x.device))
    q, k, v = constrain_qkv(q, k, v, split=True)
    if causal:
        k, v = k[:, :q_offset + t], v[:, :q_offset + t]
    o = train_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return o.reshape(b, t, -1) @ params["wo"]
