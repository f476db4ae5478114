"""GQA attention layer: QKV projection and prefill attention through kernel B3,
causal (whole or by chunks) or bidirectional (the enc-dec family's encoder
and cross-attention), and the training forward (`attention_train`), which
B3-bwd differentiates (`FlashAttentionFn`).

Port of the reference `models/attention.py`. Weight
layouts are the reference's: wq (D, H, HD), wk/wv (D, KV, HD), wo (H·HD, D).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
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
                    window: int = 0) -> torch.Tensor:
    """Differentiable attention of q (B, Tq, H, HD) over k/v (B, S, KV, HD)
    (the reference's ``flash_attention_xla`` at q_offset 0): causal,
    windowed or unmasked, through `FlashAttentionFn` (B3, then B3-bwd).
    Returns (B, Tq, H, HD), q dtype."""
    b, t, h, hd = q.shape
    o = FlashAttentionFn.apply(fold_heads(q), fold_heads(k), fold_heads(v), causal, window)
    return o.reshape(b, h, t, hd).transpose(1, 2)


def attention_train(params: dict, x: torch.Tensor, cfg: ModelConfig, *, window: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention over a full training sequence (the reference's
    `attention_train`): x (B, T, D) → (B, T, D). ``window`` > 0 masks to
    the sliding window; ``causal=False`` is the enc-dec encoder's form."""
    b, t, _ = x.shape
    q, k, v = qkv_project(params, x, cfg, torch.arange(t, device=x.device))
    return train_attention(q, k, v, causal=causal, window=window).reshape(b, t, -1) @ params["wo"]
