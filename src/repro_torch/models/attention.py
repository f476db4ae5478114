"""GQA attention layer: QKV projection and prefill attention through kernel B3.

Port of the reference `models/attention.py` for the serving path. Weight
layouts are the reference's: wq (D, H, HD), wk/wv (D, KV, HD), wo (H·HD, D).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.models.common import rmsnorm, rope


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ w (D, N, HD) → (..., N, HD)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).reshape(x.shape[:-1] + (n, hd))


def qkv_project(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x (..., T, D) → q (..., T, H, HD), k/v (..., T, KV, HD), after the
    q/k norms and RoPE. For one decode token per slot pass x (S, 1, D)."""
    q, k, v = _proj(x, params["wq"]), _proj(x, params["wk"]), _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0) -> torch.Tensor:
    """Causal attention of q (B, T, H, HD) over k/v (B, T, KV, HD) through
    kernel B3 in its (B·H, T, HD) layout. Returns (B, T, H, HD), q dtype."""
    b, t, h, hd = q.shape
    kv = k.shape[2]

    def fold(x, n):
        return x.transpose(1, 2).reshape(b * n, t, hd).contiguous()

    o = flash_attention(fold(q, h), fold(k, kv), fold(v, kv), causal=True, window=window)
    return o.reshape(b, h, t, hd).transpose(1, 2)
