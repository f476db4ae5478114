"""Shared model primitives: RMSNorm, RoPE, GLU MLP, embedding and LM head.

Port of the reference `models/common.py`. Parameters are plain dicts of
tensors in the reference's layouts; compute dtypes follow the config (the
weights' dtype for matmuls, f32 for normalization and rotary math).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
# -1e30 as each compute dtype holds it (float16: -inf), as a Python float
_VOCAB_FILL = {dt: float(torch.tensor(-1e30, dtype=dt)) for dt in _DTYPES.values()}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * params["scale"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, H, HD); positions (..., T): rotate the two halves of HD."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def glu_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    fn = F.silu if act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))
    return (fn(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def lm_logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["tok"].T
    return h @ params["head"]


def vocab_mask_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 on the padded vocab slots (a fill by a Python scalar: no host
    data becomes a tensor, so the tick stays capturable)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    v = torch.arange(cfg.padded_vocab, device=logits.device)
    return logits.masked_fill(v >= cfg.vocab_size, _VOCAB_FILL[logits.dtype])
