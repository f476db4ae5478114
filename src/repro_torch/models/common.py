"""Shared model primitives: RMSNorm, RoPE, GLU MLP, embedding and LM head.

Port of the reference `models/common.py`. Parameters are plain dicts of
tensors in the reference's layouts; compute dtypes follow the config (the
weights' dtype for matmuls, f32 for normalization and rotary math).

Under a model axis above 1 (training on a data × model mesh: an ambient
`distributed.sharding.ShardingCtx`) each rank holds its blocks of the
reference's specs and the functions here are Megatron's layers over them:
the vocab-parallel embedding (`embed_tokens_parallel`, a masked lookup of
this rank's rows of ``tok``), the vocab-parallel head (`lm_logits` on the
local block: this rank's columns), the padded-vocab mask by global column
(`vocab_mask_logits`), the vocab-parallel cross-entropy, and the GLU with
``w_gate``/``w_up`` column blocks and ``w_down`` a row block over d_ff
(`parallel_glu`), and the RMSNorm over a split last dim (`parallel_rmsnorm`,
the SSD's gated norm).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    gather_from_sequence, model_part, reduce_scatter_to_sequence, sum_over_model,
    vocab_parallel_cross_entropy)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
# -1e30 as each compute dtype holds it (float16: -inf), as a Python float
_VOCAB_FILL = {dt: float(torch.tensor(-1e30, dtype=dt)) for dt in _DTYPES.values()}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * params["scale"].float()).to(x.dtype)


def parallel_rmsnorm(params: dict, x: torch.Tensor, eps: float, width: int) -> torch.Tensor:
    """`rmsnorm` of x (..., width/M), this model rank's block of a last dim
    of ``width`` split over the model axis (``params["scale"]`` its block
    too): the mean of squares is the model group's sum of the blocks' sums
    over ``width`` (`sum_over_model`)."""
    x32 = x.float()
    var = sum_over_model(x32.square().sum(-1, keepdim=True)) / width
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


def parallel_glu(params: dict, x: torch.Tensor, cfg: ModelConfig, split: bool) -> torch.Tensor:
    """The training GLU on x in the residual's layout (its sequence split
    over the model axis where ``split``). Where the spec splits d_ff over
    "model", x is gathered whole, this rank's d_ff columns give its part of
    the row sum, and the parts are reduced back into the residual's layout;
    where d_ff is whole (or there is no model axis) the GLU acts on the
    rank's rows."""
    if model_part(cfg.d_ff)[1] == 1:
        return glu_apply(params, x, cfg.act)
    y = glu_apply(params, gather_from_sequence(x, split), cfg.act)
    return reduce_scatter_to_sequence(y, split)


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def embed_tokens_parallel(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """This model rank's part of the embedding: the rows of its ``tok``
    block [v0, v0 + V/M) for the tokens it holds, zero for the others (the
    sum over the model group is the embedding)."""
    tok = params["tok"]
    v0 = model_part(cfg.padded_vocab)[0] * tok.shape[0]
    local = tokens.long() - v0
    mine = (local >= 0) & (local < tok.shape[0])
    rows = tok[torch.where(mine, local, 0)]
    return torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype))


def lm_logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["tok"].T
    return h @ params["head"]


def vocab_mask_logits(logits: torch.Tensor, cfg: ModelConfig, v0: int = 0) -> torch.Tensor:
    """-1e30 on the padded vocab slots (a fill by a Python scalar: no host
    data becomes a tensor, so the tick stays capturable); ``logits`` hold
    the columns [v0, v0 + its width) of the padded vocab (a model rank's
    block), masked by their global index."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    v = torch.arange(v0, v0 + logits.shape[-1], device=logits.device)
    return logits.masked_fill(v >= cfg.vocab_size, _VOCAB_FILL[logits.dtype])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean cross-entropy over every position (the reference's
    `cross_entropy`): padded vocab slots masked, f32 log-sum-exp. Logits
    holding a model rank's vocab columns (the spec splits the vocab over a
    model axis above 1) take the vocab-parallel form, whose value is the
    same on every rank of the model group."""
    index, parts = model_part(cfg.padded_vocab)
    if parts > 1:
        v0 = index * logits.shape[-1]
        return vocab_parallel_cross_entropy(vocab_mask_logits(logits, cfg, v0), labels, v0)
    logits = vocab_mask_logits(logits, cfg).float()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()
