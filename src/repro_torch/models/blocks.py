"""Global-attention ("A") block of the dense LM: prefill and decode.

Port of the reference `models/blocks.py` for the dense LM: the
`salca_params_for` rule, the A-block prefill (dense causal attention
through kernel B3, then `prefill_cache`) and three branches of
`_attn_decode` (append, Salca selection, sparse attention): over the
contiguous slot pool, over a paged pool on one device, or — given a
`DecodeCtx` — over a block-sharded paged pool.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (
    dense_decode_attention, dense_decode_from_paged, salca_decode_attention,
    salca_decode_attention_paged)
from repro_torch.core.cache import (
    PagedSalcaCache, SalcaCache, append_token, append_token_paged, prefill_cache,
    record_selection)
from repro_torch.core.selection import SalcaParams
from repro_torch.core.sp_decode import sp_dense_decode_paged, sp_salca_decode_paged
from repro_torch.distributed.sharding import DecodeCtx, local_block_range
from repro_torch.models.attention import prefill_attention, qkv_project
from repro_torch.models.common import glu_apply, rmsnorm


def salca_params_for(cfg: ModelConfig, seq_len: int) -> SalcaParams:
    k = max(128, min(int(seq_len * cfg.salca_retention), cfg.salca_max_k, seq_len))
    k_cap = min(((int(k * 1.25) + 127) // 128) * 128, seq_len)
    return SalcaParams(feature_sparsity=cfg.salca_feature_sparsity, k=k, k_cap=k_cap,
                       pool_window=cfg.salca_pool_window, use_pool=cfg.salca_use_pool)


def block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, max_seq: int):
    """x (B, T, D) → (x_out, SalcaCache of the layer's K/V padded to max_seq)."""
    t = x.shape[1]
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    positions = torch.arange(t, device=x.device)
    q, k, v = qkv_project(params["attn"], xn, cfg, positions)
    o = prefill_attention(q, k, v)
    x = x + o.reshape(x.shape[0], t, -1) @ params["attn"]["wo"]
    f = glu_apply(params["ffn"]["glu"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg.act)
    cache = prefill_cache(k, v, max_seq=max_seq, params=salca_params_for(cfg, max_seq))
    return x + f, cache


def attn_decode_paged(params: dict, x: torch.Tensor, pool: PagedSalcaCache,
                      cfg: ModelConfig, pos: torch.Tensor, salca: SalcaParams,
                      active: torch.Tensor, ctx: DecodeCtx | None = None) -> torch.Tensor:
    """One token per slot: x (S, D) → attention output (S, D). Updates the
    layer's pool in place. Inactive slots write nothing (their write cursor
    is forced out of range) and read as holding 0 tokens.

    With ``ctx`` the pool is this rank's share of a block-sharded pool: q,
    k and v are replicated (every rank runs the whole dense model), the
    append lands only on the rank owning the cursor's block, and the
    attention is the two-collective sharded tick (`core.sp_decode`)."""
    s = x.shape[0]
    q, k, v = qkv_project(params, x[:, None], cfg, pos[:, None])
    q, k, v = q[:, 0].float(), k[:, 0], v[:, 0]
    inactive = ~active
    pool.length.copy_(pos).masked_fill_(inactive, -1)
    if ctx is not None:
        append_token_paged(pool, k, v, block_range=local_block_range(pool.num_blocks, ctx))
        torch.add(pos, 1, out=pool.length).masked_fill_(inactive, 0)
        o = (sp_salca_decode_paged(q, pool, salca, ctx) if cfg.salca
             else sp_dense_decode_paged(q, pool, ctx))
        return o.to(x.dtype).reshape(s, -1) @ params["wo"]
    append_token_paged(pool, k, v)
    torch.add(pos, 1, out=pool.length).masked_fill_(inactive, 0)
    if cfg.salca:
        o, sel = salca_decode_attention_paged(q, pool, salca, return_selection=True)
        record_selection(pool, sel.indices, sel.mask)
    else:
        o = dense_decode_from_paged(q, pool, pool.valid_mask())
    return o.to(x.dtype).reshape(s, -1) @ params["wo"]


def attn_decode_contiguous(params: dict, x: torch.Tensor, cache: SalcaCache,
                           cfg: ModelConfig, pos: torch.Tensor, salca: SalcaParams,
                           active: torch.Tensor) -> torch.Tensor:
    """One token per slot over the contiguous slot pool: x (S, D) →
    attention output (S, D). Updates the layer's cache in place. Inactive
    slots write nothing (their cursor is forced to ``max_seq``, where the
    append drops the write) and read as holding 0 tokens."""
    s = x.shape[0]
    q, k, v = qkv_project(params, x[:, None], cfg, pos[:, None])
    q, k, v = q[:, 0].float(), k[:, 0], v[:, 0]
    inactive = ~active
    cache.length.copy_(pos).masked_fill_(inactive, cache.max_seq)
    append_token(cache, k, v)
    torch.add(pos, 1, out=cache.length).masked_fill_(inactive, 0)
    if cfg.salca:
        o = salca_decode_attention(q, cache, salca)
    else:
        kd = cache.k_codes.float() * cache.k_scale[..., None]
        vd = cache.v_codes.float() * cache.v_scale[..., None]
        o = dense_decode_attention(q, kd, vd, cache.valid_mask())
    return o.to(x.dtype).reshape(s, -1) @ params["wo"]


def block_decode(params: dict, x: torch.Tensor, pool, cfg: ModelConfig, pos: torch.Tensor,
                 salca: SalcaParams, active: torch.Tensor,
                 ctx: DecodeCtx | None = None) -> torch.Tensor:
    """x (S, D) → (S, D) over the layer's cache: a `SalcaCache` slot pool
    (contiguous engine) or a `PagedSalcaCache` (``ctx``: block-sharded)."""
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if isinstance(pool, SalcaCache):
        if ctx is not None:
            raise NotImplementedError("the sequence-sharded contiguous tick (flat sp_* "
                                      "decode) is not ported yet; ROADMAP A.9")
        h = attn_decode_contiguous(params["attn"], xn, pool, cfg, pos, salca, active)
    else:
        h = attn_decode_paged(params["attn"], xn, pool, cfg, pos, salca, active, ctx)
    x = x + h
    return x + glu_apply(params["ffn"]["glu"], rmsnorm(params["ln2"], x, cfg.norm_eps),
                         cfg.act)
