"""Attention blocks of the dense LM, global ("A") and sliding-window ("L"):
prefill and decode.

Port of the reference `models/blocks.py` for the dense LM: the
`salca_params_for` rule, the static heavy set of
``salca_static_channels``, `ring_size`, the block prefill (dense causal or
windowed attention through kernel B3, then `prefill_cache`), the A block's
chunked form, and three branches of `_attn_decode` (append, then Salca
selection and sparse attention for "A", dense attention for "L"): over the
contiguous slot pool, over a paged pool on one device, or — given a
`DecodeCtx` — over a block-sharded paged pool.

An "L" layer whose window is shorter than the context keeps a ring of
W = ``cfg.local_window`` slots per request slot (a contiguous `SalcaCache`,
on the paged engine too): token j lives at slot j % W, so the ring holds
exactly the last min(pos + 1, W) tokens and needs no window mask. Salca
accelerates the "A" layers only.
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
from repro_torch.core.heavy_channels import top_channels
from repro_torch.core.selection import SalcaParams
from repro_torch.core.sp_decode import sp_dense_decode_paged, sp_salca_decode_paged
from repro_torch.distributed.sharding import DecodeCtx, local_block_range
from repro_torch.models.attention import fold_heads, prefill_attention, qkv_project
from repro_torch.models.common import glu_apply, rmsnorm


def salca_params_for(cfg: ModelConfig, seq_len: int) -> SalcaParams:
    k = max(128, min(int(seq_len * cfg.salca_retention), cfg.salca_max_k, seq_len))
    k_cap = min(((int(k * 1.25) + 127) // 128) * 128, seq_len)
    return SalcaParams(feature_sparsity=cfg.salca_feature_sparsity, k=k, k_cap=k_cap,
                       pool_window=cfg.salca_pool_window, use_pool=cfg.salca_use_pool)


def ring_size(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    """Cache length of a layer: a sliding-window ("L") layer keeps a
    ``local_window``-slot ring instead of the full context when the window
    is the shorter (the reference's default, ``PERF.ring_local_cache``)."""
    if kind == "L" and 0 < cfg.local_window < max_seq:
        return cfg.local_window
    return max_seq


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.local_window if kind == "L" else 0


def static_heavy_idx(attn_params: dict, cfg: ModelConfig, sp: SalcaParams,
                     batch: int) -> torch.Tensor | None:
    """The request-independent heavy set of ``cfg.salca_static_channels``:
    per kv head the top-r channels by key-projection weight mass
    Σ_d |W_k[d, ·, j]|, or by the layer's ``calib_salience`` leaf when it
    carries one; ties go to the lower index, as in ``jax.lax.top_k``.
    Returns (B, KV, R) int32 broadcast over the batch, or None for the
    paper's per-input identification. A static set is what lets requests
    whose prompts diverge share the feature rows of a common prefix."""
    if not cfg.salca_static_channels:
        return None
    sal = attn_params.get("calib_salience")
    sal = attn_params["wk"].float().abs().sum(dim=0) if sal is None else sal.float()
    idx = top_channels(sal, sp.r(cfg.resolved_head_dim))                  # (KV, R)
    return idx[None].expand((batch,) + idx.shape)


def block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, max_seq: int,
                  kind: str = "A"):
    """x (B, T, D) → (x_out, SalcaCache of the layer's K/V): padded to
    ``max_seq``, or for an "L" layer with a ring (`ring_size`) to its W
    slots, holding the prompt's last W tokens at their ring slots."""
    t = x.shape[1]
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    positions = torch.arange(t, device=x.device)
    q, k, v = qkv_project(params["attn"], xn, cfg, positions)
    o = prefill_attention(q, fold_heads(k), fold_heads(v), window=_window(cfg, kind))
    x = x + o.reshape(x.shape[0], t, -1) @ params["attn"]["wo"]
    f = glu_apply(params["ffn"]["glu"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg.act)
    sp = salca_params_for(cfg, max_seq)
    w_ring = ring_size(cfg, kind, max_seq)
    if w_ring < max_seq and t >= w_ring:
        # token j at slot j % W, so decode's wrap stays aligned
        base = t - w_ring
        slot_tok = base + (torch.arange(w_ring, device=x.device) - base) % w_ring
        k, v = k[:, slot_tok], v[:, slot_tok]
    cache = prefill_cache(k, v, max_seq=w_ring, params=sp,
                          heavy_idx=static_heavy_idx(params["attn"], cfg, sp, x.shape[0]))
    return x + f, cache


def block_prefill_chunk(params: dict, x: torch.Tensor, kbuf: torch.Tensor,
                        vbuf: torch.Tensor, t0: int, cfg: ModelConfig):
    """One layer's chunked-prefill step (reference `block_prefill_chunk`).

    ``x`` (1, C, D): the chunk's activations at positions [t0, t0+C);
    ``kbuf``/``vbuf`` (KV, T, HD): the prompt's full-precision K/V in B3's
    operand layout (the reference carries (1, T, KV, HD)), rows [0, t0)
    filled by earlier chunks. The chunk's k/v land in rows [t0, t0+C) in
    place, and its queries attend over the whole buffers with the causal
    mask shifted by t0: each row equals `block_prefill`'s row at the same
    position (`flash_attention_chunked`). Returns (x_out, kbuf, vbuf, k, v)
    with the chunk's raw k/v (1, C, KV, HD) for the pool install
    (`cache.prefill_chunk_into_pages`)."""
    c = x.shape[1]
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    positions = t0 + torch.arange(c, device=x.device)
    q, k, v = qkv_project(params["attn"], xn, cfg, positions)
    kbuf[:, t0:t0 + c] = k[0].transpose(0, 1)
    vbuf[:, t0:t0 + c] = v[0].transpose(0, 1)
    o = prefill_attention(q, kbuf, vbuf, q_offset=t0)
    x = x + o.reshape(1, c, -1) @ params["attn"]["wo"]
    f = glu_apply(params["ffn"]["glu"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg.act)
    return x + f, kbuf, vbuf, k, v


def attn_decode_paged(params: dict, x: torch.Tensor, pool: PagedSalcaCache,
                      cfg: ModelConfig, pos: torch.Tensor, salca: SalcaParams,
                      active: torch.Tensor, ctx: DecodeCtx | None = None,
                      kind: str = "A") -> torch.Tensor:
    """One token per slot: x (S, D) → attention output (S, D). Updates the
    layer's pool in place. Inactive slots write nothing (their write cursor
    is forced out of range) and read as holding 0 tokens. An "A" layer runs
    Salca (with ``cfg.salca``); an "L" layer, paged only when its window
    spans the whole context (`ring_size`), attends densely over every valid
    key: the reference's window mask would keep them all.

    With ``ctx`` the pool is this rank's share of a block-sharded pool: q,
    k and v are replicated (every rank runs the whole dense model), the
    append lands only on the rank owning the cursor's block, and the
    attention is the two-collective sharded tick (`core.sp_decode`)."""
    s = x.shape[0]
    use_salca = cfg.salca and kind == "A"
    q, k, v = qkv_project(params, x[:, None], cfg, pos[:, None])
    q, k, v = q[:, 0].float(), k[:, 0], v[:, 0]
    inactive = ~active
    pool.length.copy_(pos).masked_fill_(inactive, -1)
    if ctx is not None:
        append_token_paged(pool, k, v, block_range=local_block_range(pool.num_blocks, ctx))
        torch.add(pos, 1, out=pool.length).masked_fill_(inactive, 0)
        o = (sp_salca_decode_paged(q, pool, salca, ctx) if use_salca
             else sp_dense_decode_paged(q, pool, ctx))
        return o.to(x.dtype).reshape(s, -1) @ params["wo"]
    append_token_paged(pool, k, v)
    torch.add(pos, 1, out=pool.length).masked_fill_(inactive, 0)
    if use_salca:
        o, sel = salca_decode_attention_paged(q, pool, salca, return_selection=True)
        record_selection(pool, sel.indices, sel.mask)
    else:
        o = dense_decode_from_paged(q, pool, pool.valid_mask())
    return o.to(x.dtype).reshape(s, -1) @ params["wo"]


def attn_decode_contiguous(params: dict, x: torch.Tensor, cache: SalcaCache,
                           cfg: ModelConfig, pos: torch.Tensor, salca: SalcaParams,
                           active: torch.Tensor, kind: str = "A") -> torch.Tensor:
    """One token per slot over the contiguous slot pool, or over an "L"
    layer's ring: x (S, D) → attention output (S, D). Updates the layer's
    cache in place. Inactive slots write nothing (their cursor is forced to
    ``max_seq``, where the append drops the write) and read as holding 0
    tokens. A ring (``cache.max_seq`` <= the window) writes at pos % W and
    holds min(pos + 1, W) valid tokens, attended with no window mask over
    its dequantized rows (plain torch ops, as the reference's XLA)."""
    s = x.shape[0]
    window = _window(cfg, kind)
    ring = window > 0 and cache.max_seq <= window
    q, k, v = qkv_project(params, x[:, None], cfg, pos[:, None])
    q, k, v = q[:, 0].float(), k[:, 0], v[:, 0]
    inactive = ~active
    if ring:
        torch.remainder(pos, cache.max_seq, out=cache.length)
    else:
        cache.length.copy_(pos)
    cache.length.masked_fill_(inactive, cache.max_seq)
    append_token(cache, k, v)
    torch.add(pos, 1, out=cache.length)
    if ring:
        cache.length.clamp_max_(cache.max_seq)
    cache.length.masked_fill_(inactive, 0)
    if cfg.salca and kind == "A":
        o = salca_decode_attention(q, cache, salca)
    else:
        kd = cache.k_codes.float() * cache.k_scale[..., None]
        vd = cache.v_codes.float() * cache.v_scale[..., None]
        o = dense_decode_attention(q, kd, vd, cache.valid_mask())
    return o.to(x.dtype).reshape(s, -1) @ params["wo"]


def block_decode(params: dict, x: torch.Tensor, pool, cfg: ModelConfig, pos: torch.Tensor,
                 salca: SalcaParams, active: torch.Tensor,
                 ctx: DecodeCtx | None = None, kind: str = "A") -> torch.Tensor:
    """x (S, D) → (S, D) over the layer's cache: a `SalcaCache` (the
    contiguous engine's slot pool, or an "L" layer's ring) or a
    `PagedSalcaCache` (``ctx``: block-sharded)."""
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if isinstance(pool, SalcaCache):
        if ctx is not None:
            raise NotImplementedError("the sequence-sharded contiguous tick (flat sp_* "
                                      "decode) is not ported yet; it comes with the port "
                                      "of the reference's sequence-sharded flat decode")
        h = attn_decode_contiguous(params["attn"], xn, pool, cfg, pos, salca, active, kind)
    else:
        h = attn_decode_paged(params["attn"], xn, pool, cfg, pos, salca, active, ctx, kind)
    x = x + h
    return x + glu_apply(params["ffn"]["glu"], rmsnorm(params["ln2"], x, cfg.norm_eps),
                         cfg.act)
