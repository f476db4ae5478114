"""Decoder-only LM over a stack of "A" blocks: prefill, pooled decode
state (contiguous slot pool or paged) and the decode step.

Port of the reference `models/transformer.py` for the dense LM. Where the
reference scans stacked per-period states, the port keeps a Python list
with one entry per layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import (
    PagedSalcaCache, empty_cache, empty_paged_cache, free_pages, map_block, prefill_into_pages,
    read_block_rows, reset_slot, write_block_rows, write_prefill_into_slot)
from repro_torch.distributed.sharding import DecodeCtx, local_block_range
from repro_torch.models import blocks as B
from repro_torch.models.common import (
    cdtype, embed_tokens, lm_logits, rmsnorm, vocab_mask_logits)


@dataclass
class LMState:
    """Per-layer caches (prefill and the contiguous slot pool: `SalcaCache`;
    the paged engine: `PagedSalcaCache`) and the (B,) position cursor."""
    caches: list
    pos: torch.Tensor


def lm_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_seq: int):
    """tokens (B, T) → (last-position logits (B, V_pad), LMState of
    per-layer `SalcaCache`s)."""
    h = embed_tokens(params["embed"], tokens).to(cdtype(cfg))
    caches = []
    for layer in params["layers"]:
        h, cache = B.block_prefill(layer, h, cfg, max_seq)
        caches.append(cache)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = vocab_mask_logits(lm_logits(params["embed"], h[:, -1], cfg), cfg)
    pos = torch.full((h.shape[0],), tokens.shape[1], dtype=torch.int32, device=h.device)
    return logits, LMState(caches, pos)


def lm_init_state(cfg: ModelConfig, batch: int, max_seq: int, device) -> LMState:
    """Contiguous decode state: one empty ``(batch, max_seq, ·)`` cache per
    layer (the contiguous engine's slot pool), cursors at 0."""
    r = B.salca_params_for(cfg, max_seq).r(cfg.resolved_head_dim)
    caches = [empty_cache(batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim, r,
                          device=device)
              for _ in range(cfg.num_layers)]
    return LMState(caches, torch.zeros(batch, dtype=torch.int32, device=device))


def lm_init_paged_state(cfg: ModelConfig, slots: int, max_seq: int, block_size: int,
                        num_blocks: int, device, ctx: DecodeCtx | None = None) -> LMState:
    """Pooled decode state: one paged block pool per layer, storing K/V in
    ``cfg.kv_pool_dtype`` (the engine's knob). With ``ctx`` each pool holds
    only this rank's ``num_blocks / world_size`` blocks."""
    r = B.salca_params_for(cfg, max_seq).r(cfg.resolved_head_dim)
    max_blocks = -(-max_seq // block_size)
    local = None
    if ctx is not None:
        lo, hi = local_block_range(num_blocks, ctx)
        local = hi - lo
    caches = [empty_paged_cache(num_blocks, block_size, slots, max_blocks,
                                cfg.num_kv_heads, cfg.resolved_head_dim, r,
                                kv_pool_dtype=cfg.kv_pool_dtype, device=device,
                                local_blocks=local)
              for _ in range(cfg.num_layers)]
    return LMState(caches, torch.zeros(slots, dtype=torch.int32, device=device))


def lm_write_into_slot(pool: LMState, src: LMState, slot: int, pages=None,
                       ctx: DecodeCtx | None = None) -> LMState:
    """Install a batch=1 prefill state into row ``slot``. In place.

    Contiguous pools take ``pages=None`` (`write_prefill_into_slot`); paged
    pools take the same physical blocks ``pages`` (MB,) in every layer
    (`prefill_into_pages`) — with ``ctx`` the prefill is replicated and each
    rank writes only the blocks it owns."""
    for dst, s in zip(pool.caches, src.caches):
        if isinstance(dst, PagedSalcaCache):
            if pages is None:
                raise ValueError("paged cache substate requires a pages array "
                                 "(use write_into_pages)")
            block_range = None if ctx is None else local_block_range(dst.num_blocks, ctx)
            prefill_into_pages(dst, s, slot, pages, block_range)
        else:
            write_prefill_into_slot(dst, s, slot)
    pool.pos[slot] = src.pos[0]
    return pool


def lm_map_block(pool: LMState, slot: int, logical_block: int, page: int) -> LMState:
    for c in pool.caches:
        map_block(c, slot, logical_block, page)
    return pool


def lm_read_block(pool: LMState, page: int) -> tuple:
    """Host-spill transport, read side: the data rows of physical block
    ``page`` in every layer's pool, in storage format (views; the caller
    copies them out), one tuple of seven per layer."""
    return tuple(read_block_rows(c, page) for c in pool.caches)


def lm_write_block(pool: LMState, page: int, payload: tuple) -> LMState:
    """Host-spill transport, write side: install a payload captured by
    `lm_read_block` into block ``page`` of every layer. Data only; the page
    tables and refcounts are `lm_map_block`'s. In place."""
    for c, rows in zip(pool.caches, payload):
        write_block_rows(c, page, rows)
    return pool


def lm_selection_hist(pool: LMState) -> torch.Tensor:
    """Cumulative selected-token counts per (slot, logical block), summed
    over the layers — the signal of the host-spill demotion policy.
    Returns (slots, MB) int32."""
    return torch.stack([c.sel_hist for c in pool.caches]).sum(0, dtype=torch.int32)


def lm_reset_slot(pool: LMState, slot: int) -> LMState:
    """Free row ``slot``: caches marked empty (paged: page table unmapped and
    blocks decref'd), the position cursor zeroed. In place."""
    for c in pool.caches:
        if isinstance(c, PagedSalcaCache):
            free_pages(c, slot)
        else:
            reset_slot(c, slot)
    pool.pos[slot] = 0
    return pool


def lm_decode_step(params: dict, cfg: ModelConfig, state: LMState, token: torch.Tensor,
                   active: torch.Tensor, ctx: DecodeCtx | None = None):
    """One token for every active slot: token (S,) int → (logits (S, V_pad),
    state). Inactive slots write nothing and hold their cursor; their
    logits are garbage the caller ignores. The state's caches are the
    contiguous slot pool or paged pools; ``ctx``: the paged pools are
    block-sharded over its ranks (the logits are identical on every rank)."""
    h = embed_tokens(params["embed"], token).to(cdtype(cfg))
    pos = state.pos
    salca = B.salca_params_for(cfg, max(state.caches[0].max_seq, 128))
    for layer, pool in zip(params["layers"], state.caches):
        h = B.block_decode(layer, h, pool, cfg, pos, salca, active, ctx)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = vocab_mask_logits(lm_logits(params["embed"], h, cfg), cfg)
    state.pos = pos + active.to(torch.int32)
    return logits, state
