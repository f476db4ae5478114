"""Decoder-only LM over a stack of "A" blocks: prefill, paged decode
state and the decode step.

Port of the reference `models/transformer.py` for the dense LM of the
first slice. Where the reference scans stacked per-period states, the port
keeps a Python list with one entry per layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import empty_paged_cache, free_pages, map_block, prefill_into_pages
from repro_torch.distributed.sharding import DecodeCtx, local_block_range
from repro_torch.models import blocks as B
from repro_torch.models.common import (
    cdtype, embed_tokens, lm_logits, rmsnorm, vocab_mask_logits)


@dataclass
class LMState:
    """Per-layer caches (prefill: `SalcaCache`; serving: `PagedSalcaCache`)
    and the (B,) position cursor."""
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


def lm_init_paged_state(cfg: ModelConfig, slots: int, max_seq: int, block_size: int,
                        num_blocks: int, device, ctx: DecodeCtx | None = None) -> LMState:
    """Pooled decode state: one paged block pool per layer. With ``ctx``
    each pool holds only this rank's ``num_blocks / world_size`` blocks."""
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


def lm_write_into_slot(pool: LMState, src: LMState, slot: int, pages,
                       ctx: DecodeCtx | None = None) -> LMState:
    """Install a batch=1 prefill state into row ``slot``: the same physical
    blocks ``pages`` (MB,) in every layer's pool. In place. With ``ctx`` the
    prefill is replicated and each rank writes only the blocks it owns."""
    for dst, s in zip(pool.caches, src.caches):
        block_range = None if ctx is None else local_block_range(dst.num_blocks, ctx)
        prefill_into_pages(dst, s, slot, pages, block_range)
    pool.pos[slot] = src.pos[0]
    return pool


def lm_map_block(pool: LMState, slot: int, logical_block: int, page: int) -> LMState:
    for c in pool.caches:
        map_block(c, slot, logical_block, page)
    return pool


def lm_reset_slot(pool: LMState, slot: int) -> LMState:
    for c in pool.caches:
        free_pages(c, slot)
    pool.pos[slot] = 0
    return pool


def lm_decode_step(params: dict, cfg: ModelConfig, state: LMState, token: torch.Tensor,
                   active: torch.Tensor, ctx: DecodeCtx | None = None):
    """One token for every active slot: token (S,) int → (logits (S, V_pad),
    state). Inactive slots write nothing and hold their cursor; their
    logits are garbage the caller ignores. ``ctx``: the state's pools are
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
