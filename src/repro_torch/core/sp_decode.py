"""Salca decode over a block-sharded paged pool (the JAX package's
`core/sp_decode.py`, block-sharded part).

The physical block dim of every layer's pool is split across the ranks of
a `DecodeCtx` (rank i holds global ids ``[i·P/n, (i+1)·P/n)``); page table,
lengths, heavy sets and refcount stay replicated, and every rank holds the
whole query. A tick runs three kernel sweeps over the rank's own blocks
around two small collective phases:

  B4   scores + raw (lo, hi) bounds over the owned blocks;
  all-reduce  MIN/MAX of the bounds; SUM of the pre-pool block-edge bins
              (the max-pool halo: each block's edges are nonzero only on
              its owner);
  B5   INT8 binning with the global affine, blocked max-pool with those
       halos, sink/recent forcing, raw 256-bin histogram;
  all-reduce  SUM of the histograms (→ one global threshold) and of the
              per-block kept counts (→ the global rank that reproduces the
              flat path's capacity truncation exactly);
  B6   exact attention over the rank's selected blocks, unnormalised;
  all-reduce  MAX of m, SUM of the rescaled l and acc (online-softmax merge).

Every payload is O(MB + 256 + HD) per (slot, kv head), independent of the
context length. The union of the ranks' selections and the threshold are
bit-identical to the unsharded tick (`attention.salca_decode_attention_paged`);
outputs differ only by the float order of the merge.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import histogram_topk as ht
from repro_torch.core import quantization as qz
from repro_torch.core.cache import PagedSalcaCache, _resolve_pages
from repro_torch.core.selection import (
    SalcaParams, estimate_relevance_paged_bounds, query_heavy_features)
from repro_torch.distributed.sharding import DecodeCtx, local_block_range, pmax, pmin, psum

NEG_INF = -1e30


def _shard_pool_view(pool: PagedSalcaCache, ctx: DecodeCtx):
    """This rank's view of a block-sharded pool: (block_range, owned_blk
    (S, MB) bool — page-table entries in locally held blocks, local_pt
    (S, MB) int32 — the table in local ids, unowned/unmapped clamped to 0)."""
    lo, hi = local_block_range(pool.num_blocks, ctx)
    pt = pool.page_table
    owned_blk = (pt >= lo) & (pt < hi)
    return (lo, hi), owned_blk, torch.where(owned_blk, pt - lo, 0)


def sp_salca_decode_paged(q: torch.Tensor, pool: PagedSalcaCache, params: SalcaParams,
                          ctx: DecodeCtx, return_selection: bool = False):
    """Salca decode attention of q (S, H, HD), replicated, over this rank's
    share of a block-sharded pool (the reference's fused island,
    `_sp_salca_decode_paged_fused`, at its default per-rank capacity).
    Returns (S, H, HD) f32, identical on every rank (and this rank's
    Selection when asked)."""
    from repro_torch.kernels.flash_decode.ops import sparse_flash_decode_paged_partials
    from repro_torch.kernels.selection_fused.ops import paged_fused_select
    s_, h, hd = q.shape
    kv = pool.num_kv_heads
    groups = h // kv
    bs, mb, n = pool.block_size, pool.max_blocks, pool.max_seq
    block_range, owned_blk, local_pt = _shard_pool_view(pool, ctx)
    pos_blk = torch.arange(n, dtype=torch.int32, device=q.device).reshape(mb, bs)
    stored = pos_blk[None] < pool.length[:, None, None]                  # (S, MB, BS)
    blk_valid = owned_blk[..., None] & stored

    # --- B4: scores + raw bounds over the owned blocks ---------------------
    q_feat = query_heavy_features(q, pool.heavy_idx, groups)
    sm, lo, hi = estimate_relevance_paged_bounds(q_feat, pool, groups, blk_valid,
                                                 pages=local_pt)         # (S, KV, L)

    # --- collective 1a: global bounds, pre-pool halo columns ---------------
    lo, hi = pmin(lo, ctx), pmax(hi, ctx)
    blocked = sm.reshape(s_, kv, mb, bs)
    w = params.pool_window if params.use_pool and params.pool_window > 1 else 1
    if w > 1:
        halo = w // 2
        # Bin only each block's edge columns (O(MB·halo)) with the global
        # affine; each is nonzero only on its owner, so one SUM gives every
        # block's true edges on every rank.
        edge_s = torch.cat([blocked[..., -halo:], blocked[..., :halo]], dim=-1)
        edge_v = torch.cat([blk_valid[..., -halo:], blk_valid[..., :halo]], dim=-1)[:, None]
        edge_bins = qz.bins_from_bounds(edge_s.reshape(s_, kv, mb * 2 * halo), lo, hi,
                                        edge_v.reshape(s_, 1, mb * 2 * halo))
        edges = psum(edge_bins.reshape(s_, kv, mb, 2 * halo).to(torch.int32), ctx)
        left, right = edges[..., :halo], edges[..., halo:]
        zero = torch.zeros(left.shape[:-2] + (1, halo), dtype=torch.int32, device=q.device)
        from_left = torch.cat([zero, left[..., :-1, :]], dim=-2).to(torch.uint8)
        from_right = torch.cat([right[..., 1:, :], zero], dim=-2).to(torch.uint8)
    else:
        from_left = from_right = torch.zeros((s_, kv, mb, 1), dtype=torch.uint8,
                                             device=q.device)
    if params.sink_tokens or params.recent_tokens:
        pos = torch.arange(n, device=q.device)
        forced = torch.zeros((1, n), dtype=torch.bool, device=q.device)
        if params.sink_tokens:
            forced = forced | (pos < params.sink_tokens)
        if params.recent_tokens:
            length = pool.valid_mask().to(torch.int32).sum(-1, keepdim=True)
            forced = forced | (pos[None, :] >= (length - params.recent_tokens))
        force = forced.expand(s_, n).reshape(s_, mb, bs)
    else:
        force = torch.zeros((s_, mb, bs), dtype=torch.bool, device=q.device)

    # --- B5: binning, blocked max-pool, forcing, histogram -----------------
    pooled4, hist = paged_fused_select(blocked, lo, hi, from_left, from_right, blk_valid,
                                       force, window=w)
    pooled = pooled4.reshape(s_, kv, n)

    # --- collective 1b: global threshold; global rank for the capacity cut -
    hist = psum(hist, ctx)
    t = ht.locate_threshold(hist, params.k)                              # (S, KV)
    keep = pooled >= t[..., None].to(pooled.dtype)
    kb = keep.reshape(s_, kv, mb, bs).to(torch.int32)
    blk_counts = psum(kb.sum(-1, dtype=torch.int32), ctx)                # (S, KV, MB)
    base = torch.cumsum(blk_counts, dim=-1) - blk_counts                 # exclusive
    within = torch.cumsum(kb, dim=-1) - 1
    grank = (base[..., None] + within).reshape(s_, kv, n)
    keep = keep & (grank < params.k_cap)
    # per-rank capacity k_cap: parity holds even when every selected block
    # sits on one rank
    indices, mask, count = ht.compact_indices(keep, params.k_cap)
    sel = ht.Selection(indices, mask, count, t)

    # --- B6 + collective 2: rank-local partials, online-softmax merge ------
    acc, m, l = sparse_flash_decode_paged_partials(q, pool, sel, block_range)
    corr = torch.exp(m - pmax(m.clone(), ctx))
    l = psum(l * corr, ctx)
    acc = psum(acc * corr[..., None], ctx)
    out = (acc / torch.clamp_min(l, 1e-20)[..., None]).reshape(s_, h, hd)
    return (out, sel) if return_selection else out


def sp_dense_decode_paged(q: torch.Tensor, pool: PagedSalcaCache,
                          ctx: DecodeCtx) -> torch.Tensor:
    """Dense (no selection) decode of q (S, H, HD) over a block-sharded
    pool (global attention), in every storage mode: each rank dequantizes
    only the K/V it holds (unowned positions masked) and the partials merge
    with the same online-softmax reduce."""
    s_, h, hd = q.shape
    kv = pool.num_kv_heads
    n = pool.max_seq
    block_range = local_block_range(pool.num_blocks, ctx)
    idx = torch.arange(n, dtype=torch.int32, device=q.device).expand(s_, n)
    pg, off, owned = _resolve_pages(pool, idx, block_range)             # (S, L)
    valid = pool.valid_mask() & owned
    pgk, offk = pg[:, None, :].long(), off[:, None, :].long()           # (S, 1, L)
    kvb = torch.arange(kv, device=q.device)[None, :, None]              # (1, KV, 1)
    kc, vc = pool.k_codes[pgk, offk, kvb], pool.v_codes[pgk, offk, kvb]
    mode = pool.kv_pool_dtype
    if mode == "int4":
        kc, vc = qz.unpack_int4(kc), qz.unpack_int4(vc)
    soff = offk if mode == "int8" else torch.zeros_like(offk)           # per-block scales
    kk = kc.float() * pool.k_scale[pgk, soff, kvb][..., None]
    vv = vc.float() * pool.v_scale[pgk, soff, kvb][..., None]
    qg = q.reshape(s_, kv, h // kv, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, kk) / math.sqrt(hd)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = pmax(s.amax(-1), ctx)
    p = torch.where(vmask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = psum(p.sum(-1), ctx)
    acc = psum(torch.einsum("bkgs,bksd->bkgd", p, vv), ctx)
    return (acc / torch.clamp_min(l, 1e-20)[..., None]).reshape(s_, h, hd)
