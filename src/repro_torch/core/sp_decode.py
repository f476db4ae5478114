"""Sequence-sharded Salca decode (the JAX package's `core/sp_decode.py`):
the flat tick over a contiguous cache split by rows, and the tick over a
block-sharded paged pool.

**Flat (sequence-sharded contiguous cache).** Every rank of a `DecodeCtx`
holds rows ``[r·n_local, (r+1)·n_local)`` of every slot's cache (a ring of
W rows: ``W / world`` of them); heavy sets, activations and the query are
replicated. The paper's O(n) selection distributes without a sort:

  B7   local relevance scores;
  all-reduce  MIN/MAX of the (slot, kv head) score bounds → one global
              INT8 affine, so every rank bins as the unsharded tick would;
  exchange    the ``window // 2`` edge bins of both sequence neighbours
              (the reference's ``ppermute`` halo; zeros at the global ends);
  B10  max-pool over the halo-padded bins;
  B11  the local 256-bin histogram; all-reduce SUM → one global threshold
       (`locate_threshold`), then the local compaction into ``shard_cap``;
  B8   exact attention over the gathered local selection, unnormalised
       (its partials branch); all-reduce MAX of m, SUM of the rescaled l
       and acc (online-softmax merge).

`sp_dense_decode` is the dense (no selection) tick of the sliding-window
layers, with the same merge. Every payload is O(256 + HD) per (slot, kv
head), independent of the context length.

**Block-sharded paged pool.** The physical block dim of every layer's pool
is split across the ranks of a `DecodeCtx` (rank i holds global ids
``[i·P/n, (i+1)·P/n)``); page table,
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

With ``PERF.sharded_fused_decode`` off the tick is the reference's
logical-gather island (its PR 5 baseline), with the same eight collectives
a layer and the same selection, bit for bit: each rank gathers its own
feature blocks into logical order and scores them flat (B7); the binning,
blocked max-pool and histogram run in torch ops over that stream; the
selected rows are gathered one by one (`cache.gather_selected_paged`) and
attended by B8's partials branch in an int8 pool (torch ops in fp16 and
int4), then merged.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import histogram_topk as ht
from repro_torch.core import quantization as qz
from repro_torch.core.cache import (
    PagedSalcaCache, SalcaCache, _resolve_pages, append_token, gather_selected_paged,
    paged_logical_features)
from repro_torch.core.maxpool import maxpool1d_blocked_halo
from repro_torch.core.selection import (
    SalcaParams, estimate_relevance, estimate_relevance_paged_bounds, query_heavy_features)
from repro_torch.distributed.sharding import (
    DecodeCtx, local_block_range, neighbour_edges, pmax, pmin, psum)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# flat: a contiguous cache split by rows
# ---------------------------------------------------------------------------

def _halo_exchange(x: torch.Tensor, halo: int, ctx: DecodeCtx) -> torch.Tensor:
    """x (..., n_local) → (..., n_local + 2·halo): the ``halo`` columns of
    both sequence neighbours around this rank's, zero (the minimum bin) at
    the global ends; a ring's halo does not wrap, as in the reference."""
    from_left, from_right = neighbour_edges(x[..., -halo:], x[..., :halo], ctx)
    if ctx.rank == 0:
        from_left = torch.zeros_like(from_left)
    if ctx.rank == ctx.world_size - 1:
        from_right = torch.zeros_like(from_right)
    return torch.cat([from_left, x, from_right], dim=-1)


def local_lengths(global_len: torch.Tensor, n_local: int, ctx: DecodeCtx) -> torch.Tensor:
    """This rank's valid lengths (B,) of a cache split by rows, from the
    global cursor (B,): rank r holds ``[r·n_local, (r+1)·n_local)``."""
    return torch.clamp(global_len - ctx.rank * n_local, 0, n_local).to(torch.int32)


def sp_append_token(cache: SalcaCache, k: torch.Tensor, v: torch.Tensor,
                    global_len: torch.Tensor, ctx: DecodeCtx) -> SalcaCache:
    """Append one token's K/V (B, KV, HD) at the global cursor (B,): the
    row lands on the one rank that holds it, the others drop the write (so
    does every rank for a cursor of -1, an inactive slot). ``length`` ends
    at this rank's valid length after the append. In place."""
    n_local = cache.max_seq
    off = ctx.rank * n_local
    torch.sub(global_len, off, out=cache.length)        # out of [0, n_local): dropped
    append_token(cache, k, v)
    cache.length.copy_(torch.clamp(global_len + 1 - off, 0, n_local))
    return cache


def _merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
           ctx: DecodeCtx) -> torch.Tensor:
    """The online-softmax merge of every rank's (acc (..., HD), m, l):
    MAX of m, SUM of the rescaled l and acc; → acc / max(l, 1e-20)."""
    corr = torch.exp(m - pmax(m.clone(), ctx))
    l = psum(l * corr, ctx)
    acc = psum(acc * corr[..., None], ctx)
    return acc / torch.clamp_min(l, 1e-20)[..., None]


def sp_dense_decode(q: torch.Tensor, cache: SalcaCache, ctx: DecodeCtx, window: int = 0,
                    global_len: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (no selection) decode of q (B, H, HD) over this rank's rows of
    a sequence-sharded cache, merged across the ranks. ``window`` > 0 keeps
    the global positions p > ``global_len`` - window (the reference's mask
    with the valid length its island passes: the last window - 1 tokens)."""
    b, h, hd = q.shape
    kv = cache.num_kv_heads
    n_local = cache.max_seq
    valid = cache.valid_mask()                                          # (B, n_local)
    if window > 0:
        pos = ctx.rank * n_local + torch.arange(n_local, dtype=torch.int32, device=q.device)
        valid = valid & (pos[None, :] > (global_len[:, None] - window))
    k = cache.k_codes.float() * cache.k_scale[..., None]
    v = cache.v_codes.float() * cache.v_scale[..., None]
    qg = q.reshape(b, kv, h // kv, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.transpose(1, 2)) / math.sqrt(hd)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = pmax(s.amax(-1), ctx)
    p = torch.where(vmask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = psum(p.sum(-1), ctx)
    acc = psum(torch.einsum("bkgs,bksd->bkgd", p, v.transpose(1, 2)), ctx)
    return (acc / torch.clamp_min(l, 1e-20)[..., None]).reshape(b, h, hd)


def sp_salca_decode(q: torch.Tensor, cache: SalcaCache, params: SalcaParams, ctx: DecodeCtx,
                    shard_cap: int | None = None, return_selection: bool = False):
    """Salca decode attention of q (B, H, HD), replicated, over this rank's
    rows of a sequence-sharded cache whose ``length`` holds this rank's
    valid lengths (the module docstring's flat tick). ``shard_cap`` is the
    rank's index capacity: by default 4·k_cap / world, at least 128, at
    most n_local. Returns (B, H, HD) f32, identical on every rank (and this
    rank's Selection, indices local, when asked). Sink and recent forcing
    are not applied here, as in the reference."""
    from repro_torch.core.attention import gather_selected
    from repro_torch.kernels.flash_decode.ops import sparse_flash_decode_partials
    from repro_torch.kernels.hist_topk.ops import hist_threshold
    from repro_torch.kernels.maxpool.ops import maxpool_int8
    b, h, hd = q.shape
    kv = cache.num_kv_heads
    groups = h // kv
    n_local = cache.max_seq
    if shard_cap is None:
        shard_cap = min(n_local, max(128, (4 * params.k_cap) // ctx.world_size))

    # --- B7: local relevance scores ----------------------------------------
    q_feat = query_heavy_features(q, cache.heavy_idx, groups)
    scores = estimate_relevance(q_feat, cache.feat_words, cache.feat_scale,
                                cache.feat_zero, groups)                 # (B, KV, n_local)
    valid = cache.valid_mask()[:, None, :]                               # (B, 1, n_local)

    # --- binning with the global affine --------------------------------------
    lo = pmin(torch.where(valid, scores, torch.full_like(scores, float("inf"))).amin(-1), ctx)
    hi = pmax(torch.where(valid, scores, torch.full_like(scores, NEG_INF)).amax(-1), ctx)
    bins = qz.bins_from_bounds(scores, lo, hi, valid)

    # --- B10 over the halo-padded bins ----------------------------------------
    if params.use_pool and params.pool_window > 1:
        halo = params.pool_window // 2
        padded = _halo_exchange(bins, halo, ctx).reshape(b * kv, n_local + 2 * halo)
        pooled = maxpool_int8(padded, params.pool_window)[:, halo:-halo]
        pooled = torch.where(valid, pooled.reshape(b, kv, n_local), torch.zeros_like(bins))
    else:
        pooled = bins

    # --- B11: local histogram; global threshold; local compaction -------------
    hist, _ = hist_threshold(pooled.reshape(b * kv, n_local).contiguous(), params.k)
    hist = psum(hist.reshape(b, kv, ht.NUM_BINS), ctx)
    t = ht.locate_threshold(hist, params.k)                              # (B, KV)
    keep = pooled >= t[..., None].to(pooled.dtype)
    indices, mask, count = ht.compact_indices(keep, shard_cap)
    sel = ht.Selection(indices, mask, count, t)

    # --- B8 partials + the online-softmax merge --------------------------------
    kc, ks, vc, vs = gather_selected(cache, sel)                         # (B, KV, C, ·)
    c = kc.shape[2]
    acc, m, l = sparse_flash_decode_partials(
        q.reshape(b * kv, groups, hd).float().contiguous(), kc.reshape(b * kv, c, hd),
        ks.reshape(b * kv, c), vc.reshape(b * kv, c, hd), vs.reshape(b * kv, c),
        mask.reshape(b * kv, c))
    out = _merge(acc, m, l, ctx).reshape(b, h, hd)
    return (out, sel) if return_selection else out


# ---------------------------------------------------------------------------
# block-sharded paged pool
# ---------------------------------------------------------------------------


def _shard_pool_view(pool: PagedSalcaCache, ctx: DecodeCtx):
    """This rank's view of a block-sharded pool: (block_range, owned_blk
    (S, MB) bool — page-table entries in locally held blocks, local_pt
    (S, MB) int32 — the table in local ids, unowned/unmapped clamped to 0)."""
    lo, hi = local_block_range(pool.num_blocks, ctx)
    pt = pool.page_table
    owned_blk = (pt >= lo) & (pt < hi)
    return (lo, hi), owned_blk, torch.where(owned_blk, pt - lo, 0)


def sp_salca_decode_paged(q: torch.Tensor, pool: PagedSalcaCache, params: SalcaParams,
                          ctx: DecodeCtx, return_selection: bool = False,
                          fused: bool | None = None):
    """Salca decode attention of q (S, H, HD), replicated, over this rank's
    share of a block-sharded pool, at the reference's default per-rank
    capacity (k_cap). ``fused`` (default ``PERF.sharded_fused_decode``):
    the fused island (`_sp_salca_decode_paged_fused`), or the
    logical-gather island (`_sp_salca_decode_paged_gather`); both select
    the same tokens. Returns (S, H, HD) f32, identical on every rank (and
    this rank's Selection when asked)."""
    from repro_torch.flags import PERF
    if fused is None:
        fused = PERF.sharded_fused_decode
    island = _sp_salca_decode_paged_fused if fused else _sp_salca_decode_paged_gather
    return island(q, pool, params, ctx, return_selection)


def _sp_salca_decode_paged_fused(q: torch.Tensor, pool: PagedSalcaCache,
                                 params: SalcaParams, ctx: DecodeCtx,
                                 return_selection: bool = False):
    """The fused island: B4, B5 and B6 over the rank's own blocks (the
    module docstring)."""
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
    out = _merge(acc, m, l, ctx).reshape(s_, h, hd)
    return (out, sel) if return_selection else out


def _sp_salca_decode_paged_gather(q: torch.Tensor, pool: PagedSalcaCache,
                                  params: SalcaParams, ctx: DecodeCtx,
                                  return_selection: bool = False):
    """The reference's logical-gather island (`_sp_salca_decode_paged_gather`):
    O(local pool) logical copies of the features and a row gather of the
    selection each tick, the fused island's selection bit for bit."""
    from repro_torch.kernels.flash_decode.ops import sparse_flash_decode_partials
    s_, h, hd = q.shape
    kv = pool.num_kv_heads
    groups = h // kv
    bs, mb, n = pool.block_size, pool.max_blocks, pool.max_seq
    block_range, owned_blk, local_pt = _shard_pool_view(pool, ctx)
    own = torch.repeat_interleave(owned_blk, bs, dim=-1)                 # (S, L)
    mask3 = (pool.valid_mask() & own)[:, None, :]                        # (S, 1, L)

    # --- phase 1: B7 over the owned feature blocks in logical order --------
    q_feat = query_heavy_features(q, pool.heavy_idx, groups)
    scores = estimate_relevance(q_feat, *paged_logical_features(pool, local_pt),
                                groups)                                  # (S, KV, L)

    # --- phase 2: one global INT8 affine (min and max are exact) -----------
    sm = qz.masked_scores(scores, mask3)
    lo, hi = qz.score_bounds(sm)
    lo, hi = pmin(lo, ctx), pmax(hi, ctx)
    bins = qz.bins_from_bounds(sm, lo, hi, mask3)

    # --- phase 2b: blocked max-pool, halos summed across the ranks ---------
    if params.use_pool and params.pool_window > 1:
        w = params.pool_window
        halo = w // 2
        blocked = bins.reshape(s_, kv, mb, bs)
        # a block's edge columns are nonzero only on its owner
        edges = psum(torch.stack([blocked[..., -halo:], blocked[..., :halo]]).to(torch.int32),
                     ctx)
        left, right = edges[0].to(bins.dtype), edges[1].to(bins.dtype)
        zero = torch.zeros(blocked.shape[:-2] + (1, halo), dtype=bins.dtype, device=q.device)
        from_left = torch.cat([zero, left[..., :-1, :]], dim=-2)
        from_right = torch.cat([right[..., 1:, :], zero], dim=-2)
        pooled = maxpool1d_blocked_halo(blocked, w, from_left, from_right).reshape(s_, kv, n)
        pooled = pooled.masked_fill(~mask3, 0)
    else:
        pooled = bins
    if params.sink_tokens or params.recent_tokens:
        pos = torch.arange(n, device=q.device)
        forced = torch.zeros((1, 1, n), dtype=torch.bool, device=q.device)
        if params.sink_tokens:
            forced = forced | (pos < params.sink_tokens)
        if params.recent_tokens:
            length = pool.valid_mask().to(torch.int32).sum(-1)[:, None, None]
            forced = forced | (pos >= (length - params.recent_tokens))
        pooled = pooled.masked_fill(forced & mask3, 255)

    # --- phase 3: summed histograms → threshold; the global rank -----------
    t = ht.locate_threshold(psum(ht.histogram256(pooled), ctx), params.k)   # (S, KV)
    keep = pooled >= t[..., None].to(pooled.dtype)
    kb = keep.reshape(s_, kv, mb, bs).to(torch.int32)
    blk_counts = psum(kb.sum(-1, dtype=torch.int32), ctx)                # (S, KV, MB)
    base = torch.cumsum(blk_counts, dim=-1) - blk_counts                 # exclusive
    within = torch.cumsum(kb, dim=-1) - 1
    keep = keep & ((base[..., None] + within).reshape(s_, kv, n) < params.k_cap)
    indices, mask, count = ht.compact_indices(keep, params.k_cap)
    sel = ht.Selection(indices, mask, count, t)

    # --- phase 4: the rank's gathered rows, merged across the ranks --------
    kc, ks, vc, vs = gather_selected_paged(pool, sel, block_range)       # (S, KV, C, ·)
    c = kc.shape[2]
    if kc.dtype == torch.int8:
        acc, m, l = sparse_flash_decode_partials(
            q.reshape(s_ * kv, groups, hd).float().contiguous(), kc.reshape(s_ * kv, c, hd),
            ks.reshape(s_ * kv, c), vc.reshape(s_ * kv, c, hd), vs.reshape(s_ * kv, c),
            mask.reshape(s_ * kv, c))
        out = _merge(acc.reshape(s_, kv, groups, hd), m.reshape(s_, kv, groups),
                     l.reshape(s_, kv, groups), ctx)
    else:       # the reference's phase 4 in torch ops: the global max first
        qg = q.reshape(s_, kv, groups, hd).float()
        sc = torch.einsum("bkgd,bkcd->bkgc", qg, kc.float()) * ks[:, :, None, :] / math.sqrt(hd)
        m3 = mask[:, :, None, :]
        sc = torch.where(m3, sc, torch.full_like(sc, NEG_INF))
        m_g = pmax(sc.amax(-1), ctx)
        p = torch.where(m3, torch.exp(sc - m_g[..., None]), torch.zeros_like(sc))
        l_g = psum(p.sum(-1), ctx)
        acc = psum(torch.einsum("bkgc,bkcd->bkgd", p, vc.float() * vs[..., None]), ctx)
        out = acc / torch.clamp_min(l_g, 1e-20)[..., None]
    out = out.reshape(s_, h, hd)
    return (out, sel) if return_selection else out


def sp_dense_decode_paged(q: torch.Tensor, pool: PagedSalcaCache, ctx: DecodeCtx,
                          window: int = 0,
                          global_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (no selection) decode of q (S, H, HD) over a block-sharded
    pool, in every storage mode: each rank dequantizes only the K/V it holds
    (unowned positions masked) and the partials merge with the same
    online-softmax reduce. ``window`` > 0 keeps the positions p >
    ``global_pos`` - window (a sliding-window layer's full-context pool)."""
    s_, h, hd = q.shape
    kv = pool.num_kv_heads
    n = pool.max_seq
    block_range = local_block_range(pool.num_blocks, ctx)
    idx = torch.arange(n, dtype=torch.int32, device=q.device).expand(s_, n)
    pg, off, owned = _resolve_pages(pool, idx, block_range)             # (S, L)
    valid = pool.valid_mask() & owned
    if window > 0:
        pos = torch.arange(n, dtype=torch.int32, device=q.device)
        valid = valid & (pos[None, :] > (global_pos[:, None] - window))
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
