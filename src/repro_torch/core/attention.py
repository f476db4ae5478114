"""Salca decode attention over the contiguous cache and the paged pool,
plus the dense oracles.

Port of the reference `core/attention.py`: the contiguous tick
(`salca_decode_attention`, kernels B7, B9 and B8), the fused paged tick
(`salca_decode_attention_paged`, kernels B1 and B2) and the oracles
`exact_sparse_attention`, `dense_decode_attention`,
`dense_decode_from_cache` and `dense_decode_from_paged`.

**How the contiguous tick routes.** The reference's tick calls
`salca_decode_attention(q, cache, salca)` with ``impl=None``: the XLA
chain for phases 2-3 and `exact_sparse_attention` for phase 4. Its own
contract makes the fused route give the same Selection bit for bit
(`fused_select_flat`), and `sparse_flash_decode` compute what
`exact_sparse_attention` computes. So the port takes the fused route
whenever the reference's condition allows it, ``not (sink_tokens or
recent_tokens)``: B7 → B9 → `compact_indices` → `gather_selected` → B8.
With sink/recent forcing, phases 2-3 run the chain
(`select_sparse_pattern` in torch ops), as in the reference; phase 1 is B7
and phase 4 is B8 on both routes. CUDA tensors launch the kernels (or
raise), CPU tensors run their plain versions; there is no other switch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.cache import PagedSalcaCache, SalcaCache, paged_logical_kv
from repro_torch.core.histogram_topk import Selection, compact_indices
from repro_torch.core.selection import (
    SalcaParams, estimate_relevance, estimate_relevance_paged, query_heavy_features,
    salca_select, select_sparse_pattern_blocked)

NEG_INF = -1e30


def gather_selected(cache: SalcaCache, sel: Selection):
    """The selected K/V rows per (batch, kv head): sel.indices (B, KV, C) →
    int8 codes (B, KV, C, HD) and scales (B, KV, C). One advanced-index
    gather per field, so O(C) rows move and no transposed copy of the
    (B, S, KV, ·) cache is made."""
    b, kv, _ = sel.indices.shape
    bi = torch.arange(b, device=sel.indices.device)[:, None, None]
    ki = torch.arange(kv, device=sel.indices.device)[None, :, None]
    idx = sel.indices.long()
    return (cache.k_codes[bi, idx, ki], cache.k_scale[bi, idx, ki],
            cache.v_codes[bi, idx, ki], cache.v_scale[bi, idx, ki])


def fused_select_flat(scores: torch.Tensor, length: torch.Tensor,
                      params: SalcaParams) -> Selection:
    """Phases 2-3 through kernel B9: scores (B, KV, N) f32, length (B,) →
    the Selection of `select_sparse_pattern` without sink/recent forcing,
    bit for bit. The bounds are cleaned by `binning_affine` before B9, whose
    affine uses its ``lo`` operand raw."""
    from repro_torch.kernels.selection_fused.ops import fused_bin_pool_threshold
    b, kv, n = scores.shape
    valid = torch.arange(n, device=scores.device)[None, :] < length[:, None]
    s = qz.masked_scores(scores, valid[:, None, :])
    lo, hi = qz.score_bounds(s)
    offset, _ = qz.binning_affine(lo, hi)
    w = params.pool_window if params.use_pool else 1
    pooled, _, thr = fused_bin_pool_threshold(
        s.reshape(b * kv, n), offset.reshape(-1).contiguous(), hi.reshape(-1).contiguous(),
        torch.full((b * kv,), params.k, dtype=torch.int32, device=scores.device),
        length.to(torch.int32)[:, None].expand(b, kv).reshape(-1), window=w)
    keep = pooled >= thr[:, None].to(pooled.dtype)
    indices, mask, count = compact_indices(keep.reshape(b, kv, n), params.k_cap)
    return Selection(indices, mask, count, thr.reshape(b, kv))


def salca_decode_attention(q: torch.Tensor, cache: SalcaCache, params: SalcaParams,
                           return_selection: bool = False):
    """Salca decode attention of q (B, H, HD) over a contiguous cache (the
    routing is in the module docstring). Returns (B, H, HD) f32 (and the
    Selection when asked)."""
    from repro_torch.kernels.flash_decode.ops import sparse_flash_decode
    b, h, hd = q.shape
    kv = cache.num_kv_heads
    groups = h // kv
    q_feat = query_heavy_features(q, cache.heavy_idx, groups)
    if not (params.sink_tokens or params.recent_tokens):
        scores = estimate_relevance(q_feat, cache.feat_words, cache.feat_scale,
                                    cache.feat_zero, groups)
        sel = fused_select_flat(scores, cache.length, params)
    else:
        sel = salca_select(q_feat, cache.feat_words, cache.feat_scale, cache.feat_zero,
                           groups, params, valid_mask=cache.valid_mask())
    kc, ks, vc, vs = gather_selected(cache, sel)
    c = kc.shape[2]
    out = sparse_flash_decode(q.reshape(b * kv, groups, hd).float().contiguous(),
                              kc.reshape(b * kv, c, hd), ks.reshape(b * kv, c),
                              vc.reshape(b * kv, c, hd), vs.reshape(b * kv, c),
                              sel.mask.reshape(b * kv, c)).reshape(b, h, hd)
    return (out, sel) if return_selection else out


def salca_decode_attention_paged(q: torch.Tensor, pool: PagedSalcaCache,
                                 params: SalcaParams, return_selection: bool = False):
    """Salca decode attention of q (S, H, HD) over a paged pool, page-table
    walk fused into the kernels: scoring streams physical feature blocks
    (B1), exact attention reads only the selected physical blocks (B2).
    Returns (S, H, HD) f32 (and the Selection when asked)."""
    from repro_torch.kernels.flash_decode.ops import sparse_flash_decode_paged
    h = q.shape[1]
    groups = h // pool.num_kv_heads
    q_feat = query_heavy_features(q, pool.heavy_idx, groups)
    scores = estimate_relevance_paged(q_feat, pool, groups)
    sel = select_sparse_pattern_blocked(scores, params, pool.mapped_valid_mask()[:, None, :],
                                        pool.block_size)
    out = sparse_flash_decode_paged(q, pool, sel)
    return (out, sel) if return_selection else out


def exact_sparse_attention(q, k_codes, k_scale, v_codes, v_scale, mask) -> torch.Tensor:
    """Attention of q (B, H, HD) over gathered int8 K/V (B, KV, C, HD) with
    scales (B, KV, C) and mask (B, KV, C). Returns (B, H, HD) f32."""
    b, h, hd = q.shape
    kv = k_codes.shape[1]
    qg = q.reshape(b, kv, h // kv, hd).float()
    s = torch.einsum("bkgd,bkcd->bkgc", qg, k_codes.float())
    s = s * k_scale[:, :, None, :] / math.sqrt(hd)
    m3 = mask[:, :, None, :]
    s = torch.where(m3, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.clamp_min(s.amax(-1, keepdim=True), NEG_INF))
    p = torch.where(m3, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    v = v_codes.float() * v_scale[..., None]
    return (torch.einsum("bkgc,bkcd->bkgd", p, v) / torch.clamp_min(l, 1e-20)).reshape(b, h, hd)


def dense_decode_attention(q, k, v, valid_mask=None) -> torch.Tensor:
    """Full-precision dense decode oracle: q (B, H, HD); k, v (B, S, KV, HD);
    valid_mask (B, S). An all-masked row returns zeros."""
    b, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.transpose(1, 2).float()) / math.sqrt(hd)
    if valid_mask is not None:
        s = torch.where(valid_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if valid_mask is not None:
        p = p * valid_mask[:, None, None, :]
    return torch.einsum("bkgs,bksd->bkgd", p, v.transpose(1, 2).float()).reshape(b, h, hd)


def dense_decode_from_cache(q, cache: SalcaCache) -> torch.Tensor:
    """Dense attention over the dequantized contiguous cache (isolates the
    selection's error from the quantization's)."""
    k = cache.k_codes.float() * cache.k_scale[..., None]
    v = cache.v_codes.float() * cache.v_scale[..., None]
    return dense_decode_attention(q, k, v, cache.valid_mask())


def dense_decode_from_paged(q, pool: PagedSalcaCache, valid_mask=None) -> torch.Tensor:
    """Dense attention over a paged pool's dequantized logical view."""
    k, v = paged_logical_kv(pool)
    return dense_decode_attention(q, k, v,
                                  pool.mapped_valid_mask() if valid_mask is None else valid_mask)
