"""Salca decode attention over the paged pool, plus the dense oracles.

Port of the reference `core/attention.py`: the fused paged tick
(`salca_decode_attention_paged`, kernels B1 and B2) and, as test oracles,
`exact_sparse_attention` and `dense_decode_from_paged`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.cache import PagedSalcaCache, paged_logical_kv
from repro_torch.core.selection import (
    SalcaParams, estimate_relevance_paged, query_heavy_features,
    select_sparse_pattern_blocked)

NEG_INF = -1e30


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


def dense_decode_from_paged(q, pool: PagedSalcaCache, valid_mask=None) -> torch.Tensor:
    """Dense attention over a paged pool's dequantized logical view."""
    k, v = paged_logical_kv(pool)
    return dense_decode_attention(q, k, v,
                                  pool.mapped_valid_mask() if valid_mask is None else valid_mask)
