"""Salca sparse-pattern selection (paper Algorithm 1, phases 1-3).

Port of the reference `core/selection.py`, flat (contiguous cache) and
paged:

    q ─heavy channels─► q_feat ─(group sum)─ 3-bit quant ─► q̂
    Ŝ = dequant(q̂ · k̂ᵀ) over the 2-bit packed key features  (kernels B7, B1, B4)
    bins = uint8(Ŝ) → max-pool → 256-bin histogram threshold → compaction
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import histogram_topk as ht
from repro_torch.core import quantization as qz
from repro_torch.core.maxpool import maxpool1d_blocked, maxpool1d_reuse


@dataclass(frozen=True)
class SalcaParams:
    feature_sparsity: float = 0.5      # s_f: fraction of head_dim kept as heavy channels
    k: int = 1024                      # target sparse token count per kv head
    k_cap: int = 1536                  # index buffer capacity (≥ k)
    pool_window: int = 7               # stride-1 max-pool window (1 = bypass)
    use_pool: bool = True
    sink_tokens: int = 0               # always-keep prefix
    recent_tokens: int = 0             # always-keep suffix

    def r(self, head_dim: int) -> int:
        """Heavy channels per head; a multiple of 16 so 2-bit packing is exact."""
        r = int(self.feature_sparsity * head_dim)
        return max(16, (r // 16) * 16)

    @staticmethod
    def for_seq(n: int, retention: float = 0.05, **kw) -> "SalcaParams":
        """Params targeting a retention rate on sequences of length n."""
        k = max(128, int(n * retention))
        k_cap = ((int(k * 1.25) + 127) // 128) * 128
        return SalcaParams(k=min(k, n), k_cap=min(k_cap, n), **kw)


def query_heavy_features(q: torch.Tensor, heavy_idx: torch.Tensor,
                         groups: int) -> torch.Tensor:
    """q (B, H, HD), heavy_idx (B, KV, R) → (B, H, R) f32: each query head
    reads its kv head's heavy channels."""
    b, h, hd = q.shape
    kv, r = heavy_idx.shape[-2:]
    idx = heavy_idx[:, :, None, :].expand(b, kv, groups, r).long()
    qg = q.reshape(b, kv, groups, hd).float()
    return torch.gather(qg, -1, idx).reshape(b, h, r)


def _quantized_query_groups(q_feat: torch.Tensor, kv: int):
    """Group-fold (when ``group_sum_query``) + 3-bit quantization.

    Returns codes (B, KV, G', r) int8, scale (B, KV, G') f32 and code sums
    (B, KV, G') int32, with G' = 1 under the fold, else H // KV."""
    from repro_torch.flags import PERF
    b, h, r = q_feat.shape
    groups = h // kv
    if PERF.group_sum_query and groups > 1:
        q_feat = q_feat.reshape(b, kv, groups, r).sum(dim=2)
        groups = 1
    q3 = qz.quantize_query_features(q_feat)
    qc = q3.codes.reshape(b, kv, groups, r)
    qs = q3.scale.reshape(b, kv, groups)
    qsum = qc.to(torch.int32).sum(-1, dtype=torch.int32)
    return qc, qs, qsum


def estimate_relevance(q_feat: torch.Tensor, feat_words: torch.Tensor,
                       feat_scale: torch.Tensor, feat_zero: torch.Tensor,
                       groups: int) -> torch.Tensor:
    """Phase 1 over a contiguous feature stream (kernel B7 on the card):
    q_feat (B, H, r); feat_words (B, N, KV, r/16) int32; feat_scale/zero
    (B, N, KV) f32 → group-summed scores (B, KV, N) f32. The kernel reads
    the cache's fields through their strides (no transposed copy)."""
    from repro_torch.flags import PERF
    from repro_torch.kernels.score_est.ops import flat_score_estimate
    b, h, r = q_feat.shape
    kv = feat_words.shape[2]
    assert h == kv * groups
    qc, qs, _ = _quantized_query_groups(q_feat, kv)
    return flat_score_estimate(qc, qs, feat_words, feat_scale, feat_zero,
                               bf16=PERF.bf16_collectives)


def estimate_relevance_paged(q_feat: torch.Tensor, pool, groups: int) -> torch.Tensor:
    """Phase 1 straight off the physical block pool, per logical block through
    the page table (kernel B1 on the card). q_feat (S, H, r) → scores
    (S, KV, L) f32 in logical order; unmapped pages clamp to block 0."""
    from repro_torch.flags import PERF
    from repro_torch.kernels.score_est.ops import paged_score_estimate
    s, h, r = q_feat.shape
    kv = pool.num_kv_heads
    assert h == kv * groups
    qc, qs, qsum = _quantized_query_groups(q_feat, kv)
    return paged_score_estimate(qc, qs, qsum, pool.feat_words, pool.feat_scale,
                                pool.feat_zero, pool.clamped_pages(),
                                bf16=PERF.bf16_collectives)


def estimate_relevance_paged_bounds(q_feat: torch.Tensor, pool, groups: int,
                                    blk_valid: torch.Tensor,
                                    pages: torch.Tensor | None = None):
    """Phase 1 of the block-sharded tick: scores + raw binning bounds in one
    pass (kernel B4 on the card). ``blk_valid`` (S, MB, BS) bool marks this
    rank's owned-and-stored positions; ``pages`` (S, MB) overrides the table
    the stream walks (a sharded rank passes its localized, clamped table).
    Returns (scores (S, KV, L) with invalid positions at `SCORE_NEG_INF`,
    lo (S, KV), hi (S, KV)), the partials the caller pmin/pmax-merges."""
    from repro_torch.flags import PERF
    from repro_torch.kernels.score_est.ops import paged_score_bounds
    s, h, r = q_feat.shape
    kv = pool.num_kv_heads
    assert h == kv * groups
    if pages is None:
        pages = pool.clamped_pages()
    qc, qs, qsum = _quantized_query_groups(q_feat, kv)
    return paged_score_bounds(qc, qs, qsum, pool.feat_words, pool.feat_scale,
                              pool.feat_zero, pages, blk_valid,
                              bf16=PERF.bf16_collectives)


def _force_sink_recent(pooled: torch.Tensor, params: SalcaParams,
                       valid_mask: torch.Tensor | None) -> torch.Tensor:
    """Sink/recent forcing: the first ``sink_tokens`` and the last
    ``recent_tokens`` stored positions go to bin 255 (never a masked one)."""
    n = pooled.shape[-1]
    pos = torch.arange(n, device=pooled.device)
    forced = torch.zeros(n, dtype=torch.bool, device=pooled.device)
    if params.sink_tokens:
        forced = forced | (pos < params.sink_tokens)
    if params.recent_tokens and valid_mask is not None:
        length = valid_mask.to(torch.int32).sum(-1, keepdim=True)
        forced = forced | (pos >= (length - params.recent_tokens))
    if valid_mask is not None:
        forced = forced & valid_mask
    return torch.where(forced, torch.full_like(pooled, 255), pooled)


def select_sparse_pattern(scores: torch.Tensor, params: SalcaParams,
                          valid_mask: torch.Tensor | None = None) -> ht.Selection:
    """Phases 2-3 over flat scores (B, KV, N); valid_mask (B, 1|KV, N) bool
    (True = stored token): uint8 binning → max-pool → sink/recent forcing →
    histogram threshold → compaction."""
    bins = qz.quantize_scores_uint8(scores, valid_mask)
    if params.use_pool and params.pool_window > 1:
        pooled = maxpool1d_reuse(bins, params.pool_window)
        if valid_mask is not None:   # pooling must not revive masked slots
            pooled = torch.where(valid_mask, pooled, torch.zeros_like(pooled))
    else:
        pooled = bins
    if params.sink_tokens or params.recent_tokens:
        pooled = _force_sink_recent(pooled, params, valid_mask)
    return ht.histogram_topk(pooled, params.k, params.k_cap)


def salca_select(q_feat: torch.Tensor, feat_words: torch.Tensor, feat_scale: torch.Tensor,
                 feat_zero: torch.Tensor, groups: int, params: SalcaParams,
                 valid_mask: torch.Tensor | None = None) -> ht.Selection:
    """Phases 1-3 over a contiguous cache: B7's scores, then the chain of
    `select_sparse_pattern`. valid_mask (B, N) or (B, 1|KV, N)."""
    scores = estimate_relevance(q_feat, feat_words, feat_scale, feat_zero, groups)
    if valid_mask is not None and valid_mask.ndim == 2:
        valid_mask = valid_mask[:, None, :]
    return select_sparse_pattern(scores, params, valid_mask)


def select_sparse_pattern_blocked(scores: torch.Tensor, params: SalcaParams,
                                  valid_mask: torch.Tensor | None,
                                  block_size: int) -> ht.Selection:
    """Phases 2-3 over logical-order scores (B, KV, N), N a multiple of
    ``block_size``; valid_mask (B, 1|KV, N) bool. Returns a Selection of
    logical token positions."""
    n = scores.shape[-1]
    assert n % block_size == 0, f"N={n} not divisible by block_size={block_size}"
    nb = n // block_size
    bins = qz.quantize_scores_uint8(scores, valid_mask)
    if params.use_pool and params.pool_window > 1:
        pooled = maxpool1d_blocked(bins.reshape(bins.shape[:-1] + (nb, block_size)),
                                   params.pool_window).reshape(bins.shape)
        if valid_mask is not None:   # pooling must not revive masked slots
            pooled = torch.where(valid_mask, pooled, torch.zeros_like(pooled))
    else:
        pooled = bins
    if params.sink_tokens or params.recent_tokens:
        pooled = _force_sink_recent(pooled, params, valid_mask)
    return ht.histogram_topk_blocked(pooled.reshape(pooled.shape[:-1] + (nb, block_size)),
                                     params.k, params.k_cap)
