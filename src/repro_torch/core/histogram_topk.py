"""Approximate histogram-based Top-K (paper §3.2, Algorithm 1 phases 2-3).

Port of the reference `core/histogram_topk.py`: a 256-bin histogram of the
uint8 bins, a reverse-prefix-sum threshold, and a prefix-sum compaction of
the kept positions into a fixed-capacity index buffer. All integer, so the
port is bit-identical to the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NUM_BINS = 256


class Selection(NamedTuple):
    indices: torch.Tensor    # (..., k_cap) int32, padded with 0
    mask: torch.Tensor       # (..., k_cap) bool
    count: torch.Tensor      # (...,) int32
    threshold: torch.Tensor  # (...,) int32


def histogram256(bins: torch.Tensor) -> torch.Tensor:
    """Per-row 256-bin histogram: (..., n) uint8 → (..., 256) int32."""
    lead, n = bins.shape[:-1], bins.shape[-1]
    flat = bins.reshape(-1, n).long()
    hist = torch.zeros(flat.shape[0], NUM_BINS, dtype=torch.int32, device=bins.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist.reshape(*lead, NUM_BINS)


def locate_threshold(hist: torch.Tensor, k) -> torch.Tensor:
    """Largest bin T with ``count(bins ≥ T) ≥ k``, clamped to ≥ 1. An int
    ``k`` is compared as a Python scalar (no tensor is made of it); a per-row
    ``k`` (...,) as a tensor."""
    rev_cum = torch.flip(torch.cumsum(torch.flip(hist, [-1]), dim=-1), [-1])
    if isinstance(k, int):
        reached = rev_cum >= k
    else:
        reached = rev_cum >= torch.as_tensor(k, device=hist.device)[..., None]
    bin_ids = torch.arange(NUM_BINS, dtype=torch.int32, device=hist.device)
    t = torch.where(reached, bin_ids, torch.zeros_like(bin_ids)).amax(dim=-1)
    return torch.clamp_min(t, 1).to(torch.int32)


def compact_indices(keep: torch.Tensor, k_cap: int):
    """Compact the positions of ``keep`` (..., n) into (indices (..., k_cap)
    int32, mask (..., k_cap) bool, count (...,) int32); elements past the
    capacity are dropped."""
    lead, n = keep.shape[:-1], keep.shape[-1]
    kp = keep.reshape(-1, n)
    pos = torch.cumsum(kp.to(torch.int32), dim=-1) - 1
    valid = kp & (pos < k_cap)
    tgt = torch.where(valid, pos, torch.full_like(pos, k_cap)).long()
    src = torch.arange(n, dtype=torch.int32, device=keep.device).expand_as(pos)
    out = torch.zeros(kp.shape[0], k_cap + 1, dtype=torch.int32, device=keep.device)
    # valid targets are unique; everything dropped lands in the spare column
    out.scatter_(1, tgt, src)
    count = torch.clamp_max(kp.to(torch.int32).sum(-1), k_cap).to(torch.int32)
    mask = torch.arange(k_cap, device=keep.device) < count[:, None]
    return (out[:, :k_cap].reshape(*lead, k_cap), mask.reshape(*lead, k_cap),
            count.reshape(lead))


def histogram_topk(bins: torch.Tensor, k, k_cap: int) -> Selection:
    """Top-K over uint8 bins (..., n) (bin 0 = masked): the threshold of
    their histogram, then the kept positions compacted into ``k_cap``."""
    t = locate_threshold(histogram256(bins), k)
    keep = bins >= t[..., None].to(bins.dtype)
    indices, mask, count = compact_indices(keep, k_cap)
    return Selection(indices, mask, count, t)


def histogram_topk_blocked(bins: torch.Tensor, k, k_cap: int) -> Selection:
    """Top-K over block-decomposed bins (..., nb, bs) in page order. The
    per-block histograms add into the global one, so this equals the flat
    form; indices come out in the logical (flattened) coordinate."""
    return histogram_topk(bins.reshape(bins.shape[:-2] + (bins.shape[-2] * bins.shape[-1],)),
                          k, k_cap)


def exact_topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """O(n log n) exact Top-K baseline (``Std_TopK``) over the last dim, in
    descending score order, int32. Ties go to the lower index, as
    `lax.top_k`'s do: a stable descending sort (`torch.topk` promises no
    order among ties)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)
