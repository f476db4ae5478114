"""Kernels B1 and B4: paged relevance scoring, and their plain PyTorch versions.

B1 replaces `repro/kernels/score_est/kernel.py::paged_score_estimate_pallas`.
For each slot s and logical block j, the scores of physical block
``pages[s, j]``: unpack the 2-bit key codes, take the exact integer dot
with the 3-bit query codes, run `dequant_score_chain` (bf16 rounding
pinned) and sum over the query group.

B4 replaces `paged_score_bounds_pallas`: B1's scores masked to
`SCORE_NEG_INF` outside ``blk_valid``, plus the raw per-(slot, kv) bounds
(lo, hi) of `quantization.score_bounds`, in the same pass.

CUDA source of both: ``repro_torch/csrc/score_est.cu``; their outputs are
bit-identical to the plain versions below.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantization as qz
from repro_torch.kernels import common


def paged_score_estimate_plain(q_codes, q_scale, q_sums, feat_words, feat_scale,
                               feat_zero, pages, bf16: bool = True) -> torch.Tensor:
    """Plain version (mirrors the reference `paged_score_estimate_ref`).

    q_codes (S, KV, G, r) int8, q_scale (S, KV, G) f32, q_sums (S, KV, G)
    int32; feat_words (P, BS, KV, r/16) int32; feat_scale/zero (P, BS, KV)
    f32; pages (S, MB) int32 clamped ≥ 0 → scores (S, KV, MB·BS) f32."""
    s, kv, g, r = q_codes.shape
    mb = pages.shape[1]
    bs = feat_words.shape[1]
    pg = pages.long()
    codes = qz.unpack2bit(feat_words[pg], r).permute(0, 3, 1, 2, 4)  # (S,KV,MB,BS,r)
    # exact integer dot, by broadcast (integer matmul is CPU-only in PyTorch)
    int_dot = (q_codes.to(torch.int32)[:, :, :, None, None, :]
               * codes.to(torch.int32)[:, :, None]).sum(-1, dtype=torch.int32)
    a = feat_scale[pg].permute(0, 3, 1, 2)[:, :, None]               # (S,KV,1,MB,BS)
    z = feat_zero[pg].permute(0, 3, 1, 2)[:, :, None]
    scores = qz.dequant_score_chain(q_scale[..., None, None], a, z, int_dot,
                                    q_sums[..., None, None], bf16)
    return scores.sum(dim=2, dtype=torch.float32).reshape(s, kv, mb * bs)


def paged_score_estimate(q_codes, q_scale, q_sums, feat_words, feat_scale,
                         feat_zero, pages, bf16: bool = True) -> torch.Tensor:
    """Scores (S, KV, MB·BS) f32 streamed per physical block through the
    clamped page table. CPU tensors take the plain version; CUDA tensors
    launch kernel B1."""
    if q_codes.device.type == "cpu":
        return paged_score_estimate_plain(q_codes, q_scale, q_sums, feat_words,
                                          feat_scale, feat_zero, pages, bf16)
    s, kv, g, r = q_codes.shape
    p, bs = feat_words.shape[:2]
    mb = pages.shape[1]
    dev = q_codes.device
    if r % qz.CODES_PER_WORD:
        raise ValueError(f"r={r} not a multiple of {qz.CODES_PER_WORD}")
    common.require(q_codes, "q_codes", torch.int8, (s, kv, g, r), dev)
    common.require(q_scale, "q_scale", torch.float32, (s, kv, g), dev)
    common.require(q_sums, "q_sums", torch.int32, (s, kv, g), dev)
    common.require(feat_words, "feat_words", torch.int32, (p, bs, kv, r // 16), dev)
    common.require(feat_scale, "feat_scale", torch.float32, (p, bs, kv), dev)
    common.require(feat_zero, "feat_zero", torch.float32, (p, bs, kv), dev)
    common.require(pages, "pages", torch.int32, (s, mb), dev)
    out = torch.empty((s, kv, mb * bs), dtype=torch.float32, device=dev)
    fn = common.load("score_est", "paged_score_estimate",
                     [common.P] * 8 + [common.I] * 7 + [common.P])
    err = fn(q_codes.data_ptr(), q_scale.data_ptr(), q_sums.data_ptr(),
             feat_words.data_ptr(), feat_scale.data_ptr(), feat_zero.data_ptr(),
             pages.data_ptr(), out.data_ptr(), s, kv, g, r, bs, mb, int(bf16),
             common.stream_ptr(out))
    common.check(err, "paged_score_estimate")
    common.LAUNCHES["paged_score_estimate"] += 1
    return out


def paged_score_bounds_plain(q_codes, q_scale, q_sums, feat_words, feat_scale, feat_zero,
                             pages, blk_valid, bf16: bool = True):
    """Plain version (mirrors the reference `paged_score_bounds_ref`): B1's
    scores, then `masked_scores` and `score_bounds`."""
    s, kv = q_codes.shape[:2]
    mb, bs = blk_valid.shape[1:]
    scores = paged_score_estimate_plain(q_codes, q_scale, q_sums, feat_words, feat_scale,
                                        feat_zero, pages, bf16)
    sm = qz.masked_scores(scores, blk_valid.reshape(s, 1, mb * bs))
    lo, hi = qz.score_bounds(sm)
    return sm, lo, hi


def paged_score_bounds(q_codes, q_scale, q_sums, feat_words, feat_scale, feat_zero,
                       pages, blk_valid, bf16: bool = True):
    """B1's operands plus ``blk_valid`` (S, MB, BS) bool → (scores (S, KV,
    MB·BS) f32 with invalid positions at `SCORE_NEG_INF`, lo (S, KV), hi
    (S, KV)): lo is the min over valid scores (+inf when none), hi the max
    of the masked scores. CPU tensors take the plain version; CUDA tensors
    launch kernel B4."""
    if q_codes.device.type == "cpu":
        return paged_score_bounds_plain(q_codes, q_scale, q_sums, feat_words, feat_scale,
                                        feat_zero, pages, blk_valid, bf16)
    s, kv, g, r = q_codes.shape
    p, bs = feat_words.shape[:2]
    mb = pages.shape[1]
    dev = q_codes.device
    if r % qz.CODES_PER_WORD:
        raise ValueError(f"r={r} not a multiple of {qz.CODES_PER_WORD}")
    common.require(q_codes, "q_codes", torch.int8, (s, kv, g, r), dev)
    common.require(q_scale, "q_scale", torch.float32, (s, kv, g), dev)
    common.require(q_sums, "q_sums", torch.int32, (s, kv, g), dev)
    common.require(feat_words, "feat_words", torch.int32, (p, bs, kv, r // 16), dev)
    common.require(feat_scale, "feat_scale", torch.float32, (p, bs, kv), dev)
    common.require(feat_zero, "feat_zero", torch.float32, (p, bs, kv), dev)
    common.require(pages, "pages", torch.int32, (s, mb), dev)
    common.require(blk_valid, "blk_valid", torch.bool, (s, mb, bs), dev)
    out = torch.empty((s, kv, mb * bs), dtype=torch.float32, device=dev)
    lo = torch.full((s, kv), float("inf"), dtype=torch.float32, device=dev)
    hi = torch.full((s, kv), float("-inf"), dtype=torch.float32, device=dev)
    fn = common.load("score_est", "paged_score_bounds",
                     [common.P] * 11 + [common.I] * 7 + [common.P])
    err = fn(q_codes.data_ptr(), q_scale.data_ptr(), q_sums.data_ptr(),
             feat_words.data_ptr(), feat_scale.data_ptr(), feat_zero.data_ptr(),
             pages.data_ptr(), blk_valid.data_ptr(), out.data_ptr(), lo.data_ptr(),
             hi.data_ptr(), s, kv, g, r, bs, mb, int(bf16), common.stream_ptr(out))
    common.check(err, "paged_score_bounds")
    common.LAUNCHES["paged_score_bounds"] += 1
    return out, lo, hi
