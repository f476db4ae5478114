"""Kernels B1, B4 and B7: relevance scoring, and their plain PyTorch versions.

B1 replaces `repro/kernels/score_est/kernel.py::paged_score_estimate_pallas`.
For each slot s and logical block j, the scores of physical block
``pages[s, j]``: unpack the 2-bit key codes, take the exact integer dot
with the 3-bit query codes, run `dequant_score_chain` (bf16 rounding
pinned) and sum over the query group.

B4 replaces `paged_score_bounds_pallas`: B1's scores masked to
`SCORE_NEG_INF` outside ``blk_valid``, plus the raw per-(slot, kv) bounds
(lo, hi) of `quantization.score_bounds`, in the same pass.

B7 replaces `score_estimate_pallas`: flat scores of a contiguous feature
stream. `score_estimate` keeps the reference's (BH, ·) signature and its
unpinned f32 chain; `flat_score_estimate` is the contiguous tick's phase 1
(the flat `selection.estimate_relevance`): it reads the cache's (B, N, KV,
·) fields through their strides, with the bf16 chain pinned when asked.
Both launch one kernel (template flag BF16).

CUDA source of all three: ``repro_torch/csrc/score_est.cu``; their outputs
are bit-identical to the plain versions below.
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


def flat_score_estimate_plain(q_codes, q_scale, feat_words, feat_scale, feat_zero,
                              bf16: bool = True) -> torch.Tensor:
    """Plain version of B7 over the contiguous cache layout (mirrors the
    reference `selection.estimate_relevance` after its query prologue, and
    `score_estimate_ref` when ``bf16`` is off).

    q_codes (B, KV, G, r) int8, q_scale (B, KV, G) f32; feat_words (B, N,
    KV, r/16) int32; feat_scale/zero (B, N, KV) f32 → scores (B, KV, N) f32.
    The group sum runs in order g = 0, 1, … as the kernel adds."""
    b, kv, g, r = q_codes.shape
    codes = qz.unpack2bit(feat_words, r).permute(0, 2, 1, 3)          # (B, KV, N, r)
    q32 = q_codes.to(torch.int32)
    # exact integer dot, by broadcast (integer matmul is CPU-only in PyTorch)
    int_dot = (q32[:, :, :, None, :] * codes.to(torch.int32)[:, :, None]).sum(
        -1, dtype=torch.int32)                                         # (B, KV, G, N)
    qsum = q32.sum(-1, dtype=torch.int32)
    a = feat_scale.permute(0, 2, 1)[:, :, None]                        # (B, KV, 1, N)
    z = feat_zero.permute(0, 2, 1)[:, :, None]
    scores = qz.dequant_score_chain(q_scale[..., None], a, z, int_dot, qsum[..., None], bf16)
    out = scores[:, :, 0]
    for i in range(1, g):
        out = out + scores[:, :, i]
    return out


def flat_score_estimate(q_codes, q_scale, feat_words, feat_scale, feat_zero,
                        bf16: bool = True) -> torch.Tensor:
    """Scores (B, KV, N) f32 of the contiguous feature stream: q_codes (B,
    KV, G, r) int8, q_scale (B, KV, G) f32; feat_words (B, N, KV, r/16)
    int32 and feat_scale/zero (B, N, KV) f32, any strides (the words'
    last dim contiguous). CPU tensors take the plain version; CUDA tensors
    launch kernel B7."""
    if q_codes.device.type == "cpu":
        return flat_score_estimate_plain(q_codes, q_scale, feat_words, feat_scale,
                                         feat_zero, bf16)
    b, kv, g, r = q_codes.shape
    n = feat_words.shape[1]
    dev = q_codes.device
    if r % qz.CODES_PER_WORD:
        raise ValueError(f"r={r} not a multiple of {qz.CODES_PER_WORD}")
    common.require(q_codes, "q_codes", torch.int8, (b, kv, g, r), dev)
    common.require(q_scale, "q_scale", torch.float32, (b, kv, g), dev)
    for name, t, dt, shape in (("feat_words", feat_words, torch.int32, (b, n, kv, r // 16)),
                               ("feat_scale", feat_scale, torch.float32, (b, n, kv)),
                               ("feat_zero", feat_zero, torch.float32, (b, n, kv))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dt} {shape} on {dev}")
    if feat_words.stride(-1) != 1:
        raise ValueError("feat_words: the word dim must be contiguous")
    out = torch.empty((b, kv, n), dtype=torch.float32, device=dev)
    fn = common.load("score_est", "flat_score_estimate",
                     [common.P] * 6 + [common.I] * 5 + [common.L] * 9 + [common.I, common.P])
    ws, fs, fz = feat_words.stride(), feat_scale.stride(), feat_zero.stride()
    err = fn(q_codes.data_ptr(), q_scale.data_ptr(), feat_words.data_ptr(),
             feat_scale.data_ptr(), feat_zero.data_ptr(), out.data_ptr(), b, kv, g, r, n,
             ws[0], ws[1], ws[2], fs[0], fs[1], fs[2], fz[0], fz[1], fz[2], int(bf16),
             common.stream_ptr(out))
    common.check(err, "flat_score_estimate")
    common.LAUNCHES["score_estimate"] += 1
    return out


def score_estimate_plain(q_codes, q_scale, words, feat_scale, feat_zero) -> torch.Tensor:
    """Plain version of `score_estimate` (mirrors the reference
    `score_estimate_ref`)."""
    return flat_score_estimate_plain(q_codes[:, None], q_scale[:, None], words[:, :, None],
                                     feat_scale[:, :, None], feat_zero[:, :, None],
                                     bf16=False)[:, 0]


def score_estimate(q_codes, q_scale, words, feat_scale, feat_zero) -> torch.Tensor:
    """The reference's `score_estimate` op: q_codes (BH, G, r) int8, q_scale
    (BH, G) f32, words (BH, N, r/16) int32 (uint32 bits), feat_scale/zero
    (BH, N) f32 → scores (BH, N) f32 through the unpinned f32 chain. CPU
    tensors take the plain version; CUDA tensors launch kernel B7."""
    return flat_score_estimate(q_codes[:, None], q_scale[:, None], words[:, :, None],
                               feat_scale[:, :, None], feat_zero[:, :, None],
                               bf16=False)[:, 0]
