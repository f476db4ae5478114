#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the eleven CUDA kernels' four sources from ``src/repro_torch/csrc``
   (nvcc, sm_90a, one process per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with kernel, plain and library times and
   the roofline bound — the paged kernels (B1 paged scores, B4 scores +
   bounds and B5 bin/pool/histogram: bit-identical; B2 sparse decode
   attention and B6 its unnormalised partials: f32, in each of the pool's
   storage branches int8, fp16 and int4; B3 causal prefill attention:
   bf16), the contiguous tick's (B7 flat scores in both of its chains and
   B9 bin/pool/histogram/threshold: bit-identical; B8 sparse decode
   attention over gathered rows: f32), and B10 (max-pool) and B11
   (histogram + threshold), bit-identical, driven once through their
   public entry points; then check the whole serving path on a small
   input — paged, contiguous, a fp16 pool, and an int4 pool with the host
   tier on a pool small enough that blocks demote and promote: the port
   on the card against the port's plain versions on the CPU (greedy
   tokens identical, logits close);
4. serve full-width qwen3-0.6b (random bf16 weights from a seed) through
   ``ServingEngine(paged=True, slots=4, max_seq=8192, block_size=32)``:
   4 requests of 2048-4096-token prompts × 16 new tokens, with every
   kernel's launch counter set to 0 just before and read just after; then
   serve the same requests again through the block-sharded tick,
   ``ServingEngine(paged=True, ctx=...)`` over a world of one rank (nccl):
   B4, B5 and B6 replace B1 and B2, and the greedy tokens must equal the
   first run's; then through the contiguous slot pool,
   ``ServingEngine(paged=False, slots=4, max_seq=8192)``: B7, B9 and B8
   run the tick, fed the first run's tokens (teacher forcing), and every
   logits row of every request must stay within CONTIG_LOGIT_ULPS bf16
   ulps of the first run's row for the same history; a step where the two
   greedy picks part is printed with the paged run's top-two gap. Then the
   tiered pool: ``kv_pool_dtype="fp16"`` and ``"int4"``, each unsharded
   (B2's branch) and block-sharded at one rank (B6's branch, tokens equal
   to the unsharded run's), and ``kv_pool_dtype="int4", host_spill=True``
   on SPILL_RUN's 200-block pool, checked by `SpillProbe` (a bit-exact
   block round trip, wave admission, pressure and policy demotion,
   promotion, transfer bytes, a drained pool).

It prints a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. Without a CUDA device it exits
with code 1 and prints no result.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM: HBM3
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}   # dense, per second
SERVE = dict(paged=True, slots=4, max_seq=8192, block_size=32)
PROMPTS = (2048, 3072, 4096, 2560)
NEW_TOKENS = 16
B2_ATOL, B2_RTOL = 1e-5, 1e-5          # f32 output (B2, B8, and B6's acc and l)
B3_ATOL, B3_RTOL = 1e-4, 2.0 ** -7     # bf16 output: one ulp of each element
SMALL_PATH_LOGIT_TOL = 3e-4
# contiguous vs paged logits for one history, in bf16 ulps of the top
# logit: the card reads at most 15.75 on every row; faults injected into
# one slot (an append dropped or written a row early, a gather reading the
# neighbouring rows) read 37-106 (PERF.md)
CONTIG_LOGIT_ULPS = 24
# the host tier on the small path: 8 blocks for prompts of 5, 7 and 6 blocks
SMALL_SPILL = dict(kv_pool_dtype="int4", host_spill=True, num_blocks=8, demote_after=1,
                   spill_keep_recent=2)
# the host tier at full width: 200 blocks for the requests' 370, so that the
# 4096-token prompt (128 blocks) admits in waves after pressure demotion
# (SpillProbe; PERF.md)
SPILL_RUN = dict(kv_pool_dtype="int4", host_spill=True, num_blocks=200, demote_after=1,
                 spill_keep_recent=48)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` on the device timeline (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, kernel_name: str, iters: int) -> float:
    """Device time per launch of the CUDA kernel named ``kernel_name``, from
    the profiler's trace (averaged over the launches it recorded). Raises
    when the trace holds no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for e in prof.key_averages():
        if kernel_name in e.key:
            total_us += (getattr(e, "device_time_total", 0)
                         or getattr(e, "cuda_time_total", 0))
            launches += e.count
    if total_us <= 0:
        raise RuntimeError(f"the profiler recorded no device time for {kernel_name}")
    # per recorded launch: the trace can miss some of the ``iters`` launches
    return total_us / launches / 1e3


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_pool(dev, gen, cfg, slots, max_seq, block_size, lengths, kv_pool_dtype="int8"):
    """A paged pool at the serving shapes with random contents in storage
    mode ``kv_pool_dtype``: slot s holds ``lengths[s]`` tokens over
    scrambled physical blocks (int4: any byte is a pair of nibbles)."""
    import torch
    from repro_torch.core.cache import empty_paged_cache
    from repro_torch.models.blocks import salca_params_for
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    r = salca_params_for(cfg, max_seq).r(hd)
    mb = max_seq // block_size
    nb = slots * mb
    pool = empty_paged_cache(nb, block_size, slots, mb, kv, hd, r, kv_pool_dtype=kv_pool_dtype,
                             device=dev)
    d = pool.data
    for f in ("k_codes", "v_codes"):
        if kv_pool_dtype == "fp16":
            d[f].copy_(torch.randn(d[f].shape, generator=gen, device=dev))
        else:
            d[f].copy_(torch.randint(-127, 128, d[f].shape, generator=gen, device=dev,
                                     dtype=torch.int8))
    d["feat_words"].copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, d["feat_words"].shape,
                                        generator=gen, device=dev, dtype=torch.int32))
    for f in ("k_scale", "v_scale", "feat_scale"):
        if kv_pool_dtype != "fp16" or f == "feat_scale":      # fp16: unit scales
            d[f].copy_(torch.rand(d[f].shape, generator=gen, device=dev) * 0.02 + 1e-3)
    d["feat_zero"].copy_(torch.randn(d["feat_zero"].shape, generator=gen, device=dev))
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    for s, n in enumerate(lengths):
        need = -(-n // block_size)
        pool.page_table[s, :need] = perm[s * mb: s * mb + need]
        pool.length[s] = n
    pool.heavy_idx.copy_(torch.sort(torch.rand((slots, kv, hd), generator=gen, device=dev)
                                    .argsort(-1)[..., :r], dim=-1).values.to(torch.int32))
    return pool


def random_cache(dev, gen, cfg, slots, max_seq, lengths):
    """A contiguous slot pool at the serving shapes with random contents:
    slot s holds ``lengths[s]`` tokens."""
    import torch
    from repro_torch.core.cache import empty_cache
    from repro_torch.models.blocks import salca_params_for
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    r = salca_params_for(cfg, max_seq).r(hd)
    cache = empty_cache(slots, max_seq, kv, hd, r, device=dev)
    for f in ("k_codes", "v_codes"):
        getattr(cache, f).copy_(torch.randint(-127, 128, getattr(cache, f).shape, generator=gen,
                                              device=dev, dtype=torch.int8))
    cache.feat_words.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, cache.feat_words.shape,
                                         generator=gen, device=dev, dtype=torch.int32))
    for f in ("k_scale", "v_scale", "feat_scale"):
        getattr(cache, f).copy_(torch.rand(getattr(cache, f).shape, generator=gen, device=dev)
                                * 0.02 + 1e-3)
    cache.feat_zero.copy_(torch.randn(cache.feat_zero.shape, generator=gen, device=dev))
    cache.length.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
    cache.heavy_idx.copy_(torch.sort(torch.rand((slots, kv, hd), generator=gen, device=dev)
                                     .argsort(-1)[..., :r], dim=-1).values.to(torch.int32))
    return cache


def check_flat_kernels(dev, cfg, lengths, iters=20):
    """Phase 3a, the contiguous tick's kernels at its shapes on a random
    slot pool: B7 bit-identical in the tick's bf16-pinned chain and in the
    reference op's f32 chain, B9 bit-identical, B8 within
    B2_ATOL + B2_RTOL·|plain| on the selection B9 leads to."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import quantization as qz
    from repro_torch.core.attention import gather_selected
    from repro_torch.core.histogram_topk import Selection, compact_indices
    from repro_torch.core.selection import _quantized_query_groups, query_heavy_features
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.kernels.selection_fused import ops as sf
    from repro_torch.models.blocks import salca_params_for

    gen = torch.Generator(device=dev).manual_seed(2)
    s, n = SERVE["slots"], SERVE["max_seq"]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bh = s * kv
    cache = random_cache(dev, gen, cfg, s, n, lengths)
    q = torch.randn((s, h, hd), generator=gen, device=dev)
    qc, qs, _ = _quantized_query_groups(query_heavy_features(q, cache.heavy_idx, h // kv), kv)
    g, r = qc.shape[2], qc.shape[3]
    recs = []

    # B7 — the tick's form, reading the cache's (B, N, KV, ·) fields in place
    b7_args = (qc, qs, cache.feat_words, cache.feat_scale, cache.feat_zero)
    scores = se.flat_score_estimate(*b7_args, bf16=True)
    _check_exact("B7 (bf16 chain)", (scores,),
                 (se.flat_score_estimate_plain(*b7_args, bf16=True),))
    # … and the reference op's form, over (BH, N, ·) copies
    op_args = (qc.reshape(bh, g, r), qs.reshape(bh, g),
               cache.feat_words.transpose(1, 2).reshape(bh, n, r // 16),
               cache.feat_scale.transpose(1, 2).reshape(bh, n),
               cache.feat_zero.transpose(1, 2).reshape(bh, n))
    _check_exact("B7 (f32 chain)", (se.score_estimate(*op_args),),
                 (se.score_estimate_plain(*op_args),))
    b7_bytes = (s * n * kv * (r // 16 * 4 + 8)                 # words, scale, zero
                + qc.numel() + 4 * qs.numel() + 4 * scores.numel())
    bms, bby = bound(b7_bytes, 2 * bh * g * n * r, "int8")
    recs.append(dict(name="score_estimate", route="cuda",
                     source="src/repro_torch/csrc/score_est.cu",
                     replaces="src/repro/kernels/score_est/kernel.py:54",
                     launches=None, max_abs_err=0.0,
                     tolerance="bit-identical (bf16 and f32 chains)", err_over_tol=0.0,
                     ms=kernel_ms(lambda: se.flat_score_estimate(*b7_args), "flat_score_kernel",
                                  iters),
                     f32_chain_ms=kernel_ms(lambda: se.score_estimate(*op_args),
                                            "flat_score_kernel", iters),
                     plain_ms=events_ms(lambda: se.flat_score_estimate_plain(*b7_args),
                                        max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None))

    # B9 — on the bounds and cleaned offset `fused_select_flat` passes it
    params = salca_params_for(cfg, n)
    w = params.pool_window
    valid = torch.arange(n, device=dev)[None, :] < cache.length[:, None]
    sm = qz.masked_scores(scores, valid[:, None, :])
    lo, hi = qz.score_bounds(sm)
    offset, _ = qz.binning_affine(lo, hi)
    b9_args = (sm.reshape(bh, n), offset.reshape(-1).contiguous(), hi.reshape(-1).contiguous(),
               torch.full((bh,), params.k, dtype=torch.int32, device=dev),
               cache.length.repeat_interleave(kv))
    out9 = sf.fused_bin_pool_threshold(*b9_args, window=w)
    _check_exact("B9", out9, sf.fused_bin_pool_threshold_plain(*b9_args, window=w))
    b9_bytes = 4 * bh * n + 16 * bh + bh * n + 4 * out9[1].numel() + 4 * bh
    bms, bby = bound(b9_bytes, bh * n * (w + 8), "f32")    # bin, pool, count
    recs.append(dict(name="fused_bin_pool_threshold", route="cuda",
                     source="src/repro_torch/csrc/selection_fused.cu",
                     replaces="src/repro/kernels/selection_fused/kernel.py:90",
                     launches=None, max_abs_err=0.0, tolerance="bit-identical",
                     err_over_tol=0.0,
                     ms=kernel_ms(lambda: sf.fused_bin_pool_threshold(*b9_args, window=w),
                                  "fused_bin_pool_threshold_kernel", iters),
                     plain_ms=events_ms(lambda: sf.fused_bin_pool_threshold_plain(
                         *b9_args, window=w), max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None,
                     thresholds=sorted({int(t) for t in out9[2].tolist()})))

    # B8 — over the rows that selection gathers
    keep = out9[0] >= out9[2][:, None].to(torch.uint8)
    sel = Selection(*compact_indices(keep.reshape(s, kv, n), params.k_cap),
                    out9[2].reshape(s, kv))
    kc, ks, vc, vs = gather_selected(cache, sel)
    c = kc.shape[2]
    b8_args = (q.reshape(bh, h // kv, hd).contiguous(), kc.reshape(bh, c, hd),
               ks.reshape(bh, c), vc.reshape(bh, c, hd), vs.reshape(bh, c),
               sel.mask.reshape(bh, c))
    out8 = fd.sparse_flash_decode(*b8_args)
    plain8 = fd.sparse_flash_decode_plain(*b8_args)
    err8 = float((out8 - plain8).abs().max())
    ratio8 = float(((out8 - plain8).abs() / (B2_ATOL + B2_RTOL * plain8.abs())).max())
    if not ratio8 <= 1.0:
        raise AssertionError(f"B8: |kernel - plain| reaches {ratio8:.3g}x its bound "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·|plain| (max abs err {err8})")
    live = int(sel.mask.sum())
    b8_bytes = live * (2 * hd + 8) + bh * c + 2 * 4 * b8_args[0].numel()
    bms, bby = bound(b8_bytes, live * (h // kv) * hd * 4, "f32")
    # the yardstick: one SDPA call over the gathered rows, dequantized beforehand
    kd = (kc.float() * ks[..., None]).reshape(bh, 1, c, hd)
    vd = (vc.float() * vs[..., None]).reshape(bh, 1, c, hd)
    qq = b8_args[0].reshape(bh, 1, h // kv, hd)
    am = sel.mask.reshape(bh, 1, 1, c)
    lib = events_ms(lambda: F.scaled_dot_product_attention(qq, kd, vd, attn_mask=am), iters)
    recs.append(dict(name="sparse_flash_decode", route="cuda",
                     source="src/repro_torch/csrc/flash_decode.cu",
                     replaces="src/repro/kernels/flash_decode/kernel.py:73",
                     launches=None, max_abs_err=err8,
                     tolerance=f"{B2_ATOL:g} + {B2_RTOL:g}*|plain|", err_over_tol=ratio8,
                     ms=kernel_ms(lambda: fd.sparse_flash_decode(*b8_args),
                                  "sparse_flash_decode_paged_kernel", iters),
                     plain_ms=events_ms(lambda: fd.sparse_flash_decode_plain(*b8_args),
                                        max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=lib,
                     library_call="scaled_dot_product_attention on the gathered rows, "
                                  "dequantized beforehand (dequantization not timed)",
                     selected_rows=live, capacity=bh * c))

    # the contiguous tick against the paged tick on the same tokens: the
    # reference's contract makes their selections identical (B7 = B1's
    # scores, B9 = the blocked chain's bins and threshold), and their
    # outputs differ only in summation order
    from repro_torch.core.attention import salca_decode_attention, salca_decode_attention_paged
    from repro_torch.core.cache import SalcaCache, empty_paged_cache, prefill_into_pages
    bs = SERVE["block_size"]
    mb = n // bs
    pool = empty_paged_cache(s * mb, bs, s, mb, kv, hd, r, device=dev)
    perm = torch.randperm(s * mb, generator=gen, device=dev).to(torch.int32)
    for i in range(s):
        prefill_into_pages(pool, SalcaCache(*(f[i:i + 1] for f in cache)), i,
                           perm[i * mb:(i + 1) * mb])
    out_c, sel_c = salca_decode_attention(q, cache, params, return_selection=True)
    out_p, sel_p = salca_decode_attention_paged(q, pool, params, return_selection=True)
    _check_exact("contiguous vs paged tick selection", sel_c, sel_p)
    ratio = float(((out_c - out_p).abs() / (B2_ATOL + B2_RTOL * out_p.abs())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"contiguous vs paged tick: outputs reach {ratio:.3g}x "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·|paged|")
    print(f"contiguous vs paged tick at the main path's shapes: selections identical "
          f"({int(sel_c.count.sum())} tokens), outputs within {ratio:.3g} of "
          f"{B2_ATOL:g} + {B2_RTOL:g}·|paged|", flush=True)
    return recs


def check_kernels(dev, cfg, lengths, prompt_len, iters=20):
    """Phase 3a: each kernel against its plain version on the same inputs, at
    the main path's shapes. Returns one record per kernel (launch counts are
    filled in from the main path's run)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.selection import (
        _quantized_query_groups, query_heavy_features, select_sparse_pattern_blocked)
    from repro_torch.flags import PERF
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.models.blocks import salca_params_for

    gen = torch.Generator(device=dev).manual_seed(1)
    s, mseq, bs = SERVE["slots"], SERVE["max_seq"], SERVE["block_size"]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pool = random_pool(dev, gen, cfg, s, mseq, bs, lengths)
    q = torch.randn((s, h, hd), generator=gen, device=dev)
    q_feat = query_heavy_features(q, pool.heavy_idx, h // kv)
    qc, qs, qsum = _quantized_query_groups(q_feat, kv)
    pages = pool.clamped_pages()
    b1_args = (qc, qs, qsum, pool.feat_words, pool.feat_scale, pool.feat_zero, pages)
    recs = []

    # B1 — bit-identical
    out = se.paged_score_estimate(*b1_args, bf16=PERF.bf16_collectives)
    plain = se.paged_score_estimate_plain(*b1_args, bf16=PERF.bf16_collectives)
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        raise AssertionError(f"B1: kernel differs from plain version on "
                             f"{int((out != plain).sum())} of {out.numel()} scores")
    ms = kernel_ms(lambda: se.paged_score_estimate(*b1_args), "paged_score_kernel", iters)
    blocks = int(torch.unique(pages).numel())
    g = qc.shape[2]
    b1_bytes = (blocks * bs * kv * (pool.feat_words.shape[-1] * 4 + 8)   # words, scale, zero
                + qc.numel() + 8 * qs.numel() + 4 * pages.numel() + 4 * out.numel())
    b1_ops = 2 * s * kv * g * pages.shape[1] * bs * qc.shape[-1]
    bms, bby = bound(b1_bytes, b1_ops, "int8")
    recs.append(dict(name="paged_score_estimate", route="cuda",
                     source="src/repro_torch/csrc/score_est.cu",
                     replaces="src/repro/kernels/score_est/kernel.py:219",
                     launches=None, max_abs_err=float((out - plain).abs().max()),
                     tolerance="bit-identical", err_over_tol=0.0, ms=ms,
                     plain_ms=events_ms(lambda: se.paged_score_estimate_plain(*b1_args),
                                        max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None))

    # B2 — on the selection this query makes over this pool
    params = salca_params_for(cfg, mseq)
    sel = select_sparse_pattern_blocked(out, params, pool.mapped_valid_mask()[:, None, :], bs)
    pblk, counts, bmask = fd._selected_block_plan(pool, sel)
    qr = q.reshape(s * kv, h // kv, hd).contiguous()
    b2_args = (qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk, counts,
               bmask, kv)
    out2 = fd.sparse_flash_decode_paged_kernel(*b2_args)
    plain2 = fd.sparse_flash_decode_paged_plain(qr, pool.k_codes, pool.k_scale, pool.v_codes,
                                                pool.v_scale, pblk, bmask, kv)
    err2 = float((out2 - plain2).abs().max())
    # f32 on both sides, summed in other orders; the card read 6.6e-7
    ratio2 = float(((out2 - plain2).abs() / (B2_ATOL + B2_RTOL * plain2.abs())).max())
    if not ratio2 <= 1.0:
        raise AssertionError(f"B2: |kernel - plain| reaches {ratio2:.3g}x its bound "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·|plain| (max abs err {err2})")
    ms = kernel_ms(lambda: fd.sparse_flash_decode_paged_kernel(*b2_args),
                   "sparse_flash_decode_paged_kernel", iters)
    live = int(counts.sum())
    b2_bytes = (live * bs * (2 * hd + 8) + 2 * qr.numel() * 4 + 4 * counts.numel()
                + live * (4 + bs))
    b2_ops = live * bs * (h // kv) * hd * 4
    bms, bby = bound(b2_bytes, b2_ops, "f32")
    recs.append(dict(name="sparse_flash_decode_paged", route="cuda",
                     source="src/repro_torch/csrc/flash_decode.cu",
                     replaces="src/repro/kernels/flash_decode/kernel.py:207",
                     launches=None, max_abs_err=err2,
                     tolerance=f"{B2_ATOL:g} + {B2_RTOL:g}*|plain|", err_over_tol=ratio2, ms=ms,
                     plain_ms=events_ms(lambda: fd.sparse_flash_decode_paged_plain(
                         qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk,
                         bmask, kv), max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None,
                     selected_blocks=live, rows=int(counts.numel())))
    recs += check_sharded_kernels(dev, pool, q, b1_args, params, iters)
    del pool

    # B3 — one layer's prefill attention of the longest prompt, bf16
    t = prompt_len
    q3 = torch.randn((h, t, hd), generator=gen, device=dev).to(torch.bfloat16)
    k3 = torch.randn((kv, t, hd), generator=gen, device=dev).to(torch.bfloat16)
    v3 = torch.randn((kv, t, hd), generator=gen, device=dev).to(torch.bfloat16)
    out3 = fp.flash_attention(q3, k3, v3)
    plain3 = fp.flash_attention_plain(q3, k3, v3)
    diff3 = (out3.float() - plain3.float()).abs()
    err3 = float(diff3.max())
    # both sides work in f32 and round once to bf16, so an element may differ
    # by one bf16 ulp of itself (<= 2^-7 |x|); a dropped key tile or a wrong
    # rescale moves the late rows (|x| ~ 0.02) by far more than that
    ratio3 = float((diff3 / (B3_ATOL + B3_RTOL * plain3.float().abs())).max())
    if not ratio3 <= 1.0:
        raise AssertionError(f"B3: |kernel - plain| reaches {ratio3:.3g}x its bound "
                             f"{B3_ATOL:g} + 2^-7·|plain| (max abs err {err3})")
    ms = kernel_ms(lambda: fp.flash_attention(q3, k3, v3), "flash_prefill_kernel",
                   max(2, iters // 4))
    kr = k3.repeat_interleave(h // kv, 0)[None]
    vr = v3.repeat_interleave(h // kv, 0)[None]
    lib = events_ms(lambda: F.scaled_dot_product_attention(q3[None], kr, vr, is_causal=True),
                    max(2, iters // 4))
    b3_bytes = 2 * (2 * q3.numel() + k3.numel() + v3.numel())
    b3_ops = 4 * hd * h * t * (t + 1) // 2
    bms, bby = bound(b3_bytes, b3_ops, "bf16")
    recs.append(dict(name="flash_prefill", route="cuda",
                     source="src/repro_torch/csrc/flash_prefill.cu",
                     replaces="src/repro/kernels/flash_prefill/kernel.py:98",
                     launches=None, max_abs_err=err3,
                     tolerance=f"{B3_ATOL:g} + 2^-7*|plain|", err_over_tol=ratio3, ms=ms,
                     plain_ms=events_ms(lambda: fp.flash_attention_plain(q3, k3, v3), 2),
                     bound_ms=bms, bound_by=bby, library_ms=lib))
    return recs


def _check_exact(name, got, want):
    import torch
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: output {i} differs on "
                                 f"{int((a != b).sum())} of {a.numel()} elements")


def check_sharded_kernels(dev, pool, q, b1_args, params, iters):
    """Phase 3a, the block-sharded tick's kernels at one rank on the main
    path's pool and query: B4 and B5 bit-identical, B6 within
    B2_ATOL + B2_RTOL·scale on acc, m and l."""
    import torch
    from repro_torch.core import histogram_topk as ht
    from repro_torch.core import quantization as qz
    from repro_torch.flags import PERF
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.kernels.selection_fused import ops as sf
    s, bs = SERVE["slots"], SERVE["block_size"]
    kv, hd, mb = pool.num_kv_heads, pool.head_dim, pool.max_blocks
    n = mb * bs
    recs = []

    # B4 — at one rank every mapped, stored position is owned and valid
    pos = torch.arange(n, device=dev).reshape(mb, bs)
    blk_valid = (pool.page_table >= 0)[..., None] & (pos[None] < pool.length[:, None, None])
    b4_args = b1_args + (blk_valid,)
    out4 = se.paged_score_bounds(*b4_args, bf16=PERF.bf16_collectives)
    _check_exact("B4", out4, se.paged_score_bounds_plain(*b4_args, bf16=PERF.bf16_collectives))
    qc, pages = b1_args[0], b1_args[6]
    blocks = int(torch.unique(pages).numel())
    b4_bytes = (blocks * bs * kv * (pool.feat_words.shape[-1] * 4 + 8)
                + qc.numel() + 8 * qc.shape[0] * qc.shape[1] * qc.shape[2]
                + 4 * pages.numel() + blk_valid.numel() + 4 * out4[0].numel() + 8 * s * kv)
    b4_ops = 2 * s * kv * qc.shape[2] * mb * bs * qc.shape[-1]
    bms, bby = bound(b4_bytes, b4_ops, "int8")
    recs.append(dict(name="paged_score_bounds", route="cuda",
                     source="src/repro_torch/csrc/score_est.cu",
                     replaces="src/repro/kernels/score_est/kernel.py:164",
                     launches=None, max_abs_err=0.0, tolerance="bit-identical",
                     err_over_tol=0.0,
                     ms=kernel_ms(lambda: se.paged_score_bounds(*b4_args), "paged_score_kernel",
                                  iters),
                     plain_ms=events_ms(lambda: se.paged_score_bounds_plain(*b4_args),
                                        max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None))

    # B5 — halo columns as the one-rank all-reduce leaves them: each block's
    # neighbours' edge bins under the global affine
    sm, lo, hi = out4
    w = params.pool_window
    halo = w // 2
    bins = qz.bins_from_bounds(sm, lo, hi, blk_valid.reshape(s, 1, n)).reshape(s, kv, mb, bs)
    zero = torch.zeros((s, kv, 1, halo), dtype=torch.uint8, device=dev)
    from_left = torch.cat([zero, bins[..., :-1, -halo:]], dim=-2).contiguous()
    from_right = torch.cat([bins[..., 1:, :halo], zero], dim=-2).contiguous()
    force = torch.zeros((s, mb, bs), dtype=torch.bool, device=dev)    # no sink/recent
    b5_args = (sm.reshape(s, kv, mb, bs), lo, hi, from_left, from_right, blk_valid, force)
    out5 = sf.paged_fused_select(*b5_args, window=w)
    _check_exact("B5", out5, sf.paged_fused_select_plain(*b5_args, window=w))
    b5_bytes = (4 * sm.numel() + 8 * s * kv + 2 * from_left.numel() + 2 * blk_valid.numel()
                + out5[0].numel() + 4 * out5[1].numel())
    b5_ops = sm.numel() * (w + 8)        # bin (5 f32 ops), pool (w max), force, count
    bms, bby = bound(b5_bytes, b5_ops, "f32")
    recs.append(dict(name="paged_fused_select", route="cuda",
                     source="src/repro_torch/csrc/selection_fused.cu",
                     replaces="src/repro/kernels/selection_fused/kernel.py:188",
                     launches=None, max_abs_err=0.0, tolerance="bit-identical",
                     err_over_tol=0.0,
                     ms=kernel_ms(lambda: sf.paged_fused_select(*b5_args, window=w),
                                  "paged_fused_select_kernel", iters),
                     plain_ms=events_ms(lambda: sf.paged_fused_select_plain(*b5_args, window=w),
                                        max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None))

    # B6 — partials over the rank-local plan of the selection B5 leads to
    t = ht.locate_threshold(out5[1], params.k)
    keep = out5[0].reshape(s, kv, n) >= t[..., None].to(torch.uint8)
    sel = ht.Selection(*ht.compact_indices(keep, params.k_cap), t)
    pblk, counts, bmask = fd._selected_block_plan(pool, sel, (0, pool.num_blocks))
    h = q.shape[1]
    qr = q.reshape(s * kv, h // kv, hd).contiguous()
    kvargs = (qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk)
    out6 = fd.sparse_flash_decode_paged_partials_kernel(*kvargs, counts, bmask, kv)
    plain6 = fd.sparse_flash_decode_paged_partials_plain(*kvargs, bmask, kv)
    # acc is an unnormalised sum whose terms cancel, so its rounding error
    # scales with sum(p·|v|) (the plain partials over |v|), not with |acc|;
    # m and l do not cancel and scale with themselves
    mag = fd.sparse_flash_decode_paged_partials_plain(*kvargs[:3], kvargs[3].abs(),
                                                      *kvargs[4:], bmask, kv)[0]
    err6, ratio6 = 0.0, 0.0
    for a, b, scale in zip(out6, plain6, (mag, plain6[1].abs(), plain6[2])):
        err6 = max(err6, float((a - b).abs().max()))
        ratio6 = max(ratio6, float(((a - b).abs() / (B2_ATOL + B2_RTOL * scale)).max()))
    acc_vs_abs = float(((out6[0] - plain6[0]).abs()
                        / (B2_ATOL + B2_RTOL * plain6[0].abs())).max())
    if not ratio6 <= 1.0:
        raise AssertionError(f"B6: |kernel - plain| reaches {ratio6:.3g}x its bound "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·scale (max abs err {err6})")
    live = int(counts.sum())
    b6_bytes = (live * bs * (2 * hd + 8) + 2 * qr.numel() * 4 + 8 * qr.shape[0] * qr.shape[1]
                + 4 * counts.numel() + live * (4 + bs))
    bms, bby = bound(b6_bytes, live * bs * (h // kv) * hd * 4, "f32")
    recs.append(dict(name="sparse_flash_decode_paged_partials", route="cuda",
                     source="src/repro_torch/csrc/flash_decode.cu",
                     replaces="src/repro/kernels/flash_decode/kernel.py:276",
                     launches=None, max_abs_err=err6,
                     tolerance=(f"{B2_ATOL:g} + {B2_RTOL:g}*scale; scale = sum(p*|v|) "
                                "for acc, |plain| for m and l"), err_over_tol=ratio6,
                     acc_err_over_abs_plain_tol=acc_vs_abs,
                     ms=kernel_ms(lambda: fd.sparse_flash_decode_paged_partials_kernel(
                         *kvargs, counts, bmask, kv), "sparse_flash_decode_paged_kernel", iters),
                     plain_ms=events_ms(lambda: fd.sparse_flash_decode_paged_partials_plain(
                         *kvargs, bmask, kv), max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None,
                     selected_blocks=live, rows=int(counts.numel())))
    return recs


def check_tiered_kernels(dev, cfg, lengths, iters=20):
    """Phase 3a, B2's and B6's fp16 and int4 branches at the main path's
    shapes, each on a random pool in its mode and the selection the query
    makes over it: B2 within B2_ATOL + B2_RTOL·|plain|, B6 within
    B2_ATOL + B2_RTOL·scale as B6's int8 branch (scale = sum(p·|v|) for acc)."""
    import torch
    from repro_torch.core.quantization import pack_int4, unpack_int4
    from repro_torch.core.selection import (
        _quantized_query_groups, query_heavy_features, select_sparse_pattern_blocked)
    from repro_torch.flags import PERF
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.models.blocks import salca_params_for

    s, mseq, bs = SERVE["slots"], SERVE["max_seq"], SERVE["block_size"]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    params = salca_params_for(cfg, mseq)
    recs = []
    for mode, elem_bytes in (("fp16", 2.0), ("int4", 0.5)):
        gen = torch.Generator(device=dev).manual_seed(3)
        pool = random_pool(dev, gen, cfg, s, mseq, bs, lengths, kv_pool_dtype=mode)
        q = torch.randn((s, h, hd), generator=gen, device=dev)
        qc, qs, qsum = _quantized_query_groups(query_heavy_features(q, pool.heavy_idx, h // kv),
                                               kv)
        scores = se.paged_score_estimate(qc, qs, qsum, pool.feat_words, pool.feat_scale,
                                         pool.feat_zero, pool.clamped_pages(),
                                         bf16=PERF.bf16_collectives)
        sel = select_sparse_pattern_blocked(scores, params, pool.mapped_valid_mask()[:, None, :],
                                            bs)
        qr = q.reshape(s * kv, h // kv, hd).contiguous()
        live_rows = {}
        for partials in (False, True):
            pblk, counts, bmask = fd._selected_block_plan(
                pool, sel, (0, pool.num_blocks) if partials else None)
            ops = (qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk)
            kern = functools.partial(fd.sparse_flash_decode_paged_partials_kernel if partials
                                     else fd.sparse_flash_decode_paged_kernel,
                                     *ops, counts, bmask, kv, mode)
            plain_of = (fd.sparse_flash_decode_paged_partials_plain if partials
                        else fd.sparse_flash_decode_paged_plain)
            plain_fn = functools.partial(plain_of, *ops, bmask, kv, mode)
            got, want = kern(), plain_fn()
            if partials:
                vabs = ops[3].abs() if mode == "fp16" else pack_int4(unpack_int4(ops[3]).abs())
                scales = (plain_of(*ops[:3], vabs, *ops[4:], bmask, kv, mode)[0],
                          want[1].abs(), want[2])
                tol = (f"{B2_ATOL:g} + {B2_RTOL:g}*scale; scale = sum(p*|v|) for acc, "
                       "|plain| for m and l")
            else:
                got, want, scales = (got,), (want,), (want.abs(),)
                tol = f"{B2_ATOL:g} + {B2_RTOL:g}*|plain|"
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ratio = max(float(((a - b).abs() / (B2_ATOL + B2_RTOL * sc)).max())
                        for a, b, sc in zip(got, want, scales))
            name = ("sparse_flash_decode_paged_partials" if partials
                    else "sparse_flash_decode_paged") + f"[{mode}]"
            if not ratio <= 1.0:
                raise AssertionError(f"{name}: |kernel - plain| reaches {ratio:.3g}x its "
                                     f"bound {tol} (max abs err {err})")
            live = int(counts.sum())
            live_rows[partials] = live
            # K and V rows of the selected blocks at the mode's width, one
            # scale word per block for each; q, the outputs, the plan
            nbytes = (live * (2 * bs * hd * elem_bytes + 8) + 2 * qr.numel() * 4
                      + (8 * qr.shape[0] * qr.shape[1] if partials else 0)
                      + 4 * counts.numel() + live * (4 + bs))
            bms, bby = bound(nbytes, live * bs * (h // kv) * hd * 4, "f32")
            recs.append(dict(name=name, route="cuda",
                             source="src/repro_torch/csrc/flash_decode.cu",
                             replaces="src/repro/kernels/flash_decode/kernel.py:"
                                      + ("276" if partials else "207"),
                             launches=None, max_abs_err=err, tolerance=tol,
                             err_over_tol=ratio,
                             ms=kernel_ms(kern, "sparse_flash_decode_paged_kernel", iters),
                             plain_ms=events_ms(plain_fn, max(2, iters // 10)),
                             bound_ms=bms, bound_by=bby, library_ms=None,
                             selected_blocks=live, rows=int(counts.numel())))
        if live_rows[False] != live_rows[True]:
            raise AssertionError(f"{mode}: the one-rank plan lists {live_rows[True]} blocks, "
                                 f"the unsharded plan {live_rows[False]}")
        del pool
    return recs


def check_bin_kernels(dev, iters=50):
    """Phase 3a, B10 (max-pool) and B11 (histogram + threshold), the entry
    points `maxpool_int8` and `hist_threshold` of the reference's public
    kernel API, at (32, 8192) uint8 bins with window 7 and k = 409: each is
    driven once with the launch counts at 0 (no serving path calls them, so
    this drive is their path), then held bit for bit against its plain
    version and timed. Library calls: `max_pool1d` on a float copy (the
    bins are >= 0, so its -inf padding pools as the kernel's zero fill) and
    `bincount` over row-offset bins (the histogram only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.kernels.hist_topk import ops as ht
    from repro_torch.kernels.maxpool import ops as mp
    bh, n, window, k = SERVE["slots"] * 8, SERVE["max_seq"], 7, 409
    bins = torch.randint(0, 256, (bh, n), generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev, dtype=torch.uint8)
    reset_launches()
    pooled = mp.maxpool_int8(bins, window)
    hist, thr = ht.hist_threshold(bins, k)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _check_exact("B10", (pooled,), (mp.maxpool_int8_plain(bins, window),))
    kk = torch.full((bh,), k, dtype=torch.int32, device=dev)
    _check_exact("B11", (hist, thr), ht.hist_threshold_plain(bins, kk))
    xf = bins.float()[:, None]
    offs = (bins.long() + 256 * torch.arange(bh, device=dev)[:, None]).reshape(-1)
    recs = []
    for name, kname, fn, plain, lib, nbytes, ops, replaces, call in (
            ("maxpool_int8", "maxpool_u8_kernel", lambda: mp.maxpool_int8(bins, window),
             lambda: mp.maxpool_int8_plain(bins, window),
             lambda: F.max_pool1d(xf, window, stride=1, padding=window // 2),
             2 * bh * n, bh * n * (window - 1), "src/repro/kernels/maxpool/kernel.py:55",
             "max_pool1d on a float copy of the bins (copy not timed)"),
            ("hist_threshold", "hist_threshold_kernel", lambda: ht.hist_threshold(bins, k),
             lambda: ht.hist_threshold_plain(bins, kk),
             lambda: torch.bincount(offs, minlength=bh * 256),
             bh * n + 4 * bh + 4 * 256 * bh + 4 * bh, bh * n + bh * 256,
             "src/repro/kernels/hist_topk/kernel.py:57",
             "bincount over row-offset bins: the histogram only, no threshold "
             "(offsets not timed)")):
        bms, bby = bound(nbytes, ops, "f32")
        recs.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/selection_fused.cu", replaces=replaces,
                         launches=launches.get(name, 0), max_abs_err=0.0,
                         tolerance="bit-identical", err_over_tol=0.0,
                         ms=kernel_ms(fn, kname, iters),
                         plain_ms=events_ms(plain, max(2, iters // 10)),
                         bound_ms=bms, bound_by=bby, library_ms=events_ms(lib, iters),
                         library_call=call))
    print(f"B10/B11 drive: launches {launches}; thresholds "
          f"{sorted({int(t) for t in thr.tolist()})}", flush=True)
    return recs


def check_small_path(dev, paged: bool, **engine_kw):
    """Phase 3b: the whole serving path on a small input — the port on the
    card against the port's plain versions on the CPU (which the CPU tests
    hold against the JAX reference), through the paged or the contiguous
    engine, with ``engine_kw`` (a pool mode, the host tier). Reduced
    qwen3-0.6b at f32, a sparse selection (k = 128 of 256 positions)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import Request, ServingEngine
    from repro_torch.weights import init_lm_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="float32")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (150, 200, 170)]
    runs = {}
    for d in ("cpu", dev):
        p = params if d == "cpu" else {
            "embed": {k: v.to(d) for k, v in params["embed"].items()},
            "ln_f": {"scale": params["ln_f"]["scale"].to(d)},
            "layers": [_to(layer, d) for layer in params["layers"]]}
        eng = ServingEngine(cfg, p, max_seq=256, slots=2, paged=paged, block_size=32, device=d,
                            **engine_kw)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=5) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        logits = []
        orig = eng._decode

        def rec(*a, orig=orig, logits=logits):
            out = orig(*a)
            logits.append((a[1].copy(), out[1].float().cpu().numpy()))
            return out

        eng._decode = rec
        stats = eng.run()
        runs[d] = ([r.output for r in reqs], logits, stats)
    (tok_c, lg_c, st_c), (tok_g, lg_g, st_g) = runs["cpu"], runs[dev]
    label = f"paged={paged}" + "".join(f", {k}={v}" for k, v in engine_kw.items())
    if tok_c != tok_g:
        raise AssertionError(f"small path ({label}): greedy tokens differ: "
                             f"cpu {tok_c} vs card {tok_g}")
    spill = {}
    if engine_kw.get("host_spill"):
        spill = {k: getattr(st_g, k) for k in ("demotions", "promotions", "pcie_bytes")}
        if not (st_g.demotions > 0 and st_g.promotions > 0) or spill != {
                k: getattr(st_c, k) for k in spill}:
            raise AssertionError(f"small path ({label}): the host tier must demote and "
                                 f"promote, alike on both: card {spill} vs cpu "
                                 f"{ {k: getattr(st_c, k) for k in spill} }")
    gap = max(float(np.abs(a[1][a[0]] - b[1][b[0]]).max()) for a, b in zip(lg_c, lg_g))
    # cuBLAS and the CPU sum in other orders; over ~500 stored tokens a
    # last-ulp difference in K/V can move one int8 / 2-bit code by one step
    # (the CPU tests see 3.3e-5 against JAX for the same reason). The card
    # read 1.28e-4 in every run; the limit leaves 2.3x of headroom.
    if not gap <= SMALL_PATH_LOGIT_TOL:
        raise AssertionError(f"small path ({label}): max logits gap {gap} > "
                             f"{SMALL_PATH_LOGIT_TOL:g}")
    return {"paged": paged, **engine_kw, "tokens_identical": True, "max_logit_gap": gap,
            "ticks": len(lg_g), **spill}


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev)) for k, v in tree.items()}


def main_path_model(dev):
    """The main path's model: full-width qwen3-0.6b, random bf16 weights
    from seed 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.weights import init_lm_params
    cfg = get_config("qwen3-0.6b")
    return cfg, init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def main_path_requests(vocab_size: int):
    """The main path's requests: prompts of PROMPTS tokens drawn from seed
    0, NEW_TOKENS new tokens each."""
    from repro_torch.runtime.serve import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab_size, n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS) for i, n in enumerate(PROMPTS)]


def serve_main_path(dev, ctx=None, paged=True, force=None, probe=None, **engine_kw):
    """Phase 4: full-width qwen3-0.6b through the port's engine — the paged
    unsharded tick, with ``ctx`` the block-sharded tick, with ``paged=False``
    the contiguous tick; ``engine_kw`` adds the tiered pool's knobs
    (``kv_pool_dtype``, ``host_spill``, ...). ``force`` ({rid: tokens})
    feeds the engine those tokens in place of its own picks (teacher
    forcing); ``probe`` (a `SpillProbe`) is installed on the engine before
    the run and checks it after. Returns the launch counts of the run, its
    summary, the engine's own greedy picks per request and, for every
    generated token (request, index), the logits row it was drawn from, on
    the host (index 0: the prefill's row)."""
    import gc

    import torch
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.runtime.serve import Request, ServingEngine
    gc.collect()              # an earlier run's engine (its hooks form a cycle)
    torch.cuda.empty_cache()
    cfg, params = main_path_model(dev)
    serve = dict(SERVE, paged=paged, **engine_kw)

    # warm-up on a separate engine (module loading, cuBLAS handles, the
    # communicator of the first all-reduce)
    warm = ServingEngine(cfg, params, device=dev, ctx=ctx, **serve)
    warm.submit(Request(rid=-1, prompt=np.random.default_rng(1).integers(
        0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=2))
    warm.run()
    del warm
    torch.cuda.synchronize()

    engine = ServingEngine(cfg, params, device=dev, ctx=ctx, **serve)
    reqs = main_path_requests(cfg.vocab_size)
    for r in reqs:
        engine.submit(r)
    ticks, rows, own = [], {}, {}
    orig_decode, orig_prefill, orig_next = engine._decode, engine._prefill, engine._next_token

    def decode(*a):
        who = [(slot, req.rid, len(req.output)) for slot, req in engine._active.items()]
        nxt, logits = orig_decode(*a)
        # to pinned host memory, ready when the engine reads ``nxt``
        ticks.append((who, logits.to("cpu", non_blocking=True)))
        return nxt, logits

    def prefill(req):
        row, st = orig_prefill(req)
        rows[(req.rid, 0)] = torch.from_numpy(row)
        return row, st

    def next_token(req, tok):
        own[(req.rid, len(req.output))] = tok
        return orig_next(req, tok if force is None else force[req.rid][len(req.output)])

    engine._decode, engine._prefill, engine._next_token = decode, prefill, next_token
    if probe is not None:
        probe.install(engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    stats = engine.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert stats.completed == len(PROMPTS), stats.summary()
    assert all(len(r.output) == NEW_TOKENS and r.stop_reason == "length" for r in reqs)
    assert stats.decode_calls == stats.ticks > 0, stats.summary()
    for who, logits in ticks:
        for slot, rid, j in who:
            rows[(rid, j)] = logits[slot]
    assert all(bool(torch.isfinite(r).all()) for r in rows.values()), \
        "non-finite logits on the main path"
    nl = cfg.num_layers
    branch = {"int8": ""}.get(engine_kw.get("kv_pool_dtype", "int8"),
                              f"[{engine_kw.get('kv_pool_dtype')}]")
    if not paged:
        tick_kernels = ("score_estimate", "fused_bin_pool_threshold", "sparse_flash_decode")
    elif ctx is None:
        tick_kernels = ("paged_score_estimate", "sparse_flash_decode_paged" + branch)
    else:
        tick_kernels = ("paged_score_bounds", "paged_fused_select",
                        "sparse_flash_decode_paged_partials" + branch)
    want = {k: nl * stats.ticks for k in tick_kernels}
    want["flash_prefill"] = nl * stats.admissions
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    vocab_ok = all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
    assert vocab_ok, "sampled a token outside the vocabulary"
    summary = stats.summary()
    if probe is not None:
        summary.update(probe.finish(engine))
    summary.update(wall_s=wall, peak_mem_gb=peak,
                   ttft_s=[r.ttft_s for r in reqs], prompts=list(PROMPTS),
                   launches_per_tick={k: launches[k] / stats.ticks for k in tick_kernels})
    picks = [[own[(r.rid, j)] for j in range(len(r.output))] for r in reqs]
    return launches, summary, picks, rows


class SpillProbe:
    """Instruments the int4 + host-spill run of phase 4 and checks it.

    * Round trip: before the first tick, the oldest block of the longest
      resident request is read (every layer's rows, on the card), demoted,
      promoted back into a fresh block and read again: the two reads must
      be equal bit for bit.
    * Histogram: with random weights every tick selects tokens in every
      block (28 layers × 8 kv heads per slot), so no block goes cold by
      itself. As in the reference's spill test, the reader reports the
      first ``COLD`` logical blocks of every slot unselected (the real
      reader still runs and syncs); the policy then demotes those of them
      that are resident, and the promotion pass brings back the spilled
      blocks with the highest counts.
    * After the run: wave admission happened, demotions by pressure and by
      policy and at least one promotion happened, ``pcie_bytes`` equals
      (demotions + promotions) × the block bytes, every request ended with
      ``length`` and no overflow, and the pool drained (all blocks free,
      refcounts 0, no spilled payload left, every layer's invariants).
    """
    COLD = 8

    def install(self, eng) -> None:
        import torch
        # demotions by cause; wave admissions
        self.events = {"pressure": 0, "policy": 0, "wave": 0, "wave_admissions": 0}
        self.hist_s, self.hist_calls = 0.0, 0
        self.roundtrip = None
        real_hist, real_policy = eng._sel_hist_fn, eng._spill_policy
        real_demote, real_install, real_tick = eng.demote_block, eng._install_prompt, eng._tick
        real_streaks = eng._update_cold_streaks
        phase = {"now": "pressure"}

        def hist(state):
            h = real_hist(state).clone()
            h[:, :self.COLD] = 0
            return h

        def streaks():      # the policy's per-tick histogram read and sync
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_streaks()
            self.hist_s += time.perf_counter() - t0
            self.hist_calls += 1

        def demote(slot, logical):
            self.events[phase["now"]] += 1
            return real_demote(slot, logical)

        def policy():
            phase["now"] = "policy"
            real_policy()
            phase["now"] = "pressure"

        def install(slot, need, state1):
            if need > eng._alloc.total_free:          # the prompt admits in waves
                self.events["wave_admissions"] += 1
                phase["now"] = "wave"
            real_install(slot, need, state1)
            phase["now"] = "pressure"

        def tick():
            if self.roundtrip is None:
                self.roundtrip = self._roundtrip(eng, real_demote)
            real_tick()

        eng._sel_hist_fn, eng._spill_policy, eng.demote_block = hist, policy, demote
        eng._install_prompt, eng._tick, eng._update_cold_streaks = install, tick, streaks

    @staticmethod
    def _roundtrip(eng, demote) -> dict:
        import torch
        slot = max(eng._active, key=lambda s: eng._slot_pos[s])
        logical = next(j for j, b in enumerate(eng._slot_blocks[slot]) if b >= 0)
        before = [[t.clone() for t in rows]
                  for rows in eng.api.read_block(eng._state, eng._slot_blocks[slot][logical])]
        demote(slot, logical)
        if not eng.promote_block(slot, logical):
            raise AssertionError("round trip: no block free to promote into")
        after = eng.api.read_block(eng._state, eng._slot_blocks[slot][logical])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for ra, rb in zip(before, after) for a, b in zip(ra, rb))
        if not same:
            raise AssertionError(f"round trip of block ({slot}, {logical}) is not bit-exact")
        return {"slot": slot, "logical": logical, "bit_exact": True,
                "bytes": eng._block_bytes}

    def finish(self, eng) -> dict:
        st = eng.stats
        ev = self.events
        if not (ev["wave_admissions"] >= 1 and ev["pressure"] >= 1 and ev["policy"] >= 1
                and st.promotions >= 1):
            raise AssertionError(f"host tier: wave admission, pressure and policy demotion "
                                 f"and a promotion must all happen; got {ev}, "
                                 f"{st.promotions} promotions")
        if st.pcie_bytes != (st.demotions + st.promotions) * eng._block_bytes:
            raise AssertionError(f"pcie_bytes {st.pcie_bytes} != (demotions + promotions) "
                                 f"× {eng._block_bytes}")
        if st.overflows:
            raise AssertionError(f"{st.overflows} overflow stops with the host tier on")
        free = sorted(eng._free_blocks)
        if free != list(range(eng.num_blocks)) or eng._refcount.sum() or eng._spilled:
            raise AssertionError("the pool did not drain: leaked blocks or spilled payloads")
        for pool in eng._state.caches:
            rep = pool.check_invariants(free_blocks=free, host_refcount=eng._refcount)
            if not rep.ok:
                raise AssertionError(f"pool invariants after the run: {rep.violations}")
        return {"spill_events": dict(ev), "roundtrip": self.roundtrip,
                "block_bytes": eng._block_bytes,
                "cold_streak_update_ms_per_tick": 1e3 * self.hist_s / max(self.hist_calls, 1)}


def first_divergence(a: list, b: list):
    """(request, step) of the first token where two runs' outputs differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return i, j
        if len(x) != len(y):
            return i, min(len(x), len(y))
    return None


def bf16_ulp(row) -> float:
    """One bf16 ulp of a logits row's top logit, 2^(floor(log2|top|) - 7):
    the unit of the gaps that decide the greedy token."""
    import torch
    return 2.0 ** (torch.frexp(row.float().max()).exponent.item() - 8)


def check_contiguous_logits(tokens, trace, picks_c, trace_c) -> dict:
    """The contiguous run, fed the paged run's tokens, against the paged
    run. Both ticks select the same tokens and their attention differs only
    in summation order, so for every request and every step (the same
    history on both) the two logits rows must agree within
    CONTIG_LOGIT_ULPS bf16 ulps of the paged row's top logit. Where the two
    greedy picks part, the paged run's top-two gap is printed; it is at
    most twice the rows' difference, so the check holds it to a near-tie.
    Returns the largest difference per request, in ulps."""
    worst = {}
    for i, x in enumerate(tokens):
        most, parts = 0.0, []
        for j in range(len(x)):
            a, b = trace[(i, j)].float(), trace_c[(i, j)].float()
            ulp = bf16_ulp(a)
            d = float((a - b).abs().max()) / ulp
            if not d <= CONTIG_LOGIT_ULPS:
                raise AssertionError(
                    f"contiguous vs paged: request {i}, generated token {j}: logits differ "
                    f"by {d:.3g} bf16 ulps of the top logit > {CONTIG_LOGIT_ULPS}")
            most = max(most, d)
            if picks_c[i][j] != x[j]:
                top2 = a.topk(2).values
                parts.append(f"token {j} ({x[j]} vs {picks_c[i][j]}; paged top-two gap "
                             f"{float(top2[0] - top2[1]) / ulp:.3g} ulps)")
        worst[i] = most
        print(f"contiguous vs paged, request {i}: logits within {most:.3g} bf16 ulps over "
              f"{len(x)} steps; greedy picks part at "
              f"{', '.join(parts) if parts else 'no step'}", flush=True)
    return worst


def print_serve(label: str, summary: dict) -> None:
    print(f"serve qwen3-0.6b {label}: ms/tick={summary['decode_ms_per_tick']:.2f} "
          f"decode tok/s={summary['decode_tokens_per_s']:.1f} "
          f"mean TTFT s={summary['mean_ttft_s']:.3f} prefill_s={summary['prefill_s']:.3f} "
          f"peak mem GB={summary['peak_mem_gb']:.2f} "
          f"launches/tick={json.dumps(summary['launches_per_tick'])}", flush=True)
    print(f"serve stats {label}: {json.dumps(summary)}", flush=True)


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_decode_ctx
    from repro_torch.kernels import common

    dev = "cuda"
    print(gpu_line(), flush=True)                                          # phase 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    secs = common.build_kernels()                                          # phase 2
    print(f"build: {secs:.1f} s", flush=True)
    for name, log in common.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    cfg = get_config("qwen3-0.6b")                                         # phase 3
    lengths = [n + NEW_TOKENS for n in PROMPTS]
    recs = check_kernels(dev, cfg, lengths=lengths, prompt_len=max(PROMPTS))
    recs += check_flat_kernels(dev, cfg, lengths=lengths)
    recs += check_tiered_kernels(dev, cfg, lengths=lengths)
    recs += check_bin_kernels(dev)
    for r in recs:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"(tolerance {r['tolerance']}; {r['err_over_tol']:.3g} of it) "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']})", flush=True)
    for paged, kw in ((True, {}), (False, {}), (True, {"kv_pool_dtype": "fp16"}),
                      (True, SMALL_SPILL)):
        small = check_small_path(dev, paged, **kw)
        print(f"small path (card vs plain on CPU): {json.dumps(small)}", flush=True)

    launches, summary, tokens, trace = serve_main_path(dev)                # phase 4
    print_serve("paged", summary)
    ctx = init_decode_ctx(dev)
    launches_sh, summary_sh, tokens_sh, _ = serve_main_path(dev, ctx)
    print_serve("paged sharded (one rank, nccl)", summary_sh)
    where = first_divergence(tokens, tokens_sh)
    if where is not None:
        i, j = where
        raise AssertionError(f"sharded run diverges from the unsharded run at request {i}, "
                             f"generated token {j}: {tokens[i][j:j + 1]} vs "
                             f"{tokens_sh[i][j:j + 1]}")
    print("sharded vs unsharded greedy tokens: identical", flush=True)
    launches_c, summary_c, picks_c, trace_c = serve_main_path(
        dev, paged=False, force=dict(enumerate(tokens)))
    print_serve("contiguous (teacher-forced on the paged run's tokens)", summary_c)
    worst = check_contiguous_logits(tokens, trace, picks_c, trace_c)
    print(f"contiguous vs paged: every logits row within {max(worst.values()):.3g} bf16 ulps "
          f"(limit {CONTIG_LOGIT_ULPS})", flush=True)
    # the tiered pool: fp16 and int4 pools, each unsharded and block-sharded
    # (tokens must agree), then int4 with the host tier on a small pool
    runs = {"int8": launches, "int8 sharded": launches_sh, "contiguous": launches_c}
    for mode in ("fp16", "int4"):
        runs[mode], summary_m, tokens_m, _ = serve_main_path(dev, kv_pool_dtype=mode)
        print_serve(f"paged {mode}", summary_m)
        runs[f"{mode} sharded"], summary_ms, tokens_ms, _ = serve_main_path(
            dev, ctx, kv_pool_dtype=mode)
        print_serve(f"paged {mode} sharded (one rank, nccl)", summary_ms)
        if first_divergence(tokens_m, tokens_ms) is not None:
            raise AssertionError(f"{mode}: the sharded run's tokens differ from the paged "
                                 f"run's at (request, token) {first_divergence(tokens_m, tokens_ms)}")
        print(f"{mode}: sharded vs unsharded greedy tokens: identical", flush=True)
    runs["int4 spill"], summary_sp, _, _ = serve_main_path(dev, probe=SpillProbe(), **SPILL_RUN)
    print_serve(f"paged int4 + host spill {json.dumps(SPILL_RUN)}", summary_sp)
    # each kernel's launches on the run of its path (B10/B11: their phase-3 drive)
    home = {"sparse_flash_decode_paged[fp16]": "fp16",
            "sparse_flash_decode_paged_partials[fp16]": "fp16 sharded",
            "sparse_flash_decode_paged[int4]": "int4 spill",
            "sparse_flash_decode_paged_partials[int4]": "int4 sharded",
            "paged_score_bounds": "int8 sharded", "paged_fused_select": "int8 sharded",
            "sparse_flash_decode_paged_partials": "int8 sharded",
            "score_estimate": "contiguous", "fused_bin_pool_threshold": "contiguous",
            "sparse_flash_decode": "contiguous"}
    for r in recs:
        if r["name"] not in ("maxpool_int8", "hist_threshold"):
            r["launches"] = runs[home.get(r["name"], "int8")].get(r["name"], 0)
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on its main path")
    print(json.dumps({"kernels": recs}), flush=True)
    dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
