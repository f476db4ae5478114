"""Kernels B5 and B9: fused binning, max-pool and histogram, and their
plain PyTorch versions.

B5 replaces `repro/kernels/selection_fused/kernel.py::paged_fused_select_pallas`.
Phases 2-3 of the block-sharded tick up to the threshold: INT8 binning with
the GLOBAL (all-reduced) bounds, a stride-1 max-pool per block with the
neighbours' edge bins supplied as halo columns, sink/recent forcing to 255
and the raw 256-bin histogram. The threshold is located by the caller after
the histogram's all-reduce.

B9 replaces `fused_bin_pool_threshold_pallas`: phases 2-3 of the contiguous
tick over flat (BH, N) scores — binning with the given (lo, hi) and a
length mask, a stride-1 max-pool along the row, the 256-bin histogram and
the threshold. One CTA per row reads the scores below the row's length
only, writes the histogram whole and scans its own threshold, so a call is
one launch: no output is zeroed beforehand.

CUDA source of both: ``repro_torch/csrc/selection_fused.cu``; their outputs
are bit-identical to the plain versions below.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.histogram_topk import histogram256, locate_threshold
from repro_torch.core.maxpool import maxpool1d_blocked_halo, maxpool1d_direct
from repro_torch.kernels import common

_EPS = 1e-6


def paged_fused_select_plain(scores, lo, hi, from_left, from_right, blk_valid, force,
                             window: int = 7):
    """Plain version (mirrors the reference `paged_fused_select_ref`):
    `bins_from_bounds` → `maxpool1d_blocked_halo` → force → `histogram256`."""
    s, kv, mb, bs = scores.shape
    valid = blk_valid[:, None]                                  # (S, 1, MB, BS)
    bins = qz.bins_from_bounds(scores.reshape(s, kv, mb * bs), lo, hi,
                               valid.reshape(s, 1, mb * bs))
    blocked = bins.reshape(s, kv, mb, bs)
    if window > 1:
        pooled = maxpool1d_blocked_halo(blocked, window, from_left, from_right)
        pooled = torch.where(valid, pooled, torch.zeros_like(pooled))
    else:
        pooled = blocked
    pooled = torch.where(force[:, None] & valid, torch.full_like(pooled, 255), pooled)
    return pooled, histogram256(pooled.reshape(s, kv, mb * bs))


def paged_fused_select(scores, lo, hi, from_left, from_right, blk_valid, force,
                       window: int = 7):
    """scores (S, KV, MB, BS) f32 (sentinel-masked); lo/hi (S, KV) f32 global
    bounds; from_left/from_right (S, KV, MB, window//2) uint8 halo bins (any
    width when ``window`` is 1); blk_valid/force (S, MB, BS) bool → (pooled
    (S, KV, MB, BS) uint8, hist (S, KV, 256) int32). CPU tensors take the
    plain version; CUDA tensors launch kernel B5."""
    if scores.device.type == "cpu":
        return paged_fused_select_plain(scores, lo, hi, from_left, from_right, blk_valid,
                                        force, window)
    s, kv, mb, bs = scores.shape
    dev = scores.device
    halo = window // 2
    if window > 1 and (window % 2 == 0 or halo > bs):
        raise ValueError(f"window {window}: must be odd with window//2 <= block size {bs}")
    common.require(scores, "scores", torch.float32, (s, kv, mb, bs), dev)
    common.require(lo, "lo", torch.float32, (s, kv), dev)
    common.require(hi, "hi", torch.float32, (s, kv), dev)
    if window > 1:
        common.require(from_left, "from_left", torch.uint8, (s, kv, mb, halo), dev)
        common.require(from_right, "from_right", torch.uint8, (s, kv, mb, halo), dev)
    common.require(blk_valid, "blk_valid", torch.bool, (s, mb, bs), dev)
    common.require(force, "force", torch.bool, (s, mb, bs), dev)
    pooled = torch.empty((s, kv, mb, bs), dtype=torch.uint8, device=dev)
    hist = torch.zeros((s, kv, 256), dtype=torch.int32, device=dev)
    fn = common.load("selection_fused", "paged_fused_select",
                     [common.P] * 9 + [common.I] * 5 + [common.P])
    err = fn(scores.data_ptr(), lo.data_ptr(), hi.data_ptr(), from_left.data_ptr(),
             from_right.data_ptr(), blk_valid.data_ptr(), force.data_ptr(),
             pooled.data_ptr(), hist.data_ptr(), s, kv, mb, bs, halo,
             common.stream_ptr(pooled))
    common.check(err, "paged_fused_select")
    common.LAUNCHES["paged_fused_select"] += 1
    return pooled, hist


def fused_bin_pool_threshold_plain(scores, lo, hi, k, lengths, window: int = 7):
    """Plain version of B9 (mirrors the reference `fused_bin_pool_threshold_ref`)."""
    bh, n = scores.shape
    scale = torch.clamp_min(qz.div_const(hi - lo, 254.0), _EPS)
    valid = torch.arange(n, device=scores.device)[None, :] < lengths[:, None]
    bins = torch.clamp(torch.round((scores - lo[:, None]) / scale[:, None]) + 1.0, 1.0, 255.0)
    bins = torch.where(valid, bins, torch.zeros_like(bins)).to(torch.uint8)
    pooled = maxpool1d_direct(bins, window) if window > 1 else bins
    pooled = torch.where(valid, pooled, torch.zeros_like(pooled))
    hist = histogram256(pooled)
    return pooled, hist, locate_threshold(hist, k)


def fused_bin_pool_threshold(scores, lo, hi, k, lengths, window: int = 7):
    """scores (BH, N) f32; lo/hi (BH,) f32 (``lo`` used raw as the binning
    offset); k/lengths (BH,) int32; odd ``window`` → (pooled bins (BH, N)
    uint8, hist (BH, 256) int32, threshold (BH,) int32). CPU tensors take
    the plain version; CUDA tensors launch kernel B9."""
    if scores.device.type == "cpu":
        return fused_bin_pool_threshold_plain(scores, lo, hi, k, lengths, window)
    bh, n = scores.shape
    dev = scores.device
    halo = window // 2
    if window < 1 or window % 2 == 0 or halo > 1024:
        raise ValueError(f"window {window}: must be odd, 1 <= window <= 2049")
    common.require(scores, "scores", torch.float32, (bh, n), dev)
    common.require(lo, "lo", torch.float32, (bh,), dev)
    common.require(hi, "hi", torch.float32, (bh,), dev)
    common.require(k, "k", torch.int32, (bh,), dev)
    common.require(lengths, "lengths", torch.int32, (bh,), dev)
    pooled = torch.empty((bh, n), dtype=torch.uint8, device=dev)
    hist = torch.empty((bh, 256), dtype=torch.int32, device=dev)
    thr = torch.empty((bh,), dtype=torch.int32, device=dev)
    fn = common.load("selection_fused", "fused_bin_pool_threshold",
                     [common.P] * 8 + [common.I] * 3 + [common.P])
    err = fn(scores.data_ptr(), lo.data_ptr(), hi.data_ptr(), k.data_ptr(),
             lengths.data_ptr(), pooled.data_ptr(), hist.data_ptr(), thr.data_ptr(),
             bh, n, halo, common.stream_ptr(pooled))
    common.check(err, "fused_bin_pool_threshold")
    common.LAUNCHES["fused_bin_pool_threshold"] += 1
    return pooled, hist, thr
