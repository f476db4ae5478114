"""Kernel B11: the 256-bin histogram of uint8 score bins and its Top-K
threshold, and their plain PyTorch version.

B11 replaces `repro/kernels/hist_topk/kernel.py::hist_threshold_pallas`,
which the reference's public kernel API reaches as
`repro.kernels.hist_threshold`: per row of (BH, N) bins, the histogram and
the largest bin whose reverse cumulative count reaches k (never below 1).
Integer counts, so the kernel equals the plain version bit for bit. No
serving path calls it (the ticks count inside kernels B5 and B9).

CUDA source: ``repro_torch/csrc/selection_fused.cu``
(``hist_threshold_kernel``: shared-memory histograms per run of 1024
positions, added into the row's histogram by atomics; the row's last CTA,
by an atomic ticket, scans the threshold).
"""

from __future__ import annotations

import torch

from repro_torch.core.histogram_topk import histogram256, locate_threshold
from repro_torch.kernels import common


def hist_threshold_plain(bins: torch.Tensor, k: torch.Tensor):
    """Plain version (the reference's `hist_threshold_ref`)."""
    hist = histogram256(bins)
    return hist, locate_threshold(hist, k)


def hist_threshold(bins: torch.Tensor, k):
    """bins (BH, N) uint8, k an int or (BH,) → (hist (BH, 256) int32,
    threshold (BH,) int32). CPU tensors take the plain version; CUDA
    tensors launch kernel B11."""
    bh, n = bins.shape
    k = torch.as_tensor(k, dtype=torch.int32, device=bins.device).expand(bh).contiguous()
    if bins.device.type == "cpu":
        return hist_threshold_plain(bins, k)
    common.require(bins, "bins", torch.uint8, (bh, n), bins.device)
    hist = torch.zeros((bh, 256), dtype=torch.int32, device=bins.device)
    thr = torch.empty((bh,), dtype=torch.int32, device=bins.device)
    ticket = torch.zeros((bh,), dtype=torch.int32, device=bins.device)
    fn = common.load("selection_fused", "hist_threshold", [common.P] * 5 + [common.I] * 2
                     + [common.P])
    err = fn(bins.data_ptr(), k.data_ptr(), hist.data_ptr(), thr.data_ptr(),
             ticket.data_ptr(), bh, n, common.stream_ptr(hist))
    common.check(err, "hist_threshold")
    common.LAUNCHES["hist_threshold"] += 1
    return hist, thr
