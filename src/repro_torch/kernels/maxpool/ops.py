"""Kernel B10: stride-1 windowed max over uint8 score bins, and its plain
PyTorch version.

B10 replaces `repro/kernels/maxpool/kernel.py::maxpool_pallas`, which the
reference's public kernel API reaches as `repro.kernels.maxpool_int8`: row r
of (BH, N) bins pools ``window`` (odd) neighbours, zero past the row's
ends. Max is exact, so the kernel equals the plain version bit for bit.
No serving path calls it (the ticks pool inside kernels B5 and B9).

CUDA source: ``repro_torch/csrc/selection_fused.cu``: a thread per 16 B
vector of a row, 256 per CTA; windows up to 33 pool in registers
(``maxpool_u8_kernel``: halo words by shuffles, byte-wise max on words),
wider ones by doubling over a uint8 stage in shared memory
(``maxpool_u8_wide_kernel``, log2(window) steps). The output is allocated
16 B-aligned as the input is, so both move in whole 16 B vectors.
"""

from __future__ import annotations

import torch

from repro_torch.core.maxpool import maxpool1d_direct
from repro_torch.kernels import common


def maxpool_int8_plain(bins: torch.Tensor, window: int) -> torch.Tensor:
    """Plain version (the reference's `maxpool_int8_ref`): the direct window max."""
    return maxpool1d_direct(bins, window)


def maxpool_int8(bins: torch.Tensor, window: int) -> torch.Tensor:
    """bins (BH, N) uint8 → pooled (BH, N) uint8, stride 1, odd ``window``
    (1 returns ``bins``, as the reference does). CPU tensors take the plain
    version; CUDA tensors launch kernel B10."""
    if window == 1:
        return bins
    if window < 3 or window % 2 == 0 or window // 2 > 1024:
        raise ValueError(f"window {window}: must be odd, 3 <= window <= 2049")
    if bins.device.type == "cpu":
        return maxpool_int8_plain(bins, window)
    bh, n = bins.shape
    common.require(bins, "bins", torch.uint8, (bh, n), bins.device)
    # the output rows start at the input rows' offset from a 16 B boundary
    skew = bins.data_ptr() % 16
    out = torch.empty((bh * n + 16,), dtype=torch.uint8, device=bins.device)
    out = out[(skew - out.data_ptr()) % 16:][:bh * n].view(bh, n)
    fn = common.load("selection_fused", "maxpool_u8", [common.P] * 2 + [common.I] * 3
                     + [common.P])
    err = fn(bins.data_ptr(), out.data_ptr(), bh, n, window // 2, common.stream_ptr(out))
    common.check(err, "maxpool_int8")
    common.LAUNCHES["maxpool_int8"] += 1
    return out
