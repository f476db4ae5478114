"""Stride-1 windowed max-pooling over uint8 score bins (paper §3.2).

Port of the reference `core/maxpool.py` for the paged path. Out-of-range
neighbours contribute the dtype's minimum (0 for uint8), like a hardware
shift register that clamps. Max is exact, so the block-decomposed form
with halo columns equals the flat form over the page-order axis; this port
computes it on that axis directly.
"""

from __future__ import annotations

import torch


def maxpool1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """Windowed max along the last dim of integer data; ``window`` odd ≥ 1."""
    if window == 1:
        return x
    assert window % 2 == 1 and window >= 3, f"window must be odd ≥3, got {window}"
    h = window // 2
    n = x.shape[-1]
    edge = x.new_full(x.shape[:-1] + (h,), torch.iinfo(x.dtype).min)
    padded = torch.cat([edge, x, edge], dim=-1)
    out = padded[..., 0:n]
    for off in range(1, window):
        out = torch.maximum(out, padded[..., off:off + n])
    return out


def maxpool1d_blocked(x: torch.Tensor, window: int) -> torch.Tensor:
    """Windowed max over block-decomposed data x (..., nb, bs) in page order,
    identical to pooling the flattened (..., nb·bs) axis."""
    if window == 1:
        return x
    assert window // 2 <= x.shape[-1], "halo exceeds block size"
    flat = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
    return maxpool1d(flat, window).reshape(x.shape)


def maxpool1d_blocked_halo(x: torch.Tensor, window: int, from_left: torch.Tensor,
                           from_right: torch.Tensor) -> torch.Tensor:
    """`maxpool1d_blocked` with the neighbour halos supplied explicitly:
    x (..., nb, bs); from_left/from_right (..., nb, window//2) — the edge
    columns of each block's logical neighbours (the block-sharded tick
    psums them across ranks first). Each block pools on its own."""
    if window == 1:
        return x
    halo = window // 2
    padded = torch.cat([from_left.to(x.dtype), x, from_right.to(x.dtype)], dim=-1)
    return maxpool1d(padded, window)[..., halo:-halo]
