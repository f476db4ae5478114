"""Stride-1 windowed max-pooling over uint8 score bins (paper §3.2).

Port of the reference `core/maxpool.py`. Out-of-range neighbours
contribute the dtype's minimum (0 for uint8), like a hardware shift
register that clamps. Max is exact, so every form below gives the same
values: the multi-level reuse recurrence (`maxpool1d_reuse`), the direct
window max (`maxpool1d_direct`, the oracle of the reuse form and of kernel
B9), and the block-decomposed forms of the paged path, which pool the
page-order axis with the direct form (fewer launches than the recurrence).
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x`` shifted by ``offset`` along the last dim, vacated slots at the
    dtype's minimum: out[n] = x[n - offset]."""
    if offset == 0:
        return x
    n = x.shape[-1]
    fill = x.new_full(x.shape[:-1] + (min(abs(offset), n),), torch.iinfo(x.dtype).min)
    if offset > 0:
        return torch.cat([fill, x[..., :n - offset]], dim=-1)
    return torch.cat([x[..., -offset:], fill], dim=-1)


def maxpool1d_reuse(x: torch.Tensor, window: int) -> torch.Tensor:
    """Stride-1 windowed max along the last dim by the reuse recurrence
    mp(3, n) = max(x[n-1], x[n], x[n+1]), mp(r, n) = max(mp(r-2, n-1),
    mp(r-2, n+1)); integer data, ``window`` odd ≥ 1."""
    if window == 1:
        return x
    assert window % 2 == 1 and window >= 3, f"window must be odd ≥3, got {window}"
    out = torch.maximum(torch.maximum(_shift(x, 1), x), _shift(x, -1))
    for _ in range((window - 3) // 2):
        out = torch.maximum(_shift(out, 1), _shift(out, -1))
    return out


def maxpool1d_direct(x: torch.Tensor, window: int) -> torch.Tensor:
    """Windowed max along the last dim of integer data, one shifted copy per
    offset; ``window`` odd ≥ 1."""
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
    return maxpool1d_direct(flat, window).reshape(x.shape)


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
    return maxpool1d_direct(padded, window)[..., halo:-halo]
