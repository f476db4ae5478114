"""Heavy-channel identification (paper §3.1), per KV head.

Port of the reference `core/heavy_channels.py`. `lax.top_k` breaks ties
toward the lower index; a stable descending sort does the same, which
`torch.topk` does not promise.
"""

from __future__ import annotations

import torch


def channel_salience(keys: torch.Tensor) -> torch.Tensor:
    """``S_j = Σ_i |key[i, j]|``: keys (..., N, d) → (..., d) f32."""
    return keys.float().abs().sum(dim=-2)


def top_channels(salience: torch.Tensor, r: int) -> torch.Tensor:
    """Indices of the r largest entries along the last dim (ties → lower
    index), sorted ascending, int32."""
    order = torch.sort(salience, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :r], dim=-1).values.to(torch.int32)


def heavy_channel_indices(keys: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r channel set of keys (..., N, d) → (..., r) int32, ascending."""
    return top_channels(channel_salience(keys), r)
