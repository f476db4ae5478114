"""HBM channel-conflict simulator and reorder-based elimination (paper
§4.3.2, Table 1).

Port of the reference `core/conflict_sim.py` in numpy: the same draws from
the same seeds, so the same ratios. It models the paper's scheme: indices
map to pseudo-channels (PCs) by their low bits; a reorder window of R
requests is sorted by PC; each PC then drains its cluster one request per
cycle. The window completes in ``max_count`` cycles against the ideal
``R / chn``, so the conflict ratio is

    α(R) = E[max_count] / (R / chn)

`conflict_table` gives the paper's Table 1 (range 8→256 ⇒ α 2.18→1.09),
with uniform random indices or Salca-like *run-structured* ones (max-pooling
selects runs of neighbouring tokens, and consecutive token indices stride
across PCs). It is an analysis of the paper's ASIC: no GPU exposes its HBM
pseudo-channels to software.
"""

from __future__ import annotations

import numpy as np


def map_to_channels(indices: np.ndarray, chn: int = 8) -> np.ndarray:
    """Low-bits PC mapping (the paper uses the 3 LSBs for 8 PCs)."""
    return indices & (chn - 1)


def run_structured_indices(rng: np.ndarray, total: int, n: int,
                           mean_run: float = 5.0) -> np.ndarray:
    """Sample selection indices as runs of consecutive tokens (pooled Top-K)."""
    out, have = [], 0
    while have < total:          # the reference's draws, its total kept as it grows
        start = int(rng.integers(0, n))
        run = 1 + int(rng.geometric(1.0 / mean_run))
        out.append(np.arange(start, min(start + run, n)))
        have += len(out[-1])
    return np.concatenate(out)[:total]


def conflict_ratio(indices: np.ndarray, reorder_range: int, chn: int = 8) -> float:
    """Average α over windows of `reorder_range` requests."""
    nwin = len(indices) // reorder_range
    if nwin == 0:
        raise ValueError("not enough indices for one window")
    ch = map_to_channels(indices[: nwin * reorder_range], chn)
    ch = ch.reshape(nwin, reorder_range)
    # After reordering, each window takes max-per-channel-count cycles.
    counts = np.stack([(ch == c).sum(axis=1) for c in range(chn)], axis=1)
    cycles = counts.max(axis=1)
    ideal = reorder_range / chn
    return float(cycles.mean() / ideal)


def conflict_table(ranges=(8, 16, 32, 64, 128, 256), chn: int = 8,
                   n: int = 65536, total: int = 1 << 18, seed: int = 0,
                   structured: bool = True) -> dict[int, float]:
    """Reproduce paper Table 1. `structured=True` uses pooled-run indices."""
    rng = np.random.default_rng(seed)
    if structured:
        idx = run_structured_indices(rng, total, n)
    else:
        idx = rng.integers(0, n, size=total)
    return {r: conflict_ratio(idx, r, chn) for r in ranges}


def serialized_batches_ratio(indices: np.ndarray, batch: int = 8, chn: int = 8) -> float:
    """The naive no-reorder baseline: requests issue in order, `batch` at a
    time; a batch stalls for its own worst channel (paper Fig. 8b 'naive')."""
    return conflict_ratio(indices, batch, chn)
