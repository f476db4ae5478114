"""The synthetic attention workload of the reference's benchmarks, and its
selection-quality metrics.

Port of the reference `benchmarks/common.py` (`synthetic_attention_case`,
`true_scores`, `overlap_coverage`). The workload
is drawn with numpy from the seed by the reference's own sequence of
draws, so its q, k and v are bit for bit the reference's; they are handed
over as float32 tensors on ``device``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def synthetic_attention_case(seed: int, B=2, T=2048, H=8, KV=4, HD=64,
                             relevant_frac=0.05, boost=2.5, runs=True, device="cpu"):
    """Concentrated attention with heavy-channel structure and (optionally)
    locally coherent relevance runs, the regime the paper measures.
    Returns (q (B, H, HD), k (B, T, KV, HD), v (B, T, KV, HD), relevant
    (B, KV, n_rel) int64 numpy)."""
    rng = np.random.default_rng(seed)
    G = H // KV
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, HD)).astype(np.float32)
    qg = q.reshape(B, KV, G, HD).mean(2)
    n_rel = max(4, int(T * relevant_frac))
    relevant = np.zeros((B, KV, n_rel), np.int64)
    for b in range(B):
        for h in range(KV):
            if runs:  # coherent runs of relevant tokens (documents, spans)
                starts = rng.choice(T - 8, size=max(1, n_rel // 6), replace=False)
                idx = np.unique(np.concatenate(
                    [np.arange(s, min(s + 6, T)) for s in starts]))[:n_rel]
                idx = np.pad(idx, (0, n_rel - len(idx)), mode="edge")
            else:
                idx = rng.choice(T, size=n_rel, replace=False)
            relevant[b, h] = idx
            w = (0.5 + rng.random(n_rel))[:, None]
            k[b, idx, h] += boost * w * qg[b, h] / np.linalg.norm(qg[b, h]) * np.sqrt(HD)
    ch_scale = 1 + 4 * (rng.random(HD) < 0.25)
    k *= ch_scale
    v = rng.normal(size=(B, T, KV, HD)).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    return dev(q), dev(k), dev(v), relevant


def true_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Group-summed exact attention scores (B, KV, T), f32."""
    B, H, HD = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, HD).float()
    return torch.einsum("bkgd,btkd->bkt", qg, k.float()) / math.sqrt(HD)


def overlap_coverage(sel_idx, sel_mask, scores, k_top=None, k_cov=None):
    """Paper Table 4 metrics: overlap with the true top-K and coverage of
    the true top-K/2, averaged over (batch, kv head) rows that selected
    anything. Tensors or arrays; computed in numpy as the reference does."""
    idx, msk = np.asarray(torch.as_tensor(sel_idx).cpu()), np.asarray(torch.as_tensor(sel_mask).cpu())
    s = np.asarray(torch.as_tensor(scores).cpu())
    B, KV, T = s.shape
    k_top = k_top or msk.sum(-1).mean().astype(int)
    ov = cov = 0.0
    cnt = 0
    for b in range(B):
        for h in range(KV):
            chosen = set(idx[b, h][msk[b, h]].tolist())
            if not chosen:
                continue
            kk = min(int(k_top), T)
            top = np.argsort(s[b, h])[::-1]
            ov += len(chosen & set(top[:kk].tolist())) / kk
            kc = min(int(k_cov or kk // 2), T)
            cov += len(chosen & set(top[:kc].tolist())) / kc
            cnt += 1
    return ov / cnt, cov / cnt

