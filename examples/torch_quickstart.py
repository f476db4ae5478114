"""Quickstart of the PyTorch/CUDA port: Salca sparse decode attention.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Twin of `examples/quickstart.py`. Builds a concentrated-attention workload
(the same numpy draws), prefills the dual-compressed cache, runs one Salca
decode step on the contiguous cache (kernels B7 scores, B9 bin / pool /
histogram / threshold and B8 sparse attention on the card; their plain
versions on the CPU) and shows what the paper's pipeline did: how many
tokens the O(n) histogram filter kept, the selection's recall of the truly
relevant tokens, and the output error against dense attention. Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import cache_bytes, prefill_cache  # noqa: E402
from repro_torch.core.attention import (dense_decode_attention,  # noqa: E402
                                        salca_decode_attention)
from repro_torch.core.selection import SalcaParams  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402

B, T, H, KV, HD = 1, 4096, 8, 4, 128


def workload(device):
    """q (B, H, HD), k, v (B, T, KV, HD) f32 on ``device`` and the relevant
    token set of each kv head: ~3 % of the tokens matter."""
    rng = np.random.default_rng(0)
    G = H // KV
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, HD)).astype(np.float32)
    qg = q.reshape(B, KV, G, HD).mean(2)
    relevant = {}
    for h in range(KV):
        idx = rng.choice(T, size=128, replace=False)
        relevant[h] = set(idx.tolist())
        k[0, idx, h] += 3.0 * qg[0, h] / np.linalg.norm(qg[0, h]) * np.sqrt(HD)
    k = (k * (1 + 4 * (rng.random(HD) < 0.25))).astype(np.float32)   # heavy channels
    v = rng.normal(size=(B, T, KV, HD)).astype(np.float32)
    dev = resolve_device(device)
    return (*(torch.from_numpy(a).to(dev) for a in (q, k, v)), relevant)


def run(device="cuda") -> dict:
    """One prefill and one decode step; returns what the script prints."""
    q, k, v, relevant = workload(device)
    # Relevant tokens here are ISOLATED spikes, so max-pooling is bypassed,
    # as the paper does for models with strong Top-K behaviour (ChatGLM3);
    # pooling helps when relevance comes in locally coherent runs.
    params = SalcaParams.for_seq(T, retention=0.05, use_pool=False)
    cache = prefill_cache(k, v, max_seq=T, params=params)
    out, sel = salca_decode_attention(q, cache, params, return_selection=True)
    dense = dense_decode_attention(q, k, v)
    kept = sel.count[0].cpu().numpy()
    recall = []
    for h in range(KV):
        chosen = set(sel.indices[0, h][sel.mask[0, h]].cpu().tolist())
        recall.append(len(chosen & relevant[h]) / len(relevant[h]))
    rel = float(torch.linalg.norm(out - dense) / torch.linalg.norm(dense))
    return dict(params=params, nbytes=cache_bytes(cache), kept=kept,
                threshold=sel.threshold[0].cpu().numpy(), recall=recall, rel=rel,
                out=out, sel=sel)


def report(r: dict) -> None:
    nbytes, params, kept = r["nbytes"], r["params"], r["kept"]
    print(f"cache: kv_region={nbytes['kv_region']/2**20:.1f}MiB "
          f"feature_region={nbytes['feature_region']/2**20:.1f}MiB "
          f"(features are {nbytes['feature_region']/nbytes['kv_region']:.1%} of KV)")
    print(f"selection target k={params.k} of n={T} "
          f"(retention {params.k/T:.1%}), capacity {params.k_cap}")
    print(f"histogram thresholds (per kv head): {r['threshold'].tolist()}")
    print(f"tokens kept per kv head: {kept.tolist()}")
    for h in range(KV):
        print(f"  kv head {h}: recall of relevant tokens = {r['recall'][h]:.1%}")
    print(f"output rel. error vs dense fp attention: {r['rel']:.4f}")
    print(f"bytes touched per step ≈ features({nbytes['feature_region']/2**20:.1f}MiB) "
          f"+ gathered KV({(kept.sum() * 2 * HD)/2**20:.2f}MiB) "
          f"vs dense {nbytes['kv_region']/2**20:.1f}MiB")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    report(run(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
