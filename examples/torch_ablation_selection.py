"""Ablation on the port: feature sparsity × retention rate → selection quality.

    PYTHONPATH=src python examples/torch_ablation_selection.py [--device cpu]

Twin of `examples/ablation_selection.py`. Sweeps the paper's two
compression knobs (§3.1 / §5.4) on the synthetic concentrated-attention
workload (`repro_torch.analysis.synthetic`: the reference's numpy draws),
reporting overlap with the true top-k, coverage of the true top-k/2 and the
attention output's error against dense, the shape of paper Table 4. Each
row prefills the dual-compressed cache and runs one Salca decode step on
the contiguous cache (kernels B7, B9 and B8 on the card). Runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.analysis.synthetic import (overlap_coverage,  # noqa: E402
                                            synthetic_attention_case, true_scores)
from repro_torch.core import prefill_cache  # noqa: E402
from repro_torch.core.attention import (dense_decode_attention,  # noqa: E402
                                        salca_decode_attention)
from repro_torch.core.selection import SalcaParams  # noqa: E402

T = 2048
GRID = [(s_f, r_q) for s_f in (0.25, 0.375, 0.5) for r_q in (0.02, 0.05, 0.10)]


def row_params(s_f: float, r_q: float) -> SalcaParams:
    kk = max(64, int(T * r_q))
    return SalcaParams(feature_sparsity=s_f, k=kk, k_cap=(int(kk * 1.25) // 128 + 1) * 128,
                       use_pool=False)


def sweep(device="cuda", grid=GRID) -> list[dict]:
    """One row per (s_f, r_q) of ``grid``: overlap, coverage, relative error."""
    q, k, v, _ = synthetic_attention_case(0, T=T, device=device)
    s_true = true_scores(q, k)
    dense = dense_decode_attention(q, k, v)
    rows = []
    for s_f, r_q in grid:
        params = row_params(s_f, r_q)
        cache = prefill_cache(k, v, max_seq=T, params=params)
        out, sel = salca_decode_attention(q, cache, params, return_selection=True)
        ov, cov = overlap_coverage(sel.indices, sel.mask, s_true, k_top=params.k)
        rel = float(torch.linalg.norm(out - dense) / torch.linalg.norm(dense))
        rows.append(dict(s_f=s_f, r_q=r_q, overlap=ov, coverage=cov, rel_err=rel,
                         count=sel.count.cpu(), threshold=sel.threshold.cpu()))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"{'s_f':>5} {'retention':>9} {'overlap':>8} {'coverage':>8} {'rel_err':>8}")
    for r in sweep(args.device):
        print(f"{r['s_f']:>5} {r['r_q']:>9} {r['overlap']:>8.3f} {r['coverage']:>8.3f} "
              f"{r['rel_err']:>8.3f}")


if __name__ == "__main__":
    main()
