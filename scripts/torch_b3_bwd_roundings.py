#!/usr/bin/env python3
"""B3-bwd's bf16 operand roundings against its tolerance, case by case.

    python3 scripts/torch_b3_bwd_roundings.py

B3-bwd's bf16 branch feeds P and dS to the tensor cores. Rounded once to
bf16 (FlashAttention's operands) or split into bf16 hi + lo (two products
each, the kernel's), they move the gradients by different amounts. For every
bf16 case of ``tests/test_torch_cuda.py::test_b3_bwd_kernel_matches_plain``
and of chip_smoke's run (ae), on the card, this prints each gradient's
largest |x - plain| over chip_smoke's B3_BWD_TOL (1e-3 + 2^-7·|plain|) for:

- the plain version with P and dS each rounded once to bf16;
- the plain version with P and dS each split into bf16 hi + lo;
- the kernel itself.

The plain versions run in f32 from the same operands, output and LSE.
The last line is one JSON object. Needs a CUDA device (~1 min).
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# tests/test_torch_cuda.py::test_b3_bwd_kernel_matches_plain's bf16 cases
# (hd, h, kv, t, s_len, causal, window), operands from seed 5
TEST_CASES = {
    "qwen3": (128, 32, 16, 700, 700, True, 0),
    "qwen3_window": (128, 32, 16, 700, 700, True, 256),
    "encoder": (64, 12, 12, 333, 333, False, 0),
    "cross": (64, 12, 12, 40, 517, False, 0),
    "hd32": (32, 4, 2, 129, 129, True, 0),
    "hd256_window": (256, 4, 2, 300, 300, True, 128),
    "t1": (128, 4, 2, 1, 1, True, 0),
    "t63": (128, 4, 2, 63, 63, True, 0),
    "t65": (128, 4, 2, 65, 65, True, 0),
    "t129": (128, 4, 2, 129, 129, True, 0),
    "window_straddles_key_tile": (128, 4, 2, 700, 700, True, 130),
    "cross_g2_s517": (64, 4, 2, 40, 517, False, 0),
    "hd256_g10_window": (256, 10, 1, 600, 600, True, 200),
    "hd64_g3": (64, 6, 2, 300, 300, True, 0),
}


def ae_cases(cs) -> dict:
    """chip_smoke run (ae)'s bf16 cases, in its order (one generator, seed 30)."""
    b, t, w = cs.TRAIN_SHAPE["global_batch"], cs.TRAIN_SHAPE["seq_len"], cs.B3_BWD_WINDOW
    return {"(ae) qwen3-0.6b": (128, b * 16, b * 8, t, t, True, 0),
            "(ae) qwen3-0.6b window": (128, b * 16, b * 8, t, t, True, w),
            "(ae) whisper-small encoder": (64, b * 12, b * 12, t, t, False, 0),
            "(ae) whisper-small cross": (64, b * 12, b * 12, min(448, t), t, False, 0),
            "(ae) gemma3-12b": (256, b * 16, b * 8, t, t, True, 0),
            "(ae) gemma3-12b window": (256, b * 16, b * 8, t, t, True, w)}


def rounded_plain(fp, q, k, v, out, dout, lse, causal, window, split: bool):
    """`flash_attention_backward_plain` with P (for dV) and dS (for dQ, dK)
    rounded to bf16 once, or split into bf16 hi + lo."""
    import torch
    bh, t, hd = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    s, mask = fp._scores(q, k, causal, window, 0)
    p = torch.where(mask, torch.exp(s - lse.reshape(bkv, g, t, 1)), torch.zeros_like(s))
    del s
    do = dout.float().reshape(bkv, g, t, hd)
    d = (do * out.float().reshape(bkv, g, t, hd)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bgtd,bsd->bgts", do, v.float()) - d)

    def bf16(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi
    p, ds = bf16(p), bf16(ds)
    scale = 1.0 / math.sqrt(hd)
    dv = torch.einsum("bgts,bgtd->bsd", p, do)
    del p
    dq = torch.einsum("bgts,bsd->bgtd", ds, k.float()) * scale
    dk = torch.einsum("bgts,bgtd->bsd", ds, q.float().reshape(bkv, g, t, hd)) * scale
    return dq.reshape(bh, t, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.flash_prefill import ops as fp
    print(cs.gpu_line(), flush=True)
    atol, rtol = cs.B3_BWD_TOL["bf16"]
    dev = torch.device("cuda")

    def ratios(grads, want):
        return {n: float(((a.float() - b.float()).abs() / (atol + rtol * b.float().abs())).max())
                for n, a, b in zip(("dq", "dk", "dv"), grads, want)}

    report = []
    ae_gen = torch.Generator(device=dev).manual_seed(30)
    for label, (hd, h, kv, t, s_len, causal, window) in (TEST_CASES | ae_cases(cs)).items():
        gen = ae_gen if label.startswith("(ae)") else torch.Generator(device=dev).manual_seed(5)
        q = torch.randn((h, t, hd), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((kv, s_len, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        dout = torch.randn((h, t, hd), generator=gen, device=dev).to(torch.bfloat16)
        mask = dict(causal=causal, window=window)
        out, lse = fp.flash_attention_lse(q, k, v, **mask)
        want = fp.flash_attention_backward_plain(q, k, v, out, dout, lse, **mask)
        rec = dict(case=label, shape=[hd, h, kv, t, s_len, causal, window])
        for name, split in (("once", False), ("hi_lo", True)):
            rec[name] = ratios(rounded_plain(fp, q, k, v, out, dout, lse, causal, window, split),
                               want)
            torch.cuda.empty_cache()
        rec["kernel"] = ratios(fp.flash_attention_backward(q, k, v, out, dout, lse, **mask), want)
        del want
        torch.cuda.empty_cache()
        print(f"{label} (HD {hd}, {h} H / {kv} KV, T {t}, S {s_len}, "
              f"{'causal' if causal else 'unmasked'}{f', window {window}' if window else ''}): "
              + "; ".join(f"{what} " + ", ".join(f"{n} {r:.3g}" for n, r in rec[what].items())
                          for what in ("once", "hi_lo", "kernel")), flush=True)
        report.append(rec)
    worst = {what: max(max(r[what].values()) for r in report)
             for what in ("once", "hi_lo", "kernel")}
    print(f"largest ratio to 1e-3 + 2^-7*|plain| over {len(report)} cases: "
          + ", ".join(f"{w} {r:.3g}" for w, r in worst.items()), flush=True)
    print(json.dumps({"gpu": cs.gpu_line(), "worst": worst, "cases": report}), flush=True)
    return 0 if worst["kernel"] <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
