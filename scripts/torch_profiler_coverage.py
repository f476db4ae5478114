#!/usr/bin/env python3
"""How many of a session's kernel launches the profiler's trace records.

    python3 scripts/torch_profiler_coverage.py

chip_smoke.py times each kernel and reads its grid from ``torch.profiler``
traces. This script checks whether such a trace holds every launch made
inside its session. It launches kernel B2 (int8, HD 128, G 2, BS 32, KV 8,
64 listed blocks per row) 20 times per session, each launch over a different
number of rows (1, 2, …, 20), so the grid that the trace records for a launch
tells which launch it was. Each variant runs in a fresh process and opens
200 sessions of each of its kinds:

- ``cuda``: ``profile(activities=[CUDA])`` sessions, one after another,
  with no idle time inside them;
- ``cuda+cpu``: the same with CPU activity recorded too;
- ``warmed``: as ``cuda``, after one throwaway session of one launch;
- ``after-checks``: as ``cuda``, after chip_smoke.py's phase-3 checks of
  the paged and tiered kernels (as ``scripts/torch_b2_ab.py`` runs them),
  with four kinds of session taken in turn: 20 launches or 1, each with or
  without 50 ms of idle time inside the session before the first launch
  and after the last.

Prints per variant and kind of session the launches each session recorded
and which launch positions were missing; the last line is one JSON object
with all of it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCHES = 20
KERNEL = "sparse_flash_decode_paged_kernel"
SESSIONS = 200
VARIANTS = ("cuda", "cuda+cpu", "warmed", "after-checks")
KINDS = {"cuda": [(LAUNCHES, 0.0)], "cuda+cpu": [(LAUNCHES, 0.0)], "warmed": [(LAUNCHES, 0.0)],
         "after-checks": [(LAUNCHES, 0.0), (LAUNCHES, 0.05), (1, 0.0), (1, 0.05)]}


def operands(torch, bh, seed):
    """B2 int8 operands over ``bh`` rows: random codes and per-token scales,
    each row listing 64 scrambled blocks with a random mask."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv, bs, hd, nsb = 8, 32, 128, 64
    p = bh * nsb + 3
    kc, vc = (torch.randint(-128, 128, (p, bs, kv, hd), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((p, bs, kv), generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(2))
    pblk = torch.randperm(p, generator=gen, device="cuda")[:bh * nsb].reshape(bh, nsb)
    counts = torch.full((bh,), nsb, dtype=torch.int32, device="cuda")
    bmask = torch.rand((bh, nsb, bs), generator=gen, device="cuda") < 0.6
    q = torch.randn((bh, 2, hd), generator=gen, device="cuda")
    return (q, kc, ks, vc, vs, pblk.to(torch.int32), counts, bmask, kv, "int8")


def session(torch, fn_list, activities, pad_s=0.0) -> tuple[int, list[int]]:
    """One profiler session over every launch of ``fn_list`` (``pad_s`` of
    idle time inside the session before and after them): the launches that
    ``key_averages`` counts, and the row counts (grid.y) of the kernel
    events in the exported trace."""
    import time

    from torch.profiler import profile
    with profile(activities=activities) as prof:
        time.sleep(pad_s)
        for fn in fn_list:
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    counted = sum(e.count for e in prof.key_averages() if KERNEL in e.key)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    rows = sorted(int(e["args"]["grid"][1]) for e in events
                  if str(e.get("cat", "")).lower() == "kernel"
                  and KERNEL in e.get("name", "") and "grid" in e.get("args", {}))
    return counted, rows


def run_variant(variant: str) -> dict:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_decode import ops as fd
    common.build_kernels()
    if variant == "after-checks":
        import chip_smoke as cs
        from repro_torch.configs import get_config
        cfg = get_config("qwen3-0.6b")
        lengths = [n + cs.NEW_TOKENS for n in cs.PROMPTS]
        cs.check_kernels("cuda", cfg, lengths=lengths, prompt_len=max(cs.PROMPTS))
        cs.check_tiered_kernels("cuda", cfg, lengths=lengths)
    ops = [operands(torch, bh, bh) for bh in range(1, LAUNCHES + 1)]
    fns = [lambda a=a: fd.sparse_flash_decode_paged_kernel(*a) for a in ops]
    for fn in fns:                 # every launch once outside any session
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if variant == "cuda+cpu" else [])
    if variant == "warmed":
        session(torch, fns[:1], acts)
    kinds = {f"{n}x{pad}": dict(launches=n, pad_s=pad, counted=[], missing_positions=[])
             for n, pad in KINDS[variant]}
    for _ in range(SESSIONS):
        for k in kinds.values():
            c, rows = session(torch, fns[:k["launches"]], acts, k["pad_s"])
            k["counted"].append(c)
            k["missing_positions"].append(sorted(set(range(1, k["launches"] + 1)) - set(rows)))
    for k in kinds.values():
        k["sessions_complete"] = sum(c == k["launches"] for c in k["counted"])
    return dict(variant=variant, torch=torch.__version__, kinds=kinds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=VARIANTS, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.variant:
        print(json.dumps(run_variant(a.variant)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs
    print(cs.gpu_line(), flush=True)
    report = []
    for v in VARIANTS:
        out = subprocess.run([sys.executable, __file__, "--variant", v], check=True,
                             timeout=600, stdout=subprocess.PIPE, text=True).stdout
        rec = json.loads(out.strip().splitlines()[-1])
        for name, k in rec["kinds"].items():
            lost = [(i, m) for i, m in enumerate(k["missing_positions"]) if m]
            print(f"{v}, {k['launches']} launches, {k['pad_s']} s idle: "
                  f"{k['sessions_complete']} of {SESSIONS} sessions hold every launch; "
                  f"sessions with launches missing (index, positions): {lost}", flush=True)
        report.append(rec)
    print(json.dumps({"gpu": cs.gpu_line(), "variants": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
