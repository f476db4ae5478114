#!/usr/bin/env python3
"""Where a decode tick of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/torch_tick_profile.py [--ticks 5] [--sharded | --contiguous]
        [--kv-dtype int8|fp16|int4] [--prefill] [--eager]

Serves the main path of chip_smoke.py (its model, engine settings and
requests, imported from there) — the paged tick; with ``--sharded`` the
block-sharded tick over a world of one rank; with ``--contiguous`` the
contiguous slot pool's tick (``paged=False``); ``--kv-dtype`` picks the
paged pool's storage — warms up for 3 ticks, then profiles
``--ticks`` decode ticks with torch.profiler. An unsharded tick is a CUDA
graph after the first warm-up tick (`runtime.steps`), so the profiled ticks
are replays; ``--eager`` builds the engine under `steps.eager()` instead
(the tick as it ran before the graph: run both to compare them). Prints
the host wall time per tick, the device time per tick (sum of kernel
times; kernels of one stream do not overlap), the device busy share,
launches per tick, the launches the kernel wrappers counted per tick
(`kernels.common.LAUNCHES`) beside the trace's launches of those kernels,
the peak device memory, the kernels with the most device time and the
host operators with the most self CPU time. With
``--prefill`` it profiles the admission of the four prompts in place of the
ticks (after a warm-up admission of a 64-token prompt on another engine),
and every number is per prefill. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
WARM_TICKS = 3
# kernel wrapper's launch counter (`LAUNCHES`, branch suffix dropped) → its
# kernel's symbol in the trace
_SYMBOL = {"paged_score_estimate": "paged_score_estimate_kernel",
           "paged_score_bounds": "paged_score_bounds_kernel",
           "paged_fused_select": "paged_fused_select_kernel",
           "sparse_flash_decode_paged": "sparse_flash_decode_paged_kernel",
           "sparse_flash_decode_paged_partials": "sparse_flash_decode_paged_kernel",
           "score_estimate": "flat_score_kernel",
           "fused_bin_pool_threshold": "fused_bin_pool_threshold_kernel",
           "sparse_flash_decode": "sparse_flash_decode_flat_kernel",
           "flash_prefill": "flash_prefill"}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ticks", type=int, default=5)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--sharded", action="store_true",
                      help="profile ServingEngine(paged=True, ctx=...) over a world of one rank")
    mode.add_argument("--contiguous", action="store_true",
                      help="profile ServingEngine(paged=False), the contiguous slot pool")
    ap.add_argument("--kv-dtype", choices=("int8", "fp16", "int4"), default="int8",
                    help="the paged pool's K/V storage")
    ap.add_argument("--prefill", action="store_true",
                    help="profile the four prompts' prefills (their admission), not ticks")
    ap.add_argument("--eager", action="store_true",
                    help="build the engine under steps.eager(): no CUDA graph of the tick")
    args = ap.parse_args()
    if args.contiguous and args.kv_dtype != "int8":
        ap.error("--kv-dtype names the paged pool's storage")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import contextlib

    import numpy as np
    from chip_smoke import NEW_TOKENS, SERVE, main_path_model, main_path_requests
    from repro_torch.distributed.sharding import init_decode_ctx
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.runtime.serve import Request, ServingEngine
    from repro_torch.runtime.steps import eager
    if WARM_TICKS + args.ticks > NEW_TOKENS - 1:
        ap.error(f"--ticks: the requests decode {NEW_TOKENS - 1} ticks, "
                 f"{WARM_TICKS} of them warm-up")

    dev = "cuda"
    cfg, params = main_path_model(dev)
    ctx = init_decode_ctx(dev) if args.sharded else None
    serve = dict(SERVE, paged=not args.contiguous,
                 **({} if args.contiguous else {"kv_pool_dtype": args.kv_dtype}))
    with eager() if args.eager else contextlib.nullcontext():
        engine = ServingEngine(cfg, params, device=dev, ctx=ctx, **serve)
    reqs = main_path_requests(cfg.vocab_size)
    for r in reqs:
        engine.submit(r)
    if args.prefill:        # the warm-up admission: module loading, cuBLAS handles
        warm = ServingEngine(cfg, params, device=dev, ctx=ctx, **serve)
        warm.submit(Request(rid=-1, prompt=np.random.default_rng(1).integers(
            0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=2))
        warm._admit()
        del warm
        steps, unit = len(reqs), "prefill"
    else:
        engine._admit()
        for _ in range(WARM_TICKS):
            engine._tick()
        steps, unit = args.ticks, "tick"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        if args.prefill:
            engine._admit()
        else:
            for _ in range(args.ticks):
                engine._tick()
        torch.cuda.synchronize()
        wall = (time.time() - t0) / steps
    counted = {k: n / steps for k, n in LAUNCHES.items()}
    rows, host = [], []
    device_us = 0.0
    launches = 0
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if dt > 0 and e.device_type is not None and "CUDA" in str(e.device_type):
            device_us += dt
            launches += e.count
            rows.append((dt, e.count, e.key))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    tick = ("sharded (one rank)" if args.sharded else
            "contiguous" if args.contiguous else "paged unsharded")
    out = {"tick": tick, "kv_pool_dtype": None if args.contiguous else args.kv_dtype,
           "profiled": f"{steps} {unit}s" + (f" (prompts {[len(r.prompt) for r in reqs]})"
                                             if args.prefill else ""),
           f"wall_ms_per_{unit}": wall * 1e3,
           f"device_ms_per_{unit}": device_us / steps / 1e3,
           "device_busy_share": device_us / 1e3 / steps / (wall * 1e3),
           f"kernel_launches_per_{unit}": launches / steps,
           "graphed": engine._step.graphed and not args.prefill,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           f"wrapper_launches_per_{unit}": counted,
           f"traced_launches_per_{unit}": {
               k: sum(n for _, n, key in rows if _SYMBOL.get(k.split("[")[0], k) in key) / steps
               for k in counted},
           "top": [{"kernel": k[:90], f"ms_per_{unit}": dt / steps / 1e3,
                    f"launches_per_{unit}": n / steps} for dt, n, k in rows[:15]],
           "top_host": [{"op": k[:90], f"self_cpu_ms_per_{unit}": dt / steps / 1e3,
                         f"calls_per_{unit}": n / steps} for dt, n, k in host[:15]]}
    print(json.dumps(out, indent=1))
    print(f"gpu: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
