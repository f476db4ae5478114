#!/usr/bin/env python3
"""Where a decode tick of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/torch_tick_profile.py [--ticks 5] [--sharded | --contiguous]
        [--kv-dtype int8|fp16|int4]

Serves the main path of chip_smoke.py (its model, engine settings and
requests, imported from there) — the paged tick; with ``--sharded`` the
block-sharded tick over a world of one rank; with ``--contiguous`` the
contiguous slot pool's tick (``paged=False``); ``--kv-dtype`` picks the
paged pool's storage — warms up for 3 ticks, then profiles
``--ticks`` decode ticks with torch.profiler. Prints the host wall time per tick, the device
time per tick (sum of kernel times; kernels of one stream do not overlap),
the device busy share, launches per tick, the kernels with the most device
time and the host operators with the most self CPU time. Needs a CUDA
device.
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
    args = ap.parse_args()
    if args.contiguous and args.kv_dtype != "int8":
        ap.error("--kv-dtype names the paged pool's storage")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import NEW_TOKENS, SERVE, main_path_model, main_path_requests
    from repro_torch.distributed.sharding import init_decode_ctx
    from repro_torch.runtime.serve import ServingEngine
    if WARM_TICKS + args.ticks > NEW_TOKENS - 1:
        ap.error(f"--ticks: the requests decode {NEW_TOKENS - 1} ticks, "
                 f"{WARM_TICKS} of them warm-up")

    dev = "cuda"
    cfg, params = main_path_model(dev)
    ctx = init_decode_ctx(dev) if args.sharded else None
    engine = ServingEngine(cfg, params, device=dev, ctx=ctx,
                           **dict(SERVE, paged=not args.contiguous,
                                  **({} if args.contiguous else {"kv_pool_dtype": args.kv_dtype})))
    for r in main_path_requests(cfg.vocab_size):
        engine.submit(r)
    engine._admit()
    for _ in range(WARM_TICKS):
        engine._tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(args.ticks):
            engine._tick()
        torch.cuda.synchronize()
        wall = (time.time() - t0) / args.ticks
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
           "wall_ms_per_tick": wall * 1e3,
           "device_ms_per_tick": device_us / args.ticks / 1e3,
           "device_busy_share": device_us / 1e3 / args.ticks / (wall * 1e3),
           "kernel_launches_per_tick": launches / args.ticks,
           "top": [{"kernel": k[:90], "ms_per_tick": dt / args.ticks / 1e3,
                    "launches_per_tick": n / args.ticks} for dt, n, k in rows[:15]],
           "top_host": [{"op": k[:90], "self_cpu_ms_per_tick": dt / args.ticks / 1e3,
                         "calls_per_tick": n / args.ticks} for dt, n, k in host[:15]]}
    print(json.dumps(out, indent=1))
    print(f"gpu: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
