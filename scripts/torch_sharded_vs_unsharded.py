#!/usr/bin/env python3
"""The block-sharded tick at one rank against the unsharded tick, on one GPU.

    python3 scripts/torch_sharded_vs_unsharded.py [--rounds 2]

Serves chip_smoke.py's main path (its model, engine settings and requests,
imported from there) in turns — unsharded, sharded, sharded, unsharded,
... — in one process, the sharded runs through ``ServingEngine(ctx=...)``
over a world of one rank (nccl). Prints each run's ms per decode tick,
prefill seconds, mean TTFT and peak memory, and fails unless every run
gives the same greedy tokens. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import serve_main_path
    from repro_torch.distributed.sharding import init_decode_ctx
    ctx = init_decode_ctx("cuda")
    order = []
    for r in range(args.rounds):
        order += [None, ctx] if r % 2 == 0 else [ctx, None]
    runs, tokens = [], None
    for c in order:
        _, s, t = serve_main_path("cuda", c)
        if tokens is None:
            tokens = t
        elif t != tokens:
            raise AssertionError("greedy tokens differ between runs")
        runs.append({"tick": "unsharded" if c is None else "sharded (one rank)",
                     "ms_per_tick": s["decode_ms_per_tick"], "prefill_s": s["prefill_s"],
                     "mean_ttft_s": s["mean_ttft_s"], "peak_mem_gb": s["peak_mem_gb"]})
        print(json.dumps(runs[-1]), flush=True)
    print(f"gpu: {torch.cuda.get_device_name(0)}; tokens identical in all {len(runs)} runs")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
