#!/usr/bin/env python3
"""The paged unsharded tick against another decode tick, on one GPU.

    python3 scripts/torch_tick_compare.py [--against sharded|contiguous] [--rounds 2]

Serves chip_smoke.py's main path (its model, engine settings and requests,
imported from there) in turns — paged, other, other, paged, ... — in one
process. The other tick is the block-sharded one, ``ServingEngine(paged=True,
ctx=...)`` over a world of one rank (nccl), or the contiguous slot pool,
``ServingEngine(paged=False)``. Prints each run's ms per decode tick,
prefill seconds, mean TTFT and peak memory, and fails unless every run of
one tick gives the same greedy tokens and the sharded tick gives the paged
tick's tokens (the contiguous tick may part from them at bf16 near-ties;
chip_smoke.py compares its logits with the paged tick's under teacher
forcing). Needs a CUDA device.
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
    ap.add_argument("--against", choices=("sharded", "contiguous"), default="sharded")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import serve_main_path
    from repro_torch.distributed.sharding import init_decode_ctx
    other = (dict(ctx=init_decode_ctx("cuda")) if args.against == "sharded"
             else dict(paged=False))
    order = []
    for r in range(args.rounds):
        order += [{}, other] if r % 2 == 0 else [other, {}]
    runs, tokens = [], {}
    for kw in order:
        tick = args.against if kw else "paged"
        _, s, t, _ = serve_main_path("cuda", **kw)
        if tokens.setdefault(tick, t) != t:
            raise AssertionError(f"greedy tokens differ between runs of the {tick} tick")
        runs.append({"tick": tick, "ms_per_tick": s["decode_ms_per_tick"],
                     "prefill_s": s["prefill_s"], "mean_ttft_s": s["mean_ttft_s"],
                     "peak_mem_gb": s["peak_mem_gb"]})
        print(json.dumps(runs[-1]), flush=True)
    if args.against == "sharded" and tokens["sharded"] != tokens["paged"]:
        raise AssertionError("the sharded tick's greedy tokens differ from the paged tick's")
    same = sum(a == b for a, b in zip(tokens["paged"], tokens[args.against]))
    print(f"gpu: {torch.cuda.get_device_name(0)}; {len(runs)} runs; {same} of "
          f"{len(tokens['paged'])} requests with identical tokens in both ticks")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
