"""Serving launcher of the port: Salca decoding with random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --requests 4 --prompt-len 2048 --new-tokens 16 --max-seq 8192

Serves the contiguous slot pool by default (kernels B7-B9 in the tick), as
the reference launcher does; ``--paged`` serves the paged block pool
(kernels B1, B2). ``--sharded`` runs the tick over a world of one rank —
``nccl`` on the card, ``gloo`` on the CPU: on the contiguous pool the
sequence-sharded flat tick (kernels B7, B10, B11 and B8's partials
branch), with ``--paged`` the block-sharded tick (kernels B4-B6).
``--local`` serves the reduced config; pass ``--device cpu`` to run on the
CPU with the kernels' plain versions. ``--arch`` takes every ported config:
the dense and MoE LMs, ``mamba2-2.7b`` (SSD layers) and
``recurrentgemma-2b`` (RG-LRU layers beside local-attention rings).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.runtime.serve import Request, ServingEngine
from repro_torch.weights import init_lm_params


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--local", action="store_true", help="serve the reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=192)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true", help="paged block pool")
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded tick over a world of one rank: sequence-sharded "
                         "contiguous cache, or with --paged the block-sharded pool")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    max_seq = args.max_seq or (args.prompt_len + args.new_tokens + 8)
    max_seq = ((max_seq + 127) // 128) * 128        # as the reference launcher rounds
    paged = args.paged
    if paged and max_seq % args.block_size:
        ap.error(f"--block-size {args.block_size} must divide max_seq {max_seq} (the "
                 f"requested length rounded up to a multiple of 128)")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_lm_params(cfg, gen, args.device)
    ctx = init_decode_ctx(args.device) if args.sharded else None
    engine = ServingEngine(cfg, params, max_seq=max_seq, slots=args.slots,
                           paged=paged, block_size=args.block_size,
                           device=args.device, ctx=ctx)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)
        engine.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.new_tokens))
    stats = engine.run()
    print("serve stats:", json.dumps(stats.summary()))


if __name__ == "__main__":
    main()
