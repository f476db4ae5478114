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
CPU with the kernels' plain versions. ``--arch`` takes every config: the
dense and MoE LMs, ``mamba2-2.7b`` (SSD layers), ``recurrentgemma-2b``
(RG-LRU layers beside local-attention rings), ``llava-next-mistral-7b``
text-only like the others, and two kinds of request that carry more than
tokens, served through the model API by `runtime.steps.PooledServer` on
the contiguous pool: ``whisper-small`` (the enc-dec family), whose
requests carry ``--frames`` random frame embeddings each (the
cross-attention stream that Salca reads; the decoder prompt and its new
tokens fit in ``decoder_max_len``), and ``--image`` on the vision
frontend, whose requests carry the config's patch embeddings ahead of the
prompt.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.models import get_model
from repro_torch.runtime.serve import Request, ServingEngine
from repro_torch.runtime.steps import PooledServer
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
    ap.add_argument("--frames", type=int, default=1536,
                    help="enc-dec: random frame embeddings per request (T_enc)")
    ap.add_argument("--image", action="store_true",
                    help="vision frontend: requests carry random patch embeddings")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced()
    pooled = cfg.encdec or args.image
    if args.image and cfg.frontend != "vision":
        ap.error(f"--image needs the vision frontend; {cfg.name}'s is {cfg.frontend!r}")
    if pooled and args.paged:
        ap.error("the enc-dec family and image requests are served on the contiguous pool")
    if cfg.encdec and args.prompt_len + args.new_tokens > cfg.decoder_max_len:
        ap.error(f"--prompt-len + --new-tokens must fit {cfg.name}'s decoder_max_len "
                 f"{cfg.decoder_max_len}")
    images = cfg.num_image_tokens if args.image else 0
    max_seq = args.max_seq or (images + args.prompt_len + args.new_tokens + 8)
    max_seq = ((max_seq + 127) // 128) * 128        # as the reference launcher rounds
    paged = args.paged
    if paged and max_seq % args.block_size:
        ap.error(f"--block-size {args.block_size} must divide max_seq {max_seq} (the "
                 f"requested length rounded up to a multiple of 128)")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_lm_params(cfg, gen, args.device)
    ctx = init_decode_ctx(args.device) if args.sharded else None
    rng = np.random.default_rng(args.seed)
    if pooled:
        serve_pooled(args, cfg, params, ctx, max_seq, gen, rng)
        return
    engine = ServingEngine(cfg, params, max_seq=max_seq, slots=args.slots,
                           paged=paged, block_size=args.block_size,
                           device=args.device, ctx=ctx)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)
        engine.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.new_tokens))
    stats = engine.run()
    print("serve stats:", json.dumps(stats.summary()))


def serve_pooled(args, cfg, params, ctx, max_seq: int, gen, rng) -> None:
    """The model-API server (`PooledServer`): enc-dec requests with random
    frames (the pool's max_seq is T_enc), or image requests with random
    patches, each with a random prompt."""
    server = PooledServer(get_model(cfg), params, args.slots,
                          args.frames if cfg.encdec else max_seq, args.device, ctx)
    key, shape = (("frames", (1, args.frames, cfg.d_model)) if cfg.encdec else
                  ("patches", (1, cfg.num_image_tokens, cfg.frontend_dim)))
    requests = [(torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, args.prompt_len))
                                  .astype(np.int32)),
                 {key: torch.randn(shape, generator=gen, device=args.device)})
                for _ in range(args.requests)]
    t0 = time.perf_counter()
    out = server.serve(requests, args.new_tokens)
    wall = time.perf_counter() - t0
    done = len(requests) - len(server.nonfinite)
    print("serve stats:", json.dumps({
        "completed": done, "nonfinite": server.nonfinite, "ticks": server.ticks,
        "tokens_generated": sum(len(o) for o in out), "wall_s": round(wall, 4),
        "graphed": server.step.graphed}))


if __name__ == "__main__":
    main()
