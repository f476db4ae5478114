"""End-to-end serving on the port: batched requests through prefill and Salca decode.

    PYTHONPATH=src python examples/torch_serve_longcontext.py [--arch qwen3-0.6b] [--device cpu]

Twin of `examples/serve_longcontext.py`. Runs the reduced config of a real
arch (``--full``: the full-width config), random weights from seed 0,
through the port's `ServingEngine` (continuous batching: slots admit queued
requests as sequences finish) and reports the phase split the paper's
Fig. 1 is about — prefill against decode time — and the latency per
request. On the card the prefill runs kernel B3, the paged tick B1 and B2
(a CUDA graph after its first tick), the contiguous tick B7, B9 and B8.
Runs on ``cuda`` unless ``--device cpu`` is given.

``--prompt-lens`` serves one request per listed length in place of
``--requests`` × ``--prompt-len``; ``max_seq`` is the longest prompt plus
its new tokens, rounded up to 128, as the reference rounds it.

``--host-spill`` runs the tiered-KV demo: a context whose block footprint
overflows an fp16 pool completes on an int8 pool of the same byte budget
with cold blocks spilled to host memory.

``--shards N`` runs the capacity demo of the block-sharded pool: one
long-context request against a 1-shard pool of ``--blocks-per-shard``
blocks (it overflows: rejected at submit) and against an N-shard pool (its
blocks span the shards and it completes). On the CPU the N shards are N
ranks over ``gloo``, each a process spawned from this script and joined
through a file store in a temporary directory; on the card the N-shard
pool is served by a world of one rank over ``nccl`` (one card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime.serve import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.tree import leaves  # noqa: E402
from repro_torch.weights import init_lm_params  # noqa: E402


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--prompt-len", type=int, default=192)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--paged", action="store_true",
                    help="paged block-pool KV cache instead of dense slots")
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool size in blocks (0 = dense-equivalent budget)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="refcounted copy-on-write prefix sharing (paged "
                         "only); requests share a system prompt below")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of shared system prompt per request "
                         "(default: 75%% of prompt-len when sharing)")
    ap.add_argument("--kv-dtype", choices=("fp16", "int8", "int4"), default=None,
                    help="block pool exact-K/V storage precision (paged only)")
    ap.add_argument("--host-spill", action="store_true",
                    help="tiered-KV demo (implies --paged): a context whose "
                         "block footprint overflows an fp16 pool completes "
                         "on an int8 pool of the same byte budget with cold "
                         "blocks spilled to host memory")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the paged block pool across N ranks (implies "
                         "--paged); demos a context that overflows 1 shard "
                         "but completes on N")
    ap.add_argument("--blocks-per-shard", type=int, default=8,
                    help="per-shard pool slice for the --shards demo")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config (default: the reduced one)")
    ap.add_argument("--prompt-lens", type=str, default="",
                    help="comma-separated prompt lengths, one request each "
                         "(replaces --requests x --prompt-len)")
    ap.add_argument("--device", default="cuda")
    # one rank of the --shards demo on the CPU (set by the spawning process)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap


def model_config(args):
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.prefix_sharing:
        # static weight-derived heavy channels: the request-independent set
        # that lets divergent-tail requests alias feature blocks
        cfg = dataclasses.replace(cfg, salca_static_channels=True)
    return cfg


def prompt_lengths(args) -> list[int]:
    if args.prompt_lens:
        return [int(n) for n in args.prompt_lens.split(",")]
    return [args.prompt_len] * args.requests


def make_requests(args, cfg) -> list[Request]:
    """The requests: random prompts from ``--seed`` (with prefix sharing a
    shared system prompt ahead of each random tail)."""
    rng = np.random.default_rng(0)
    lens = prompt_lengths(args)
    shared = np.zeros((0,), np.int32)
    if args.prefix_sharing:
        shared_len = args.shared_prefix or (3 * min(lens)) // 4
        if not 0 < shared_len < min(lens):
            raise ValueError(f"--shared-prefix {shared_len} must be in (0, prompt-len "
                             f"{min(lens)}): requests need a divergent tail")
        shared = rng.integers(0, cfg.vocab_size, shared_len).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n - len(shared)).astype(np.int32)]), max_new_tokens=args.new_tokens)
        for i, n in enumerate(lens)]


def serve(args, cfg, params, hook=None) -> dict:
    """Serve ``make_requests`` on one engine built from the flags; ``hook(engine)``
    runs on the built engine just before the run. Returns the engine, the
    requests, the summary and the run's wall seconds."""
    max_seq = ((max(prompt_lengths(args)) + args.new_tokens + 127) // 128) * 128
    engine = ServingEngine(cfg, params, max_seq=max_seq, slots=args.slots,
                           paged=args.paged, block_size=args.block_size,
                           num_blocks=args.num_blocks or None,
                           prefix_sharing=args.prefix_sharing, kv_pool_dtype=args.kv_dtype,
                           device=args.device)
    reqs = make_requests(args, cfg)
    for r in reqs:
        engine.submit(r)
    if hook is not None:
        hook(engine)
    t0 = time.perf_counter()
    stats = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(engine=engine, requests=reqs, summary=stats.summary(),
                wall_s=time.perf_counter() - t0)


def report(args, out: dict) -> None:
    s = out["summary"]
    print(f"completed {s['completed']} requests | prefill {s['prefill_s']}s "
          f"decode {s['decode_s']}s over {s['ticks']} ticks "
          f"({s['decode_calls']} fused decode calls, "
          f"{s['decode_ms_per_tick']} ms/tick, "
          f"{s['decode_ms_per_step']} ms/token)")
    print(f"latency: mean TTFT {s['mean_ttft_s']}s "
          f"(queue wait {s['mean_queue_wait_s']}s)")
    for r in out["requests"]:
        print(f"  request {r.rid}: prompt {len(r.prompt)} tokens, TTFT {r.ttft_s:.4f}s, "
              f"{len(r.output)} tokens, stop {r.stop_reason}")
    if args.paged:
        print(f"block pool: {s['peak_blocks_in_use']}/{s['block_pool_size']} "
              f"blocks at peak (utilization {s['block_utilization']}), "
              f"{s['overflows']} overflows")
    if args.prefix_sharing:
        print(f"prefix sharing: {s['shared_blocks']} blocks shared across "
              f"{s['prefix_hits']} hits, {s['cow_copies']} CoW copies, "
              f"{s['memory_saved_tokens']} tokens of HBM saved")
    print("decode/(prefill+decode) time share: "
          f"{s['decode_s']/max(s['prefill_s']+s['decode_s'], 1e-9):.1%} "
          "(the paper's Fig.1 regime: decode dominates long-context serving)")


def spill_demo(args, cfg, params) -> list[str]:
    """Tiered KV memory at a fixed HBM byte budget: the same long-context
    request is rejected by an fp16 pool, rejected by a plain int8 pool
    (still one block short), and completes on the int8 pool once cold
    blocks may spill to the host tier. Returns the lines it printed."""
    from repro_torch.core.cache import block_data_bytes, empty_paged_cache
    from repro_torch.models.blocks import salca_params_for

    bs = args.block_size
    need = 7                                    # request lifetime in blocks
    prompt_len = need * bs - args.new_tokens
    max_seq = ((prompt_len + args.new_tokens + 127) // 128) * 128
    r = salca_params_for(cfg, max_seq).r(cfg.resolved_head_dim)

    def bb(dt):
        return block_data_bytes(empty_paged_cache(
            1, bs, 1, max_seq // bs, cfg.num_kv_heads, cfg.resolved_head_dim, r,
            kv_pool_dtype=dt))

    budget = 4 * bb("fp16")                     # an fp16 pool of 4 blocks
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, prompt_len).astype(np.int32)
    want_dt = args.kv_dtype or "int8"
    lines = [f"\ntiered-KV demo: {prompt_len}-token context needs {need} blocks x {bs} "
             f"tokens; HBM budget {budget} B per layer (= 4 fp16 blocks)"]
    print(lines[-1])
    for tag, dt, spill in (("fp16", "fp16", False), (want_dt, want_dt, False),
                           (f"{want_dt}+spill", want_dt, True)):
        blocks = int(budget // bb(dt))
        engine = ServingEngine(cfg, params, max_seq=max_seq, slots=1, paged=True,
                               block_size=bs, num_blocks=blocks, kv_pool_dtype=dt,
                               host_spill=spill, device=args.device)
        req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=args.new_tokens)
        try:
            engine.submit(req)
        except ValueError as e:                 # the pool can never hold it
            lines.append(f"  {tag}: pool {blocks} blocks — rejected at submit ({e})")
            print(lines[-1])
            continue
        s = engine.run().summary()
        line = (f"  {tag}: pool {blocks} blocks — stop_reason={req.stop_reason}, "
                f"{len(req.output)}/{args.new_tokens} tokens, {s['overflows']} overflows")
        if spill:
            line += (f", {s['demotions']} demotions / {s['promotions']} promotions, "
                     f"peak cold {s['peak_cold_blocks']} blocks, {s['pcie_bytes']} PCIe bytes")
        lines.append(line)
        print(line)
    print("  → the byte budget that rejects the request at fp16 (and still at int8) "
          "serves it once rarely-selected blocks demote to host memory and resurrect "
          "on demand.")
    return lines


def _shard_request(args, cfg) -> tuple[Request, int]:
    """The --shards demo's request: a context needing about two shards'
    blocks; returns it and its max_seq."""
    bs = args.block_size
    prompt_len = 2 * args.blocks_per_shard * bs - args.new_tokens
    max_seq = ((prompt_len + args.new_tokens + 127) // 128) * 128
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, prompt_len).astype(np.int32)
    return Request(rid=0, prompt=prompt, max_new_tokens=args.new_tokens), max_seq


def _serve_shards(args, cfg, params, shards: int, ctx) -> dict:
    """The --shards demo's request on a pool of ``shards`` × blocks-per-shard
    blocks (block-sharded over ``ctx`` when given)."""
    req, max_seq = _shard_request(args, cfg)
    blocks = shards * args.blocks_per_shard
    engine = ServingEngine(cfg, params, max_seq=max_seq, slots=1, ctx=ctx, paged=True,
                           block_size=args.block_size, num_blocks=blocks, device=args.device)
    try:
        engine.submit(req)
    except ValueError as e:                     # the pool can never hold it
        return dict(shards=shards, blocks=blocks, rejected=str(e))
    s = engine.run().summary()
    return dict(shards=shards, blocks=blocks, stop_reason=req.stop_reason,
                output=list(req.output), peak_blocks=s["peak_blocks_in_use"],
                peak_shard_blocks=s.get("peak_shard_blocks_in_use"),
                world=ctx.world_size if ctx is not None else 1)


def _rank_main(args) -> None:
    """One spawned rank of the --shards demo on the CPU: join the gloo world
    through the file store, serve, and (rank 0) write the result."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import init_decode_ctx
    store = dist.FileStore(os.path.join(args.store, "store"), args.shards)
    ctx = init_decode_ctx("cpu", rank=args.rank, world_size=args.shards, store=store)
    cfg = model_config(args)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = _serve_shards(args, cfg, params, args.shards, ctx)
    if args.rank == 0:
        with open(os.path.join(args.store, "result.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def _spawn_shards(args, argv) -> dict:
    """Run the N-shard pool as N spawned gloo ranks; rank 0's result."""
    with tempfile.TemporaryDirectory() as work:
        cmd = [sys.executable, os.path.abspath(__file__), *argv, "--store", work]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(args.shards)]
        logs = [p.communicate(timeout=900)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise RuntimeError(f"--shards rank {r} exited {p.returncode}:\n{log}")
        with open(os.path.join(work, "result.json")) as f:
            return json.load(f)


def sharded_demo(args, cfg, params, argv) -> list[dict]:
    """One long-context request against a fixed per-shard pool: it overflows
    a 1-shard pool and completes when the block pool spans --shards shards.
    Returns each run's result."""
    from repro_torch.distributed.sharding import init_decode_ctx
    req, _ = _shard_request(args, cfg)
    dev = torch.device(args.device)
    where = (f"{args.shards} gloo ranks" if dev.type == "cpu"
             else "one nccl rank holding every shard's blocks (one card)")
    print(f"\nsharded-pool demo: {len(req.prompt)}-token context, {args.blocks_per_shard} "
          f"blocks x {args.block_size} tokens per shard; the {args.shards}-shard pool on "
          f"{where}")
    results = [_serve_shards(args, cfg, params, 1, None)]
    if dev.type == "cpu":
        results.append(_spawn_shards(args, argv))
    else:
        results.append(_serve_shards(args, cfg, params, args.shards,
                                     init_decode_ctx(args.device)))
    for r in results:
        head = f"  shards={r['shards']}: pool {r['blocks']} blocks — "
        if "rejected" in r:
            print(head + f"rejected at submit ({r['rejected']})")
            continue
        print(head + f"stop_reason={r['stop_reason']}, {len(r['output'])}/"
              f"{args.new_tokens} tokens, peak blocks {r['peak_blocks']}"
              + (f", hottest shard {r['peak_shard_blocks']}/{args.blocks_per_shard}"
                 if r["peak_shard_blocks"] is not None else ""))
    print("  → the same per-shard budget that overflows one shard completes when "
          "the page tables resolve across the shards.")
    return results


def main(argv=None) -> None:
    ap = parse_args()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.shards > 1 or args.host_spill:
        args.paged = True
    if args.rank is not None:
        _rank_main(args)
        return
    cfg = model_config(args)
    print(f"arch={args.arch} ({'full' if args.full else 'reduced'}: {cfg.num_layers}L "
          f"d={cfg.d_model}, salca={'on' if cfg.salca else 'off — ' + cfg.family})")
    t0 = time.time()
    params = init_lm_params(cfg, torch.Generator(device=args.device).manual_seed(0),
                            args.device)
    n = sum(t.numel() for _, t in leaves(params))
    print(f"init {time.time()-t0:.1f}s, params {n/1e6:.1f}M")
    if args.shards > 1:
        sharded_demo(args, cfg, params, argv)
        return
    if args.host_spill:
        spill_demo(args, cfg, params)
        return
    report(args, serve(args, cfg, params))


if __name__ == "__main__":
    main()
