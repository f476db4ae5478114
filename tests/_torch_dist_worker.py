"""One rank of a multi-process check of the port's sharded decode.

    python tests/_torch_dist_worker.py <task> <workdir> <rank> <world>

Spawned by tests/test_torch_sharded.py and the other tests/test_torch_*.py
files, one process per rank, all joined
over gloo through a `FileStore` in ``workdir`` (no TCP port). Reads the
task's inputs from ``workdir/in.pt`` and writes this rank's results to
``workdir/out<rank>.pt``. Imports torch and the port only.

Tasks:
  island  build this rank's share of a pool from replicated prefills and
          appends, then run the sharded Salca (the fused island, or with
          ``fused`` False the logical-gather one) and dense ticks;
  engine  run `ServingEngine(ctx=...)` on a request trace, recording every
          tick's logits and layer-0 page table;
  prefix  the engine task, and a pool-level copy on write across ranks in
          every storage mode (`cow_block` with this rank's block range);
  scheduler  the engine task on a chunked, preempting engine, recording
          the page row of every chunk step;
  lifecycle  the engine task under a fault plan that each rank builds from
          the same seed, returning the faults it fired;
  cache   a persistent-prefix-cache engine serving a visit trace one request
          at a time, recording per visit the tokens and the pinned radix
          keys, and every block the cache evicted (key and id);
  sp_flat the sequence-sharded flat island on every case: this rank's rows
          written from the replicated prefill, the append at the global
          cursor, `sp_salca_decode` (with its bins, pooled bins, all-reduced
          histogram and Selection) and `sp_dense_decode`;
  sp_engine  `ServingEngine(ctx=...)` on each of a list of engine runs (the
          contiguous cache split by rows, or paged with sequence-sharded
          rings), recording per tick the logits and, per "A" layer, this
          rank's selected counts;
  collectives  qwen3-0.6b.reduced() served for one decode tick under ``ctx``
          on the contiguous pool (the sequence-sharded flat tick) and on
          the paged pool (the block-sharded tick), recording every
          collective the tick hands to torch.distributed (kind, bytes) and
          `analysis.collectives.TRACE`'s summary of the same tick;
  encdec  whisper-small.reduced()'s pooled decode state split by rows,
          written from replicated batch=1 prefills, then greedy ticks of
          the enc-dec decode step under ``ctx``, recording each tick's
          tokens and logits.
"""

import dataclasses
import os
import pathlib
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.distributed.sharding import init_decode_ctx, local_block_range  # noqa: E402


def island(inp, ctx):
    from repro_torch.core import cache as tc
    from repro_torch.core.selection import SalcaParams
    from repro_torch.core.sp_decode import sp_dense_decode_paged, sp_salca_decode_paged
    params = SalcaParams(**inp["params"])
    nb, bs, mb, kv, hd = (inp[k] for k in ("num_blocks", "bs", "mb", "kv", "hd"))
    br = local_block_range(nb, ctx)
    pool = tc.empty_paged_cache(nb, bs, inp["slots"], mb, kv, hd, params.r(hd),
                                local_blocks=br[1] - br[0])
    for slot, k, v, pages in inp["prefills"]:
        src = tc.prefill_cache(k, v, max_seq=mb * bs, params=params)
        tc.prefill_into_pages(pool, src, slot, pages, block_range=br)
    for k1, v1 in inp["appends"]:
        tc.append_token_paged(pool, k1, v1, block_range=br)
    out, sel = sp_salca_decode_paged(inp["q"], pool, params, ctx, return_selection=True,
                                     fused=inp.get("fused", True))
    dense = sp_dense_decode_paged(inp["q"], pool, ctx)
    leaves = {f: getattr(pool, f).clone() for f in tc._DATA_FIELDS + (
        "page_table", "length", "refcount")}
    return dict(out=out, dense=dense, sel=tuple(sel), leaves=leaves)


def engine(inp, ctx, hook=None):
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import Request, ServingEngine
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="float32",
                              **inp.get("cfg", {}))
    eng = ServingEngine(cfg, inp["weights"], paged=True, device="cpu", ctx=ctx,
                        **inp["engine"])
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=inp["new_tokens"])
            for i, p in enumerate(inp["prompts"])]
    for r in reqs:
        eng.submit(r)
    if hook is not None:
        hook(eng)
    ticks = []
    orig = eng._decode

    def recording(tokens, mask):
        out = orig(tokens, mask)
        ticks.append((mask.copy(), out[1].clone(), eng._state.caches[0].page_table.clone()))
        return out

    eng._decode = recording
    stats = eng.run()
    pools_ok = all(c.check_invariants(free_blocks=eng._free_blocks,
                                      host_refcount=eng._refcount).ok
                   for c in eng._state.caches)
    return dict(outputs=[r.output for r in reqs], stops=[r.stop_reason for r in reqs],
                ticks=ticks, free=sorted(eng._free_blocks), stats=stats.summary(),
                pools_ok=pools_ok, audit_ok=eng.check_invariants().ok)


def cow(inp, ctx):
    """Per storage mode: this rank's share of a pool built from a replicated
    prefill, a shared slot, ``steps`` of `cow_block` (slot, logical, new
    page) and one append; returns the rank's leaves."""
    from repro_torch.core import cache as tc
    from repro_torch.core.selection import SalcaParams
    params = SalcaParams(**inp["params"])
    nb, bs, slots, mb, kv, hd = inp["shape"]
    br = local_block_range(nb, ctx)
    out = {}
    for mode in ("int8", "fp16", "int4"):
        pool = tc.empty_paged_cache(nb, bs, slots, mb, kv, hd, params.r(hd), kv_pool_dtype=mode,
                                    local_blocks=br[1] - br[0])
        src = tc.prefill_cache(inp["k"], inp["v"], max_seq=mb * bs, params=params)
        tc.prefill_into_pages(pool, src, 1, inp["pages"], block_range=br)
        tc.share_blocks(pool, 1, 2, 0)
        for slot, logical, page in inp["steps"]:
            tc.cow_block(pool, slot, logical, page, br, ctx.group)
        tc.append_token_paged(pool, inp["k1"], inp["v1"], block_range=br)
        out[mode] = {f: getattr(pool, f).clone() for f in tc._DATA_FIELDS + (
            "page_table", "length", "refcount", "heavy_idx")}
    return out


def prefix(inp, ctx):
    return dict(engine(inp, ctx), cow=cow(inp["cow"], ctx))


def scheduler(inp, ctx):
    chunks = []

    def hook(eng):
        real = eng.api.prefill_chunk

        def chunk(params, pool, tokens, cursor, slot, pages, *a, **kw):
            chunks.append(pages.copy())
            return real(params, pool, tokens, cursor, slot, pages, *a, **kw)

        eng.api = eng.api._replace(prefill_chunk=chunk)

    return dict(engine(inp, ctx, hook), chunk_pages=chunks)


def lifecycle(inp, ctx):
    """The engine task under a fault plan built on this rank from
    ``inp["faults"]`` = (seed, [(site, kwargs)]); also returns the plan's
    fired log."""
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    seed, specs = inp["faults"]
    plan = FaultPlan(seed=seed, specs=tuple(FaultSpec(site=s, **kw) for s, kw in specs))
    res = engine(dict(inp, engine=dict(inp["engine"], faults=plan)), ctx)
    return dict(res, fired=plan.fired_log)


def cache(inp, ctx):
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import Request, ServingEngine
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="float32",
                              **inp.get("cfg", {}))
    eng = ServingEngine(cfg, inp["weights"], paged=True, device="cpu", ctx=ctx,
                        **inp["engine"])
    victims, blocks, real = [], [], eng._cache_victim

    def victim(protect=frozenset()):
        b = real(protect)
        if b is not None:
            victims.append(eng._block_keys[b])
            blocks.append(b)
        return b

    eng._cache_victim = victim
    ticks, orig = [], eng._decode

    def recording(tokens, mask):
        out = orig(tokens, mask)
        ticks.append((mask.copy(), out[1].clone(), eng._state.caches[0].page_table.clone()))
        return out

    eng._decode = recording
    log = []
    for rid, i in enumerate(inp["visits"]):
        r = Request(rid=rid, prompt=inp["prompts"][i].copy(), max_new_tokens=inp["new_tokens"])
        eng.submit(r)
        eng.run()
        log.append((r.output, sorted(eng._block_keys[b] for b in eng._cached)))
    stats = dataclasses.asdict(eng.stats)
    audit_ok = eng.check_invariants().ok
    taken = dict(victims=list(victims), victim_blocks=list(blocks))   # not the flush's
    eng.flush_prefix_cache()
    drained = (eng.check_invariants().ok and sorted(eng._free_blocks) == list(
        range(eng.num_blocks)) and not eng._refcount.any() and not eng._prefix_nodes)
    return dict(taken, log=log, ticks=ticks, stats=stats, audit_ok=audit_ok, drained=drained)


def sp_flat_case(case, ctx):
    """One case of `tests/_torch_sp_reference.py`'s island on this rank."""
    from repro_torch.core import cache as tc
    from repro_torch.core import histogram_topk as tht
    from repro_torch.core import quantization as tqz
    from repro_torch.core import sp_decode as tsp
    from repro_torch.core.selection import SalcaParams
    from repro_torch.distributed.sharding import local_row_range
    from repro_torch.kernels.hist_topk import ops as thk
    params = SalcaParams(**case["params"])
    k, v = torch.from_numpy(case["k"]), torch.from_numpy(case["v"])
    b, _, kv, hd = k.shape
    rows = local_row_range(case["rows"], ctx)
    src = tc.prefill_cache(k, v, max_seq=case["rows"], params=params)
    cache = tc.empty_cache(b, rows[1] - rows[0], kv, hd, params.r(hd))
    for slot in range(b):
        tc.write_prefill_into_slot(cache, tc.SalcaCache(*(x[slot:slot + 1] for x in src)),
                                   slot, rows)
    stash, real = {}, (tqz.bins_from_bounds, tht.locate_threshold, thk.hist_threshold)

    def bins(*a):
        stash["bins"] = out = real[0](*a)
        return out

    def locate(hist, k_):
        stash["hist"] = hist.clone()
        return real[1](hist, k_)

    def counts(pooled, k_):
        stash["pooled"] = pooled.clone()
        return real[2](pooled, k_)

    tqz.bins_from_bounds, tht.locate_threshold, thk.hist_threshold = bins, locate, counts
    try:
        wp = torch.as_tensor(case["cursor"], dtype=torch.int32)
        vl = torch.as_tensor(case["valid_len"], dtype=torch.int32)
        tsp.sp_append_token(cache, torch.from_numpy(case["k1"]), torch.from_numpy(case["v1"]),
                            wp, ctx)
        cache.length.copy_(tsp.local_lengths(vl, cache.max_seq, ctx))
        q = torch.from_numpy(case["q"])
        out, sel = tsp.sp_salca_decode(q, cache, params, ctx, shard_cap=case.get("shard_cap"),
                                       return_selection=True)
    finally:
        tqz.bins_from_bounds, tht.locate_threshold, thk.hist_threshold = real
    dense = tsp.sp_dense_decode(q, cache, ctx, window=case["window"], global_len=vl)
    leaves = {f: getattr(cache, f).clone() for f in tc._DATA_FIELDS + ("length",)}
    return dict(out=out, dense=dense, sel=tuple(sel), leaves=leaves, **stash)


def sp_flat(inp, ctx):
    return [sp_flat_case(c, ctx) for c in inp["cases"]]


def sp_engine(inp, ctx):
    """Each run of ``inp["runs"]``: (config name, engine kwargs, prompts,
    new tokens, flags). Returns per run the outputs, each tick's mask,
    logits and (slot, rid, tokens so far) of its active slots, and per tick
    and "A" layer this rank's Selection counts."""
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.runtime.serve import Request, ServingEngine
    out = []
    real = blocks.sp_salca_decode
    for arch, kw, prompts, new_tokens, perf in inp["runs"]:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        counts = []

        def counting(*a, **k):
            o, sel = real(*a, return_selection=True, **k)
            counts[-1].append(sel.count.clone())
            return o

        with flags.perf_flags(**perf):
            eng = ServingEngine(cfg, inp["weights"][arch], device="cpu", ctx=ctx, **kw)
            reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=new_tokens)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            ticks, orig = [], eng._decode

            def recording(tokens, mask):
                counts.append([])
                who = [(slot, req.rid, len(req.output)) for slot, req in eng._active.items()
                       if mask[slot]]
                res = orig(tokens, mask)
                ticks.append((mask.copy(), res[1].clone(), who))
                return res

            eng._decode = recording
            blocks.sp_salca_decode = counting
            try:
                stats = eng.run()
            finally:
                blocks.sp_salca_decode = real
        out.append(dict(outputs=[r.output for r in reqs], ticks=ticks,
                        counts=[torch.stack(c) if c else None for c in counts],
                        stats=stats.summary()))
    return out


def encdec(inp, ctx):
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = dataclasses.replace(get_config("whisper-small").reduced(), dtype="float32")
    api = get_model(cfg)
    slots = len(inp["prefills"])
    pool = api.init_state(slots, inp["t_enc"], "cpu", ctx)
    for slot, (frames, tokens) in enumerate(inp["prefills"]):
        _, src = api.prefill(inp["weights"], tokens, frames=frames)
        api.write_into_slot(pool, src, slot, ctx=ctx)
    tok, act, out = inp["first"], torch.from_numpy(inp["active"].copy()), []
    for _ in range(inp["ticks"]):
        logits, pool = api.decode_step(inp["weights"], pool, torch.from_numpy(tok), act, ctx)
        tok = logits.argmax(-1).numpy().astype("int32")
        out.append((tok, logits.numpy()))
    return out


def collectives(inp, ctx):
    import numpy as np

    from repro_torch.analysis.collectives import TRACE
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import COLLECTIVES
    from repro_torch.runtime.serve import Request, ServingEngine
    from repro_torch.weights import init_lm_params
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="float32")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    issued, out = [], {}
    real = {"all-reduce": dist.all_reduce, "all-gather": dist.all_gather_into_tensor}

    def logged(op):
        def call(*a, **k):
            t = a[0]
            issued.append((op, t.numel() * t.element_size()))
            return real[op](*a, **k)
        return call

    for paged in (False, True):
        eng = ServingEngine(cfg, params, max_seq=256, slots=2, paged=paged, block_size=32,
                            device="cpu", ctx=ctx)
        prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 150).astype(np.int32)
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
        orig = eng._decode

        def tick(*a, orig=orig):
            issued.clear()
            TRACE.reset()
            COLLECTIVES.clear()
            dist.all_reduce = logged("all-reduce")
            dist.all_gather_into_tensor = logged("all-gather")
            try:
                return orig(*a)
            finally:
                dist.all_reduce = real["all-reduce"]
                dist.all_gather_into_tensor = real["all-gather"]

        eng._decode = tick
        eng.run()
        out["paged" if paged else "contiguous"] = dict(
            issued=list(issued), summary=TRACE.summary(), counted=dict(COLLECTIVES))
    return out


def main() -> int:
    task, workdir, rank, world = sys.argv[1], pathlib.Path(sys.argv[2]), *map(int, sys.argv[3:5])
    torch.set_num_threads(1)
    inp = torch.load(workdir / "in.pt", weights_only=False)
    ctx = init_decode_ctx("cpu", rank=rank, world_size=world,
                          store=dist.FileStore(str(workdir / "store"), world))
    res = {"island": island, "engine": engine, "prefix": prefix,
           "scheduler": scheduler, "lifecycle": lifecycle, "cache": cache,
           "sp_flat": sp_flat, "sp_engine": sp_engine, "encdec": encdec,
           "collectives": collectives}[task](inp, ctx)
    torch.save(res, workdir / f"out{rank}.pt")
    dist.barrier()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # no process-group teardown: under load, gloo's teardown can abort a rank
    # whose peer closed its sockets first, after both results were written
    os._exit(code)
