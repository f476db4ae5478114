"""One rank of a multi-process check of the port's block-sharded decode.

    python tests/_torch_dist_worker.py <task> <workdir> <rank> <world>

Spawned by tests/test_torch_sharded.py, one process per rank, all joined
over gloo through a `FileStore` in ``workdir`` (no TCP port). Reads the
task's inputs from ``workdir/in.pt`` and writes this rank's results to
``workdir/out<rank>.pt``. Imports torch and the port only.

Tasks:
  island  build this rank's share of a pool from replicated prefills and
          appends, then run the sharded Salca and dense ticks;
  engine  run `ServingEngine(ctx=...)` on a request trace, recording every
          tick's logits and layer-0 page table.
"""

import dataclasses
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
    out, sel = sp_salca_decode_paged(inp["q"], pool, params, ctx, return_selection=True)
    dense = sp_dense_decode_paged(inp["q"], pool, ctx)
    leaves = {f: getattr(pool, f).clone() for f in tc._DATA_FIELDS + (
        "page_table", "length", "refcount")}
    return dict(out=out, dense=dense, sel=tuple(sel), leaves=leaves)


def engine(inp, ctx):
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import Request, ServingEngine
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="float32")
    eng = ServingEngine(cfg, inp["weights"], paged=True, device="cpu", ctx=ctx,
                        **inp["engine"])
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=inp["new_tokens"])
            for i, p in enumerate(inp["prompts"])]
    for r in reqs:
        eng.submit(r)
    ticks = []
    orig = eng._decode

    def recording(tokens, mask):
        nxt, logits = orig(tokens, mask)
        ticks.append((mask.copy(), logits.clone(), eng._state.caches[0].page_table.clone()))
        return nxt, logits

    eng._decode = recording
    stats = eng.run()
    pools_ok = all(c.check_invariants(free_blocks=eng._free_blocks,
                                      host_refcount=eng._refcount).ok
                   for c in eng._state.caches)
    return dict(outputs=[r.output for r in reqs], stops=[r.stop_reason for r in reqs],
                ticks=ticks, free=sorted(eng._free_blocks), stats=stats.summary(),
                pools_ok=pools_ok)


def main() -> int:
    task, workdir, rank, world = sys.argv[1], pathlib.Path(sys.argv[2]), *map(int, sys.argv[3:5])
    torch.set_num_threads(1)
    inp = torch.load(workdir / "in.pt", weights_only=False)
    ctx = init_decode_ctx("cpu", rank=rank, world_size=world,
                          store=dist.FileStore(str(workdir / "store"), world))
    res = {"island": island, "engine": engine}[task](inp, ctx)
    torch.save(res, workdir / f"out{rank}.pt")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
