"""Port parity, the block-sharded paged decode tick (kernels B4, B5, B6 and
`ServingEngine(ctx=...)`) against the JAX reference.

* B4 (scores + bounds) and B5 (bin, pool, force, histogram): the plain
  versions bit for bit against `paged_score_bounds_pallas` and
  `paged_fused_select_pallas` in interpret mode. B6 (attention partials):
  within 1e-5 of `sparse_flash_decode_paged_partials_pallas` (the
  reference's own bound, tests/test_kernels.py), rows with nothing
  selected exactly (0, -1e30, 0).
* Shard-local pool primitives: each rank's leaves equal its slice of the
  JAX pool bit for bit; sharded refcount, page resolution and the
  rank-local block plan likewise.
* The island (`sp_salca_decode_paged`): at one rank (in-process gloo group)
  against the JAX island in `shard_map` on a one-device mesh — selection
  and threshold bit for bit, outputs within 1e-5; at 2 and 4 gloo ranks
  (spawned processes, `tests/_torch_dist_worker.py`) against the JAX
  unsharded tick — the union of the ranks' selections and the thresholds
  bit for bit, every rank's output within 1e-5.
* The engine: at one rank against the JAX engine on a one-device mesh, at
  two ranks against both unsharded engines — greedy tokens identical, ranks
  in lockstep (same tokens, logits and page tables), no leaked block.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_bridge import POOL_FIELDS, assert_fields_equal, f32_configs, tn, tt
from repro import compat
from repro.core import cache as jc
from repro.core.attention import dense_decode_from_paged as j_dense
from repro.core.attention import salca_decode_attention_paged as j_attn
from repro.core.maxpool import maxpool1d_blocked_halo as j_halo_pool
from repro.core.selection import SalcaParams as JParams
from repro.core.sp_decode import sp_dense_decode_paged as j_sp_dense
from repro.core.sp_decode import sp_salca_decode_paged as j_sp_salca
from repro.kernels.flash_decode.kernel import sparse_flash_decode_paged_partials_pallas
from repro.kernels.flash_decode.ops import _selected_block_plan as j_plan
from repro.kernels.score_est.kernel import paged_score_bounds_pallas
from repro.kernels.selection_fused.kernel import paged_fused_select_pallas
from repro.models import get_model as jget_model
from repro.models.blocks import DecodeCtx as JCtx
from repro.models.blocks import paged_cache_pspec
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro.runtime.serve import ShardedBlockAllocator as JAlloc
from repro_torch.core import cache as tc
from repro_torch.core.maxpool import maxpool1d_blocked_halo as t_halo_pool
from repro_torch.core.selection import SalcaParams as TParams
from repro_torch.core.sp_decode import sp_dense_decode_paged as t_sp_dense
from repro_torch.core.sp_decode import sp_salca_decode_paged as t_sp_salca
from repro_torch.distributed.sharding import DecodeCtx, init_decode_ctx, pmin
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_decode.ops import _selected_block_plan as t_plan
from repro_torch.kernels.flash_decode.ops import sparse_flash_decode_paged_partials_kernel
from repro_torch.kernels.score_est.ops import paged_score_bounds
from repro_torch.kernels.selection_fused.ops import paged_fused_select
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.runtime.serve import ShardedBlockAllocator as TAlloc
from repro_torch.weights import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30
DATA = tc._DATA_FIELDS
# island shapes: the reference's sharded battery (tests/_sharded_pool_check.py)
S, KV, HD, BS, MB, NB = 4, 2, 64, 16, 8, 32
H = 2 * KV
LENGTHS = (120, 77, 33, 0)        # the last slot holds nothing: an all-masked row
ISLAND_PARAMS = {"pool7_sink_recent": dict(k=24, k_cap=32, pool_window=7, sink_tokens=2,
                                           recent_tokens=4),
                 "no_pool": dict(k=24, k_cap=32, pool_window=1),
                 # 40 forced recent tokens > k_cap: the global-rank capacity cut
                 "capacity_cut": dict(k=16, k_cap=24, pool_window=7, sink_tokens=2,
                                      recent_tokens=40)}


@pytest.fixture(scope="module")
def world1():
    """The in-process world of one rank (gloo over a HashStore)."""
    return init_decode_ctx("cpu")


def _bounds_inputs(rng, s=3, kv=2, g=1, r=32, p=20, bs=16, mb=4):
    q_codes = rng.integers(-3, 4, (s, kv, g, r)).astype(np.int8)
    valid = rng.random((s, mb, bs)) < 0.7
    valid[1] = False                                  # a row with nothing valid
    return dict(
        q_codes=q_codes,
        q_scale=rng.uniform(1e-3, 1.0, (s, kv, g)).astype(np.float32),
        q_sums=q_codes.astype(np.int32).sum(-1).astype(np.int32),
        feat_words=rng.integers(0, 2 ** 32, (p, bs, kv, r // 16), dtype=np.uint64)
        .astype(np.uint32),
        feat_scale=rng.uniform(1e-3, 0.5, (p, bs, kv)).astype(np.float32),
        feat_zero=rng.normal(size=(p, bs, kv)).astype(np.float32),
        pages=rng.permutation(p)[:s * mb].reshape(s, mb).astype(np.int32),
        blk_valid=valid)


@pytest.mark.parametrize("g,bf16", [(1, True), (2, True), (2, False)])
def test_b4_plain_bitwise_vs_pallas(rng, g, bf16):
    """Scrambled pages, a partly masked and an all-masked row: scores, lo
    (+inf on the all-masked row) and hi bit for bit under the default
    bf16-pinned chain. Unpinned, the reference lets XLA contract the f32
    chain into FMAs, so there only float agreement is defined (as for B1)."""
    x = _bounds_inputs(rng, g=g)
    names = list(x)
    pal = paged_score_bounds_pallas(*(jnp.asarray(x[n]) for n in names), bf16=bf16,
                                    interpret=True)
    before = dict(LAUNCHES)
    out = paged_score_bounds(*(tt(x[n]) for n in names), bf16=bf16)
    assert dict(LAUNCHES) == before          # CPU tensors never count a launch
    for t, j in zip(out, pal):
        if bf16:
            np.testing.assert_array_equal(tn(t), np.asarray(j))
        else:
            np.testing.assert_allclose(tn(t), np.asarray(j), **TOL)
    assert np.isinf(tn(out[1])[1]).all() and (tn(out[1])[1] > 0).all()


def _select_inputs(rng, window, s=3, kv=2, mb=5, bs=16):
    valid = rng.random((s, mb, bs)) < 0.8
    valid[2] = False
    scores = rng.normal(size=(s, kv, mb, bs)).astype(np.float32)
    scores = np.where(valid[:, None], scores, np.float32(-3.0e38))
    lo = np.where(valid.any((1, 2))[:, None], scores.min(axis=(2, 3)) - 0.5, np.inf)
    hi = scores.max(axis=(2, 3)) + rng.uniform(0, 1, (s, kv))
    halo = max(window // 2, 1)
    edge = lambda: rng.integers(0, 256, (s, kv, mb, halo)).astype(np.uint8) * (window > 1)
    force = np.zeros((s, mb, bs), bool)
    force[:, 0, :2] = True                            # sink columns
    force[0, -1, -4:] = True                          # recent columns
    return dict(scores=scores, lo=lo.astype(np.float32), hi=hi.astype(np.float32),
                from_left=edge(), from_right=edge(), blk_valid=valid, force=force)


@pytest.mark.parametrize("window", [1, 3, 7])
def test_b5_plain_bitwise_vs_pallas(rng, window):
    """Binning with external bounds (an all-masked row among them), pooling
    with explicit halo columns, sink/recent force: pooled bins and the raw
    histogram bit for bit."""
    x = _select_inputs(rng, window)
    names = list(x)
    pal = paged_fused_select_pallas(*(jnp.asarray(x[n]) for n in names), window=window,
                                    interpret=True)
    out = paged_fused_select(*(tt(x[n]) for n in names), window=window)
    for t, j in zip(out, pal):
        np.testing.assert_array_equal(tn(t), np.asarray(j))


@pytest.mark.parametrize("window", [1, 3, 7])
def test_b5_plain_bitwise_vs_pallas_on_empty_blocks(rng, window):
    """The cases the card kernel takes a shortcut on: blocks with nothing
    valid interleaved with partly valid ones (their bins are all 0 and
    their positions count to bin 0 whatever the halo columns and force
    bytes hold), and force set on invalid positions (never 255)."""
    x = _select_inputs(rng, window, mb=8)
    s, mb, bs = x["blk_valid"].shape
    empty = np.zeros((s, mb), bool)
    empty[:, 1::2] = True                             # every other block
    empty[1, :3] = True                               # and a run of three
    x["blk_valid"] = x["blk_valid"] & ~empty[..., None]
    x["blk_valid"][0, 2, :5] = False                  # a partly valid block
    x["scores"] = np.where(x["blk_valid"][:, None], x["scores"], np.float32(-3.0e38))
    x["force"] = rng.random((s, mb, bs)) < 0.3
    assert (x["force"] & ~x["blk_valid"]).any() and (x["force"] & x["blk_valid"]).any()
    names = list(x)
    pal = paged_fused_select_pallas(*(jnp.asarray(x[n]) for n in names), window=window,
                                    interpret=True)
    out = paged_fused_select(*(tt(x[n]) for n in names), window=window)
    for t, j in zip(out, pal):
        np.testing.assert_array_equal(tn(t), np.asarray(j))
    pooled = tn(out[0])
    assert (pooled.transpose(0, 2, 1, 3)[empty] == 0).all()        # (slot, block) first
    assert (pooled[np.broadcast_to((x["force"] & x["blk_valid"])[:, None], pooled.shape)]
            == 255).all()


@pytest.mark.parametrize("g", [1, 2])
def test_b6_plain_vs_pallas(rng, g):
    p, bs, kv, hd, bh, nsb = 12, 16, 2, 32, 6, 4
    q = rng.normal(size=(bh, g, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (p, bs, kv, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (p, bs, kv, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 0.05, (p, bs, kv)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.05, (p, bs, kv)).astype(np.float32)
    counts = np.array([2, 0, 4, 1, 0, 3], np.int32)
    pblk = rng.integers(0, p, (bh, nsb)).astype(np.int32)
    bmask = (rng.random((bh, nsb, bs)) < 0.5) & (np.arange(nsb)[None, :, None]
                                                 < counts[:, None, None])
    args = (q, kc, ks, vc, vs, pblk, counts, bmask)
    pal = sparse_flash_decode_paged_partials_pallas(*map(jnp.asarray, args), num_kv=kv,
                                                    interpret=True)
    out = sparse_flash_decode_paged_partials_kernel(*map(tt, args), kv)
    empty = counts == 0
    for t, j in zip(out, pal):
        np.testing.assert_allclose(tn(t)[~empty], np.asarray(j)[~empty], **TOL)
        np.testing.assert_array_equal(tn(t)[empty], np.asarray(j)[empty])
    acc, m, l = (tn(t)[empty] for t in out)
    assert (acc == 0).all() and (m == np.float32(NEG_INF)).all() and (l == 0).all()


def test_maxpool_blocked_halo_bitwise(rng):
    x = rng.integers(0, 256, (2, 3, 6, 8)).astype(np.uint8)
    fl, fr = (rng.integers(0, 256, (2, 3, 6, 3)).astype(np.uint8) for _ in range(2))
    np.testing.assert_array_equal(tn(t_halo_pool(tt(x), 7, tt(fl), tt(fr))),
                                  np.asarray(j_halo_pool(jnp.asarray(x), 7, jnp.asarray(fl),
                                                         jnp.asarray(fr))))


# ---------------------------------------------------------------------------
# pools: global JAX pool vs per-rank port pools
# ---------------------------------------------------------------------------

def _island_inputs(rng, params):
    """Replicated prefills over scrambled pages (each slot's blocks spread
    over every rank's range), two appends, and a query."""
    perm = rng.permutation(NB)
    prefills, used = [], 0
    for slot, t in enumerate(LENGTHS):
        if not t:
            continue
        k = rng.normal(size=(1, t, KV, HD)).astype(np.float32)
        v = rng.normal(size=(1, t, KV, HD)).astype(np.float32)
        need = -(-t // BS)
        pages = np.full(MB, -1, np.int32)
        pages[:need] = perm[used:used + need]
        used += need
        prefills.append((slot, k, v, pages))
    appends = [tuple(rng.normal(size=(S, KV, HD)).astype(np.float32) for _ in range(2))
               for _ in range(2)]
    return dict(prefills=prefills, appends=appends, params=params,
                q=rng.normal(size=(S, H, HD)).astype(np.float32))


def _jax_pool(inp):
    """The global pool, eager (the port divides where jit multiplies)."""
    jp = JParams(**inp["params"])
    pool = jc.empty_paged_cache(NB, BS, S, MB, KV, HD, jp.r(HD))
    for slot, k, v, pages in inp["prefills"]:
        src = jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=MB * BS, params=jp)
        pool = jc.prefill_into_pages(pool, src, slot, jnp.asarray(pages))
    for k1, v1 in inp["appends"]:
        pool = jc.append_token_paged(pool, jnp.asarray(k1), jnp.asarray(v1))
    return pool


def _port_rank_pool(inp, block_range):
    tp = TParams(**inp["params"])
    pool = tc.empty_paged_cache(NB, BS, S, MB, KV, HD, tp.r(HD),
                                local_blocks=block_range[1] - block_range[0])
    for slot, k, v, pages in inp["prefills"]:
        src = tc.prefill_cache(tt(k), tt(v), max_seq=MB * BS, params=tp)
        tc.prefill_into_pages(pool, src, slot, tt(pages), block_range=block_range)
    for k1, v1 in inp["appends"]:
        tc.append_token_paged(pool, tt(k1), tt(v1), block_range=block_range)
    return pool


def _assert_rank_slice(jpool, leaves, block_range):
    lo, hi = block_range
    for f in DATA:
        j = np.asarray(getattr(jpool, f))[lo:hi]
        np.testing.assert_array_equal(tn(leaves[f], j), j, err_msg=f)
    for f in ("page_table", "length", "refcount"):
        np.testing.assert_array_equal(tn(leaves[f]), np.asarray(getattr(jpool, f)), err_msg=f)


@pytest.mark.parametrize("n", [2, 4])
def test_rank_local_prefill_and_append_bitwise(rng, n):
    """Replicated prefill written shard-locally, appends landing only on the
    owner: every rank's leaves equal its slice of the JAX pool."""
    inp = _island_inputs(rng, ISLAND_PARAMS["pool7_sink_recent"])
    jpool = _jax_pool(inp)
    for r in range(n):
        br = (r * NB // n, (r + 1) * NB // n)
        pool = _port_rank_pool(inp, br)
        _assert_rank_slice(jpool, {f: getattr(pool, f) for f in DATA + (
            "page_table", "length", "refcount")}, br)


def test_sharded_refcount_resolution_and_plan_bitwise(rng):
    """The reference's sharded-refcount `map_block`/`free_pages`, the
    local-or-sentinel `_resolve_pages` and the rank-local block plan, per
    rank of a 4-way split, bit for bit."""
    table = rng.integers(-1, NB, (S, MB)).astype(np.int32)
    rc = np.bincount(table[table >= 0], minlength=NB).astype(np.int32)
    idx = rng.integers(0, MB * BS, (S, KV, 20)).astype(np.int32)
    sel_mask = rng.random((S, KV, 20)) < 0.8
    for lo, hi in ((0, 8), (8, 16), (16, 24), (24, 32)):
        jpool = jc.empty_paged_cache(NB, BS, S, MB, KV, HD, 32)._replace(
            page_table=jnp.asarray(table), refcount=jnp.asarray(rc[lo:hi]),
            length=jnp.full((S,), MB * BS, jnp.int32))
        tpool = tc.empty_paged_cache(NB, BS, S, MB, KV, HD, 32)
        tpool.page_table.copy_(tt(table))
        tpool.length.fill_(MB * BS)
        tpool.refcount = tt(rc[lo:hi]).clone()
        for got, want in zip(tc._resolve_pages(tpool, tt(idx), (lo, hi)),
                             jc._resolve_pages(jpool, jnp.asarray(idx), (lo, hi))):
            np.testing.assert_array_equal(tn(got), np.asarray(want))
        tsel = type("Sel", (), {"indices": tt(idx), "mask": tt(sel_mask)})()
        jsel = type("Sel", (), {"indices": jnp.asarray(idx), "mask": jnp.asarray(sel_mask)})()
        for got, want in zip(t_plan(tpool, tsel, (lo, hi)), j_plan(jpool, jsel, (lo, hi))):
            np.testing.assert_array_equal(tn(got), np.asarray(want))
        jpool = jc.map_block(jpool, 2, 5, 19, block_range=(lo, hi))
        tc.map_block(tpool, 2, 5, 19, block_range=(lo, hi))
        jpool = jc.free_pages(jpool, 1, block_range=(lo, hi))
        tc.free_pages(tpool, 1, block_range=(lo, hi))
        for f in ("page_table", "refcount", "length"):
            np.testing.assert_array_equal(tn(getattr(tpool, f)), np.asarray(getattr(jpool, f)))


# ---------------------------------------------------------------------------
# the island
# ---------------------------------------------------------------------------

def _sel_set(indices, mask):
    """{(slot, kv, logical index)} of a Selection's real entries."""
    idx, msk = np.asarray(indices), np.asarray(mask)
    return {tuple(p[:-1]) + (int(idx[tuple(p)]),) for p in np.argwhere(msk)}


def _port_pool_from(jpool):
    """A port pool holding the JAX pool's leaves (the same input bits)."""
    pool = tc.empty_paged_cache(NB, BS, S, MB, KV, HD, jpool.feat_words.shape[-1] * 16)
    for f in DATA:
        getattr(pool, f).copy_(tt(getattr(jpool, f)))
    for f in ("heavy_idx", "length", "page_table", "refcount"):
        getattr(pool, f).copy_(tt(getattr(jpool, f)))
    return pool


@pytest.mark.parametrize("case", list(ISLAND_PARAMS))
def test_island_world1_vs_jax_one_device_mesh(rng, world1, case):
    """The port's island at one rank against the JAX fused island in
    `shard_map` on a one-device mesh, its kernel legs the Pallas kernels in
    interpret mode; and the dense sharded tick likewise."""
    inp = _island_inputs(rng, ISLAND_PARAMS[case])
    jpool, jp = _jax_pool(inp), JParams(**inp["params"])
    mesh = compat.make_mesh((1,), ("seq",))
    rep = P(None, None, None)

    def island(q_, pool_):
        o, sel = j_sp_salca(q_, pool_, jp, "seq", return_selection=True, fused=True,
                            impl="pallas", interpret=True)
        return o, j_sp_dense(q_, pool_, "seq"), tuple(sel)

    jo, jd, jsel = jax.jit(compat.shard_map(
        island, mesh=mesh, in_specs=(rep, paged_cache_pspec(JCtx(axis="seq", mesh=mesh))),
        out_specs=(rep, rep, (rep, rep, P(None, None), P(None, None))),
        check_vma=False))(jnp.asarray(inp["q"]), jpool)
    pool = _port_pool_from(jpool)
    to, tsel = t_sp_salca(tt(inp["q"]), pool, TParams(**inp["params"]), world1,
                          return_selection=True)
    for t, j in zip(tsel, jsel):
        np.testing.assert_array_equal(tn(t), np.asarray(j))
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tn(t_sp_dense(tt(inp["q"]), pool, world1)), np.asarray(jd),
                               **TOL)


def _spawn(task, inp, world, tmp_path):
    """Run ``world`` ranks of `_torch_dist_worker.py` over a FileStore in
    ``tmp_path``; returns each rank's results."""
    torch.save(inp, tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               task, str(tmp_path), str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_island_gloo_ranks_vs_jax_unsharded(rng, tmp_path, world):
    """2 and 4 gloo ranks, pools built from replicated prefills, more kept
    tokens than the index capacity (the cut runs on the all-reduced global
    rank): the union of the ranks' selections and the thresholds equal the
    JAX unsharded tick's bit for bit, every rank's output is within 1e-5 (Salca and
    dense), and every rank's leaves equal its slice of the JAX pool."""
    inp = _island_inputs(rng, ISLAND_PARAMS["capacity_cut"])
    jpool, jp = _jax_pool(inp), JParams(**inp["params"])
    jo, jsel = j_attn(jnp.asarray(inp["q"]), jpool, jp, return_selection=True)
    jd = j_dense(jnp.asarray(inp["q"]), jpool)
    work = dict(params=inp["params"], q=tt(inp["q"]), slots=S, num_blocks=NB, bs=BS, mb=MB,
                kv=KV, hd=HD, appends=[tuple(map(tt, a)) for a in inp["appends"]],
                prefills=[(slot, tt(k), tt(v), tt(pg)) for slot, k, v, pg in inp["prefills"]])
    res = _spawn("island", work, world, tmp_path)
    sets = [_sel_set(tn(r["sel"][0]), tn(r["sel"][1])) for r in res]
    for i in range(world):
        for j in range(i + 1, world):
            assert not sets[i] & sets[j], f"ranks {i} and {j} both select a token"
    assert set().union(*sets) == _sel_set(jsel.indices, jsel.mask)
    assert sum(int(tn(r["sel"][2]).sum()) for r in res) == int(np.asarray(jsel.count).sum())
    for r, out in enumerate(res):
        np.testing.assert_array_equal(tn(out["sel"][3]), np.asarray(jsel.threshold))
        np.testing.assert_allclose(tn(out["out"]), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tn(out["dense"]), np.asarray(jd), **TOL)
        _assert_rank_slice(jpool, out["leaves"], (r * NB // world, (r + 1) * NB // world))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

JCFG, TCFG = f32_configs()
ENGINE = dict(max_seq=256, slots=2, block_size=32, num_blocks=16)
PROMPT_LENS, NEW_TOKENS = (150, 200, 170), 5     # k = 128 of 256: a sparse tick


@pytest.fixture(scope="module")
def engine_weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(engine_cls, req_cls, cfg, params, **kw):
    eng = engine_cls(cfg, params, paged=True, **ENGINE, **kw)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    return [r.output for r in reqs], stats, eng


def test_engine_world1_vs_jax_one_device_mesh(engine_weights, world1):
    jp, tp = engine_weights
    mesh = compat.make_mesh((1,), ("seq",))
    jout, _, _ = _serve(JEngine, JRequest, JCFG, jp, ctx=JCtx(axis="seq", mesh=mesh))
    tout, stats, eng = _serve(TEngine, TRequest, TCFG, tp, device="cpu", ctx=world1)
    assert tout == jout
    assert stats.shards == 1 and stats.completed == 3
    assert sorted(eng._free_blocks) == list(range(ENGINE["num_blocks"]))
    for pool in eng._state.caches:
        assert pool.check_invariants(free_blocks=eng._free_blocks,
                                     host_refcount=eng._refcount).ok
        assert pool.sink == ENGINE["num_blocks"]


def test_engine_two_gloo_ranks_vs_unsharded_engines(engine_weights, tmp_path):
    """Two SPMD ranks, each holding half the pool: greedy tokens equal the
    JAX and the port's unsharded engines; the ranks stay in lockstep —
    identical logits and page tables every tick — and drain leak-free."""
    jp, tp = engine_weights
    jout, _, _ = _serve(JEngine, JRequest, JCFG, jp)
    tout, _, _ = _serve(TEngine, TRequest, TCFG, tp, device="cpu")
    assert tout == jout
    res = _spawn("engine", dict(weights=tp, prompts=_prompts(), new_tokens=NEW_TOKENS,
                                engine=ENGINE), 2, tmp_path)
    for r in res:
        assert r["outputs"] == jout
        assert r["stops"] == ["length"] * 3
        assert r["free"] == list(range(ENGINE["num_blocks"])) and r["pools_ok"]
        assert r["stats"]["shards"] == 2 and r["stats"]["peak_shard_blocks_in_use"] > 0
    assert len(res[0]["ticks"]) == len(res[1]["ticks"]) > 0
    for (m0, l0, pt0), (m1, l1, pt1) in zip(res[0]["ticks"], res[1]["ticks"]):
        np.testing.assert_array_equal(m0, m1)
        assert torch.equal(l0, l1) and torch.equal(pt0, pt1)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_allocator_matches_reference_pop_order(n_shards):
    """Random alloc (with and without a preferred shard) / release
    interleavings: the port's allocator hands out the reference's ids in
    the reference's order."""
    master = np.random.default_rng(11 + n_shards)
    ja, ta = JAlloc(16, n_shards), TAlloc(16, n_shards)
    held = []
    for _ in range(60):
        if master.random() < 0.6:
            need = int(master.integers(0, 7))
            prefer = int(master.integers(n_shards)) if master.random() < 0.5 else None
            got = ta.alloc(need, prefer)
            assert got == ja.alloc(need, prefer)
            held += got or []
        elif held:
            b = held.pop(int(master.integers(len(held))))
            ja.release(b)
            ta.release(b)
        assert ta.free_ids() == ja.free_ids() and ta.free_counts() == ja.free_counts()


def test_ctx_validation(engine_weights, world1):
    """An uneven split, a mismatched backend and host spill over more than
    one rank raise; so does a multi-rank world without a store. Prefix
    sharing builds on a block-sharded pool, as in the reference."""
    _, tp = engine_weights
    three = DecodeCtx(world1.group, 0, 3, "gloo")
    with pytest.raises(ValueError, match="divide evenly"):
        TEngine(TCFG, tp, max_seq=64, paged=True, block_size=16, num_blocks=8, device="cpu",
                ctx=three)
    eng = TEngine(TCFG, tp, max_seq=64, paged=True, block_size=16, device="cpu", ctx=world1,
                  prefix_sharing=True)
    assert eng.prefix_sharing and eng.ctx is world1
    # the reference's rule: host spill needs selection histograms, which the
    # island does not record, so a pool over more than one rank refuses it
    two = DecodeCtx(world1.group, 0, 2, "gloo")
    with pytest.raises(ValueError, match="host_spill"):
        TEngine(TCFG, tp, max_seq=64, paged=True, block_size=16, num_blocks=8, device="cpu",
                ctx=two, host_spill=True)
    with pytest.raises(RuntimeError, match="nccl"):
        pmin(torch.zeros(3), world1._replace(backend="nccl"))
    with pytest.raises(ValueError, match="store"):
        init_decode_ctx("cpu", rank=0, world_size=2)
