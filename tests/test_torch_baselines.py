"""Port parity, the reference's unfused baselines against the JAX package on
the CPU: the paged tick with ``paged_fused_decode`` off (its PR 3 path),
the logical-gather island with ``sharded_fused_decode`` off (its PR 5
path) and the engine's ``fused_decode`` knob.

* Bit for bit: `cache.paged_logical_features`, `resolve_logical_rows` and
  `gather_selected_paged` in the int8, fp16 and int4 pools, with a
  host-spilled (unmapped) block below a cursor, and the rank-local gather
  over two block ranges of the pool; the unfused tick's Selection against
  the reference's unfused tick and the port's fused one; the gather
  island's Selection at one in-process rank against the JAX island on a
  one-device mesh, and at two spawned gloo ranks
  (`tests/_torch_dist_worker.py island` with ``fused`` False) as the union
  of the ranks' selections against the JAX unsharded tick.
* Within 1e-5 (the reference's own bound): outputs.
* `ServingEngine(paged=True, fused_decode=False)` against the JAX engine
  with the same knob: tokens and tick logits under
  `_torch_bridge.assert_code_ticks_close`; against the port's fused
  engine: tokens and every layer's selection histogram.

Run alone: ~80 s on this container's CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_bridge import assert_code_ticks_close, f32_configs, record_code_ticks, tn, tt
from repro import compat
from repro import flags as jflags
from repro.core import cache as jc
from repro.core.attention import salca_decode_attention_paged as j_attn
from repro.core.histogram_topk import Selection as JSelection
from repro.core.selection import SalcaParams as JParams
from repro.core.sp_decode import sp_salca_decode_paged as j_sp_salca
from repro.models import get_model as jget_model
from repro.models.blocks import DecodeCtx as JCtx
from repro.models.blocks import paged_cache_pspec
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch import flags as tflags
from repro_torch.core import cache as tc
from repro_torch.core.attention import salca_decode_attention_paged as t_attn
from repro_torch.core.histogram_topk import Selection as TSelection
from repro_torch.core.selection import SalcaParams as TParams
from repro_torch.core.sp_decode import sp_salca_decode_paged as t_sp_salca
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy
from test_torch_sharded import (
    ISLAND_PARAMS, _island_inputs, _jax_pool, _port_pool_from, _sel_set, _spawn)

MODES = ("int8", "fp16", "int4")
MAX_SEQ, BS, NBLK = 64, 16, 20
MB = MAX_SEQ // BS
TOL = dict(rtol=1e-5, atol=1e-5)
JP = JParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
TP = TParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
DATA = tc._DATA_FIELDS


@pytest.fixture(scope="module")
def world1():
    return init_decode_ctx("cpu")


def _filled(rng, mode, spill: bool):
    """Both packages' pools (3 slots) with slot 1 holding a 40-token prompt
    over scrambled blocks, slot 0 a 25-token one and slot 2 nothing; with
    ``spill`` slot 1's logical block 1 is unmapped below its cursor, as a
    host-spilled block is."""
    kw = dict(kv_heads=2, head_dim=32, r=16, kv_pool_dtype=mode)
    jp = jc.empty_paged_cache(NBLK, BS, 3, MB, **kw)
    tp = tc.empty_paged_cache(NBLK, BS, 3, MB, **kw)
    for slot, t, ids in ((1, 40, [13, 2, 7]), (0, 25, [5, 11])):
        k = rng.normal(size=(1, t, 2, 32)).astype(np.float32)
        v = rng.normal(size=(1, t, 2, 32)).astype(np.float32)
        pages = np.full(MB, -1, np.int32)
        pages[:len(ids)] = ids
        jp = jc.prefill_into_pages(
            jp, jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=MAX_SEQ, params=JP),
            slot, jnp.asarray(pages))
        tc.prefill_into_pages(tp, tc.prefill_cache(tt(k), tt(v), max_seq=MAX_SEQ, params=TP),
                              slot, tt(pages))
    if spill:
        jp = jp._replace(page_table=jp.page_table.at[1, 1].set(-1))
        tp.page_table[1, 1] = -1
    return jp, tp


def _local(jp, tp, block_range):
    """Both pools as a rank owning ``block_range`` holds them: the data
    leaves of its blocks, the metadata whole."""
    lo, hi = block_range
    jl = jp._replace(**{f: getattr(jp, f)[lo:hi] for f in DATA})
    tl = tc.empty_paged_cache(NBLK, BS, 3, MB, 2, 32, 16, kv_pool_dtype=tp.kv_pool_dtype,
                              local_blocks=hi - lo)
    for f in DATA:
        getattr(tl, f).copy_(getattr(tp, f)[lo:hi])
    for f in ("heavy_idx", "length", "page_table", "refcount"):
        getattr(tl, f).copy_(getattr(tp, f))
    return jl, tl


@pytest.mark.parametrize("spill", [False, True], ids=["mapped", "spilled"])
@pytest.mark.parametrize("mode", MODES)
def test_logical_features_rows_and_gathers_bitwise(rng, mode, spill):
    """The feature stream in logical order, logical rows through the page
    table (unmapped, out-of-range and spilled positions clamp), and the
    selected rows' gather, whole and rank-local at two block ranges."""
    jp, tp = _filled(rng, mode, spill)
    for j, t in zip(jc.paged_logical_features(jp), tc.paged_logical_features(tp)):
        np.testing.assert_array_equal(tn(t, j), np.asarray(j))
    idx = rng.integers(-3, MAX_SEQ + 5, (3, 2, 24)).astype(np.int32)
    np.testing.assert_array_equal(tn(tc.resolve_logical_rows(tp, tt(idx))),
                                  np.asarray(jc.resolve_logical_rows(jp, jnp.asarray(idx))))
    sel_idx = rng.integers(0, MAX_SEQ, (3, 2, 24)).astype(np.int32)
    mask = rng.random((3, 2, 24)) < 0.8
    count = mask.sum(-1).astype(np.int32)
    thr = np.ones((3, 2), np.int32)
    jsel = JSelection(*(jnp.asarray(a) for a in (sel_idx, mask, count, thr)))
    tsel = TSelection(*(tt(a) for a in (sel_idx, mask, count, thr)))
    for block_range in (None, (0, 10), (10, 20)):
        jl, tl = (jp, tp) if block_range is None else _local(jp, tp, block_range)
        got = tc.gather_selected_paged(tl, tsel, block_range)
        want = jc.gather_selected_paged(jl, jsel, block_range)
        for name, t, j in zip(("k_codes", "k_scale", "v_codes", "v_scale"), got, want):
            np.testing.assert_array_equal(tn(t), np.asarray(j), err_msg=f"{name} {block_range}")


@pytest.mark.parametrize("spill", [False, True], ids=["mapped", "spilled"])
@pytest.mark.parametrize("mode", MODES)
def test_unfused_paged_tick_vs_reference_and_fused(rng, mode, spill):
    """The unfused tick against the reference's (selection bit for bit,
    out within 1e-5) and against the port's fused tick (selection bit for
    bit); the flag picks the unfused path when ``fused`` is not given."""
    jp, tp = _filled(rng, mode, spill)
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    jo, jsel = j_attn(jnp.asarray(q), jp, JP, return_selection=True, fused=False)
    to, tsel = t_attn(tt(q), tp, TP, return_selection=True, fused=False)
    for a, b in zip(jsel, tsel):
        np.testing.assert_array_equal(tn(b), np.asarray(a))
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    fo, fsel = t_attn(tt(q), tp, TP, return_selection=True, fused=True)
    for a, b in zip(fsel, tsel):
        assert torch.equal(a, b)
    np.testing.assert_allclose(tn(fo), tn(to), **TOL)
    with tflags.perf_flags(paged_fused_decode=False):
        assert torch.equal(t_attn(tt(q), tp, TP), to)


@pytest.mark.parametrize("case", list(ISLAND_PARAMS))
def test_gather_island_world1_vs_jax_one_device_mesh(rng, world1, case):
    """The logical-gather island at one rank against the reference's in
    `shard_map` on a one-device mesh: selection and threshold bit for bit,
    out within 1e-5; and equal to the port's fused island's selection."""
    inp = _island_inputs(rng, ISLAND_PARAMS[case])
    jpool, jp = _jax_pool(inp), JParams(**inp["params"])
    mesh = compat.make_mesh((1,), ("seq",))
    rep = P(None, None, None)

    def island(q_, pool_):
        o, sel = j_sp_salca(q_, pool_, jp, "seq", return_selection=True, fused=False)
        return o, tuple(sel)

    jo, jsel = jax.jit(compat.shard_map(
        island, mesh=mesh, in_specs=(rep, paged_cache_pspec(JCtx(axis="seq", mesh=mesh))),
        out_specs=(rep, (rep, rep, P(None, None), P(None, None))),
        check_vma=False))(jnp.asarray(inp["q"]), jpool)
    pool = _port_pool_from(jpool)
    tp = TParams(**inp["params"])
    to, tsel = t_sp_salca(tt(inp["q"]), pool, tp, world1, return_selection=True, fused=False)
    for t, j in zip(tsel, jsel):
        np.testing.assert_array_equal(tn(t), np.asarray(j))
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    with tflags.perf_flags(sharded_fused_decode=True):
        fo, fsel = t_sp_salca(tt(inp["q"]), pool, tp, world1, return_selection=True)
    for a, b in zip(fsel, tsel):
        assert torch.equal(a, b)
    np.testing.assert_allclose(tn(fo), tn(to), **TOL)


@pytest.mark.parametrize("mode", ("fp16", "int4"))
def test_gather_island_per_mode_equals_the_unsharded_ticks(rng, world1, mode):
    """In an fp16 and an int4 pool (phase 4 in torch ops), at one rank: the
    gather island selects what the fused island and the unsharded unfused
    tick select, bit for bit; outputs within 1e-5."""
    _, tp = _filled(rng, mode, spill=False)
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    uo, usel = t_attn(tt(q), tp, TP, return_selection=True, fused=False)
    go, gsel = t_sp_salca(tt(q), tp, TP, world1, return_selection=True, fused=False)
    fo, fsel = t_sp_salca(tt(q), tp, TP, world1, return_selection=True, fused=True)
    for u, g, f in zip(usel, gsel, fsel):
        assert torch.equal(u, g) and torch.equal(g, f)
    np.testing.assert_allclose(tn(go), tn(uo), **TOL)
    np.testing.assert_allclose(tn(go), tn(fo), **TOL)


def test_gather_island_two_gloo_ranks_vs_jax_unsharded(rng, tmp_path):
    """Two spawned gloo ranks running the gather island, more kept tokens
    than the index capacity: the union of the ranks' selections and the
    thresholds equal the JAX unsharded tick's bit for bit, every rank's
    output within 1e-5."""
    inp = _island_inputs(rng, ISLAND_PARAMS["capacity_cut"])
    jpool, jp = _jax_pool(inp), JParams(**inp["params"])
    jo, jsel = j_attn(jnp.asarray(inp["q"]), jpool, jp, return_selection=True)
    work = dict(params=inp["params"], q=tt(inp["q"]), slots=4, num_blocks=32, bs=16, mb=8,
                kv=2, hd=64, appends=[tuple(map(tt, a)) for a in inp["appends"]],
                prefills=[(slot, tt(k), tt(v), tt(pg)) for slot, k, v, pg in inp["prefills"]],
                fused=False)
    res = _spawn("island", work, 2, tmp_path)
    sets = [_sel_set(tn(r["sel"][0]), tn(r["sel"][1])) for r in res]
    assert not sets[0] & sets[1]
    assert sets[0] | sets[1] == _sel_set(jsel.indices, jsel.mask)
    for out in res:
        np.testing.assert_array_equal(tn(out["sel"][3]), np.asarray(jsel.threshold))
        np.testing.assert_allclose(tn(out["out"]), np.asarray(jo), **TOL)


# ---------------------------------------------------------------------------
# the engine's knob
# ---------------------------------------------------------------------------

JCFG, TCFG = f32_configs()
ENGINE = dict(max_seq=256, slots=2, paged=True, block_size=32, num_blocks=16)


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


def _serve(engine_cls, req_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, **ENGINE, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = record_code_ticks(eng, cfg)
    hists = []
    if not hasattr(eng._state, "period_states"):         # the port: each layer's sel_hist
        orig = eng._decode

        def decode(*a):
            out = orig(*a)
            hists.append(torch.stack([c.sel_hist.clone() for c in eng._state.caches]))
            return out

        eng._decode = decode
    eng.run()
    return [r.output for r in reqs], ticks, hists


def test_engine_unfused_vs_reference_and_fused(weights):
    """Three requests of 150, 200 and 170 tokens × 6 new on two slots (k 128
    of 256: a sparse tick, blocks reused after the first completion), with
    ``fused_decode=False``: tokens and tick logits equal the JAX engine's
    with the same knob; tokens and every layer's selection histogram, tick
    for tick, equal the port's fused engine's. The knob leaves the global
    flag as it was."""
    jp, tp = weights
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in (150, 200, 170)]
    jout, jticks, _ = _serve(JEngine, JRequest, JCFG, jp, prompts, fused_decode=False)
    tout, tticks, thists = _serve(TEngine, TRequest, TCFG, tp, prompts, device="cpu",
                                  fused_decode=False)
    assert tout == jout
    assert_code_ticks_close(jticks, tticks)
    assert tflags.PERF.paged_fused_decode and jflags.PERF.paged_fused_decode
    fout, _, fhists = _serve(TEngine, TRequest, TCFG, tp, prompts, device="cpu",
                             fused_decode=True)
    assert fout == tout and len(fhists) == len(thists) > 0
    for a, b in zip(fhists, thists):
        assert torch.equal(a, b)
