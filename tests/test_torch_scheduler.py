"""Port parity, continuous batching (the reference's chunked prefill and
preemption): `block_prefill_chunk`, `prefill_chunk_into_pages`,
`lm_prefill_chunk` and `lm_static_heavy` against the JAX package, and the
reference battery tests/test_scheduler.py ported case for case, every
engine trace run through the JAX engine as well.

* Module parity: a block's chunk step over ragged chunks (activations
  within LOGIT_TOL, the chunk's k/v and the carried buffers too, and every
  row equal to the port's own whole-prompt `block_prefill`); the streaming
  pool install in int8 and fp16 over ragged chunks with shared prefix
  blocks, every leaf plus page table and refcount after each chunk equal to
  the JAX pool's (on a whole pool and on each rank's share of a
  block-sharded one), and at the end to a monolithic `prefill_into_pages`;
  `lm_prefill_chunk` over a whole prompt against the JAX pool and the
  port's monolithic prefill; the static heavy sets index for index.
* The battery: the constructor's `ValueError`s; chunked equals monolithic;
  preemption at (8, 8), (7, 8) and (8, None) with zero overflows and the
  big pool's outputs, and (8, 8) on an fp16 pool; a preempted request re-admitted through the radix
  map; an overflow finish and a reset racing a preemption; cycle
  accounting; the stats' populations; the bounded stash; incremental
  chunk charging; seeded and hypothesis interleavings of submit, chunk,
  tick and preempt. Each engine trace also runs through the JAX engine:
  tokens identical, every tick's logits within LOGIT_TOL (CODE_STEP_TOL
  where the two pools round a K/V value to adjacent int8 codes), the
  counters equal, the pool drained.
* The block-sharded engine at one in-process rank (int8 and fp16) and at
  two spawned gloo ranks (tests/_torch_dist_worker.py ``scheduler``): its
  chunks land on both ranks, it preempts, and its tokens equal the
  unsharded port's.

Engines serve qwen3-0.6b.reduced() with ``salca_static_channels`` at
float32 compute, from the JAX init tree converted by `repro_torch.weights`.
The JAX engine compiles its steps per engine; engines of one shape here
share the first one's compiled steps (same config, same closures), which
keeps this file's run short.
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

from _torch_bridge import POOL_FIELDS, f32_configs, record_ticks, tn, tt
from repro.core import cache as jc
from repro.models import blocks as jblocks
from repro.models import get_model as jget_model
from repro.models import transformer as jtr
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.core import cache as tc
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttr
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

try:
    from hypothesis import given, settings, strategies as hst
    HAVE_HYPOTHESIS = True
except ImportError:            # a container without hypothesis: the seeded cases only
    HAVE_HYPOTHESIS = False

ROOT = pathlib.Path(__file__).resolve().parents[1]
JF32, TF32 = f32_configs()
JCFG, TCFG = (dataclasses.replace(c, salca_static_channels=True) for c in (JF32, TF32))
# logits: f32 summation-order differences through 2 layers, the bound of
# tests/test_torch_engine.py and tests/test_torch_prefix_sharing.py
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# the engines' tick logits: LOGIT_TOL while the blocks the tick reads hold
# the same int8 K/V codes in both pools (an fp16 pool's rows carry them
# times a scale: `_torch_bridge.int8_codes`); where the two packages' f32 forwards
# round a K or V value to adjacent codes (tests/test_torch_prefix_sharing.py
# allows 2e-4 for one such code, measured 1.34e-4), the codes may differ by
# one step and the rows by CODE_STEP_TOL: measured up to 4.4e-4 (one code)
# on these traces, against O(0.1) for a row read from the wrong history
CODE_STEP_TOL = dict(rtol=1e-5, atol=1e-3)
# the pool's f32 scales, model against model: each is |x|max / 127 of a K/V
# row that the two packages' f32 forwards give to within their summation
# order (measured 2.2e-7 relative in layer 0, 1.2e-6 in layer 1)
SCALE_RTOL = 1e-5
MAX_SEQ, BS = 64, 8
PROMPT_LENS = (21, 13, 30, 9)
COUNTERS = ("completed", "admissions", "ttft_count", "tokens_generated", "overflows",
            "preemptions", "replayed_tokens", "prefill_chunks", "chunk_stalls",
            "prefill_tokens", "peak_blocks_in_use", "shared_blocks", "prefix_hits",
            "ticks")


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JF32).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TF32, "cpu")


def _prompts(seed=7, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JF32.vocab_size, (n,)).astype(np.int32) for n in lens]


def _layer(jp, i):
    return jax.tree_util.tree_map(lambda a: a[i], jp["periods"][0])


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------

CHUNKS = (5, 8, 3, 14)         # ragged: 30 tokens, no chunk on a block boundary


def test_block_prefill_chunk_matches_reference(weights, rng):
    """Layer 0's chunk step over four ragged chunks of a 30-token prompt:
    the chunk's activations within LOGIT_TOL of the JAX step's, its raw k/v
    and the carried buffers too; every activation row and k/v row equal,
    bit for bit, to the port's whole-prompt `block_prefill` of the same
    input."""
    jp, tp = weights
    t, kv, hd = sum(CHUNKS), TCFG.num_kv_heads, TCFG.resolved_head_dim
    x = rng.normal(size=(1, t, TCFG.d_model)).astype(np.float32)
    jl, tl = _layer(jp, 0), tp["layers"][0]
    jk = jv = jnp.zeros((1, t, kv, hd), jnp.float32)
    tk, tv = (torch.zeros(kv, t, hd) for _ in range(2))
    whole, wcache = tblocks.block_prefill(tl, tt(x), TCFG, MAX_SEQ)
    t0 = 0
    for c in CHUNKS:
        xc = x[:, t0:t0 + c]
        jo, jk, jv, jk_c, jv_c = jax.jit(jblocks.block_prefill_chunk, static_argnames="cfg")(
            jl, jnp.asarray(xc), jk, jv, t0, cfg=JCFG)
        to, tk, tv, tk_c, tv_c = tblocks.block_prefill_chunk(tl, tt(xc), tk, tv, t0, TCFG)
        np.testing.assert_allclose(tn(to), np.asarray(jo), **LOGIT_TOL)
        for got, want in ((tk_c, jk_c), (tv_c, jv_c)):
            np.testing.assert_allclose(tn(got), np.asarray(want), **LOGIT_TOL)
        for got, want in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(tn(got.transpose(0, 1)[None]), np.asarray(want),
                                       **LOGIT_TOL)
        assert torch.equal(to, whole[:, t0:t0 + c]), f"chunk at {t0}: rows differ"
        t0 += c
    mono = tc.prefill_cache(tk.transpose(0, 1)[None], tv.transpose(0, 1)[None], MAX_SEQ,
                            tblocks.salca_params_for(TCFG, MAX_SEQ),
                            heavy_idx=wcache.heavy_idx)
    for f in ("k_codes", "k_scale", "v_codes", "v_scale", "feat_words"):
        assert torch.equal(getattr(mono, f), getattr(wcache, f)), f


NB, PSLOTS, PMB, PKV, PHD = 12, 3, 8, 2, 32
POOL_PARAMS = dict(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
# slot 1: 28 tokens over blocks [5, 2, 9, 7] of 8; blocks 5 and 2 shared
# (another slot wrote them), four chunks of 7 tokens: three cross a block
# boundary and the last ends inside a block (one chunk shape, so the
# reference's eager ops compile once)
CHUNK_PAGES = (5, 2, 9, 7)
POOL_CHUNKS = (7, 7, 7, 7)
N_SHARED = 2


def _chunk_charge(pages_so_far, consumed, c):
    """The page row a chunk sees: the shared prefix and every fresh block
    covered through the chunk."""
    row = np.full(PMB, -1, np.int32)
    span = max(-(-(consumed + c) // BS), N_SHARED)
    row[:span] = pages_so_far[:span]
    return row


def _chunked_pools(rng, mode, block_range=None):
    """Both packages' pools after each chunk of a 28-token install into slot
    1 (slot 0 holding the shared blocks' owner), the chunks' k/v, and the
    port's pool of a monolithic install of the same rows."""
    from repro.core.selection import SalcaParams as JP
    from repro_torch.core.selection import SalcaParams as TP
    jpp, tpp = JP(**POOL_PARAMS), TP(**POOL_PARAMS)
    r = tpp.r(PHD)
    local = None if block_range is None else block_range[1] - block_range[0]
    jpool = jc.empty_paged_cache(NB, BS, PSLOTS, PMB, PKV, PHD, r, kv_pool_dtype=mode)
    tpool = tc.empty_paged_cache(NB, BS, PSLOTS, PMB, PKV, PHD, r, kv_pool_dtype=mode,
                                 local_blocks=local)
    t = sum(POOL_CHUNKS)
    k, v = (rng.normal(size=(1, t, PKV, PHD)).astype(np.float32) for _ in range(2))
    heavy = np.sort(rng.permutation(PHD)[:r])[None, None].repeat(PKV, 1).astype(np.int32)
    owner = np.array([5, 2] + [-1] * (PMB - 2), np.int32)
    jsrc = jc.prefill_cache(jnp.asarray(k[:, :16]), jnp.asarray(v[:, :16]), max_seq=PMB * BS,
                            params=jpp, heavy_idx=jnp.asarray(heavy))
    tsrc = tc.prefill_cache(tt(k[:, :16]), tt(v[:, :16]), max_seq=PMB * BS, params=tpp,
                            heavy_idx=tt(heavy))
    jpool = jc.prefill_into_pages(jpool, jsrc, 0, jnp.asarray(owner))
    tc.prefill_into_pages(tpool, tsrc, 0, tt(owner), block_range)
    pages = np.array(CHUNK_PAGES + (-1,) * (PMB - len(CHUNK_PAGES)), np.int32)
    steps, t0 = [], 0
    for c in POOL_CHUNKS:
        row = _chunk_charge(pages, t0, c)
        jpool = jc.prefill_chunk_into_pages(jpool, jnp.asarray(k[:, t0:t0 + c]),
                                            jnp.asarray(v[:, t0:t0 + c]), jnp.asarray(heavy),
                                            1, jnp.asarray(row), t0, N_SHARED)
        tc.prefill_chunk_into_pages(tpool, tt(k[:, t0:t0 + c]), tt(v[:, t0:t0 + c]),
                                    tt(heavy), 1, row, t0, N_SHARED, block_range)
        steps.append((t0, jpool, {f: getattr(tpool, f).clone() for f in POOL_FIELDS}))
        t0 += c
    mono = tc.empty_paged_cache(NB, BS, PSLOTS, PMB, PKV, PHD, r, kv_pool_dtype=mode,
                                local_blocks=local)
    tc.prefill_into_pages(mono, tsrc, 0, tt(owner), block_range)
    tc.prefill_into_pages(mono, tc.prefill_cache(tt(k), tt(v), max_seq=PMB * BS, params=tpp,
                                                 heavy_idx=tt(heavy)),
                          1, pages, block_range, n_shared=N_SHARED)
    return steps, tpool, mono


@pytest.mark.parametrize("mode", ["int8", "fp16"])
def test_prefill_chunk_into_pages_matches_reference(rng, mode):
    """After each of four ragged chunks (two shared prefix blocks, blocks
    first covered mid-chunk) every leaf, the page table and the refcount
    equal the JAX pool's; at the end every leaf equals a monolithic
    `prefill_into_pages(n_shared=2)` of the prompt's rows."""
    steps, tpool, mono = _chunked_pools(rng, mode)
    for t0, jpool, leaves in steps:
        for f in POOL_FIELDS:
            j = np.asarray(getattr(jpool, f))
            np.testing.assert_array_equal(tn(leaves[f], j), j, err_msg=f"chunk at {t0}: {f}")
    for f in POOL_FIELDS:
        assert torch.equal(getattr(tpool, f), getattr(mono, f)), f
    assert tpool.check_invariants().ok
    assert tn(tpool.refcount)[[5, 2, 9, 7]].tolist() == [2, 2, 1, 1]


@pytest.mark.parametrize("mode", ["int8", "fp16"])
def test_prefill_chunk_into_pages_rank_local(rng, mode):
    """The rank-local form on each share of a pool split in two (blocks
    0-5 and 6-11): each rank's data leaves equal its slice of the JAX pool
    after every chunk, and the page table, lengths and refcount equal the
    whole pool's (global ids, replicated)."""
    for rank in range(2):
        lo, hi = 6 * rank, 6 * rank + 6
        steps, tpool, mono = _chunked_pools(np.random.default_rng(5), mode, (lo, hi))
        for t0, jpool, leaves in steps:
            for f in POOL_FIELDS:
                j = np.asarray(getattr(jpool, f))
                if f in tc._DATA_FIELDS:
                    j = j[lo:hi]
                np.testing.assert_array_equal(tn(leaves[f], j), j,
                                              err_msg=f"rank {rank}, chunk at {t0}: {f}")
        for f in POOL_FIELDS:
            assert torch.equal(getattr(tpool, f), getattr(mono, f)), (rank, f)


def test_prefill_chunk_into_pages_refuses_int4(rng):
    from repro_torch.core.selection import SalcaParams
    pool = tc.empty_paged_cache(NB, BS, PSLOTS, PMB, PKV, PHD,
                                SalcaParams(**POOL_PARAMS).r(PHD), kv_pool_dtype="int4")
    k = torch.zeros(1, 4, PKV, PHD)
    with pytest.raises(ValueError, match="int4"):
        tc.prefill_chunk_into_pages(pool, k, k, torch.zeros(1, PKV, 16, dtype=torch.int32),
                                    0, np.zeros(PMB, np.int32), 0)


def test_lm_prefill_chunk_matches_reference_and_monolithic(weights):
    """A 30-token prompt through `lm_prefill_chunk` in chunks of 10 (each but
    the first crossing a block boundary) into slot 1 of a 2-slot pool: every layer's pool leaves equal the JAX chunked
    install's (codes, features and metadata exactly, scales within
    SCALE_RTOL) and, bit for bit, the port's own monolithic prefill +
    `prefill_into_pages` on the same blocks; the final logits are the monolithic ones bit for
    bit and within LOGIT_TOL of the JAX ones; ``pos[1]`` is 30."""
    jp, tp = weights
    prompt = _prompts(3, (30,))[0]
    nb = 10
    pages = np.array([7, 3, 8, 1] + [-1] * 4, np.int32)
    japi = jget_model(JCFG)
    jpool = jtr.lm_init_paged_state(JCFG, 2, MAX_SEQ, BS, nb)
    jcur = jtr.lm_prefill_begin(JCFG, len(prompt))
    tpool = ttr.lm_init_paged_state(TCFG, 2, MAX_SEQ, BS, nb, "cpu")
    tcur = ttr.lm_prefill_begin(TCFG, len(prompt), "cpu")
    for t0 in range(0, 30, 10):
        c = 10
        row = np.where(np.arange(8) < -(-(t0 + c) // BS), pages, -1).astype(np.int32)
        final = t0 + c == 30
        jl, jpool, jcur = japi.prefill_chunk(jp, jpool, jnp.asarray(prompt[None, t0:t0 + c]),
                                             jcur, 1, jnp.asarray(row), 0, MAX_SEQ,
                                             final=final)
        tl, _, tcur = ttr.lm_prefill_chunk(tp, TCFG, tpool,
                                           torch.from_numpy(prompt[None, t0:t0 + c]), tcur, 1,
                                           row, 0, MAX_SEQ, final=final)
        assert (tl is None) == (not final)
    mono = ttr.lm_init_paged_state(TCFG, 2, MAX_SEQ, BS, nb, "cpu")
    ml, st = ttr.lm_prefill(tp, TCFG, torch.from_numpy(prompt[None]), MAX_SEQ)
    ttr.lm_write_into_slot(mono, st, 1, pages)
    for i, (pool, want) in enumerate(zip(tpool.caches, mono.caches)):
        for f in POOL_FIELDS:
            j = np.asarray(getattr(jpool.period_states[0], f))[i]
            if j.dtype == np.float32:    # the scales: the two models' K/V part in the last bit
                np.testing.assert_allclose(tn(getattr(pool, f)), j, rtol=SCALE_RTOL, atol=0,
                                           err_msg=f"layer {i}: {f}")
            else:
                np.testing.assert_array_equal(tn(getattr(pool, f), j), j,
                                              err_msg=f"layer {i}: {f}")
            assert torch.equal(getattr(pool, f), getattr(want, f)), (i, f)
    assert torch.equal(tl, ml)
    np.testing.assert_allclose(tn(tl), np.asarray(jl), **LOGIT_TOL)
    assert tn(tpool.pos).tolist() == [0, 30] == tn(mono.pos).tolist()
    assert tcur.t0 == 30


def test_lm_static_heavy_matches_reference(weights):
    """The static heavy sets per layer, index for index, in the layout the
    engine hashes (`_heavy_bytes` of a monolithic prefill state)."""
    jp, tp = weights
    want = jtr.lm_static_heavy(jp, JCFG, MAX_SEQ)
    got = ttr.lm_static_heavy(tp, TCFG, MAX_SEQ)
    assert len(want) == 1 and len(got) == TCFG.num_layers
    np.testing.assert_array_equal(tn(torch.stack(got)), np.asarray(want[0]))
    _, st = ttr.lm_prefill(tp, TCFG, torch.from_numpy(_prompts()[0][None]), MAX_SEQ)
    assert TEngine._heavy_bytes(st) == torch.stack(got).numpy().tobytes()
    assert ttr.lm_static_heavy(tp, TF32, MAX_SEQ) is None


# ---------------------------------------------------------------------------
# engines: both packages on one trace
# ---------------------------------------------------------------------------

# the JAX engine's jitted steps, shared by every JAX engine of this file: they
# close over the engine's model API and max_seq only, which all engines here
# share, and jit keys its compilations on the argument shapes
_JAX_STEPS: dict = {}
_JAX_STEP_NAMES = ("_decode", "_prefill", "_reset", "_write", "_map_block", "_cow_block",
                   "_chunk_step")


def _engine(kind, weights, **kw):
    """A paged engine of either package over qwen3-0.6b.reduced() with
    static channels (MAX_SEQ, BS); ``kw`` as the reference battery's."""
    jp, tp = weights
    kw = dict(dict(max_seq=MAX_SEQ, paged=True, block_size=BS), **kw)
    if kind == "port":
        return TEngine(TCFG, tp, device="cpu", **kw)
    eng = JEngine(JCFG, jp, **kw)
    for name in _JAX_STEP_NAMES:
        if hasattr(eng, name):
            setattr(eng, name, _JAX_STEPS.setdefault(name, getattr(eng, name)))
    return eng


def _reset(eng, slot):
    """A second device reset of ``slot`` (the reference battery's)."""
    if isinstance(eng, TEngine):
        eng.api.reset_slot(eng._state, slot)
    else:
        eng._state = eng._reset(eng._state, jnp.int32(slot))


def _submit_all(eng, req_cls, prompts, max_new):
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs


def _both(weights, drive, **kw):
    """Run ``drive(eng, req_cls) -> requests`` on a JAX and a port engine
    built with ``kw``; assert the port's trace is the reference's (tokens,
    stop reasons, preemptions and shared blocks per request, every tick's
    mask and logits rows, the counters) and both pools drained; return the
    port's engine, requests and summary."""
    runs = []
    for kind, req_cls in (("jax", JRequest), ("port", TRequest)):
        eng = _engine(kind, weights, **kw)
        ticks = record_ticks(eng)
        reqs = drive(eng, req_cls)
        runs.append((eng, reqs, ticks, eng.stats.summary()))
    (je, jr, jt, js), (te, tr, tt_, ts) = runs
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.stop_reason for r in tr] == [r.stop_reason for r in jr]
    assert [r.preemptions for r in tr] == [r.preemptions for r in jr]
    assert [r.shared_blocks for r in tr] == [r.shared_blocks for r in jr]
    assert len(tt_) == len(jt)
    for (tm, tl, tcodes), (jm, jl, jcodes) in zip(tt_, jt):
        np.testing.assert_array_equal(tm, jm)
        step = int(np.abs(tcodes - jcodes).max(initial=0))
        assert step <= 1, f"the pools' int8 codes part by {step} steps"
        np.testing.assert_allclose(tl[tm], jl[jm], **(CODE_STEP_TOL if step else LOGIT_TOL))
    assert {k: getattr(te.stats, k) for k in COUNTERS} == \
        {k: getattr(je.stats, k) for k in COUNTERS}
    for eng in (je, te):
        _assert_drained(eng)
    for pool in te._state.caches:
        assert pool.check_invariants(free_blocks=te._free_blocks,
                                     host_refcount=te._refcount).ok
    return te, tr, ts


def _assert_drained(eng):
    """Every block back on the free list, refcounts zero, no duplicates."""
    free = eng._alloc.free_ids()
    assert eng._alloc.total_free == eng.num_blocks
    assert len(free) == len(set(free)) == eng.num_blocks
    assert not eng._refcount.any()


def _serve(prompts, max_new):
    def drive(eng, req_cls):
        reqs = _submit_all(eng, req_cls, prompts, max_new)
        eng.run()
        return reqs
    return drive


_TRACES: dict = {}


def _serve_port(weights, prompts, max_new, **kw):
    """A port engine's outputs, and the engine, for submit-all-then-run (a
    reference run whose JAX twin other traces hold)."""
    eng = _engine("port", weights, **kw)
    reqs = _submit_all(eng, TRequest, prompts, max_new)
    eng.run()
    return [r.output for r in reqs], eng


def _trace(weights, name, prompts, max_new, **kw):
    """`_both` on submit-all-then-run, once per name in this module."""
    if name not in _TRACES:
        _TRACES[name] = _both(weights, _serve(prompts, max_new), **kw)
    return _TRACES[name]


# ---------------------------------------------------------------------------
# constructor validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(preempt=True), "preempt"),
    (dict(prefill_chunk=8), "paged"),
    (dict(paged=True, num_blocks=16, prefill_chunk=0), ">= 1"),
    (dict(paged=True, num_blocks=16, prefill_chunk=8, static=False), "unsupported"),
    (dict(paged=True, num_blocks=16, prefill_chunk=8, kv_pool_dtype="int4"), "int4"),
    (dict(paged=True, num_blocks=16, prefill_chunk=8, host_spill=True), "host_spill")],
    ids=["preempt_requires_paged", "chunk_requires_paged", "bad_budget",
         "per_input_channels", "int4_pool", "host_spill"])
def test_constructor_refuses_like_reference(weights, kw, match):
    """The reference's ValueErrors, raised by both engines (the reference
    battery's five, plus chunks with the host tier's wave admission)."""
    jp, tp = weights
    kw = dict(kw)
    static = kw.pop("static", True)
    for eng_cls, cfg, params, extra in ((JEngine, JCFG if static else JF32, jp, {}),
                                        (TEngine, TCFG if static else TF32, tp,
                                         {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            eng_cls(cfg, params, max_seq=MAX_SEQ, slots=2, block_size=BS, **kw, **extra)


def test_later_knobs_left_unported():
    """The port's `ServingEngine.__init__` takes every parameter of the
    reference's (``fused_decode``, the unfused baselines' knob, included)
    and one of its own, ``device``."""
    import inspect
    ref = set(inspect.signature(JEngine.__init__).parameters)
    port = set(inspect.signature(TEngine.__init__).parameters)
    assert ref - port == set()
    assert port - ref == {"device"}


# ---------------------------------------------------------------------------
# chunked prefill parity
# ---------------------------------------------------------------------------

def test_chunked_prefill_matches_monolithic(weights):
    """The same trace through the monolithic and the chunked engine: greedy
    outputs identical and the chunked engine really chunked; both equal
    the JAX engines' (tokens, tick logits, counters)."""
    prompts = _prompts()
    _, mono, _ = _trace(weights, "mono6", prompts, 6, slots=3, num_blocks=40)
    eng, chunked, s = _trace(weights, "chunk6", prompts, 6, slots=3, num_blocks=40,
                             prefill_chunk=8)
    assert [r.output for r in chunked] == [r.output for r in mono]
    assert s["prefill_chunks"] > len(prompts)
    assert eng.stats.ttft_count == len(prompts)


# ---------------------------------------------------------------------------
# preemption: zero overflows, the big pool's outputs, a drained pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_blocks,chunk", [(8, 8), (7, 8), (8, None)])
def test_preemption_parity_and_zero_overflow(weights, num_blocks, chunk):
    """A pool far too small for the working set: the engine preempts, never
    overflows, and reproduces the big pool's outputs (replayed tokens are
    force-fed); the JAX engine does the same, step for step."""
    prompts = _prompts()
    _, ref, _ = _trace(weights, "ref14", prompts, 14, slots=3, num_blocks=40)
    eng, reqs, s = _trace(weights, f"pre{num_blocks}-{chunk}", prompts, 14, slots=3,
                          num_blocks=num_blocks, preempt=True, prefill_chunk=chunk)
    assert s["overflows"] == 0 and all(r.stop_reason != "overflow" for r in reqs)
    assert s["preemptions"] > 0 and s["replayed_tokens"] > 0
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert eng.stats.tokens_generated == sum(len(r.output) for r in reqs)


def test_fp16_pool_chunked_preemption_matches_reference(weights):
    """The (8, 8) trace on an fp16 pool (chunks store the dequantized int8
    rows verbatim): the big fp16 pool's outputs, zero overflows, and the
    JAX engine's trace step for step."""
    prompts = _prompts()
    want, _ = _serve_port(weights, prompts, 14, slots=3, num_blocks=40, kv_pool_dtype="fp16")
    eng, reqs, s = _trace(weights, "fp16 pre8-8", prompts, 14, slots=3, num_blocks=8,
                          preempt=True, prefill_chunk=8, kv_pool_dtype="fp16")
    assert eng._state.caches[0].kv_pool_dtype == "fp16"
    assert s["overflows"] == 0 and s["preemptions"] > 0 and s["prefill_chunks"] > len(prompts)
    assert [r.output for r in reqs] == want


def test_preempted_readmission_hits_radix(weights):
    """A preempted request whose prefix another active request still holds
    re-admits through the radix map (its re-prefill shares blocks)."""
    rng = np.random.default_rng(3)
    pre = rng.integers(0, JF32.vocab_size, (24,)).astype(np.int32)      # 3 blocks
    prompts = [np.concatenate([pre, rng.integers(0, JF32.vocab_size, (n,)).astype(np.int32)])
               for n in (5, 3)]
    ref, _ = _serve_port(weights, prompts, 8, slots=2, num_blocks=40)
    victims = []

    def drive(eng, req_cls):
        reqs = _submit_all(eng, req_cls, prompts, 8)
        for _ in range(16):
            eng._admit()
            eng._tick()
            if len(eng._active) == 2:
                break
        assert len(eng._active) == 2
        eng._tick()
        victim = eng._pick_victim()
        vreq = eng._active[victim]
        eng._preempt_slot(victim)
        assert vreq.preemptions == 1 and vreq.output == []
        victims.append(vreq)
        eng.run()
        return reqs

    _, reqs, _ = _both(weights, drive, slots=2, num_blocks=20, prefix_sharing=True,
                       preempt=True, prefill_chunk=8)
    vreq = victims[-1]
    assert vreq.stop_reason == "length" and vreq.shared_blocks > 0
    assert [r.output for r in reqs] == ref


def test_overflow_finish_preempt_reset_interleaving(weights):
    """A preemption's unmap takes the idempotent paths: releasing the slot
    again (an overflow finish racing it) and resetting it again leave the
    free list as it was, and the engine still drains clean."""
    prompts = _prompts(seed=5, lens=(17, 11))

    def drive(eng, req_cls):
        reqs = _submit_all(eng, req_cls, prompts, 6)
        for _ in range(8):
            eng._admit()
            eng._tick()
            if len(eng._active) == 2:
                break
        assert len(eng._active) == 2
        victim = eng._pick_victim()
        eng._preempt_slot(victim)
        free_after = sorted(eng._alloc.free_ids())
        eng._release_blocks(victim)
        assert sorted(eng._alloc.free_ids()) == free_after
        _reset(eng, victim)
        eng._release_blocks(victim)
        assert sorted(eng._alloc.free_ids()) == free_after
        eng.run()
        return reqs

    _, reqs, _ = _both(weights, drive, slots=2, num_blocks=20, preempt=True)
    assert all(r.stop_reason == "length" for r in reqs)


# ---------------------------------------------------------------------------
# admission accounting
# ---------------------------------------------------------------------------

def test_begin_cycle_accounting(weights):
    """Re-admission never resets ``submitted``/``admitted``; the queue wait
    adds up per cycle and a cycle opens once; as in the JAX engine."""
    for kind, req_cls in (("jax", JRequest), ("port", TRequest)):
        eng = _engine(kind, weights, slots=2, num_blocks=16)
        req = req_cls(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=1)
        req.submitted = 100.0
        eng._begin_cycle(req, 103.0)
        assert req.admitted == 103.0 and req.queue_wait_s == pytest.approx(3.0)
        eng._begin_cycle(req, 105.0)
        assert req.admitted == 103.0 and req.queue_wait_s == pytest.approx(3.0)
        req._requeued_at = 110.0
        req._cycle_started = False
        eng._begin_cycle(req, 112.0)
        assert req.admitted == 103.0 and req.queue_wait_s == pytest.approx(5.0), kind
        assert eng.stats.admissions == 2 and eng.stats.queue_wait_s == pytest.approx(5.0)


def test_stats_populations_under_preemption(weights):
    """One admission cycle per (re-)admission, one TTFT sample per request;
    per-request waits and preemptions reported by `Request.stats()`."""
    prompts = _prompts()
    eng, reqs, s = _trace(weights, "pre8-8", prompts, 14, slots=3, num_blocks=8,
                          preempt=True, prefill_chunk=8)
    assert s["preemptions"] > 0
    assert eng.stats.ttft_count == len(prompts)
    assert s["admissions"] == len(prompts) + s["preemptions"]
    assert all(r.queue_wait_s is not None and r.queue_wait_s >= 0 for r in reqs)
    assert sum(r.stats()["preemptions"] for r in reqs) == s["preemptions"]
    assert s["mean_ttft_s"] >= 0 and s["mean_queue_wait_s"] >= 0


def test_prefill_stash_is_bounded(weights):
    """The engine holds at most one stashed prefill state, none at drain."""
    assert "_prefill" not in {f.name for f in dataclasses.fields(TRequest)}
    prompts = _prompts(seed=11, lens=(9, 9, 9))

    def drive(eng, req_cls):
        reqs = _submit_all(eng, req_cls, prompts, 4)
        for _ in range(40):
            eng._admit()
            assert eng._stash is None or isinstance(eng._stash, tuple)
            eng._tick()
            if not (eng._queue or eng._active):
                break
        assert eng._stash is None
        return reqs

    _, reqs, _ = _both(weights, drive, slots=1, num_blocks=20)
    assert all(r.stop_reason == "length" for r in reqs)


# ---------------------------------------------------------------------------
# incremental chunk charging
# ---------------------------------------------------------------------------

def test_chunk_charging_is_incremental(weights):
    """Each chunk charges exactly the blocks it first covers (host mirror
    and every layer's device refcount); preempting mid-prefill frees
    exactly what was charged."""
    prompt = _prompts(seed=13, lens=(30,))[0]

    def drive(eng, req_cls):
        req = req_cls(rid=0, prompt=prompt.copy(), max_new_tokens=4)
        eng.submit(req)
        for consumed in (8, 16, 24):
            eng._admit()
            inf = eng._inflight
            assert inf is not None and inf.consumed == consumed
            covered = -(-consumed // BS)
            assert len(eng._slot_blocks[inf.slot]) == covered
            assert eng._alloc.total_free == eng.num_blocks - covered
            assert eng._refcount.sum() == covered
            if isinstance(eng, TEngine):
                assert all(int(c.refcount.sum()) == covered for c in eng._state.caches)
        eng._preempt_slot(eng._inflight.slot)
        assert eng._inflight is None
        _assert_drained(eng)
        eng.run()
        assert req.stop_reason == "length" and len(req.output) == 4 and req.preemptions == 1
        return [req]

    _both(weights, drive, slots=2, num_blocks=16, preempt=True, prefill_chunk=8)


# ---------------------------------------------------------------------------
# interleavings of submit / chunk / tick / preempt
# ---------------------------------------------------------------------------

PROP_LENS = (5, 9, 14, 22)


def _interleave(weights, ops, seed):
    """Drive both engines (chunked, preempting, 10 blocks) through the same
    op sequence, then drain: equal traces, no overflow, no leaked block."""
    def drive(eng, req_cls):
        rng = np.random.default_rng(seed)
        reqs = []
        for kind, a in ops:
            kind %= 4
            if kind == 0 and len(reqs) < 6:
                p = rng.integers(0, JF32.vocab_size,
                                 (PROP_LENS[a % len(PROP_LENS)],)).astype(np.int32)
                reqs.append(req_cls(rid=len(reqs), prompt=p, max_new_tokens=3 + a % 5))
                eng.submit(reqs[-1])
            elif kind == 1:
                eng._admit()                 # one chunk / one admission pass
            elif kind == 2:
                eng._tick()
            else:
                victim = eng._pick_victim()
                if victim is not None:
                    eng._preempt_slot(victim)
            free = eng._alloc.free_ids()
            assert len(free) == len(set(free))
        eng.run()
        return reqs

    _, reqs, s = _both(weights, drive, slots=3, num_blocks=10, preempt=True, prefill_chunk=8)
    assert s["overflows"] == 0 and all(r.stop_reason in ("length", "stop") for r in reqs)


def test_scheduler_interleavings_deterministic(weights):
    """Seeded op sequences (the reference's hypothesis-free cases)."""
    master = np.random.default_rng(17)
    for _ in range(4):
        ops = [tuple(master.integers(0, 64, 2).tolist()) for _ in range(10)]
        _interleave(weights, ops, int(master.integers(2 ** 31)))


if HAVE_HYPOTHESIS:
    @settings(max_examples=15, derandomize=True, deadline=None)
    @given(ops=hst.lists(hst.tuples(hst.integers(0, 63), hst.integers(0, 63)),
                         min_size=1, max_size=12),
           seed=hst.integers(0, 2 ** 31 - 1))
    def test_scheduler_interleavings_hypothesis(weights, ops, seed):
        """Random op sequences on both engines: equal traces, zero overflow
        stops, zero leaked blocks at drain."""
        _interleave(weights, ops, seed)


# ---------------------------------------------------------------------------
# the block-sharded engine
# ---------------------------------------------------------------------------

# the (8, 8) preemption trace: 8 blocks, 4 per rank at two ranks
SHARD_ENGINE = dict(max_seq=MAX_SEQ, slots=3, block_size=BS, num_blocks=8, preempt=True,
                    prefill_chunk=8)
SHARD_NEW = 14


@pytest.mark.parametrize("mode", ["int8", "fp16"])
def test_sharded_engine_world1_equals_unsharded(weights, mode):
    """The chunked, preempting engine over a one-rank gloo world, in both
    pool modes that take chunks: the unsharded engine's tokens and
    counters, a drained pool."""
    want, eng = _serve_port(weights, _prompts(), SHARD_NEW, kv_pool_dtype=mode, **SHARD_ENGINE)
    got, eng1 = _serve_port(weights, _prompts(), SHARD_NEW, ctx=init_decode_ctx("cpu"),
                            kv_pool_dtype=mode, **SHARD_ENGINE)
    assert got == want
    assert eng1.stats.preemptions == eng.stats.preemptions > 0
    assert eng1.stats.prefill_chunks == eng.stats.prefill_chunks
    assert eng1.stats.overflows == 0
    _assert_drained(eng1)


def test_sharded_engine_two_gloo_ranks(weights, tmp_path):
    """Two SPMD ranks (tests/_torch_dist_worker.py ``scheduler``): chunks
    whose blocks lie on both ranks, at least one preemption, the unsharded
    port's tokens, equal logits and page tables on both ranks, both pools
    drained and consistent."""
    want, eng = _serve_port(weights, _prompts(), SHARD_NEW, **SHARD_ENGINE)
    torch.save(dict(weights=weights[1], prompts=_prompts(), new_tokens=SHARD_NEW, engine=SHARD_ENGINE,
                    cfg=dict(salca_static_channels=True)), tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               "scheduler", str(tmp_path), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    res = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(2)]
    for r in res:
        assert r["outputs"] == want
        assert r["stats"]["preemptions"] == eng.stats.preemptions > 0
        assert r["stats"]["overflows"] == 0 and r["free"] == list(range(8)) and r["pools_ok"]
        owners = {int(b) // 4 for pages in r["chunk_pages"] for b in pages if b >= 0}
        assert owners == {0, 1}, "the chunks' blocks must lie on both ranks"
    assert len(res[0]["chunk_pages"]) == eng.stats.prefill_chunks
    for (m0, l0, pt0), (m1, l1, pt1) in zip(res[0]["ticks"], res[1]["ticks"]):
        assert torch.equal(l0, l1) and torch.equal(pt0, pt1)
