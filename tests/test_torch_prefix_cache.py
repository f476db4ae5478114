"""Port parity, the persistent prefix cache (the reference's persistent
cross-request prefix cache): `adopt_pages`, the pool audit's
``cache_pinned``, `lm_calibrate_static_heavy` and the float32
``calib_salience`` leaf of `weights.params_from_numpy` against the JAX
package, and the reference battery tests/test_prefix_cache.py ported case
for case, every engine trace run through the JAX engine as well.

* Module parity: `adopt_pages` on one pool (every leaf) and in its
  rank-local form at two block ranges (the refcount equal to the reference
  pool's slice); the audit's ``ok`` and violation count for a clean pin, a
  mapped pin, a pin on the free list and a duplicate pin; calibration
  (salience within CALIB_RTOL, heavy sets equal, the smallest top-r margin
  printed, the input tree untouched); a bf16 config's ``calib_salience``
  leaf kept in float32 and its heavy sets equal to the reference's.
* The battery: pins, warm hits (zero prefill, bit for bit against the cold
  engine, a divergent tail copied on write), adoption gated off without
  static channels, LRU eviction and its order, eviction before preemption,
  the host cold tier (demotion, bit-exact rehydration, its bound), the
  refusals, the flush, the audit against corrupted pins, the chunked
  engine, the calibrated engine, and seeded and hypothesis visit traces.
  Each trace runs through both engines: tokens identical, the counters,
  pins, radix nodes (block, heavy bytes, depth), cold keys and free lists
  equal block id for block id (both allocators pop the highest id), the
  kept logits rows and every tick's logits within LOGIT_TOL
  (CODE_STEP_TOL where the two pools round a K/V value to adjacent int8
  codes); then each engine flushes its cache and audits clean with a full
  free list and every refcount 0.
* Sampling on a warm hit (the first token drawn from the kept row); the
  block-sharded engine at one in-process rank and at two spawned gloo
  ranks (tests/_torch_dist_worker.py ``cache``) on a visit trace that
  evicts.

Engines serve qwen3-0.6b.reduced() with ``salca_static_channels`` at
float32 compute, from the JAX init tree converted by `repro_torch.weights`;
JAX engines of one config share the first one's compiled steps, which
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
from repro.configs import get_config as jget_config
from repro.core import cache as jc
from repro.models import blocks as jblocks
from repro.models import get_model as jget_model
from repro.runtime.serve import CACHE_COLD as J_CACHE_COLD
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.core import cache as tc
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.models import blocks as tblocks
from repro_torch.models.registry import get_model as tget_model
from repro_torch.runtime.serve import CACHE_COLD, Request as TRequest
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
# logits and codes: the bounds and measurements of tests/test_torch_scheduler.py
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
CODE_STEP_TOL = dict(rtol=1e-5, atol=1e-3)
# calibration salience, model against model: a sum over B·T rows of
# |code · scale|, where the two packages' f32 forwards give each scale to
# within SCALE_RTOL (tests/test_torch_scheduler.py) and may round a K value
# to the adjacent code; measured 4.4e-7 here, against O(1) between channels
CALIB_RTOL = 1e-5
MAX_SEQ, BS = 128, 16
COUNTERS = ("completed", "admissions", "ttft_count", "tokens_generated", "overflows",
            "preemptions", "replayed_tokens", "prefill_chunks", "chunk_stalls",
            "prefill_tokens", "peak_blocks_in_use", "shared_blocks", "prefix_hits",
            "cow_copies", "cache_hits", "cache_hit_blocks", "cache_evictions",
            "cache_pinned_blocks", "peak_cache_blocks", "zero_prefill_hits", "demotions",
            "promotions", "pcie_bytes", "ticks")


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JF32).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TF32, "cpu")


def _prompt(rng, n):
    return rng.integers(0, JF32.vocab_size, n).astype(np.int32)


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------

NB, PSLOTS, PMB, PKV, PHD = 12, 3, 8, 2, 32
POOL_PARAMS = dict(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
OWNER_PAGES = (5, 2, 9, 7)     # slot 0 holds a 28-token prompt on blocks of 8


def _owner_pools(rng):
    """Both packages' pools with slot 0's prompt written, its blocks then
    released (the cache-pinned state: rows kept, refcount 0), the heavy set
    and the pages to adopt."""
    from repro.core.selection import SalcaParams as JP
    from repro_torch.core.selection import SalcaParams as TP
    jpp, tpp = JP(**POOL_PARAMS), TP(**POOL_PARAMS)
    r = tpp.r(PHD)
    k, v = (rng.normal(size=(1, 28, PKV, PHD)).astype(np.float32) for _ in range(2))
    heavy = np.sort(rng.permutation(PHD)[:r])[None, None].repeat(PKV, 1).astype(np.int32)
    pages = np.array(OWNER_PAGES + (-1,) * (PMB - len(OWNER_PAGES)), np.int32)
    jpool = jc.empty_paged_cache(NB, 8, PSLOTS, PMB, PKV, PHD, r)
    tpool = tc.empty_paged_cache(NB, 8, PSLOTS, PMB, PKV, PHD, r)
    jsrc = jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=PMB * 8, params=jpp,
                            heavy_idx=jnp.asarray(heavy))
    tsrc = tc.prefill_cache(tt(k), tt(v), max_seq=PMB * 8, params=tpp, heavy_idx=tt(heavy))
    jpool = jc.free_pages(jc.prefill_into_pages(jpool, jsrc, 0, jnp.asarray(pages)), 0)
    tc.free_pages(tc.prefill_into_pages(tpool, tsrc, 0, tt(pages)), 0)
    return jpool, tpool, heavy, pages


def test_adopt_pages_matches_reference(rng):
    """A released prompt adopted into slot 2 (and slot 1 aliasing it): every
    leaf of the pool equals the JAX pool's, data rows untouched."""
    jpool, tpool, heavy, pages = _owner_pools(rng)
    before = {f: getattr(tpool, f).clone() for f in tc._DATA_FIELDS}
    for slot in (2, 1):
        jpool = jc.adopt_pages(jpool, slot, jnp.asarray(pages), 28, jnp.asarray(heavy))
        tc.adopt_pages(tpool, slot, pages, 28, tt(heavy))
    for f in POOL_FIELDS:
        j = np.asarray(getattr(jpool, f))
        np.testing.assert_array_equal(tn(getattr(tpool, f), j), j, err_msg=f)
    for f in tc._DATA_FIELDS:
        assert torch.equal(getattr(tpool, f), before[f]), f
    assert tn(tpool.refcount)[list(OWNER_PAGES)].tolist() == [2] * 4
    assert tpool.check_invariants().ok


@pytest.mark.parametrize("block_range", [(0, 6), (6, 12)])
def test_adopt_pages_rank_local(rng, block_range):
    """The rank-local form (a sharded refcount, as `map_block`'s): the
    metadata equals the JAX pool's everywhere, the refcount the JAX
    refcount's slice of the owned blocks."""
    lo, hi = block_range
    jpool, tpool, heavy, pages = _owner_pools(rng)
    tpool.refcount = tpool.refcount[lo:hi].clone()
    jpool = jc.adopt_pages(jpool, 1, jnp.asarray(pages), 28, jnp.asarray(heavy))
    tc.adopt_pages(tpool, 1, pages, 28, tt(heavy), block_range=block_range)
    for f in ("page_table", "length", "heavy_idx", "sel_hist"):
        np.testing.assert_array_equal(tn(getattr(tpool, f)), np.asarray(getattr(jpool, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tn(tpool.refcount), np.asarray(jpool.refcount)[lo:hi])


def _pinned_pool(rng):
    """A pool with slot 0 mapping blocks 5, 2, 9 (block 7 released) for the
    audit cases, both packages."""
    jpool, tpool, heavy, pages = _owner_pools(rng)
    row = np.array([5, 2, 9] + [-1] * (PMB - 3), np.int32)
    jpool = jc.adopt_pages(jpool, 0, jnp.asarray(row), 20, jnp.asarray(heavy))
    tc.adopt_pages(tpool, 0, row, 20, tt(heavy))
    return jpool, tpool


AUDIT_CASES = {
    "clean": ([7], [b for b in range(NB) if b not in (5, 2, 9, 7)]),
    "mapped_pin": ([7, 2], [b for b in range(NB) if b not in (5, 2, 9, 7)]),
    "pin_on_free_list": ([7], [b for b in range(NB) if b not in (5, 2, 9)]),
    "duplicate_pin": ([7, 7], [b for b in range(NB) if b not in (5, 2, 9, 7)]),
    "leaked_without_pins": (None, [b for b in range(NB) if b not in (5, 2, 9, 7)]),
}


@pytest.mark.parametrize("case", list(AUDIT_CASES))
def test_check_invariants_cache_pinned(rng, case):
    """The audit with ``cache_pinned``: the port's report is ``ok`` exactly
    where the reference's is, with as many violations."""
    jpool, tpool = _pinned_pool(rng)
    pins, free = AUDIT_CASES[case]
    want = jpool.check_invariants(free_blocks=free, cache_pinned=pins)
    got = tpool.check_invariants(free_blocks=free, cache_pinned=pins)
    assert got.ok == want.ok == (case == "clean"), (got, want)
    assert len(got.violations) == len(want.violations), (got, want)
    if pins is not None and case != "clean":
        assert any("pin" in v for v in got.violations), got


def _leaves(tree, path="") -> dict:
    """A parameter tree's tensors by path."""
    if torch.is_tensor(tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items for k, v in _leaves(sub, f"{path}/{key}").items()}


def _calib_tokens(rng, b=2, t=32):
    return np.stack([_prompt(rng, t) for _ in range(b)])


def test_calibrate_matches_reference(weights, rng):
    """`lm_calibrate_static_heavy` on a (2, 32) batch: each layer's salience
    within CALIB_RTOL of the JAX one, the heavy sets index for index (the
    smallest gap between the r-th and (r+1)-th salience over the kv heads
    printed: a near-tie would show there), and the input tree untouched."""
    jp, tp = weights
    tokens = _calib_tokens(rng)
    jcal = jget_model(JCFG).calibrate(jp, jnp.asarray(tokens))
    before = {k: v.clone() for k, v in _leaves(tp).items()}
    tcal = tget_model(TCFG).calibrate(tp, torch.from_numpy(tokens))
    r = tblocks.salca_params_for(TCFG, MAX_SEQ).r(TCFG.resolved_head_dim)
    margins = []
    for i, layer in enumerate(tcal["layers"]):
        sal = layer["attn"]["calib_salience"]
        want = np.asarray(jcal["periods"][0]["attn"]["calib_salience"])[i]
        assert sal.dtype == torch.float32 and sal.shape == want.shape
        np.testing.assert_allclose(tn(sal), want, rtol=CALIB_RTOL, atol=0, err_msg=f"layer {i}")
        top = np.sort(tn(sal), axis=-1)[:, ::-1]
        margins.append(float((top[:, r - 1] - top[:, r]).min()))
    got = tget_model(TCFG).static_heavy(tcal, MAX_SEQ)
    want = jget_model(JCFG).static_heavy(jcal, MAX_SEQ)[0]
    np.testing.assert_array_equal(tn(torch.stack(got)), np.asarray(want))
    assert not np.array_equal(tn(torch.stack(got)),
                              tn(torch.stack(tget_model(TCFG).static_heavy(tp, MAX_SEQ))))
    print(f"calibration: smallest gap between the r-th and (r+1)-th salience per layer "
          f"{[f'{m:.3e}' for m in margins]}")
    assert all("calib_salience" not in layer["attn"] for layer in tp["layers"])
    after = _leaves(tp)
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_weights_keep_calib_salience_f32(weights, rng):
    """A bf16 config's tree carrying a ``calib_salience`` leaf: the leaf
    arrives as float32 (every other leaf in bf16), and its heavy sets equal
    the reference's `static_heavy_idx` on the same tree."""
    jp, _ = weights
    jcfg = dataclasses.replace(jget_config("qwen3-0.6b").reduced(), salca_static_channels=True)
    tcfg = dataclasses.replace(tget_config("qwen3-0.6b").reduced(), salca_static_channels=True)
    assert tcfg.dtype == "bfloat16"
    n, kv, hd = JF32.num_layers, JF32.num_kv_heads, JF32.resolved_head_dim
    # salience with near-ties a bf16 rounding would break: 1 + k·2^-12
    sal = (1.0 + rng.permutation(kv * hd).reshape(kv, hd) * 2.0 ** -12).astype(np.float32)
    sal = np.stack([np.roll(sal, i, axis=-1) for i in range(n)])
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["periods"][0]["attn"]["calib_salience"] = sal
    tp = params_from_numpy(tree, tcfg, "cpu")
    sp = tblocks.salca_params_for(tcfg, MAX_SEQ)
    from repro.models.blocks import salca_params_for as jsp_for
    jsp = jsp_for(jcfg, MAX_SEQ)
    for i, layer in enumerate(tp["layers"]):
        assert layer["attn"]["calib_salience"].dtype == torch.float32
        assert layer["attn"]["wk"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tn(layer["attn"]["calib_salience"]), sal[i])
        jattn = {"wk": jnp.asarray(tree["periods"][0]["attn"]["wk"][i]),
                 "calib_salience": jnp.asarray(sal[i])}
        np.testing.assert_array_equal(
            tn(tblocks.static_heavy_idx(layer["attn"], tcfg, sp, 1)),
            np.asarray(jblocks.static_heavy_idx(jattn, jcfg, jsp, 1)), err_msg=f"layer {i}")
    rounded = torch.from_numpy(sal[0]).to(torch.bfloat16)
    assert not torch.equal(rounded.float(), torch.from_numpy(sal[0])), \
        "the case must hold values a bf16 leaf would round"


def test_calib_salience_overrides_weight_mass(rng):
    """`static_heavy_idx` takes an installed ``calib_salience`` leaf over the
    weight mass; without the leaf the weight mass holds; as the JAX one."""
    sp = tblocks.salca_params_for(TCFG, MAX_SEQ)
    from repro.models.blocks import salca_params_for as jsp_for
    jsp = jsp_for(JCFG, MAX_SEQ)
    hd, kv = TCFG.resolved_head_dim, TCFG.num_kv_heads
    wk = rng.normal(size=(TCFG.d_model, kv, hd)).astype(np.float32)
    r = sp.r(hd)
    sal = np.zeros((kv, hd), np.float32)
    sal[:, -r:] = 1.0 + np.arange(r)
    base = tblocks.static_heavy_idx({"wk": tt(wk)}, TCFG, sp, 1)
    cal = tblocks.static_heavy_idx({"wk": tt(wk), "calib_salience": tt(sal)}, TCFG, sp, 1)
    np.testing.assert_array_equal(tn(cal[0]), np.broadcast_to(np.arange(hd - r, hd), (kv, r)))
    assert base.shape == cal.shape and not torch.equal(base, cal)
    for attn, got in (({"wk": wk}, base), ({"wk": wk, "calib_salience": sal}, cal)):
        want = jblocks.static_heavy_idx({k: jnp.asarray(v) for k, v in attn.items()}, JCFG,
                                        jsp, 1)
        np.testing.assert_array_equal(tn(got), np.asarray(want))


def test_calibrate_returns_new_params_and_changes_sets(weights, rng):
    """`api.calibrate` installs per-layer salience without touching the input
    tree; the calibrated static sets are sorted, unique, in range."""
    _, tp = weights
    api = tget_model(TCFG)
    cal = api.calibrate(tp, torch.from_numpy(_calib_tokens(rng)))
    assert all("calib_salience" not in layer["attn"] for layer in tp["layers"])
    base, sets = api.static_heavy(tp, MAX_SEQ), api.static_heavy(cal, MAX_SEQ)
    assert len(base) == len(sets)
    for a, b in zip(base, sets):
        assert a.shape == b.shape
        assert (torch.diff(b, dim=-1) > 0).all()
        assert int(b.min()) >= 0 and int(b.max()) < TCFG.resolved_head_dim


# ---------------------------------------------------------------------------
# engines: both packages on one trace
# ---------------------------------------------------------------------------

# the JAX engine's jitted steps, shared by the JAX engines of one config: they
# close over the engine's model API and max_seq only, and jit keys its
# compilations on the argument shapes and trees
_JAX_STEPS: dict = {}
_JAX_STEP_NAMES = ("_decode", "_prefill", "_reset", "_write", "_map_block", "_cow_block",
                   "_chunk_step", "_adopt", "_read_block", "_write_block", "_sel_hist_fn")


def _engine(kind, weights, *, num_blocks=20, slots=4, cache=True, static=True, params=None,
            **kw):
    """A paged engine of either package with prefix sharing, the reference
    battery's `_engine`; ``params`` (JAX tree, port tree) overrides the
    weights, ``static=False`` drops the static heavy channels."""
    jp, tp = params or weights
    kw = dict(max_seq=MAX_SEQ, slots=slots, paged=True, block_size=BS, num_blocks=num_blocks,
              prefix_sharing=True, prefix_cache=cache, **kw)
    if kind == "port":
        return TEngine(TCFG if static else TF32, tp, device="cpu", **kw)
    eng = JEngine(JCFG if static else JF32, jp, **kw)
    for name in _JAX_STEP_NAMES:
        if getattr(eng, name, None) is not None:
            setattr(eng, name, _JAX_STEPS.setdefault((name, static), getattr(eng, name)))
    return eng


def _run_one(eng, mk, prompt, rid=0, max_new=2, **req_kw):
    r = mk(rid=rid, prompt=prompt.copy(), max_new_tokens=max_new, **req_kw)
    eng.submit(r)
    eng.run()
    return r


def _audit(eng):
    rep = eng.check_invariants()
    assert rep.ok, rep.violations
    return rep


def _cache_state(eng) -> dict:
    """The cache's host state: pins and stamps, radix nodes (block, heavy
    bytes), depths, cold and kept-row keys, the free list."""
    return dict(pins=dict(eng._cached), nodes=dict(eng._prefix_nodes),
                depth=dict(eng._node_depth), cold=sorted(eng._cold_cache),
                rows=sorted(eng._logits_cache), free=sorted(eng._alloc.free_ids()),
                refcount=np.asarray(eng._refcount).tolist(), clock=eng._cache_clock)


def _drain(eng) -> None:
    """Flush the cache: a clean audit, a full free list, every refcount 0,
    nothing left of the cache."""
    eng.flush_prefix_cache()
    _audit(eng)
    assert sorted(eng._alloc.free_ids()) == list(range(eng.num_blocks))
    assert not np.asarray(eng._refcount).any()
    assert not (eng._cached or eng._prefix_nodes or eng._cold_cache or eng._logits_cache)


def _both(weights, drive, **kw):
    """Run ``drive(eng, mk) -> requests`` on a JAX and a port engine built
    with ``kw`` (`_engine`'s); assert the port's trace is the reference's
    (tokens, stop reasons, shared blocks, every tick's mask and logits, the
    counters, the cache's state block for block, the kept logits rows),
    drain both; return the port's engine and requests and the JAX engine's
    requests."""
    runs = []
    for kind, mk in (("jax", JRequest), ("port", TRequest)):
        eng = _engine(kind, weights, **kw)
        ticks = record_ticks(eng)
        reqs = drive(eng, mk)
        runs.append((eng, reqs, ticks))
    (je, jr, jt), (te, tr, tt_) = runs
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.stop_reason for r in tr] == [r.stop_reason for r in jr]
    assert [r.shared_blocks for r in tr] == [r.shared_blocks for r in jr]
    assert len(tt_) == len(jt)
    for (tm, tl, tcodes), (jm, jl, jcodes) in zip(tt_, jt):
        np.testing.assert_array_equal(tm, jm)
        step = int(np.abs(tcodes - jcodes).max(initial=0))
        assert step <= 1, f"the pools' int8 codes part by {step} steps"
        np.testing.assert_allclose(tl[tm], jl[jm], **(CODE_STEP_TOL if step else LOGIT_TOL))
    assert {k: getattr(te.stats, k) for k in COUNTERS} == \
        {k: getattr(je.stats, k) for k in COUNTERS}
    tstate, jstate = _cache_state(te), _cache_state(je)
    assert tstate == jstate
    for key in tstate["rows"]:
        np.testing.assert_allclose(te._logits_cache[key], je._logits_cache[key], **LOGIT_TOL)
    for eng in (je, te):
        _drain(eng)
    return te, tr, jr


def _visits(*visits, max_new=2):
    """A drive serving ``visits`` (prompt, rid) one at a time, each run
    until the engine drains (no two requests resident together)."""
    def drive(eng, mk):
        return [_run_one(eng, mk, p, rid=rid, max_new=max_new) for p, rid in visits]
    return drive


# ---------------------------------------------------------------------------
# pin lifecycle
# ---------------------------------------------------------------------------

def test_release_pins_instead_of_freeing(weights, rng):
    """The last owner's release keeps its radix-published blocks under a
    cache pin: off the free list, refcount 0, the radix entry kept."""
    p = _prompt(rng, 40)                        # 3 blocks: 2 full and a partial

    def drive(eng, mk):
        r = _run_one(eng, mk, p)
        assert len(eng._cached) == 3
        for b in eng._cached:
            assert eng._refcount[b] == 0 and b not in eng._free_blocks
            assert b in eng._block_keys and eng._block_keys[b] in eng._prefix_nodes
        assert eng.stats.cache_pinned_blocks == eng.stats.peak_cache_blocks == 3
        _audit(eng)
        return [r]

    _both(weights, drive)


def test_nonpersistent_engine_frees_on_release(weights, rng):
    p = _prompt(rng, 40)

    def drive(eng, mk):
        r = _run_one(eng, mk, p)
        assert sorted(eng._free_blocks) == list(range(20))
        assert not eng._prefix_nodes and not eng._block_keys
        _audit(eng)
        return [r]

    _both(weights, drive, cache=False)


def test_warm_hit_pops_pin_and_counts_cache_hit(weights, rng):
    """The repeat adopts the pinned blocks: the pins go back to resident,
    counted as a cache hit (across requests), not as sharing."""
    p = _prompt(rng, 40)

    def drive(eng, mk):
        r0 = _run_one(eng, mk, p, rid=0)
        pinned = set(eng._cached)
        r1 = _run_one(eng, mk, p, rid=1)
        assert r1.shared_blocks == 3
        assert (eng.stats.cache_hits, eng.stats.cache_hit_blocks) == (1, 3)
        assert (eng.stats.prefix_hits, eng.stats.shared_blocks) == (0, 0)
        assert eng.stats.zero_prefill_hits == 1
        assert set(eng._cached) >= pinned
        _audit(eng)
        return [r0, r1]

    _both(weights, drive)


def test_summary_separates_cache_from_intra_flight(weights, rng):
    p = _prompt(rng, 40)
    te, _, _ = _both(weights, _visits((p, 0), (p, 1)))
    s = te.stats.summary()
    assert s["cache_hits"] == 1 and s["zero_prefill_hits"] == 1
    assert s["cache_saved_tokens"] == 3 * BS
    assert s["prefix_hits"] == 0
    assert s["effective_blocks_saved"] == 3 - te.stats.cow_copies


# ---------------------------------------------------------------------------
# zero-prefill adoption: parity with the cold engine
# ---------------------------------------------------------------------------

_COLD: dict = {}


def _cold(weights, prompt, max_new, **kw):
    """A fresh cold engine's outputs for one prompt, through both packages
    (cached by prompt)."""
    key = (prompt.tobytes(), max_new, tuple(sorted(kw.items())))
    if key not in _COLD:
        _, reqs, _ = _both(weights, _visits((prompt, 0), max_new=max_new), cache=False, **kw)
        _COLD[key] = reqs[0].output
    return _COLD[key]


def test_warm_hits_bit_identical_to_cold_engine(weights, rng):
    """Prompts replayed one at a time: every output, the zero-prefill
    adoptions included, equals a fresh cold engine's for its request."""
    prompts = [_prompt(rng, 40), _prompt(rng, 33)]
    trace = [prompts[0], prompts[1], prompts[0], prompts[0], prompts[1]]
    cold = [_cold(weights, p, 4) for p in trace]
    te, reqs, _ = _both(weights, _visits(*((p, i) for i, p in enumerate(trace)), max_new=4))
    assert [r.output for r in reqs] == cold
    assert te.stats.zero_prefill_hits == 3


def test_warm_hit_with_divergent_tail_cows(weights, rng):
    """Two requests admitted together off one pinned prefix: the second
    shares the first's adopted blocks while resident, so the first write
    into the partial block is copied; outputs equal the cold engine's and
    the partial block's kept rows serve the next hit."""
    p = _prompt(rng, 40)
    cold = _cold(weights, p, 5)

    def drive(eng, mk):
        r0 = _run_one(eng, mk, p, rid=0, max_new=5)
        rb, rc = (mk(rid=i, prompt=p.copy(), max_new_tokens=5) for i in (1, 2))
        eng.submit(rb)
        eng.submit(rc)
        eng.run()
        assert rb.output == rc.output == cold
        assert eng.stats.cow_copies >= 1
        assert eng.stats.cache_hits >= 1 and eng.stats.prefix_hits >= 1
        r3 = _run_one(eng, mk, p, rid=3, max_new=5)
        assert r3.output == cold
        _audit(eng)
        return [r0, rb, rc, r3]

    _both(weights, drive)


def test_adoption_gated_off_without_static_channels(weights, rng):
    """Per-input heavy channels: no adoption (`_adopt` is None); a hit still
    maps the pinned blocks by reference through the prefill path."""
    p = _prompt(rng, 40)
    cold = _cold(weights, p, 2, static=False)

    def drive(eng, mk):
        assert eng._adopt is None
        r0 = _run_one(eng, mk, p, rid=0)
        r1 = _run_one(eng, mk, p, rid=1)
        assert r1.output == cold
        assert eng.stats.zero_prefill_hits == 0
        assert (eng.stats.cache_hits, eng.stats.cache_hit_blocks) == (1, 3)
        _audit(eng)
        return [r0, r1]

    _both(weights, drive, static=False)


# ---------------------------------------------------------------------------
# LRU eviction under pressure
# ---------------------------------------------------------------------------

def test_pressure_evicts_lru_pins_before_waiting(weights, rng):
    """An admission short of blocks drains the cache's LRU end: the oldest
    stamp's pins go first, deepest first, with their radix nodes."""
    pa, pb, pc = (_prompt(rng, 40) for _ in range(3))

    def drive(eng, mk):
        reqs = [_run_one(eng, mk, pa, rid=0), _run_one(eng, mk, pb, rid=1)]
        assert len(eng._cached) == 6
        keys_a = {eng._node_depth[b]: eng._block_keys[b]
                  for b, s in eng._cached.items() if s == 1}
        reqs.append(_run_one(eng, mk, pc, rid=2))   # needs 2 more: evicts pa's
        assert eng.stats.cache_evictions == 2
        assert keys_a[2] not in eng._prefix_nodes and keys_a[1] not in eng._prefix_nodes
        assert keys_a[0] in eng._prefix_nodes
        _audit(eng)
        return reqs

    _both(weights, drive, num_blocks=7, slots=2)


def test_hit_after_evict_reprefills_correctly(weights, rng):
    """Evicted, a repeat finds no radix entry and prefills again: the same
    outputs."""
    pa = _prompt(rng, 40)
    others = [_prompt(rng, 40) for _ in range(3)]

    def drive(eng, mk):
        first = _run_one(eng, mk, pa, rid=0)
        reqs = [first] + [_run_one(eng, mk, p, rid=i) for i, p in enumerate(others, 1)]
        hits0 = eng.stats.cache_hits
        again = _run_one(eng, mk, pa, rid=4)
        assert again.output == first.output and again.shared_blocks == 0
        assert eng.stats.cache_hits == hits0
        _audit(eng)
        return reqs + [again]

    _both(weights, drive, num_blocks=7, slots=2)


def test_lru_order_prefers_oldest_stamp_deepest_block(weights, rng):
    """The victim order (stamp ascending, depth descending): a re-hit
    refreshes its prefix's stamps, so the untouched prefix goes first;
    draining one pin at a time never orphans a chain."""
    pa, pb = _prompt(rng, 40), _prompt(rng, 40)

    def drive(eng, mk):
        reqs = [_run_one(eng, mk, p, rid=i) for i, p in enumerate((pa, pb, pa))]
        stale = [b for b, s in sorted(eng._cached.items()) if s == min(eng._cached.values())]
        victim = eng._cache_victim()
        assert victim in stale
        assert eng._node_depth[victim] == max(eng._node_depth[b] for b in stale)
        order = []
        while True:
            b = eng._cache_victim()
            if not eng._evict_cache_block():
                break
            order.append(b)
            _audit(eng)
        assert not eng._cached and not eng._prefix_nodes
        eng.order = order
        return reqs

    te, _, _ = _both(weights, drive, num_blocks=20, slots=2)
    assert len(te.order) == 6


def test_eviction_runs_before_preemption(weights, rng):
    """Growth pressure drains the pins before any preemption: with enough
    of them, no request is preempted."""
    p0, p1, p2 = (_prompt(rng, 40) for _ in range(3))

    def drive(eng, mk):
        r0 = _run_one(eng, mk, p0, rid=0)
        assert len(eng._cached) == 3
        # two growers, 4 blocks each over their lifetime (40 + 24 = 64
        # tokens): the pool exactly, so both finish unpreempted only if the
        # pins drain under pressure
        r1, r2 = (mk(rid=i, prompt=p.copy(), max_new_tokens=25) for i, p in ((1, p1), (2, p2)))
        eng.submit(r1)
        eng.submit(r2)
        eng.run()
        assert r1.stop_reason == r2.stop_reason == "length"
        assert eng.stats.preemptions == 0 and eng.stats.cache_evictions >= 1
        _audit(eng)
        return [r0, r1, r2]

    _both(weights, drive, num_blocks=8, slots=2, preempt=True)


# ---------------------------------------------------------------------------
# the host cold tier
# ---------------------------------------------------------------------------

def test_spill_cache_demotes_and_rehydrates_bit_exact(weights, rng):
    """With ``host_spill`` pressure demotes pins to the host tier (the radix
    key stays matchable as CACHE_COLD) and the next hit rehydrates them:
    the cold engine's outputs."""
    pa, pb = _prompt(rng, 40), _prompt(rng, 40)
    cold = [_cold(weights, p, 2, num_blocks=4, slots=2) for p in (pa, pb, pa)]
    seen_cold = []

    def drive(eng, mk):
        reqs = [_run_one(eng, mk, pa, rid=0), _run_one(eng, mk, pb, rid=1)]
        seen_cold.append(sum(b == (CACHE_COLD if isinstance(eng, TEngine) else J_CACHE_COLD)
                             for b, _ in eng._prefix_nodes.values()))
        reqs.append(_run_one(eng, mk, pa, rid=2))
        return reqs

    te, reqs, _ = _both(weights, drive, num_blocks=4, slots=2, host_spill=True)
    assert [r.output for r in reqs] == cold
    assert te.stats.demotions >= 2 and te.stats.promotions >= 1 and te.stats.cache_hits >= 1
    assert seen_cold[0] == seen_cold[1] >= 2
    assert CACHE_COLD == J_CACHE_COLD


def test_spill_prefix_sharing_no_longer_raises(weights):
    """The host tier combines with prefix sharing and with the cache."""
    for kind in ("jax", "port"):
        eng = _engine(kind, weights, host_spill=True, cache=False)
        assert eng.host_spill and eng.prefix_sharing
        assert _engine(kind, weights, host_spill=True).prefix_cache


def test_cold_tier_is_bounded(weights, rng):
    """The host tier holds at most one pool's worth of cold entries; past
    that its LRU entry is dropped (counted as an eviction)."""
    prompts = [_prompt(rng, 40) for _ in range(8)]

    def drive(eng, mk):
        reqs = [_run_one(eng, mk, p, rid=i) for i, p in enumerate(prompts)]
        assert len(eng._cold_cache) <= 4
        assert eng.stats.cache_evictions > 0
        _audit(eng)
        return reqs

    _both(weights, drive, num_blocks=4, slots=2, host_spill=True)


# ---------------------------------------------------------------------------
# refusals, flush, audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(prefix_sharing=True, kv_pool_dtype="int4"), "int4"),
    (dict(), "prefix_sharing")], ids=["int4_pool", "requires_prefix_sharing"])
def test_prefix_cache_refusals(weights, kw, match):
    """The reference's ValueErrors, raised by both engines."""
    jp, tp = weights
    for eng_cls, cfg, params, extra in ((JEngine, JCFG, jp, {}),
                                        (TEngine, TCFG, tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            eng_cls(cfg, params, max_seq=MAX_SEQ, slots=2, paged=True, block_size=BS,
                    num_blocks=8, prefix_cache=True, **kw, **extra)


def test_flush_returns_pool_to_full(weights, rng):
    prompts = [_prompt(rng, 40) for _ in range(3)]

    def drive(eng, mk):
        reqs = [_run_one(eng, mk, p, rid=i) for i, p in enumerate(prompts)]
        snapshot = _cache_state(eng)
        assert eng.flush_prefix_cache() == 9              # 3 requests × 3 blocks
        assert not eng._cached and not eng._prefix_nodes
        assert not eng._logits_cache and not eng._cold_cache
        assert sorted(eng._free_blocks) == list(range(20))
        assert (np.asarray(eng._refcount) == 0).all()
        _audit(eng)
        eng.flushed = snapshot
        return reqs

    te, _, _ = _both(weights, drive)
    assert len(te.flushed["pins"]) == 9


def test_invariants_catch_pin_corruption(weights, rng):
    """The audit bites: a pin that is also on the free list is reported."""
    p = _prompt(rng, 40)

    def drive(eng, mk):
        r = _run_one(eng, mk, p)
        b = next(iter(eng._cached))
        eng._alloc.release(b)                           # pinned AND free
        rep = eng.check_invariants()
        assert not rep.ok and any("pinned" in v for v in rep.violations)
        eng.caught = len(rep.violations)
        eng._alloc.take(b)
        _audit(eng)
        return [r]

    te, _, _ = _both(weights, drive)
    assert te.caught >= 2              # the pool audit and the engine's both see it


def test_chunked_prefill_engine_supports_cache(weights, rng):
    """Continuous batching: pins, warm hits and adoption through
    `_advance_prefill`."""
    p = _prompt(rng, 40)
    cold = _cold(weights, p, 2, prefill_chunk=16)
    te, reqs, _ = _both(weights, _visits((p, 0), (p, 1)), prefill_chunk=16)
    assert [r.output for r in reqs] == [cold, cold]
    assert te.stats.cache_hits == te.stats.zero_prefill_hits == 1


# ---------------------------------------------------------------------------
# calibrated static heavy channels
# ---------------------------------------------------------------------------

def test_calibrated_engine_warm_hits_stay_bit_identical(weights, rng):
    """The cache on calibrated sets: warm hits equal the calibrated cold
    engine's outputs."""
    jp, tp = weights
    tokens = np.stack([_prompt(rng, 32)])
    cal = (jget_model(JCFG).calibrate(jp, jnp.asarray(tokens)),
           tget_model(TCFG).calibrate(tp, torch.from_numpy(tokens)))
    p = _prompt(rng, 40)
    _, cold, _ = _both(weights, _visits((p, 0)), params=cal, cache=False)
    te, reqs, _ = _both(weights, _visits((p, 0), (p, 1)), params=cal)
    assert reqs[0].output == reqs[1].output == cold[0].output
    assert te.stats.zero_prefill_hits == 1


# ---------------------------------------------------------------------------
# sampling on a warm hit
# ---------------------------------------------------------------------------

class _Draws:
    """The engine's generator with its Gumbel draws recorded."""
    def __init__(self, rng):
        self.rng, self.g = rng, []

    def gumbel(self, size):
        g = self.rng.gumbel(size=size)
        self.g.append(g)
        return g


def test_sampled_warm_hit_matches_reference(weights, rng):
    """``greedy=False, seed=3``, one prompt at temperature 0.7 visited twice:
    the warm visit's first token is drawn from the kept row (no prefill),
    and the port's tokens equal the JAX engine's; the smallest top-two
    margin of z + g is printed."""
    p = _prompt(rng, 40)
    rows = {}

    def drive(eng, mk):
        eng._rng = _Draws(eng._rng)
        seen, real = [], eng._sample

        def sample(req, row):
            seen.append((np.asarray(row, np.float64), req.temperature))
            return real(req, row)

        eng._sample = sample
        reqs = [_run_one(eng, mk, p, rid=i, max_new=4, temperature=0.7) for i in range(2)]
        assert eng.stats.zero_prefill_hits == 1 and eng.stats.prefill_tokens == len(p)
        rows[type(eng).__module__] = (seen, eng._rng.g)
        return reqs

    te, reqs, _ = _both(weights, drive, greedy=False, seed=3)
    seen, draws = rows[TEngine.__module__]
    assert len(draws) == len(seen) == 8
    np.testing.assert_array_equal(seen[4][0], seen[0][0])     # the kept row, bit for bit
    margins = [float(np.diff(np.sort(row / t + g)[-2:])[0]) for (row, t), g in zip(seen, draws)]
    print(f"sampled warm hit: {len(draws)} draws; smallest top-two margin of z + g "
          f"{min(margins):.3e}")


# ---------------------------------------------------------------------------
# visit traces
# ---------------------------------------------------------------------------

PROMPT_POOL_LENS = (24, 33, 40, 47)


def _trace(weights, ops, seed):
    """Interpret (op, arg) pairs on both engines: serve one of four fixed
    prompts, flush, or audit; after every op the pin invariants hold."""
    rng = np.random.default_rng(seed)
    prompts = [_prompt(rng, n) for n in PROMPT_POOL_LENS]

    def drive(eng, mk):
        reqs = []
        for kind, a in ops:
            kind %= 8
            if kind < 6:
                reqs.append(_run_one(eng, mk, prompts[a % len(prompts)], rid=len(reqs)))
            elif kind == 6:
                eng.flush_prefix_cache()
            _audit(eng)
            for b in eng._cached:
                assert eng._refcount[b] == 0 and b not in eng._free_blocks
        return reqs

    _both(weights, drive, num_blocks=10, slots=2)


def test_visit_traces_preserve_invariants_deterministic(weights):
    master = np.random.default_rng(13)
    for _ in range(3):
        ops = [tuple(master.integers(0, 64, 2).tolist()) for _ in range(8)]
        _trace(weights, ops, int(master.integers(2 ** 31)))


if HAVE_HYPOTHESIS:
    @settings(max_examples=20, derandomize=True, deadline=None)
    @given(ops=hst.lists(hst.tuples(hst.integers(0, 63), hst.integers(0, 63)),
                         min_size=1, max_size=6),
           seed=hst.integers(0, 3))
    def test_visit_traces_preserve_invariants_hypothesis(weights, ops, seed):
        """Random serve/flush interleavings on both engines: pins never leak
        or alias the free list, and the pool drains whole."""
        _trace(weights, ops, seed)


# ---------------------------------------------------------------------------
# the block-sharded engine
# ---------------------------------------------------------------------------

# a visit trace that evicts: three 40-token prompts (3 blocks each) on 8
# blocks (4 per rank at two ranks), then the first two again
SHARD_ENGINE = dict(max_seq=MAX_SEQ, slots=2, block_size=BS, num_blocks=8,
                    prefix_sharing=True, prefix_cache=True)
SHARD_VISITS = (0, 1, 2, 0, 1, 0)


def _shard_prompts():
    rng = np.random.default_rng(21)
    return [_prompt(rng, 40) for _ in range(3)]


def _visit_log(eng, prompts, visits, mk=TRequest):
    """Serve ``visits`` one at a time; per visit the request's tokens and
    the cache's pinned radix keys, and every victim the cache took."""
    victims, real = [], eng._cache_victim

    def victim(protect=frozenset()):
        b = real(protect)
        if b is not None:
            victims.append(eng._block_keys[b])
        return b

    eng._cache_victim = victim
    log = []
    for rid, i in enumerate(visits):
        r = _run_one(eng, mk, prompts[i], rid=rid, max_new=3)
        log.append((r.output, sorted(eng._block_keys[b] for b in eng._cached)))
    return log, victims


def test_sharded_engine_world1_equals_unsharded(weights):
    """The cache engine over a one-rank gloo world: the unsharded port's
    tokens, pins (block ids too: one shard), victims and counters."""
    prompts = _shard_prompts()
    runs = []
    for ctx in (None, init_decode_ctx("cpu")):
        eng = TEngine(TCFG, weights[1], paged=True, device="cpu", ctx=ctx, **SHARD_ENGINE)
        log, victims = _visit_log(eng, prompts, SHARD_VISITS)
        runs.append((eng, log, victims, dict(eng._cached)))
    (e0, log0, v0, pins0), (e1, log1, v1, pins1) = runs
    assert log1 == log0 and v1 == v0 and pins1 == pins0
    assert {k: getattr(e1.stats, k) for k in COUNTERS} == \
        {k: getattr(e0.stats, k) for k in COUNTERS}
    assert e0.stats.cache_evictions > 0 and e0.stats.zero_prefill_hits > 0
    for eng in (e0, e1):
        _drain(eng)


def test_sharded_engine_two_gloo_ranks(weights, tmp_path):
    """Two SPMD ranks (tests/_torch_dist_worker.py ``cache``): the
    unsharded port's tokens, pinned keys per visit and victims, equal
    counters, and the two ranks agree on every victim block and page
    table; both drain clean."""
    prompts = _shard_prompts()
    eng = TEngine(TCFG, weights[1], paged=True, device="cpu", **SHARD_ENGINE)
    want, want_victims = _visit_log(eng, prompts, SHARD_VISITS)
    torch.save(dict(weights=weights[1], prompts=prompts, visits=SHARD_VISITS, new_tokens=3,
                    engine=SHARD_ENGINE, cfg=dict(salca_static_channels=True)),
               tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               "cache", str(tmp_path), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    res = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(2)]
    for r in res:
        assert r["log"] == want and r["victims"] == want_victims
        assert {k: r["stats"][k] for k in COUNTERS} == {k: getattr(eng.stats, k) for k in COUNTERS}
        assert r["audit_ok"] and r["drained"]
    assert res[0]["victim_blocks"] == res[1]["victim_blocks"]
    assert {b // 4 for b in res[0]["victim_blocks"]} == {0, 1}, \
        "the victims must lie on both ranks"
    for (m0, l0, pt0), (m1, l1, pt1) in zip(res[0]["ticks"], res[1]["ticks"]):
        assert torch.equal(l0, l1) and torch.equal(pt0, pt1)
    _drain(eng)
