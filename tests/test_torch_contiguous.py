"""Port parity, the contiguous slot-pool slice: the contiguous cache's
primitives, kernels B7, B8 and B9 (plain versions on the CPU), the flat
Salca decode attention on both of its routes, and
`ServingEngine(paged=False)` against the JAX reference.

* Cache leaves after `append_token`, `append_token_masked`,
  `write_prefill_into_slot` and `reset_slot`: bit for bit (the cases of
  tests/test_serve.py).
* B7: the reference op's unpinned f32 chain within rtol 1e-5 / atol 1e-4
  of `score_estimate_pallas(interpret=True)` and `score_estimate_ref` (XLA
  may contract the chain into FMAs; tests/test_kernels.py uses the same
  bound); the tick's bf16-pinned form bit for bit against
  `estimate_relevance`.
* B8 within 1e-5 of `sparse_flash_decode_ref` and the interpreted Pallas
  kernel (f32, other summation order; the bound of tests/test_kernels.py).
* B9 bit for bit against `fused_bin_pool_threshold_pallas(interpret=True)`.
* `salca_decode_attention`: the Selection bit for bit against JAX's
  ``impl=None`` chain and ``impl="ref"``, the output within 1e-5; with
  sink/recent forcing the chain route is taken.
* The engine: greedy tokens identical, logits within the tolerances of
  tests/test_torch_engine.py, equal tick and decode-call counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import CACHE_FIELDS, assert_fields_equal, f32_configs, tn, tt
from repro.core import cache as jc
from repro.core import quantization as jqz
from repro.core.attention import dense_decode_from_cache as j_dense
from repro.core.attention import salca_decode_attention as j_attn
from repro.core.selection import SalcaParams as JParams
from repro.core.selection import estimate_relevance as j_relevance
from repro.flags import perf_flags as j_flags
from repro.kernels.flash_decode.kernel import sparse_flash_decode_pallas
from repro.kernels.flash_decode.ref import sparse_flash_decode_ref
from repro.kernels.score_est.kernel import score_estimate_pallas
from repro.kernels.score_est.ref import score_estimate_ref
from repro.kernels.selection_fused.kernel import fused_bin_pool_threshold_pallas
from repro.models import get_model as jget_model
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.core import cache as tc
from repro_torch.core.attention import dense_decode_from_cache as t_dense
from repro_torch.core.attention import salca_decode_attention as t_attn
from repro_torch.core.selection import SalcaParams as TParams
from repro_torch.core.selection import estimate_relevance as t_relevance
from repro_torch.flags import perf_flags as t_flags
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_decode.ops import sparse_flash_decode
from repro_torch.kernels.score_est.ops import score_estimate
from repro_torch.kernels.selection_fused import ops as sf_ops
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
B7_F32_TOL = dict(rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Contiguous cache primitives
# ---------------------------------------------------------------------------

def _prefill(rng, t, max_seq, kv=2, hd=32):
    k = rng.normal(size=(1, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(1, t, kv, hd)).astype(np.float32)
    jp = JParams(feature_sparsity=0.5, k=8, k_cap=8)
    tp = TParams(feature_sparsity=0.5, k=8, k_cap=8)
    return (jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=max_seq, params=jp),
            tc.prefill_cache(tt(k), tt(v), max_seq=max_seq, params=tp))


def test_write_prefill_into_slot_and_reset_bitwise(rng):
    """The case of tests/test_serve.py: a 10-token prefill into slot 1 of a
    3-slot pool, a second one into slot 2, then slot 1 reset."""
    jpool = jc.empty_cache(batch=3, max_seq=32, kv_heads=2, head_dim=32, r=16)
    tpool = tc.empty_cache(batch=3, max_seq=32, kv_heads=2, head_dim=32, r=16)
    assert_fields_equal(jpool, tpool, CACHE_FIELDS)
    for slot, t in ((1, 10), (2, 32)):
        jsrc, tsrc = _prefill(rng, t, 32)
        jpool = jc.write_prefill_into_slot(jpool, jsrc, slot)
        assert tc.write_prefill_into_slot(tpool, tsrc, slot) is tpool      # in place
        assert_fields_equal(jpool, tpool, CACHE_FIELDS)
    jpool = jc.reset_slot(jpool, 1)
    tc.reset_slot(tpool, 1)
    assert_fields_equal(jpool, tpool, CACHE_FIELDS)
    np.testing.assert_array_equal(tn(tpool.valid_mask()), np.asarray(jpool.valid_mask()))
    _, small = _prefill(rng, 8, 16)
    with pytest.raises(ValueError):
        tc.write_prefill_into_slot(tpool, small, 0)           # max_seq mismatch
    assert tc.cache_bytes(tpool) == jc.cache_bytes(jpool)


@pytest.mark.parametrize("length", [0, 1, 30, 31, 32])
def test_append_token_masked_bitwise(rng, length):
    """The case of tests/test_serve.py: cursors near 0 and max_seq, three
    appends under alternating active masks; every leaf after every append
    equals the reference's, inactive rows and full rows included."""
    max_seq = 32
    jcache = jc.empty_cache(batch=4, max_seq=max_seq, kv_heads=2, head_dim=16, r=16)
    tcache = tc.empty_cache(batch=4, max_seq=max_seq, kv_heads=2, head_dim=16, r=16)
    hv = np.stack([np.sort(rng.permutation(16)) for _ in range(8)]).reshape(4, 2, 16)
    jcache = jcache._replace(length=jnp.full((4,), length, jnp.int32),
                             heavy_idx=jnp.asarray(hv, jnp.int32))
    tcache.length.fill_(length)
    tcache.heavy_idx.copy_(tt(hv.astype(np.int32)))
    active = np.asarray([True, False, True, False])
    for _ in range(3):
        k = rng.normal(size=(4, 2, 16)).astype(np.float32)
        v = rng.normal(size=(4, 2, 16)).astype(np.float32)
        jcache = jc.append_token_masked(jcache, jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(active))
        tc.append_token_masked(tcache, tt(k), tt(v), tt(active))
        assert_fields_equal(jcache, tcache, CACHE_FIELDS)
        active = ~active


def test_append_token_at_capacity_drops_bitwise(rng):
    """Unmasked appends: a full row (cursor at max_seq) drops its write and
    keeps its length, the others land at their cursor."""
    jcache, tcache = _prefill(rng, 30, 32)
    hv = np.asarray(jcache.heavy_idx)
    for _ in range(3):                       # 30 → 31 → 32 → 32 (dropped)
        k = rng.normal(size=(1, 2, 32)).astype(np.float32)
        v = rng.normal(size=(1, 2, 32)).astype(np.float32)
        jcache = jc.append_token(jcache, jnp.asarray(k), jnp.asarray(v))
        tc.append_token(tcache, tt(k), tt(v))
        assert_fields_equal(jcache, tcache, CACHE_FIELDS)
    assert int(tcache.length[0]) == 32
    np.testing.assert_array_equal(tn(tcache.heavy_idx), hv)


# ---------------------------------------------------------------------------
# Kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,g,r,n", [
    (1, 1, 16, 256), (2, 4, 64, 512), (3, 2, 32, 1024), (2, 8, 128, 2048)])
def test_b7_plain_vs_ref_and_pallas(rng, bh, g, r, n):
    """The reference op's form (unpinned f32 chain), at the shapes of
    tests/test_kernels.py."""
    k2 = jqz.quantize_key_features(jnp.asarray(rng.normal(size=(bh, n, r)), jnp.float32))
    words = jqz.pack2bit(k2.codes)
    q3 = jqz.quantize_query_features(jnp.asarray(rng.normal(size=(bh, g, r)), jnp.float32))
    args = (q3.codes, q3.scale, words, k2.scale, k2.zero)
    ref = score_estimate_ref(*args)
    pal = score_estimate_pallas(*args, interpret=True)
    before = dict(LAUNCHES)
    out = score_estimate(*(tt(a) for a in args))
    assert dict(LAUNCHES) == before          # CPU tensors never count a launch
    np.testing.assert_allclose(tn(out), np.asarray(ref), **B7_F32_TOL)
    np.testing.assert_allclose(tn(out), np.asarray(pal), **B7_F32_TOL)


@pytest.mark.parametrize("b,h,kv,r,n,group_sum", [
    (2, 8, 4, 32, 256, True), (3, 4, 2, 64, 384, True), (2, 8, 4, 32, 256, False)])
def test_b7_bf16_form_bitwise_vs_estimate_relevance(rng, b, h, kv, r, n, group_sum):
    """The tick's form (flag on): the flat `estimate_relevance` under the
    default bf16_collectives=True, bit for bit, read straight off the
    cache's (B, N, KV, ·) layout."""
    q_feat = rng.normal(size=(b, h, r)).astype(np.float32)
    kf = jqz.quantize_key_features(jnp.asarray(rng.normal(size=(b, n, kv, r)), jnp.float32))
    words = jqz.pack2bit(kf.codes)
    with j_flags(group_sum_query=group_sum), t_flags(group_sum_query=group_sum):
        want = j_relevance(jnp.asarray(q_feat), words, kf.scale, kf.zero, h // kv)
        got = t_relevance(tt(q_feat), tt(words), tt(kf.scale), tt(kf.zero), h // kv)
    np.testing.assert_array_equal(tn(got), np.asarray(want))


@pytest.mark.parametrize("bh,g,c,hd,density", [
    (1, 1, 256, 64, 1.0), (2, 4, 512, 128, 0.7), (3, 2, 1024, 128, 0.3),
    (2, 8, 256, 256, 0.9)])
def test_b8_plain_vs_ref_and_pallas(rng, bh, g, c, hd, density):
    """At the shapes of tests/test_kernels.py; row 0 of the last case has
    nothing selected and must come out as zeros."""
    kc = rng.integers(-127, 128, size=(bh, c, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, size=(bh, c, hd)).astype(np.int8)
    ks = (rng.random((bh, c)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((bh, c)) * 0.02 + 1e-3).astype(np.float32)
    mask = rng.random((bh, c)) < density
    mask[:, 0] = True
    if g == 8:
        mask[0] = False
    q = rng.normal(size=(bh, g, hd)).astype(np.float32)
    args = (q, kc, ks, vc, vs, mask)
    ref = sparse_flash_decode_ref(*(jnp.asarray(a) for a in args))
    pal = sparse_flash_decode_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    out = tn(sparse_flash_decode(*(tt(a) for a in args)))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(out, np.asarray(pal), **TOL)
    if g == 8:
        assert (out[0] == 0).all()


@pytest.mark.parametrize("bh,n,window,block,lengths", [
    pytest.param(2, 1024, 7, 512, None, id="2-1024-7-512"),
    pytest.param(1, 4096, 1, 4096, None, id="1-4096-1-4096"),
    pytest.param(3, 2048, 11, 1024, None, id="3-2048-11-1024"),
    pytest.param(2, 512, 3, 128, None, id="2-512-3-128"),
    pytest.param(3, 1024, 7, 256, (0, 1, 1024), id="lengths-0-1-N"),
    pytest.param(4, 512, 7, 512, (1, 0, 3, 512), id="lengths-0-1-3-N-window7")])
def test_b9_plain_bitwise_vs_pallas(rng, bh, n, window, block, lengths):
    """Pooled bins, histogram and threshold, at the shapes of
    tests/test_kernels.py (ragged lengths, halos across the Pallas blocks)
    and at rows of length 0, 1 and N; and the count the CUDA kernel writes
    for bin 0 without reading a score: every valid bin is >= 1 and pools to
    >= 1, so hist[:, 0] == N - min(len, N)."""
    scores = (rng.normal(size=(bh, n)) * 4).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(n // 2, n + 1, size=(bh,)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    pos = np.arange(n)[None, :]
    lo = np.where(pos < lengths[:, None], scores, np.inf).min(-1).astype(np.float32)
    hi = np.where(pos < lengths[:, None], scores, -np.inf).max(-1).astype(np.float32)
    k = np.full((bh,), max(8, n // 16), np.int32)
    args = (scores, lo, hi, k, lengths)
    want = fused_bin_pool_threshold_pallas(*(jnp.asarray(a) for a in args), window=window,
                                           block_n=block, interpret=True)
    got = sf_ops.fused_bin_pool_threshold(*(tt(a) for a in args), window=window)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(tn(g_), np.asarray(w_))
    np.testing.assert_array_equal(tn(got[1])[:, 0], n - np.minimum(lengths, n))


# ---------------------------------------------------------------------------
# Flat Salca decode attention
# ---------------------------------------------------------------------------

def _attn_case(rng, params_kw, b=2, t=256, kv=4, g=2, hd=64):
    k = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    k[:, rng.choice(t, 12, replace=False)] *= 3.0        # a few salient keys
    q = rng.normal(size=(b, kv * g, hd)).astype(np.float32)
    jp, tp = JParams(**params_kw), TParams(**params_kw)
    jcache = jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=t, params=jp)
    tcache = tc.prefill_cache(tt(k), tt(v), max_seq=t, params=tp)
    lengths = np.asarray([100, t], np.int32)             # a ragged row
    jcache = jcache._replace(length=jnp.asarray(lengths))
    tcache.length.copy_(tt(lengths))
    return q, jp, tp, jcache, tcache


def _assert_same_selection(jsel, tsel):
    for f in ("threshold", "indices", "mask", "count"):
        np.testing.assert_array_equal(tn(getattr(tsel, f)), np.asarray(getattr(jsel, f)),
                                      err_msg=f)


@pytest.mark.parametrize("params_kw", [
    dict(k=48, k_cap=96, pool_window=7), dict(k=48, k_cap=64, use_pool=False),
    dict(k=300, k_cap=256, pool_window=5)])
def test_salca_decode_attention_fused_route(rng, monkeypatch, params_kw):
    """No forcing: the fused route (B7 → B9 → compact → gather → B8) gives
    the Selection of the reference's chain (impl=None) and of its fused
    route (impl="ref") bit for bit, and the output within 1e-5."""
    calls = []
    real = sf_ops.fused_bin_pool_threshold
    monkeypatch.setattr(sf_ops, "fused_bin_pool_threshold",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, jp, tp, jcache, tcache = _attn_case(rng, params_kw)
    tout, tsel = t_attn(tt(q), tcache, tp, return_selection=True)
    assert calls == [1]
    for impl in (None, "ref"):
        jout, jsel = j_attn(jnp.asarray(q), jcache, jp, return_selection=True, impl=impl)
        _assert_same_selection(jsel, tsel)
        np.testing.assert_allclose(tn(tout), np.asarray(jout), **TOL)
    assert (tn(tsel.indices[0])[tn(tsel.mask[0])] < 100).all()


def test_salca_decode_attention_forcing_takes_chain(rng, monkeypatch):
    """Sink/recent forcing: phases 2-3 run the chain (B9 is not called), as
    in the reference; same Selection, output within 1e-5."""
    monkeypatch.setattr(sf_ops, "fused_bin_pool_threshold",
                        lambda *a, **kw: pytest.fail("B9 on a forcing config"))
    q, jp, tp, jcache, tcache = _attn_case(
        rng, dict(k=48, k_cap=96, pool_window=7, sink_tokens=4, recent_tokens=16))
    tout, tsel = t_attn(tt(q), tcache, tp, return_selection=True)
    jout, jsel = j_attn(jnp.asarray(q), jcache, jp, return_selection=True)
    _assert_same_selection(jsel, tsel)
    np.testing.assert_allclose(tn(tout), np.asarray(jout), **TOL)
    assert tn(tsel.mask).sum(-1).min() >= 4 + 16


def test_dense_decode_from_cache(rng):
    """The dense oracle over the dequantized cache, ragged lengths and an
    empty row (exact zeros), within 1e-5."""
    q, jp, tp, jcache, tcache = _attn_case(rng, dict(k=48, k_cap=96))
    lengths = np.asarray([0, 170], np.int32)
    jcache = jcache._replace(length=jnp.asarray(lengths))
    tcache.length.copy_(tt(lengths))
    out = tn(t_dense(tt(q), tcache))
    np.testing.assert_allclose(out, np.asarray(j_dense(jnp.asarray(q), jcache)), **TOL)
    assert (out[0] == 0).all()


# ---------------------------------------------------------------------------
# The contiguous engine
# ---------------------------------------------------------------------------

JCFG, TCFG = f32_configs()


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


def _run(engine_cls, req_cls, cfg, params, prompts, max_seq, **kw):
    eng = engine_cls(cfg, params, max_seq=max_seq, slots=2, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = []            # per tick: (active mask, logits rows)
    orig = eng._decode

    def recording(*args):
        out = orig(*args)
        logits = out[1].float().numpy() if hasattr(out[1], "float") else np.asarray(out[1])
        ticks.append((np.asarray(args[-1]).copy(), np.asarray(logits, np.float32)))
        return out

    eng._decode = recording
    return eng, reqs, eng.run(), ticks


@pytest.mark.parametrize("max_seq,lens,atol", [
    # the dense trace of tests/test_torch_engine.py (k ≥ n: every stored token)
    (64, (12, 30, 20), 1e-5),
    # its sparse trace (k = 128 of 256 positions); 1e-4 as there: over ~500
    # stored tokens a last-ulp difference can move one int8 code by a step
    (256, (150, 200, 170), 1e-4),
])
def test_engine_parity_with_reference(weights, rng, max_seq, lens, atol):
    """3 requests, 2 slots (slot reuse after the first completion), 5 new
    tokens each, through both contiguous engines."""
    jp, tp = weights
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in lens]
    je, jr, js, jticks = _run(JEngine, JRequest, JCFG, jp, prompts, max_seq)
    te, tr, ts, tticks = _run(TEngine, TRequest, TCFG, tp, prompts, max_seq, device="cpu")
    assert not je.paged and not te.paged
    for a, b in zip(jr, tr):
        assert a.output == b.output, (a.rid, a.output, b.output)
        assert a.stop_reason == b.stop_reason == "length"
    assert len(jticks) == len(tticks) == ts.ticks == js.ticks
    assert ts.decode_calls == js.decode_calls == ts.ticks
    for (jm, jl), (tm, tl) in zip(jticks, tticks):
        np.testing.assert_array_equal(jm, tm)
        np.testing.assert_allclose(tl[tm], jl[jm], rtol=1e-5, atol=atol)
    assert ts.completed == 3 and ts.tokens_generated == js.tokens_generated == 15
    assert "block_pool_size" not in ts.summary()
    jpool = je._state.period_states[0]
    for layer, tcache in enumerate(te._state.caches):
        assert isinstance(tcache, tc.SalcaCache)
        for f in ("heavy_idx", "length"):
            np.testing.assert_array_equal(tn(getattr(tcache, f)),
                                          np.asarray(getattr(jpool, f)[layer]), err_msg=f)
    np.testing.assert_array_equal(tn(te._state.pos), np.asarray(je._state.pos))


def test_engine_validation_and_overflow(weights, rng):
    """The knobs the reference rejects without paged=True raise its
    ValueErrors; a slot that reaches max_seq finishes with an overflow
    stop, as in the reference."""
    jp, tp = weights
    for kw in ({"prefix_sharing": True}, {"host_spill": True}, {"preempt": True},
               {"prefill_chunk": 8}, {"kv_pool_dtype": "int4"}):
        with pytest.raises(ValueError):
            JEngine(JCFG, jp, max_seq=64, slots=2, **kw)
        with pytest.raises(ValueError):
            TEngine(TCFG, tp, max_seq=64, slots=2, device="cpu", **kw)
    eng = TEngine(TCFG, tp, max_seq=64, slots=2, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(TRequest(rid=0, prompt=np.zeros(60, np.int32), max_new_tokens=5))
    req = TRequest(rid=1, prompt=rng.integers(0, 512, 60).astype(np.int32), max_new_tokens=4)
    eng.submit(req)
    req.max_new_tokens = 9           # past the submit check: the slot fills up
    stats = eng.run()
    assert req.stop_reason == "overflow" and stats.overflows == stats.dropped_writes == 1
    assert len(req.prompt) + len(req.output) - 1 == 64
