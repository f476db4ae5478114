"""Port parity, the slice as a whole: the dense LM's prefill and paged decode
step, and `ServingEngine(paged=True)` against the JAX engine on one trace.

Both sides run qwen3-0.6b.reduced() at float32 compute from the SAME
weights (the JAX init tree converted by `repro_torch.weights`). Matmuls,
RoPE's cos/sin and reductions run in different orders on the two sides,
so logits agree to a float tolerance — stated below — while heavy-channel
sets, greedy tokens and the paged pool's bookkeeping must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import f32_configs, tn, tt
from repro.models import get_model as jget_model
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.models import get_model as tget_model
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

JCFG, TCFG = f32_configs()
MAX_SEQ, BS = 64, 16
# Logits tolerance: f32 summation-order differences through 2 layers (the
# measured gap on this trace is under 1e-6 at logits of magnitude ~0.8),
# the same 1e-5 bound as one layer's paged attention.
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


def test_prefill_parity(weights, rng):
    jp, tp = weights
    prompt = rng.integers(0, JCFG.vocab_size, (1, 24)).astype(np.int32)
    jl, js = jget_model(JCFG).prefill(jp, {"tokens": jnp.asarray(prompt)}, MAX_SEQ)
    tl, ts = tget_model(TCFG).prefill(tp, tt(prompt), MAX_SEQ)
    np.testing.assert_allclose(tn(tl), np.asarray(jl), **LOGIT_TOL)
    jcache = js.period_states[0]
    for layer, tcache in enumerate(ts.caches):
        np.testing.assert_array_equal(tn(tcache.heavy_idx), np.asarray(jcache.heavy_idx[layer]))
        # K/V codes: equal up to rare one-step rounding flips
        kj, kt = np.asarray(jcache.k_codes[layer]).astype(int), tn(tcache.k_codes).astype(int)
        assert np.abs(kj - kt).max() <= 1 and (kj != kt).mean() < 0.01
    assert int(ts.pos[0]) == 24


def _run(engine_cls, req_cls, cfg, params, prompts, max_seq=MAX_SEQ, bs=BS, **kw):
    eng = engine_cls(cfg, params, max_seq=max_seq, slots=2, paged=True, block_size=bs,
                     num_blocks=2 * max_seq // bs, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = []            # per tick: (active mask, logits rows)
    orig = eng._decode

    def recording(*args):
        out = orig(*args)
        mask = np.asarray(args[-1]).copy()
        ticks.append((mask, np.asarray(out[1].float() if torch.is_tensor(out[1])
                                       else out[1], np.float32)))
        return out

    eng._decode = recording
    stats = eng.run()
    return eng, reqs, stats, ticks


@pytest.mark.parametrize("max_seq,bs,lens,atol", [
    # the shapes of tests/test_serve.py (k ≥ n: every stored token selected)
    (MAX_SEQ, BS, (12, 30, 20), LOGIT_TOL["atol"]),
    # k = 128 of 256 positions: sparse selection. Over ~500 stored tokens a
    # last-ulp difference in V can move one int8 code by one step (1/127 of
    # its row's range); measured: one code of 32768, logits gap 3.3e-5.
    (256, 32, (150, 200, 170), 1e-4),
])
def test_engine_parity_with_reference(weights, rng, max_seq, bs, lens, atol):
    """3 requests, 2 slots, mixed prompt lengths, 5 new tokens each, over a
    pool of 2·max_seq tokens (block reuse after the first completion)."""
    jp, tp = weights
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in lens]
    je, jr, js, jticks = _run(JEngine, JRequest, JCFG, jp, prompts, max_seq, bs)
    te, tr, ts, tticks = _run(TEngine, TRequest, TCFG, tp, prompts, max_seq, bs,
                              device="cpu")
    # heavy-channel sets of the last occupant of each slot, layer by layer
    jpool = je._state.period_states[0]
    for layer, tpool in enumerate(te._state.caches):
        np.testing.assert_array_equal(tn(tpool.heavy_idx), np.asarray(jpool.heavy_idx[layer]))
    for a, b in zip(jr, tr):
        assert a.output == b.output, (a.rid, a.output, b.output)
        assert a.stop_reason == b.stop_reason == "length"
    assert len(jticks) == len(tticks) == ts.ticks
    for (jm, jl), (tm, tl) in zip(jticks, tticks):
        np.testing.assert_array_equal(jm, tm)
        np.testing.assert_allclose(tl[tm], jl[jm], rtol=LOGIT_TOL["rtol"], atol=atol)
    assert ts.decode_calls == ts.ticks == js.ticks
    assert ts.completed == 3 and ts.tokens_generated == js.tokens_generated == 15
    # drained: every block back on the free list, every pool row unmapped
    assert sorted(te._free_blocks) == list(range(2 * max_seq // bs))
    for layer, tpool in enumerate(te._state.caches):
        assert tpool.check_invariants(free_blocks=te._free_blocks,
                                      host_refcount=te._refcount).ok
        for f in ("page_table", "refcount", "length"):
            np.testing.assert_array_equal(tn(getattr(tpool, f)),
                                          np.asarray(getattr(jpool, f)[layer]))


def test_engine_overflow_and_validation(weights, rng):
    """Block exhaustion finishes a request with an `overflow` stop (no silent
    clip); the knobs of later slices raise instead of being ignored."""
    _, tp = weights
    eng = TEngine(TCFG, tp, max_seq=MAX_SEQ, slots=2, paged=True, block_size=BS, num_blocks=3,
                  device="cpu")
    ra = TRequest(rid=0, prompt=rng.integers(0, 512, 30).astype(np.int32), max_new_tokens=18)
    rb = TRequest(rid=1, prompt=rng.integers(0, 512, 14).astype(np.int32), max_new_tokens=18)
    eng.submit(ra)
    eng.submit(rb)
    stats = eng.run()
    assert stats.completed == 2 and stats.overflows >= 1
    assert stats.dropped_writes == stats.overflows
    assert "overflow" in (ra.stop_reason, rb.stop_reason)
    assert sorted(eng._free_blocks) == [0, 1, 2]
    for kw in ({"prefix_sharing": True}, {"preempt": True}, {"prefill_chunk": 8},
               {"prefix_cache": True, "prefix_sharing": True}, {"faults": object()}):
        with pytest.raises(NotImplementedError):
            TEngine(TCFG, tp, max_seq=MAX_SEQ, slots=2, paged=True, block_size=BS,
                    device="cpu", **kw)
    with pytest.raises(ValueError):
        TEngine(TCFG, tp, max_seq=MAX_SEQ, slots=2, paged=True, block_size=24, device="cpu")
