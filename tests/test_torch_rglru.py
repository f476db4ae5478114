"""Port parity, the hybrid family (recurrentgemma-2b: RG-LRU layers "R" and
local-attention layers "L", pattern "RRL") against the JAX package on the
CPU, at float32 compute.

* `models.rglru.associative_scan` bit for bit against the reference's
  eager ``jax.lax.associative_scan`` at lengths 1 to 255 (the same pairing of
  terms; under jit XLA contracts a2·b1 + b2 into an FMA and moves the last
  ulps, up to 4.8e-7 here).
* `rglru_train(return_state=True)` on one layer of recurrentgemma.reduced()
  at prompts of 1, 2, 32, 33 and 100 tokens: the output, ``h`` and the conv
  window (unpadded: one row for a 1-token prompt, two for 2) within `TOL`,
  each state leaf a tensor of its own (not a view of the prompt's buffers).
* `rglru_decode` through `blocks.block_decode` (the "R" block, its FFN
  included) over 5 steps with slot 1 inactive: active slots within `TOL`,
  the inactive slot's state bit for bit unchanged.
* The reference's short-prompt conv state: a 1-token prompt's one row is
  broadcast into all W-1 rows of the slot's window; a 2-token prompt raises
  the reference's ValueError at the slot write, message for message.
* `weights.params_from_numpy` keeps ``w_r``, ``w_i`` and ``lam`` in float32
  in a bf16 tree; `init_lm_params` makes the reference's tree.
* Engines on recurrentgemma.reduced() (rings of 64 that the prompts wrap)
  against the JAX engine, each reference engine run once per module:
  contiguous, paged, ``preempt=True`` on a pool that runs dry, a cancel, and
  max_seq 64 (the window spans the context: the "L" layers are a paged pool
  with dense decode, not rings): tokens identical, tick logits under
  `_torch_bridge.assert_code_ticks_close`.
* A tick at one in-process rank (the rings sequence-sharded) equal to the
  unsharded tick; the tick updates its state in place and makes no tensor
  of host data (tests/test_torch_steps.py's checks).

Run alone: ~50 s on this container's CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_code_ticks_close, record_code_ticks, tn, tt
from repro.configs import get_config as jget_config
from repro.models import blocks as jB
from repro.models import get_model as jget_model
from repro.models import rglru as jrglru
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.models import blocks as tB
from repro_torch.models import rglru as trglru
from repro_torch.models.transformer import decode_salca_params
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import init_lm_params, params_from_numpy
from test_torch_steps import HostData, _engine, _rebound_after_ticks

ARCH = "recurrentgemma-2b"
# f32 on both sides; XLA's fused gates and products round apart from
# torch's (the scan itself is bit for bit): measured here up to 3.9e-7
# (prefill outputs and states) and 7.2e-7 (decode steps); the engines'
# tick logits, under `assert_code_ticks_close` (their rings can hold a code
# a step apart), up to 5.6e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(dtype="float32"):
    return tuple(dataclasses.replace(get(ARCH).reduced(), dtype=dtype)
                 for get in (jget_config, tget_config))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def _jtrain(jcfg):
    return jax.jit(lambda p, u: jrglru.rglru_train(p, u, jcfg, return_state=True))


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 255])
def test_associative_scan_bitwise_against_lax(n):
    """a in [0.9, 1), as the RG-LRU's decays: the running products stay
    normal (XLA on the CPU flushes subnormal products to zero, torch keeps
    them)."""
    rng = np.random.default_rng(n)
    a = (0.9 + 0.1 * rng.random((2, n, 16))).astype(np.float32)
    b = rng.standard_normal((2, n, 16)).astype(np.float32)
    ja, jh = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, th = trglru.associative_scan(tt(a), tt(b))
    np.testing.assert_array_equal(tn(th), np.asarray(jh))
    np.testing.assert_array_equal(tn(ta), np.asarray(ja))


@pytest.mark.parametrize("t", [1, 2, 32, 33, 100])
def test_rglru_train_with_state_matches_reference(weights, t):
    jcfg, tcfg, jp, tp = weights
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["periods"][0]["rglru"])
    tl = tp["layers"][0]["rglru"]
    u = np.random.default_rng(t).standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    jo, js = _jtrain(jcfg)(jl, jnp.asarray(u))
    to, ts = trglru.rglru_train(tl, tt(u), tcfg, return_state=True)
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tn(ts.h), np.asarray(js.h), **TOL)
    assert ts.conv.shape == np.asarray(js.conv).shape == (2, min(t, 3), 128)
    np.testing.assert_allclose(tn(ts.conv), np.asarray(js.conv), **TOL)
    assert ts.h.dtype == torch.float32
    # each leaf owns its storage: a view would keep the prompt's buffers alive
    assert all(leaf._base is None for leaf in ts)


def test_rglru_decode_steps_with_an_inactive_slot(weights):
    """Five decode steps of an "R" block (RG-LRU, then the FFN) from a
    33-token prefill of three slots, slot 1 inactive."""
    jcfg, tcfg, jp, tp = weights
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["periods"][1])
    tblock = tp["layers"][1]
    rng = np.random.default_rng(5)
    u = rng.standard_normal((3, 33, jcfg.d_model)).astype(np.float32)
    _, jst = _jtrain(jcfg)(jblock["rglru"], jnp.asarray(u))
    tst = trglru.RGLRUState(tt(np.asarray(jst.h)), tt(np.asarray(jst.conv)))
    active = np.array([True, False, True])
    pos = np.full(3, 33, np.int32)
    jstep = jax.jit(lambda p, x, st, pos, act: jB.block_decode(p, "R", x, st, jcfg, pos,
                                                               jB.DecodeCtx(), None, act))
    for _ in range(5):
        x = rng.standard_normal((3, jcfg.d_model)).astype(np.float32)
        jx, jst = jstep(jblock, jnp.asarray(x), jst, jnp.asarray(pos), jnp.asarray(active))
        before = [t.clone() for t in tst]
        tx = tB.block_decode(tblock, tt(x), tst, tcfg, tt(pos), None, tt(active), None, "R")
        np.testing.assert_allclose(tn(tx)[active], np.asarray(jx)[active], **TOL)
        for got, want, old in zip(tst, jst, before):
            np.testing.assert_allclose(tn(got)[active], np.asarray(want)[active], **TOL)
            assert torch.equal(got[1], old[1])
            np.testing.assert_array_equal(tn(got)[1], np.asarray(want)[1])


def test_short_prompts_as_the_reference(weights):
    """The reference keeps ``x_raw[:, -(W-1):]`` unpadded: a 1-token prompt
    serves (its one conv row broadcast into the window's three rows, in the
    port as in the reference) and a 2-token prompt raises at the slot write."""
    jcfg, tcfg, jp, tp = weights
    outs = []
    for engine_cls, req_cls, cfg, params, extra in (
            (JEngine, JRequest, jcfg, jp, {}), (TEngine, TRequest, tcfg, tp, {"device": "cpu"})):
        eng = engine_cls(cfg, params, max_seq=128, slots=2, **extra)
        req = req_cls(rid=0, prompt=np.array([5], np.int32), max_new_tokens=3)
        eng.submit(req)
        eng._admit()
        conv = eng._state.caches[0].conv if extra else eng._state.period_states[0].conv[0]
        conv = np.asarray(conv)[0]
        assert (conv == conv[:1]).all() and conv.any()
        eng.run()
        outs.append((req.output, req.stop_reason))
        eng = engine_cls(cfg, params, max_seq=128, slots=2, **extra)
        eng.submit(req_cls(rid=1, prompt=np.array([5, 7], np.int32), max_new_tokens=3))
        with pytest.raises(ValueError) as err:
            eng.run()
        outs.append(str(err.value))
    assert outs[:2] == outs[2:] and outs[0][1] == "length"
    assert outs[1] == ("Incompatible shapes for broadcasting: (2, 128) and requested shape "
                       "(3, 128)")


def test_params_from_numpy_keeps_rglru_leaves_f32():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jget_model(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    init = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for tree in (tp, init):
        rg = tree["layers"][0]["rglru"]
        assert {k for k, v in rg.items() if v.dtype == torch.float32} == {"w_r", "w_i", "lam"}
        assert tree["layers"][0]["ffn"]["glu"]["w_up"].dtype == torch.bfloat16
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), init)
    assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), tp)
    np.testing.assert_allclose(tn(init["layers"][0]["rglru"]["lam"]),
                               np.asarray(jp["periods"][0]["rglru"]["lam"][0]), rtol=1e-6)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

RUNS = {"contiguous": dict(paged=False),
        "paged": dict(paged=True, block_size=32),
        # request 1's growth at 48 finds the 6 blocks of 16 dry: preempted, replayed
        "preempt": dict(paged=True, block_size=16, num_blocks=6, preempt=True),
        "cancel": dict(paged=True, block_size=32),
        # the window (64) spans max_seq: "L" layers are paged, dense decode
        "max_seq_64": dict(paged=True, block_size=16, max_seq=64)}


# the JAX engines' jitted steps, shared between engines of one max_seq (the
# prefill closes over it, the tick over the model API alone) and, for the
# slot writes, one pool kind; jit keys its compilations on the arguments'
# shapes and structure
_JAX_STEPS: dict = {}


def _share_steps(eng) -> None:
    for name in ("_decode", "_prefill", "_reset", "_write", "_map_block", "_cow_block"):
        if hasattr(eng, name):
            key = (name, eng.max_seq) + ((eng.paged,) if name == "_write" else ())
            setattr(eng, name, _JAX_STEPS.setdefault(key, getattr(eng, name)))


def _serve(engine_cls, req_cls, cfg, params, run, **extra):
    rng = np.random.default_rng(7)
    lengths = {"preempt": (40, 45, 30), "max_seq_64": (20, 30, 25)}.get(run, (70, 100, 50))
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    kw = dict(dict(max_seq=128, slots=2), **RUNS[run])
    eng = engine_cls(cfg, params, **kw, **extra)
    if engine_cls is JEngine:
        _share_steps(eng)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=8 if run == "preempt" else 5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = record_code_ticks(eng, cfg)
    if run == "cancel":
        eng._admit()
        eng._tick()
        eng._tick()
        assert eng.cancel(reqs[0].rid)
    eng.run()
    return eng, reqs, ticks


@pytest.fixture(scope="module")
def reference_runs(weights):
    jcfg, _, jp, _ = weights
    return {run: _serve(JEngine, JRequest, jcfg, jp, run) for run in RUNS}


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_matches_reference(weights, reference_runs, run):
    _, tcfg, _, tp = weights
    je, jr, jticks = reference_runs[run]
    te, tr, tticks = _serve(TEngine, TRequest, tcfg, tp, run, device="cpu")
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.stop_reason for r in tr] == [r.stop_reason for r in jr]
    assert te.stats.ticks == je.stats.ticks
    assert_code_ticks_close(jticks, tticks)
    kinds = [type(c).__name__ for c in te._state.caches]
    attn = "PagedSalcaCache" if run == "max_seq_64" else "SalcaCache"
    assert kinds == ["RGLRUState", "RGLRUState", attn] * 2
    if run == "preempt":
        assert te.stats.preemptions == je.stats.preemptions > 0
    if run == "cancel":
        assert tr[0].stop_reason == "cancelled"
    if te.paged:
        assert te._alloc.total_free == te.num_blocks
        assert te.check_invariants().ok == je.check_invariants().ok == (run == "max_seq_64")


def test_salca_params_from_the_first_attention_layer(weights):
    """The tick's SalcaParams come from layer 2's ring (64 rows → k 128),
    the reference's first attention cache; with no attention layer, from 128."""
    _, tcfg, _, tp = weights
    eng = TEngine(tcfg, tp, max_seq=1024, slots=2, paged=True, device="cpu")
    sp = decode_salca_params(tcfg, eng._state)
    assert (sp.k, sp.k_cap) == (128, 128) == (tB.salca_params_for(tcfg, 128).k,
                                               tB.salca_params_for(tcfg, 128).k_cap)


def test_tick_at_one_rank_equals_unsharded(weights):
    """Paged, rings sequence-sharded over one in-process rank: tokens equal,
    tick logits within 1e-5 of the unsharded engine's."""
    _, tcfg, _, tp = weights
    runs = []
    for ctx in (None, init_decode_ctx("cpu")):
        eng = TEngine(tcfg, tp, max_seq=128, slots=2, paged=True, device="cpu", ctx=ctx)
        rng = np.random.default_rng(3)
        reqs = [TRequest(rid=i, prompt=rng.integers(0, tcfg.vocab_size, n).astype(np.int32),
                         max_new_tokens=4) for i, n in enumerate((80, 66))]
        for r in reqs:
            eng.submit(r)
        ticks = record_code_ticks(eng, tcfg)
        eng.run()
        runs.append(([r.output for r in reqs], ticks))
    (uo, ut), (so, st) = runs
    assert uo == so and len(ut) == len(st) > 0
    for (um, ul, _), (sm, sl, _) in zip(ut, st):
        np.testing.assert_array_equal(um, sm)
        np.testing.assert_allclose(sl[sm], ul[um], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_tick_in_place_and_without_host_data(paged):
    cfg = _cfgs()[1]
    pool = "int8" if paged else "contiguous"
    assert _rebound_after_ticks(_engine(cfg, pool)) == []
    eng = _engine(cfg, pool)
    with HostData() as mode:
        eng._decode(eng._tokens.copy(), eng._mask.copy())
    assert mode.bad == []
