"""Port parity, the SSM family (mamba2-2.7b: SSD layers, pattern "S") against
the JAX package on the CPU, at float32 compute.

* `models.ssm.ssd_train(return_state=True)` on one layer of
  mamba2.reduced() (chunk 32) at prompts of 1, 2, 32 (one chunk), 33 and 100
  tokens (padded to a chunk multiple with dt zeroed on the pad): the
  output, the state ``h`` and the conv window within `TOL` (each a tensor
  of its own, not a view keeping the prompt's buffers alive); with integer
  inputs and projections, whose products are exact on both sides, the conv
  window (the raw inputs of the last W-1 real tokens, zero-padded on the
  left) bit for bit.
* `models.ssm.ssd_decode` through `blocks.block_decode` over 5 steps from a
  prefill state, with slot 1 inactive: the active slots' outputs and
  states within `TOL` of the reference's ``ssd_decode`` +
  ``merge_masked_state``, the inactive slot's state bit for bit unchanged.
* `weights.params_from_numpy` keeps ``A_log``, ``D`` and ``dt_bias`` in
  float32 in a bf16 tree; `init_lm_params` makes the reference's tree.
* Engines on mamba2.reduced() against the JAX engine, each reference engine
  run once per module: contiguous, paged, ``preempt=True`` on a pool that
  runs dry (the replay rebuilds the recurrent state), and a cancel of a
  resident request whose slot the queue then takes: tokens identical, tick
  logits within `_torch_bridge.SAME_CODES_TOL` (no attention layer, so no
  stored codes), the tick's state updated in place, and no tensor made of
  host data in the tick (tests/test_torch_steps.py's checks).

Run alone: ~30 s on this container's CPU.
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
from repro.models import ssm as jssm
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.models import blocks as tB
from repro_torch.models import get_model as tget_model
from repro_torch.models import ssm as tssm
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import init_lm_params, params_from_numpy
from test_torch_steps import HostData, _engine, _rebound_after_ticks

ARCH = "mamba2-2.7b"
# f32 on both sides: XLA's fused einsums and torch's matmuls sum in other
# orders; measured here up to 8.3e-7 (prefill outputs and states), 1.4e-6
# (decode steps) and 2.2e-6 (engine tick logits)
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
    """The reference's ``ssd_train(return_state=True)``, jitted (its eager
    dispatch takes seconds a call)."""
    return jax.jit(lambda p, u: jssm.ssd_train(p, u, jcfg, return_state=True))


def _layer(jp, tp):
    """Layer 0's SSD parameters on both sides."""
    return jax.tree_util.tree_map(lambda a: a[0], jp["periods"][0]["ssd"]), tp["layers"][0]["ssd"]


PROMPTS = [1, 2, 32, 33, 100]


@pytest.mark.parametrize("t", PROMPTS)
def test_ssd_train_with_state_matches_reference(weights, t):
    jcfg, tcfg, jp, tp = weights
    jl, tl = _layer(jp, tp)
    u = np.random.default_rng(t).standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    jo, js = _jtrain(jcfg)(jl, jnp.asarray(u))
    to, ts = tssm.ssd_train(tl, tt(u), tcfg, return_state=True)
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tn(ts.h), np.asarray(js.h), **TOL)
    np.testing.assert_allclose(tn(ts.conv), np.asarray(js.conv), **TOL)
    assert ts.h.shape == (2, 16, 16, 16) and ts.conv.shape == (2, tcfg.conv_width - 1, 288)
    assert ts.h.dtype == torch.float32 and ts.conv.dtype == torch.float32
    # each leaf owns its storage: a view would keep the prompt's buffers alive
    assert all(leaf._base is None for leaf in ts)


@pytest.mark.parametrize("t", PROMPTS)
def test_ssd_conv_window_bitwise_with_exact_projections(weights, t):
    """Integer inputs and projection weights make every product exact on
    both sides: the conv window (zero rows on the left of a prompt shorter
    than W-1) equals the reference's bit for bit, and so do the padded
    rows' no-op on the state (the prompt's output rows are finite)."""
    jcfg, tcfg, jp, tp = weights
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(10 + t)
    ints = {k: rng.integers(-1, 2, np.asarray(jl[k]).shape).astype(np.float32)
            for k in ("w_x", "w_B", "w_C")}
    jl = {**jl, **{k: jnp.asarray(v) for k, v in ints.items()}}
    tl = {**tl, **{k: tt(v) for k, v in ints.items()}}
    u = rng.integers(-2, 3, (2, t, jcfg.d_model)).astype(np.float32)
    jo, js = _jtrain(jcfg)(jl, jnp.asarray(u))
    to, ts = tssm.ssd_train(tl, tt(u), tcfg, return_state=True)
    np.testing.assert_array_equal(tn(ts.conv), np.asarray(js.conv))
    if t < tcfg.conv_width - 1:
        assert not ts.conv[:, : tcfg.conv_width - 1 - t].any()
    assert torch.isfinite(to).all() and torch.isfinite(ts.h).all()


def test_ssd_decode_steps_with_an_inactive_slot(weights):
    """Five decode steps of an "S" block from a 33-token prefill of three
    slots, slot 1 inactive: outputs and states of slots 0 and 2 within TOL
    of the reference's, slot 1's state bit for bit unchanged."""
    jcfg, tcfg, jp, tp = weights
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["periods"][0])
    tblock = tp["layers"][0]
    rng = np.random.default_rng(5)
    u = rng.standard_normal((3, 33, jcfg.d_model)).astype(np.float32)
    _, jst = _jtrain(jcfg)(jblock["ssd"], jnp.asarray(u))
    tst = tssm.SSMState(tt(np.asarray(jst.h)), tt(np.asarray(jst.conv)))   # the same start
    active = np.array([True, False, True])
    pos = np.full(3, 33, np.int32)
    jstep = jax.jit(lambda p, x, st, pos, act: jB.block_decode(p, "S", x, st, jcfg, pos,
                                                               jB.DecodeCtx(), None, act))
    for step in range(5):
        x = rng.standard_normal((3, jcfg.d_model)).astype(np.float32)
        jx, jst = jstep(jblock, jnp.asarray(x), jst, jnp.asarray(pos), jnp.asarray(active))
        before = [t.clone() for t in tst]
        tx = tB.block_decode(tblock, tt(x), tst, tcfg, tt(pos), None, tt(active), None, "S")
        np.testing.assert_allclose(tn(tx)[active], np.asarray(jx)[active], **TOL)
        for got, want, old in zip(tst, jst, before):
            np.testing.assert_allclose(tn(got)[active], np.asarray(want)[active], **TOL)
            assert torch.equal(got[1], old[1])
            np.testing.assert_array_equal(tn(got)[1], np.asarray(want)[1])


def test_params_from_numpy_keeps_ssd_leaves_f32():
    """A bf16 tree: every SSD leaf in bf16 but A_log, D and dt_bias, kept
    in float32 as the reference keeps them; `init_lm_params` makes the
    same tree (keys, shapes, dtypes)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jget_model(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    init = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for tree in (tp, init):
        ssd = tree["layers"][0]["ssd"]
        assert {k for k, v in ssd.items() if not isinstance(v, dict)
                and v.dtype == torch.float32} == {"A_log", "D", "dt_bias"}
        assert ssd["norm"]["scale"].dtype == torch.bfloat16 and "ffn" not in tree["layers"][0]
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), init)
    assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), tp)
    np.testing.assert_allclose(tn(init["layers"][1]["ssd"]["A_log"]),
                               np.asarray(jp["periods"][0]["ssd"]["A_log"][1]), rtol=1e-6)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

RUNS = {"contiguous": dict(paged=False),
        "paged": dict(paged=True, block_size=32),
        # 3 + 3 blocks of 16 hold both prompts; request 1's growth at 48
        # finds the pool dry and preempts it, then it replays
        "preempt": dict(paged=True, block_size=16, num_blocks=6, preempt=True),
        "cancel": dict(paged=True, block_size=32)}


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
    lengths = (40, 45, 30) if run == "preempt" else (40, 66, 50)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    eng = engine_cls(cfg, params, max_seq=128, slots=2, **RUNS[run], **extra)
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
        assert eng.cancel(reqs[0].rid)       # slot 0 frees; request 2 takes it
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
    assert assert_code_ticks_close(jticks, tticks) == 0
    if run == "preempt":
        assert te.stats.preemptions == je.stats.preemptions > 0
        assert te.stats.replayed_tokens == je.stats.replayed_tokens > 0
    if run == "cancel":
        assert tr[0].stop_reason == "cancelled" and te.stats.cancellations == 1
    if te.paged:
        assert te._alloc.total_free == te.num_blocks
        # no paged layer to audit: the reference's violation, in both engines
        for eng in (te, je):
            rep = eng.check_invariants()
            assert not rep.ok and "no PagedSalcaCache" in str(rep)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_tick_in_place_and_without_host_data(paged):
    """The "S" tick writes its recurrent state back in place (slots going
    active and inactive), and makes no tensor of host data: it captures. A
    state with no paged layer has no selection histogram (None, as the
    reference's)."""
    cfg = _cfgs()[1]
    pool = "int8" if paged else "contiguous"
    assert _rebound_after_ticks(_engine(cfg, pool)) == []
    eng = _engine(cfg, pool)
    with HostData() as mode:
        eng._decode(eng._tokens.copy(), eng._mask.copy())
    assert mode.bad == []
    assert tget_model(cfg).selection_hist(eng._state) is None
