"""Port parity, request lifecycle and fault tolerance (the reference's PR 9):
`runtime/faults.py`, `runtime/monitor.py`, the pool's and the engine's
`check_invariants`, and the reference battery tests/test_faults.py ported
case for case, every engine trace run through the JAX engine as well.

* Module cases, no model: `FaultPlan` / `FaultSpec` (schedules, filters,
  validation; the port's plan and the reference's fire at the same calls of
  one random sequence of sites), `NaNGuard`'s slot streaks, `StepMonitor`'s
  flags, alarm and heartbeat against the reference's on one sequence of step
  times, and the pool audit on clean and corrupted pools (the same ``ok``
  as the reference's in every case).
* The battery: knob validation, `max_queue` shedding, cancellation (queued,
  resident, in flight), deadlines (queued, resident), NaN quarantine,
  ``alloc_exhausted`` stalls and ``prefill_chunk`` retries (bit for bit
  against the run without faults), the degraded spill run against the
  masked-block oracle, heartbeat and straggler stats, the chaos battery
  over every site × seeds 0-2, seeded and hypothesis interleavings. Each
  trace also runs through the JAX engine: tokens identical, stop reasons
  and counters equal, the same faults fired at the same calls, every tick's
  mask equal and its logits within LOGIT_TOL (CODE_STEP_TOL where the two
  pools round a K/V value to adjacent int8 codes), both pools drained and
  audited clean.
* Sampling: ``greedy=False`` with a seed, per-request temperatures; the
  port's tokens equal the JAX engine's (the smallest top-two margin of
  z + g is printed); a preempted sampled request replays its recorded
  tokens and draws nothing inside the window.
* The block-sharded engine at one in-process rank and at two spawned gloo
  ranks (tests/_torch_dist_worker.py ``lifecycle``) under a fault plan: the
  unsharded port's tokens and stop reasons.

Deadlines read the wall clock; here both engines read a clock of the test's
that moves TICK_S before every `_tick`, so a deadline expires at the same
call in both. Engines serve qwen3-0.6b.reduced() with
``salca_static_channels`` at float32 compute, from the JAX init tree
converted by `repro_torch.weights`; JAX engines share the first one's
compiled steps, which keeps this file's run short.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import f32_configs, record_ticks
from repro.core import cache as jc
from repro.models import get_model as jget_model
from repro.runtime import faults as jfaults
from repro.runtime import monitor as jmonitor
from repro.runtime import serve as jserve
from repro_torch.core import cache as tc
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import monitor as tmonitor
from repro_torch.runtime import serve as tserve
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
MAX_SEQ, BS = 64, 8
PROMPT_LENS = (21, 13, 30, 9)
CHAOS_SEEDS = (0, 1, 2)
TICK_S = 0.01                  # the test clock's step before every tick
COUNTERS = ("completed", "admissions", "tokens_generated", "overflows", "preemptions",
            "replayed_tokens", "prefill_chunks", "chunk_stalls", "ticks", "deadline_stops",
            "cancellations", "rejections", "errors", "retries", "degraded_ticks",
            "faults_injected", "audits", "audit_failures", "demotions", "promotions")
_TERMINAL = {"length", "stop", "error", "deadline", "cancelled", "rejected"}
PKG = {"jax": (jserve, jfaults), "port": (tserve, tfaults)}


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JF32).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TF32, "cpu")


def _prompts(seed=7, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JF32.vocab_size, (n,)).astype(np.int32) for n in lens]


def _plan(kind, seed, specs):
    """A `FaultPlan` of ``kind``'s package from (site, kwargs) rules."""
    f = PKG[kind][1]
    return f.FaultPlan(seed=seed, specs=tuple(f.FaultSpec(site=s, **kw) for s, kw in specs))


# ---------------------------------------------------------------------------
# FaultPlan / FaultSpec, NaNGuard, StepMonitor (no model)
# ---------------------------------------------------------------------------

def test_fault_plan_deterministic_schedule():
    mk = lambda seed: _plan("port", seed, [("decode_logits", dict(p=0.5))])  # noqa: E731
    p1, p2 = mk(7), mk(7)
    s1 = [p1.fires("decode_logits", rid=0) for _ in range(64)]
    assert s1 == [p2.fires("decode_logits", rid=0) for _ in range(64)]
    assert any(s1) and not all(s1)
    assert p1.total_fired == sum(s1) and p1.counts() == {"decode_logits": sum(s1)}
    p3 = mk(8)
    assert [p3.fires("decode_logits", rid=0) for _ in range(64)] != s1


def test_fault_plan_fires_as_reference():
    """Equal plans of both packages, several rules (filters, ``after``,
    ``max_fires``), one random sequence of 400 site calls: the same call
    fires in both, and the fired logs are equal."""
    specs = [("decode_logits", dict(p=0.3, rids=(1, 2))),
             ("alloc_exhausted", dict(p=0.5, after=3, max_fires=7)),
             ("spill_transfer", dict(p=0.6, direction="promote")),
             ("spill_transfer", dict(p=0.2)),
             ("prefill_chunk", dict(p=0.4, max_fires=5))]
    jplan, tplan = _plan("jax", 11, specs), _plan("port", 11, specs)
    rng = np.random.default_rng(4)
    for _ in range(400):
        site = tfaults.SITES[rng.integers(len(tfaults.SITES))]
        ctx = dict(rid=int(rng.integers(4)), direction=("demote", "promote")[rng.integers(2)])
        assert tplan.fires(site, **ctx) == jplan.fires(site, **ctx)
    assert tplan.fired_log == jplan.fired_log and tplan.total_fired > 20
    assert tplan.counts() == jplan.counts()


def test_fault_spec_after_and_max_fires():
    plan = _plan("port", 0, [("alloc_exhausted", dict(p=1.0, after=2, max_fires=3))])
    assert [plan.fires("alloc_exhausted") for _ in range(10)] == \
        [False, False, True, True, True, False, False, False, False, False]
    assert plan.total_fired == 3


def test_fault_spec_rid_and_direction_filters():
    plan = _plan("port", 0, [("spill_transfer", dict(p=1.0, rids=(3,), direction="promote"))])
    assert not plan.fires("spill_transfer", rid=2, direction="promote")
    assert not plan.fires("spill_transfer", rid=3, direction="demote")
    assert plan.fires("spill_transfer", rid=3, direction="promote")
    broad = _plan("port", 0, [("spill_transfer", {})])
    assert broad.fires("spill_transfer", rid=99, direction="demote")
    assert not broad.fires("decode_logits", rid=99)


def test_fault_spec_validation():
    for f in (jfaults, tfaults):
        with pytest.raises(ValueError, match="unknown fault site"):
            f.FaultSpec(site="bogus")
        with pytest.raises(ValueError, match="p"):
            f.FaultSpec(site="decode_logits", p=1.5)
        with pytest.raises(ValueError, match="direction"):
            f.FaultSpec(site="spill_transfer", direction="sideways")
    assert tfaults.SITES == jfaults.SITES


def test_nan_guard_slot_streaks():
    """The reference's sequence of observations through both guards."""
    for m in (jmonitor, tmonitor):
        g = m.NaNGuard(patience=2)
        assert not g.check_slot(0, True)
        assert not g.check_slot(0, False)
        assert g.check_slot(0, False)
        assert not g.check_slot(1, False)
        g.reset_slot(0), g.reset_slot(1)
        assert g.slot_streaks == {}
        assert m.NaNGuard(patience=1).check_slot(4, False)
        assert g.check(float("nan")) is False and g.check(float("inf")) is True
    assert tmonitor.log.name == "repro_torch.monitor"


def test_step_monitor_matches_reference(tmp_path):
    """One sequence of step times (steady, spikes, a run of three slow steps)
    through both monitors: the same EWMA, flags and alarms at every step;
    the heartbeat file holds the last step."""
    times = [0.10, 0.11, 0.09, 0.50, 0.10, 0.40, 0.45, 0.50, 0.10, 0.30, 0.12]
    mons = [m.StepMonitor(heartbeat_path=str(tmp_path / f"hb_{k}.json"))
            for k, m in (("jax", jmonitor), ("port", tmonitor))]
    for step, s in enumerate(times):
        want, got = (m.record(step, s) for m in mons)
        assert got["flagged"] == want["flagged"] and got["alarm"] == want["alarm"]
        assert got["ewma"] == pytest.approx(want["ewma"], rel=1e-12)
    assert [r["flagged"] for r in mons[1].history].count(True) == mons[1].flagged_steps >= 3
    assert any(r["alarm"] for r in mons[1].history)
    beat = json.loads((tmp_path / "hb_port.json").read_text())
    assert beat["step"] == len(times) - 1 and "time" in beat
    assert not (tmp_path / "hb_port.json.tmp").exists()


# ---------------------------------------------------------------------------
# the pool audit (no model)
# ---------------------------------------------------------------------------

def _tiny_pools():
    """Both packages' 8-block pool with slot 0 holding block 3, as numpy
    metadata to corrupt."""
    meta = dict(page_table=np.full((2, 4), -1, np.int32), refcount=np.zeros(8, np.int32),
                length=np.zeros(2, np.int32))
    meta["page_table"][0, 0], meta["refcount"][3], meta["length"][0] = 3, 1, 4
    return meta, [b for b in range(8) if b != 3]


def _audit(kind, meta, **kw):
    if kind == "jax":
        c = jc.empty_paged_cache(num_blocks=8, block_size=4, slots=2, max_blocks=4,
                                 kv_heads=2, head_dim=8, r=4)
        c = c._replace(**{k: jnp.asarray(v) for k, v in meta.items()})
    else:
        c = tc.empty_paged_cache(num_blocks=8, block_size=4, slots=2, max_blocks=4,
                                 kv_heads=2, head_dim=8, r=4)
        for k, v in meta.items():
            getattr(c, k).copy_(torch.from_numpy(v))
    return c.check_invariants(**kw)


def _corrupt(case):
    meta, free = _tiny_pools()
    kw = dict(free_blocks=free)
    if case == "clean":
        kw["host_refcount"] = meta["refcount"].copy()
    elif case == "ghost_refcount":
        meta["refcount"][5] = 1                   # counted but unmapped
    elif case == "free_mapped":
        kw["free_blocks"] = list(range(8))         # block 3 is mapped
    elif case == "mirror":
        kw["host_refcount"] = meta["refcount"].copy()
        kw["host_refcount"][3] = 2
    elif case == "bad_length":
        meta["length"][1] = 999
    else:                                          # a hole below a mapped block
        meta["page_table"][0, :2] = -1, 3
        kw["allow_holes"] = case == "hole_allowed"
    return meta, kw


AUDIT_CASES = {"clean": (True, None), "ghost_refcount": (False, "refcount"),
               "free_mapped": (False, "free"), "mirror": (False, "mirror"),
               "bad_length": (False, "length"), "hole": (False, "hole"),
               "hole_allowed": (True, None)}


@pytest.mark.parametrize("case", list(AUDIT_CASES))
def test_pool_audit_matches_reference(case):
    """A clean pool and each seeded corruption: the port's audit has the
    reference's ``ok`` and names the fault as the reference does."""
    ok, word = AUDIT_CASES[case]
    meta, kw = _corrupt(case)
    want, got = _audit("jax", meta, **kw), _audit("port", meta, **kw)
    assert got.ok == want.ok == ok, (got, want)
    if word is not None:
        assert any(word in v for v in got.violations), got
    assert len(got.violations) == len(want.violations)
    assert got.checked["blocks"] == 8 and got.checked["slots"] == 2


def test_invariant_report_merge():
    a, b = tc.InvariantReport(checked={"x": 1}), tc.InvariantReport(checked={"x": 2, "y": 3})
    b.fail("bad")
    a.merge(b, prefix="pool[1]: ")
    assert a.violations == ["pool[1]: bad"] and a.checked == {"x": 1, "y": 3} and not a.ok
    assert "1 violation(s)" in repr(a) and "- pool[1]: bad" in repr(a)


# ---------------------------------------------------------------------------
# engines: both packages on one trace
# ---------------------------------------------------------------------------

# the JAX engine's jitted steps, shared by every JAX engine of this file (the
# closures read the model API and max_seq only, which all engines here share)
_JAX_STEPS: dict = {}
_JAX_STEP_NAMES = ("_decode", "_prefill", "_reset", "_write", "_map_block", "_cow_block",
                   "_chunk_step", "_read_block", "_write_block", "_sel_hist_fn")


class _Clock:
    """The wall clock both serve modules read in a trace: it moves TICK_S
    before every `_tick`, so deadlines expire at the same call in both."""
    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t


def _engine(kind, weights, faults=None, **kw):
    """A paged engine of either package over qwen3-0.6b.reduced() with
    static channels (MAX_SEQ, BS); ``faults``: (seed, [(site, kwargs)])."""
    jp, tp = weights
    kw = dict(dict(max_seq=MAX_SEQ, paged=True, block_size=BS, slots=3, num_blocks=40), **kw)
    if faults is not None:
        kw["faults"] = _plan(kind, *faults)
    if kind == "port":
        return tserve.ServingEngine(TCFG, tp, device="cpu", **kw)
    eng = jserve.ServingEngine(JCFG, jp, **kw)
    for name in _JAX_STEP_NAMES:
        if hasattr(eng, name):
            setattr(eng, name, _JAX_STEPS.setdefault(name, getattr(eng, name)))
    return eng


def _stub_cold_block0(eng):
    """The reference battery's stub: the selection reads block 0 of every
    slot as unselected, so the spill policy has a block to demote."""
    real = eng._sel_hist_fn

    def cold_block0(state):
        h = real(state)
        h = h.clone() if torch.is_tensor(h) else np.asarray(h).copy()
        h[:, 0] = 0
        return h

    eng._sel_hist_fn = cold_block0


def _run(kind, weights, drive, clocked=True, stub_cold=False, **kw):
    """``drive(eng, mk) -> requests`` on one engine, ``mk(rid, prompt, **kw)``
    making the package's requests; under the test clock unless ``clocked``
    is False. Returns the engine, its requests and its ticks."""
    mod = PKG[kind][0]
    eng = _engine(kind, weights, **kw)
    if stub_cold:
        _stub_cold_block0(eng)
    ticks = record_ticks(eng)
    clock = _Clock() if clocked else None

    def mk(rid, prompt, **rkw):
        if clock is not None:
            rkw.setdefault("submitted", clock.t)
        return mod.Request(rid=rid, prompt=np.array(prompt, np.int32), **rkw)

    if clock is None:
        return eng, drive(eng, mk), ticks
    real_tick = eng._tick

    def tick():
        clock.t += TICK_S
        real_tick()

    eng._tick = tick
    with mock.patch.object(mod, "time", clock):
        return eng, drive(eng, mk), ticks


def _assert_drained(eng):
    """Every block back on the free list, refcounts zero, the audit clean."""
    free = eng._alloc.free_ids()
    assert eng._alloc.total_free == eng.num_blocks
    assert len(free) == len(set(free)) == eng.num_blocks
    assert not eng._refcount.any()
    rep = eng.check_invariants()
    assert rep.ok, rep


def _both(weights, drive, **kw):
    """``drive`` on a JAX and a port engine built with ``kw``: the port's
    trace is the reference's (tokens, stop reasons, preemptions, every
    tick's mask and logits, the counters, the faults fired and where) and
    both pools drained and audited clean. Returns the port's engine and
    requests."""
    (je, jr, jt), (te, tr, tt_) = (_run(k, weights, drive, **kw) for k in ("jax", "port"))
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.stop_reason for r in tr] == [r.stop_reason for r in jr]
    assert [r.preemptions for r in tr] == [r.preemptions for r in jr]
    assert len(tt_) == len(jt)
    for (tm, tl, tcodes), (jm, jl, jcodes) in zip(tt_, jt):
        np.testing.assert_array_equal(tm, jm)
        step = int(np.abs(tcodes - jcodes).max(initial=0))
        assert step <= 1, f"the pools' int8 codes part by {step} steps"
        np.testing.assert_allclose(tl[tm], jl[jm], **(CODE_STEP_TOL if step else LOGIT_TOL))
    assert {k: getattr(te.stats, k) for k in COUNTERS} == \
        {k: getattr(je.stats, k) for k in COUNTERS}
    if kw.get("faults") is not None:
        assert te._faults.fired_log == je._faults.fired_log
        assert te._faults._opportunities == je._faults._opportunities
    for eng in (je, te):
        _assert_drained(eng)
    return te, tr


def _serve(max_new=8, lens=PROMPT_LENS, **req_kw):
    def drive(eng, mk):
        reqs = [mk(i, p, max_new_tokens=max_new, **req_kw)
                for i, p in enumerate(_prompts(lens=lens))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs
    return drive


_BASE: dict = {}


def _baseline(weights, max_new=8, **kw):
    """The port's outputs on the four prompts without faults (cached)."""
    key = (max_new, tuple(sorted(kw.items())))
    if key not in _BASE:
        _, reqs, _ = _run("port", weights, _serve(max_new), **kw)
        _BASE[key] = [tuple(r.output) for r in reqs]
    return _BASE[key]


# ---------------------------------------------------------------------------
# constructor validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(max_queue=0), "max_queue"), (dict(audit_every=0), "audit_every"),
    (dict(spill_max_retries=-1), "spill_max_retries"),
    (dict(spill_backoff_base=0), "spill_backoff")],
    ids=["max_queue", "audit_every", "max_retries", "backoff"])
def test_engine_validates_fault_knobs(weights, kw, match):
    for kind in ("jax", "port"):
        with pytest.raises(ValueError, match=match):
            _engine(kind, weights, **kw)


# ---------------------------------------------------------------------------
# lifecycle: shedding, cancellation, deadlines
# ---------------------------------------------------------------------------

def test_max_queue_sheds_and_counts(weights):
    def drive(eng, mk):
        reqs = [mk(i, p, max_new_tokens=4) for i, p in enumerate(_prompts())]
        assert eng.submit(reqs[0]) and eng.submit(reqs[1])
        assert eng.submit(reqs[2]) is False
        assert reqs[2].stop_reason == "rejected" and reqs[2].done_time is not None
        eng.run()
        return reqs[:3]

    eng, reqs = _both(weights, drive, max_queue=2)
    assert eng.stats.rejections == 1
    assert [r.stop_reason for r in reqs] == ["length", "length", "rejected"]
    assert eng.stats.admissions == eng.stats.completed + eng.stats.preemptions


def _cancel_queued_and_resident(eng, mk):
    reqs = [mk(i, p, max_new_tokens=4) for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    assert eng.cancel(reqs[3].rid) is True and reqs[3].stop_reason == "cancelled"
    assert eng.cancel(999) is False
    eng._admit()
    eng._tick()
    resident = next(iter(eng._active.values()))
    assert eng.cancel(resident.rid) is True and resident.stop_reason == "cancelled"
    eng.run()
    return reqs


def _cancel_inflight(eng, mk):
    reqs = [mk(i, p, max_new_tokens=4) for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng._admit()                             # the first chunk of request 0
    assert eng._inflight is not None
    assert eng.cancel(eng._inflight.req.rid) is True and eng._inflight is None
    eng.run()
    return reqs


@pytest.mark.parametrize("where", ["queued_resident", "inflight"])
def test_cancel_queued_resident_inflight(weights, where):
    if where == "inflight":
        eng, reqs = _both(weights, _cancel_inflight, prefill_chunk=8)
        assert eng.stats.cancellations == 1 and reqs[0].stop_reason == "cancelled"
    else:
        eng, reqs = _both(weights, _cancel_queued_and_resident, slots=1)
        assert eng.stats.cancellations == 2
    assert eng.stats.admissions == eng.stats.completed + eng.stats.preemptions


def test_deadline_resident_and_queued(weights):
    """A resident request with a 1 ms deadline ends at the next tick's
    sweep; a queued one with 0.5 ms is shed before it gets a slot."""
    def resident(eng, mk):
        reqs = [mk(i, p, max_new_tokens=30, deadline_ms=1.0 if i == 0 else None)
                for i, p in enumerate(_prompts())]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs

    eng, reqs = _both(weights, resident)
    assert reqs[0].stop_reason == "deadline" and reqs[0].output
    assert all(r.stop_reason == "length" for r in reqs[1:])
    assert eng.stats.deadline_stops == 1

    def queued(eng, mk):
        reqs = [mk(i, p, max_new_tokens=4, deadline_ms=None if i == 0 else 0.5)
                for i, p in enumerate(_prompts()[:2])]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs

    eng, reqs = _both(weights, queued, slots=1)
    assert [r.stop_reason for r in reqs] == ["length", "deadline"] and not reqs[1].output
    assert eng.stats.admissions == eng.stats.completed + eng.stats.preemptions == 1


# ---------------------------------------------------------------------------
# fault sites: quarantine, stall, chunk retry, spill degradation
# ---------------------------------------------------------------------------

def test_nan_quarantine_isolates_slot(weights):
    base = _baseline(weights)
    eng, reqs = _both(weights, _serve(), audit_every=1,
                      faults=(0, [("decode_logits", dict(p=1.0, rids=(1,), max_fires=1))]))
    assert reqs[1].stop_reason == "error"
    assert eng.stats.errors == 1 and eng.stats.faults_injected == 1
    for i in (0, 2, 3):
        assert tuple(reqs[i].output) == base[i]
    assert eng.stats.audits == eng.stats.ticks and eng.stats.audit_failures == 0


def _poison_v(eng, blocks):
    """NaN into every V code of ``blocks`` in layer 0 of an fp16 pool."""
    if isinstance(eng, tserve.ServingEngine):
        eng._state.caches[0].data["v_codes"][blocks] = float("nan")
    else:
        st = eng._state.period_states[0]
        st = st._replace(v_codes=st.v_codes.at[0, np.asarray(blocks)].set(jnp.nan))
        eng._state = eng._state._replace(period_states=(st,) + eng._state.period_states[1:])


def test_real_nan_quarantines_through_finite(weights):
    """No fault plan: NaN written into request 1's V codes of layer 0 (fp16
    pool) after the 3rd tick reaches its logits row; the tick's ``finite``
    output drops its flag and it ends with "error" in both engines; the
    other requests keep the clean fp16 run's output."""
    base = _baseline(weights, kv_pool_dtype="fp16")

    def drive(eng, mk):
        reqs = [mk(i, p, max_new_tokens=8) for i, p in enumerate(_prompts())]
        for r in reqs:
            eng.submit(r)
        while eng.stats.ticks < 3:
            eng._admit()
            eng._tick()
        slot = next(s for s, r in eng._active.items() if r.rid == 1)
        _poison_v(eng, [b for b in eng._slot_blocks[slot] if b >= 0])
        eng.run()
        return reqs

    eng, reqs = _both(weights, drive, kv_pool_dtype="fp16", audit_every=1)
    assert [r.stop_reason for r in reqs] == ["length", "error", "length", "length"]
    assert eng.stats.errors == 1 and eng.stats.faults_injected == 0
    assert len(reqs[1].output) == 4 and tuple(reqs[1].output) == base[1][:4]
    for i in (0, 2, 3):
        assert tuple(reqs[i].output) == base[i]


def test_alloc_exhausted_stall_bit_identical(weights):
    """A spurious allocator failure stalls the slot for one tick: no token
    lost, the output bit for bit the run without faults'."""
    base = _baseline(weights)
    eng, reqs = _both(weights, _serve(), audit_every=1,
                      faults=(3, [("alloc_exhausted", dict(p=0.5, max_fires=4))]))
    assert eng.stats.faults_injected > 0
    assert all(r.stop_reason == "length" for r in reqs)
    assert [tuple(r.output) for r in reqs] == base


def test_prefill_chunk_fault_retries_exact(weights):
    base = _baseline(weights, prefill_chunk=8)
    eng, reqs = _both(weights, _serve(), prefill_chunk=8, audit_every=1,
                      faults=(2, [("prefill_chunk", dict(p=0.4, max_fires=5))]))
    assert eng.stats.faults_injected > 0 and eng.stats.retries >= eng.stats.faults_injected
    assert all(r.stop_reason == "length" for r in reqs)
    assert [tuple(r.output) for r in reqs] == base


def test_degraded_matches_masked_oracle(weights, rng):
    """Exhausted promote retries pin the block cold and unselectable: the
    degraded run equals, bit for bit, an oracle that never promotes."""
    prompt = rng.integers(0, JF32.vocab_size, 40).astype(np.int32)
    spill = dict(slots=1, num_blocks=8, host_spill=True, demote_after=1, spill_keep_recent=1,
                 audit_every=1)

    def drive(eng, mk):
        r = mk(0, prompt, max_new_tokens=8)
        eng.submit(r)
        eng.run()
        return [r]

    oracle, (r_o,) = _both(weights, drive, stub_cold=True, promote_headroom=8, **spill)
    assert oracle.stats.demotions >= 1 and oracle.stats.promotions == 0
    eng, (r_d,) = _both(weights, drive, stub_cold=True, promote_headroom=1,
                        spill_max_retries=2, spill_backoff_base=1, spill_backoff_cap=2,
                        faults=(0, [("spill_transfer", dict(p=1.0, direction="promote"))]),
                        **spill)
    assert eng.stats.retries > 0 and eng.stats.promotions == 0
    assert eng.stats.degraded_ticks > 0
    assert r_d.output == r_o.output and r_d.stop_reason == r_o.stop_reason == "length"


def test_heartbeat_and_straggler_stats(weights, tmp_path):
    """On the wall clock: each engine writes its heartbeat and keeps the
    tick EWMA; the tokens are the reference's."""
    got = {}
    for kind in ("jax", "port"):
        hb = tmp_path / f"hb_{kind}.json"
        eng, reqs, _ = _run(kind, weights, _serve(max_new=4), clocked=False,
                            heartbeat_path=str(hb))
        beat = json.loads(hb.read_text())
        assert beat["step"] == eng.stats.ticks and "time" in beat
        assert eng.stats.tick_ewma_s > 0 and "tick_ewma_ms" in eng.stats.summary()
        assert eng.monitor.total_steps == eng.stats.ticks
        _assert_drained(eng)
        got[kind] = [r.output for r in reqs]
    assert got["port"] == got["jax"]
    mon = tmonitor.StepMonitor()
    eng = _engine("port", weights, monitor=mon, heartbeat_path=str(tmp_path / "hb.json"))
    assert eng.monitor is mon and mon.heartbeat_path == str(tmp_path / "hb.json")


# ---------------------------------------------------------------------------
# chaos battery: every injection site × seeds
# ---------------------------------------------------------------------------

_SITE_SETUP = {
    "decode_logits": dict(kw=dict(preempt=True, num_blocks=14),
                          spec=dict(p=0.2, max_fires=2), exact=False),
    "alloc_exhausted": dict(kw=dict(preempt=True, num_blocks=14),
                            spec=dict(p=0.4, max_fires=6), exact=True),
    "prefill_chunk": dict(kw=dict(prefill_chunk=8, num_blocks=40),
                          spec=dict(p=0.4, max_fires=6), exact=True),
    "spill_transfer": dict(kw=dict(slots=2, num_blocks=8, host_spill=True, demote_after=1,
                                   spill_keep_recent=1, spill_max_retries=2,
                                   spill_backoff_base=1, spill_backoff_cap=2),
                           spec=dict(p=0.5), exact=False),
}


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("site", tfaults.SITES)
def test_chaos_battery(weights, site, seed):
    """Every site and seed: no crash, no leaked block, a clean audit at drain
    and every request ended with a truthful stop reason, through both
    engines alike; the transient sites' outputs equal the run without
    faults, and under decode_logits every request that was not quarantined
    keeps its output."""
    setup = _SITE_SETUP[site]
    eng, reqs = _both(weights, _serve(max_new=5), stub_cold=site == "spill_transfer",
                      audit_every=2, faults=(seed, [(site, setup["spec"])]), **setup["kw"])
    stats = eng.stats
    assert all(r.stop_reason in _TERMINAL for r in reqs)
    assert stats.errors == sum(r.stop_reason == "error" for r in reqs)
    assert stats.admissions == stats.completed + stats.preemptions
    assert stats.audit_failures == 0
    if setup["exact"] or site == "decode_logits":
        base = _baseline(weights, max_new=5, **setup["kw"])
        for i, r in enumerate(reqs):
            if r.stop_reason != "error":
                assert tuple(r.output) == base[i], (site, seed, i)


# ---------------------------------------------------------------------------
# interleavings of submit / admit / tick / preempt / cancel under faults
# ---------------------------------------------------------------------------

PROP_LENS = (5, 9, 14, 22)
MIXED = [("alloc_exhausted", dict(p=0.25, max_fires=4)),
         ("prefill_chunk", dict(p=0.25, max_fires=4)),
         ("decode_logits", dict(p=0.1, max_fires=2))]


def _interleave(weights, ops, seed):
    """Both engines (chunked, preempting, 10 blocks, a mixed fault plan, a
    bounded queue, audited every tick) through one op sequence, then drain:
    equal traces, truthful stops, no overflow, no leaked block."""
    def drive(eng, mk):
        rng = np.random.default_rng(seed)
        reqs = []
        for kind, a in ops:
            kind %= 5
            if kind == 0 and len(reqs) < 6:
                p = rng.integers(0, JF32.vocab_size, (PROP_LENS[a % len(PROP_LENS)],))
                reqs.append(mk(len(reqs), p, max_new_tokens=3 + a % 5,
                               deadline_ms=50.0 if a % 7 == 0 else None))
                eng.submit(reqs[-1])
            elif kind == 1:
                eng._admit()
            elif kind == 2:
                eng._tick()
            elif kind == 3:
                victim = eng._pick_victim()
                if victim is not None:
                    eng._preempt_slot(victim)
            elif reqs:
                eng.cancel(reqs[a % len(reqs)].rid)
            free = eng._alloc.free_ids()
            assert len(free) == len(set(free))
        eng.run()
        return reqs

    eng, reqs = _both(weights, drive, slots=3, num_blocks=10, preempt=True, prefill_chunk=8,
                      faults=(seed, MIXED), max_queue=6, audit_every=1)
    assert all(r.stop_reason in _TERMINAL for r in reqs)
    assert eng.stats.overflows == 0 and eng.stats.audit_failures == 0
    assert eng.stats.admissions == eng.stats.completed + eng.stats.preemptions


def test_fault_interleavings_deterministic(weights):
    """Seeded op sequences (the reference's hypothesis-free cases)."""
    master = np.random.default_rng(23)
    for _ in range(4):
        ops = [tuple(master.integers(0, 64, 2).tolist()) for _ in range(10)]
        _interleave(weights, ops, int(master.integers(2 ** 31)))


if HAVE_HYPOTHESIS:
    @settings(max_examples=15, derandomize=True, deadline=None)
    @given(ops=hst.lists(hst.tuples(hst.integers(0, 63), hst.integers(0, 63)),
                         min_size=1, max_size=12),
           seed=hst.integers(0, 2 ** 31 - 1))
    def test_fault_interleavings_hypothesis(weights, ops, seed):
        """Random lifecycle interleavings under the mixed fault plan: equal
        traces, a clean audit and no leaked block at drain."""
        _interleave(weights, ops, seed)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

class _Draws:
    """The engine's generator with its Gumbel draws recorded."""
    def __init__(self, rng):
        self.rng, self.g = rng, []

    def gumbel(self, size):
        g = self.rng.gumbel(size=size)
        self.g.append(g)
        return g


def _sampled(max_new, temps):
    def drive(eng, mk):
        eng._rng = _Draws(eng._rng)
        rows = []
        real = eng._sample

        def sample(req, row):
            if row is not None and req.temperature > 0:
                rows.append((np.asarray(row, np.float64), req.temperature))
            return real(req, row)

        eng._sample = sample
        eng.rows = rows
        reqs = [mk(i, p, max_new_tokens=max_new, temperature=t)
                for i, (p, t) in enumerate(zip(_prompts(), temps))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs
    return drive


def test_sampled_engine_matches_reference(weights):
    """``greedy=False, seed=3``; requests 0 and 2 at temperature 0.7, 1 and
    3 at 0: the port's tokens equal the JAX engine's; the greedy requests'
    equal the greedy run's; one Gumbel row of V_pad draws per sampled fresh
    token, in the reference's order."""
    temps = (0.7, 0.0, 0.7, 0.0)
    eng, reqs = _both(weights, _sampled(8, temps), greedy=False, seed=3)
    draws = eng._rng.g
    assert len(draws) == sum(len(r.output) for r, t in zip(reqs, temps) if t > 0)
    assert all(g.shape == (TCFG.padded_vocab,) for g in draws)
    margins = []
    for (row, t), g in zip(eng.rows, draws):
        top2 = np.sort(row / t + g)[-2:]
        margins.append(top2[1] - top2[0])
    print(f"sampled parity: {len(draws)} draws; smallest top-two margin of z + g "
          f"{min(margins):.3e}")
    base = _baseline(weights)
    assert tuple(reqs[1].output) == base[1] and tuple(reqs[3].output) == base[3]
    assert [tuple(r.output) for r in reqs] != base


def test_sampled_preempted_replay_draws_nothing(weights):
    """Every request sampled at 0.7 on a pool that preempts: a preempted
    request replays its recorded tokens, so the draws are exactly the fresh
    tokens (none inside a replay window); the trace is the reference's."""
    eng, reqs = _both(weights, _sampled(14, (0.7,) * 4), greedy=False, seed=5, num_blocks=8,
                      preempt=True, prefill_chunk=8)
    assert eng.stats.preemptions > 0 and eng.stats.replayed_tokens > 0
    assert len(eng._rng.g) == eng.stats.tokens_generated == 14 * len(reqs)


# ---------------------------------------------------------------------------
# the block-sharded engine
# ---------------------------------------------------------------------------

SHARD_ENGINE = dict(max_seq=MAX_SEQ, slots=3, block_size=BS, num_blocks=8, preempt=True,
                    prefill_chunk=8, audit_every=1)
SHARD_FAULTS = (1, [("alloc_exhausted", dict(p=0.3, max_fires=4)),
                    ("prefill_chunk", dict(p=0.3, max_fires=3)),
                    ("decode_logits", dict(p=1.0, rids=(1,), after=3, max_fires=1))])
SHARD_NEW = 10


def _port_faulted(weights, **kw):
    eng, reqs, _ = _run("port", weights, _serve(SHARD_NEW), faults=SHARD_FAULTS,
                        **dict(SHARD_ENGINE, **kw))
    return eng, [r.output for r in reqs], [r.stop_reason for r in reqs]


def test_sharded_engine_world1_under_faults(weights):
    """The chunked, preempting engine under the fault plan over a one-rank
    gloo world: the unsharded port's tokens, stop reasons and faults."""
    eng, want, stops = _port_faulted(weights)
    assert "error" in stops and eng.stats.faults_injected >= 3
    eng1, got, stops1 = _port_faulted(weights, ctx=init_decode_ctx("cpu"))
    assert (got, stops1) == (want, stops)
    assert eng1._faults.fired_log == eng._faults.fired_log
    assert eng1.stats.audit_failures == 0
    _assert_drained(eng1)


def test_sharded_engine_two_gloo_ranks_under_faults(weights, tmp_path):
    """Two SPMD ranks (tests/_torch_dist_worker.py ``lifecycle``), each with
    its own plan from the same seed: the unsharded port's tokens, stop
    reasons and fired faults on both ranks, clean audits, drained pools."""
    eng, want, stops = _port_faulted(weights)
    torch.save(dict(weights=weights[1], prompts=_prompts(), new_tokens=SHARD_NEW,
                    engine=SHARD_ENGINE, faults=SHARD_FAULTS,
                    cfg=dict(salca_static_channels=True)), tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               "lifecycle", str(tmp_path), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    for r in (torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(2)):
        assert r["outputs"] == want and r["stops"] == stops
        assert r["fired"] == eng._faults.fired_log
        assert r["audit_ok"] and r["free"] == list(range(8)) and r["pools_ok"]
