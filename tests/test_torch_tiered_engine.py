"""Port parity, the tiered pool at the engine level: `ServingEngine` with
``kv_pool_dtype`` fp16/int4 and with ``host_spill``, against the JAX engine.

Both sides serve qwen3-0.6b.reduced() at float32 compute from the same
weights. Greedy tokens must be identical:

* paged engines with fp16 and int4 pools (a sparse tick, k = 128 of 256
  positions, over a pool with block reuse), and the block-sharded engine
  on those pools at one in-process gloo rank and at two spawned gloo ranks
  (tests/_torch_dist_worker.py);
* the three host-spill scenarios of tests/test_quantized_pool.py: a
  demote → promote round trip mid-decode, policy spill with the selection
  histogram stubbed to report block 0 unselected (as the reference test
  does), and wave admission of a prompt larger than the whole pool — with
  the same demotion/promotion counts and transfer bytes as the reference,
  and the pool drained with no leaked block.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import f32_configs
from repro.models import get_model as jget_model
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
JCFG, TCFG = f32_configs()
ENGINE = dict(max_seq=256, slots=2, block_size=32, num_blocks=16)
PROMPT_LENS, NEW_TOKENS = (150, 200, 170), 5     # k = 128 of 256: a sparse tick
# logits: f32 summation-order differences; over ~500 stored tokens a last-ulp
# difference can move one stored code by one step (tests/test_torch_engine.py)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
_JAX_RUNS: dict = {}


@pytest.fixture(scope="module")
def weights():
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
    logits = []
    orig = eng._decode

    def recording(*args):
        out = orig(*args)
        mask = np.asarray(args[-1]).copy()
        lg = out[1].float() if torch.is_tensor(out[1]) else out[1]
        logits.append(np.asarray(lg, np.float32)[mask])
        return out

    eng._decode = recording
    stats = eng.run()
    return [r.output for r in reqs], logits, stats, eng


def _jax_run(jp, mode):
    if mode not in _JAX_RUNS:
        _JAX_RUNS[mode] = _serve(JEngine, JRequest, JCFG, jp, kv_pool_dtype=mode)
    return _JAX_RUNS[mode]


def _drained(eng):
    assert sorted(eng._free_blocks) == list(range(eng.num_blocks))
    assert int(np.asarray(eng._refcount).sum()) == 0
    for pool in eng._state.caches:
        assert pool.check_invariants(free_blocks=eng._free_blocks,
                                     host_refcount=eng._refcount).ok


@pytest.mark.parametrize("mode", ("fp16", "int4"))
def test_engine_per_mode_vs_jax(weights, mode):
    """Paged fp16/int4 engines: tokens identical to the JAX engine's, logits
    within LOGIT_TOL every tick; the block-sharded engine at one rank gives
    the same tokens."""
    jp, tp = weights
    jout, jlog, _, _ = _jax_run(jp, mode)
    tout, tlog, stats, eng = _serve(TEngine, TRequest, TCFG, tp, device="cpu",
                                    kv_pool_dtype=mode)
    assert tout == jout
    assert len(tlog) == len(jlog) == stats.ticks
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, **LOGIT_TOL)
    assert all(c.kv_pool_dtype == mode for c in eng._state.caches)
    _drained(eng)
    sout, _, sstats, seng = _serve(TEngine, TRequest, TCFG, tp, device="cpu",
                                   kv_pool_dtype=mode, ctx=init_decode_ctx("cpu"))
    assert sout == jout and sstats.shards == 1
    _drained(seng)


@pytest.mark.parametrize("mode", ("fp16", "int4"))
def test_sharded_engine_two_gloo_ranks_per_mode(weights, tmp_path, mode):
    """Two SPMD ranks over a fp16/int4 pool, each holding half the blocks
    (B6's per-block branch on each rank's share): tokens identical to the
    JAX unsharded engine's, both ranks drained."""
    jp, tp = weights
    jout = _jax_run(jp, mode)[0]
    torch.save(dict(weights=tp, prompts=_prompts(), new_tokens=NEW_TOKENS,
                    engine=dict(ENGINE, kv_pool_dtype=mode)), tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               "engine", str(tmp_path), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    for r in range(2):
        res = torch.load(tmp_path / f"out{r}.pt", weights_only=False)
        assert res["outputs"] == jout
        assert res["free"] == list(range(ENGINE["num_blocks"])) and res["pools_ok"]
        assert res["stats"]["shards"] == 2


# ---------------------------------------------------------------------------
# host spill: the scenarios of tests/test_quantized_pool.py
# ---------------------------------------------------------------------------

SPILL_SEQ, SPILL_BS = 64, 16


def _spill_engines(weights, **kw):
    jp, tp = weights
    common = dict(paged=True, block_size=SPILL_BS, host_spill=True, **kw)
    return (JEngine(JCFG, jp, **common),
            TEngine(TCFG, tp, device="cpu", **common))


def _spill_stats_equal(js, ts):
    for key in ("completed", "overflows", "demotions", "promotions", "pcie_bytes",
                "peak_cold_blocks", "ticks"):
        assert getattr(ts, key) == getattr(js, key), key


@pytest.mark.parametrize("mode", ("int8", "int4"))
def test_demote_promote_roundtrip_vs_jax(weights, mode):
    """Block 0 demoted by hand after two ticks; the promotion pass brings it
    back before the next tick; tokens, counts and bytes equal the
    reference's, and nothing leaks."""
    prompt = np.random.default_rng(1).integers(0, JCFG.vocab_size, 40).astype(np.int32)
    outs = []
    for eng, req_cls in zip(_spill_engines(weights, max_seq=SPILL_SEQ, slots=1, num_blocks=6,
                                           demote_after=10 ** 6, spill_keep_recent=2,
                                           kv_pool_dtype=mode), (JRequest, TRequest)):
        req = req_cls(rid=0, prompt=prompt.copy(), max_new_tokens=8)
        eng.submit(req)
        eng._admit()
        eng._tick(), eng._tick()
        assert eng.demote_block(0, 0)
        assert eng._slot_blocks[0][0] == -1 and eng.stats.cold_blocks == 1
        eng.run()
        assert req.stop_reason == "length"
        assert eng.stats.demotions == eng.stats.promotions == 1
        assert eng.stats.pcie_bytes == 2 * eng._block_bytes
        assert not eng._spilled and eng._alloc.total_free == 6
        outs.append((req.output, eng.stats, eng._block_bytes))
    (jo, js, jb), (to, ts, tb) = outs
    assert to == jo and tb == jb
    _spill_stats_equal(js, ts)


def test_spill_policy_demotes_and_completes_vs_jax(weights):
    """Policy spill with the histogram reader stubbed to report block 0
    unselected on both sides: equal tokens, demotions, promotions and
    bytes; every request ends with `length`; the pool drains."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, JCFG.vocab_size, 40).astype(np.int32) for _ in range(2)]
    runs = []
    for eng, req_cls in zip(_spill_engines(weights, max_seq=SPILL_SEQ, slots=2, num_blocks=8,
                                           demote_after=1, spill_keep_recent=1),
                            (JRequest, TRequest)):
        real = eng._sel_hist_fn

        def cold_block0(state, real=real):
            h = real(state)
            h = h.clone() if torch.is_tensor(h) else np.asarray(h).copy()
            h[:, 0] = 0
            return h

        eng._sel_hist_fn = cold_block0
        reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run()
        assert all(r.stop_reason == "length" and len(r.output) == 6 for r in reqs)
        assert stats.demotions >= 1 and stats.peak_cold_blocks >= 1
        assert stats.pcie_bytes == (stats.demotions + stats.promotions) * eng._block_bytes
        assert not eng._spilled and eng._alloc.total_free == 8
        runs.append(([r.output for r in reqs], stats))
    (jo, js), (to, ts) = runs
    assert to == jo
    _spill_stats_equal(js, ts)
    assert ts.summary()["demotions"] == ts.demotions


@pytest.mark.parametrize("mode", ("int8", "fp16"))
def test_wave_admission_vs_jax(weights, mode):
    """A 100-token prompt (7 blocks) into a 4-block pool admits in waves
    and decodes to completion, as in the reference."""
    prompt = np.random.default_rng(3).integers(0, JCFG.vocab_size, 100).astype(np.int32)
    runs = []
    for eng, req_cls in zip(_spill_engines(weights, max_seq=128, slots=1, num_blocks=4,
                                           demote_after=10 ** 6, spill_keep_recent=2,
                                           kv_pool_dtype=mode), (JRequest, TRequest)):
        req = req_cls(rid=0, prompt=prompt.copy(), max_new_tokens=4)
        eng.submit(req)
        stats = eng.run()
        assert req.stop_reason == "length" and len(req.output) == 4
        assert stats.overflows == 0 and stats.demotions >= 3
        assert not eng._spilled and eng._alloc.total_free == 4
        assert int(np.asarray(eng._refcount).sum()) == 0
        runs.append((req.output, stats))
    (jo, js), (to, ts) = runs
    assert to == jo
    _spill_stats_equal(js, ts)
