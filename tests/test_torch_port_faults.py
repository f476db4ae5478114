"""The port against the reference where four faults once parted them: the
launcher's rounding of ``max_seq``, `ServingEngine.submit`'s return value,
`ServeStats.summary`'s keys and rounding, and pool-wide copies in the paged
tick (the reference's `test_fused_tick_has_no_pool_wide_ops`, here with a
dispatch mode instead of a jaxpr walk).

Both launchers run on the CPU with ``--local`` and a stub engine that stops
them once it has seen ``max_seq``; the engines serve qwen3-0.6b.reduced()
at float32 compute from the same weights (the JAX init tree converted by
`repro_torch.weights`).
"""

import dataclasses
import importlib
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from _torch_bridge import f32_configs
from repro.models import get_model as jget_model
from repro.models.blocks import salca_params_for as j_salca_params_for
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServeStats as JStats
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.flags import perf_flags
from repro_torch.models.blocks import salca_params_for as t_salca_params_for
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServeStats as TStats
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

JCFG, TCFG = f32_configs()


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


# ---------------------------------------------------------------------------
# the launchers' max_seq
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _launcher_max_seq(module: str, argv: list, monkeypatch) -> int:
    """``max_seq`` that launcher ``module``'s main() hands its engine."""
    mod = importlib.import_module(module)
    seen = {}

    def engine(cfg, params, max_seq, **kw):
        seen["max_seq"] = max_seq
        raise _Stop

    monkeypatch.setattr(mod, "ServingEngine", engine)
    monkeypatch.setattr(sys, "argv", [module, "--arch", "qwen3-0.6b", "--local", *argv])
    with pytest.raises(_Stop):
        mod.main()
    return seen["max_seq"]


@pytest.mark.parametrize("argv", [[], ["--prompt-len", "2048"], ["--max-seq", "1000"],
                                  ["--max-seq", "300", "--new-tokens", "4"]])
def test_launchers_round_max_seq_alike(argv, monkeypatch):
    """Both launchers round the requested length up to a multiple of 128,
    so both engines get the same max_seq and Salca parameters."""
    j = _launcher_max_seq("repro.launch.serve", argv, monkeypatch)
    t = _launcher_max_seq("repro_torch.launch.serve", argv + ["--device", "cpu"], monkeypatch)
    assert t == j and j % 128 == 0
    jcfg, tcfg = (m.get_config("qwen3-0.6b").reduced()
                  for m in (importlib.import_module("repro.configs"),
                            importlib.import_module("repro_torch.configs")))
    assert dataclasses.asdict(t_salca_params_for(tcfg, t)) == \
        dataclasses.asdict(j_salca_params_for(jcfg, j))


def test_launcher_refuses_block_size_not_dividing_max_seq(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        _launcher_max_seq("repro_torch.launch.serve",
                          ["--device", "cpu", "--paged", "--block-size", "48"], monkeypatch)
    assert "--block-size 48 must divide max_seq 256" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# submit and summary
# ---------------------------------------------------------------------------

def _serve(engine_cls, req_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, max_seq=64, slots=2, paged=True, block_size=16,
                     num_blocks=8, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=4) for i, p in enumerate(prompts)]
    enqueued = [eng.submit(r) for r in reqs]
    return enqueued, eng.run().summary(), reqs


def _timing(key: str) -> bool:
    return key.endswith("_s") or "_ms_" in key


def test_submit_and_summary_match_reference_on_one_trace(weights, rng):
    """Both paged engines serve the same three requests: submit returns
    True for each, and every summary key both have, timings aside, holds
    the same value (block use and utilisation included)."""
    jp, tp = weights
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in (12, 30, 20)]
    jq, js, _ = _serve(JEngine, JRequest, JCFG, jp, prompts)
    tq, ts, _ = _serve(TEngine, TRequest, TCFG, tp, prompts, device="cpu")
    assert jq == [True] * 3 and all(q is True for q in tq)
    assert ts.keys() == js.keys()
    shared = sorted(k for k in set(js) & set(ts) if not _timing(k))
    assert "block_utilization" in shared and "peak_blocks_in_use" in shared
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}


def test_summary_matches_reference_on_a_preempting_trace(weights, rng):
    """Both paged engines, chunked (8 tokens) and preempting, on a pool of 5
    blocks for prompts of 40, 30 and 20 tokens (8 new each): the second
    request's growth past 32 tokens finds the pool dry and preempts it. Every summary key both have, timings
    aside — preemptions, replayed_tokens, prefill_chunks and chunk_stalls
    among them — holds the same value, and so do the requests' stats."""
    jp, tp = weights
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in (40, 30, 20)]
    runs = []
    for eng_cls, req_cls, cfg, params, extra in ((JEngine, JRequest, JCFG, jp, {}),
                                                 (TEngine, TRequest, TCFG, tp, {"device": "cpu"})):
        eng = eng_cls(dataclasses.replace(cfg, salca_static_channels=True), params, max_seq=64,
                      slots=2, paged=True, block_size=16, num_blocks=5, prefill_chunk=8,
                      preempt=True, **extra)
        reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        runs.append((eng.run().summary(), [r.stats() for r in reqs]))
    (js, jr), (ts, tr) = runs
    assert ts.keys() == js.keys()
    shared = sorted(k for k in set(js) & set(ts) if not _timing(k))
    assert {"preemptions", "replayed_tokens", "prefill_chunks", "chunk_stalls"} <= set(shared)
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
    assert ts["preemptions"] > 0 and ts["prefill_chunks"] > 0 and ts["overflows"] == 0
    for j, t in zip(jr, tr):
        assert {k: t[k] for k in t if not _timing(k)} == {k: j[k] for k in j if not _timing(k)}
    assert sum(t["preemptions"] for t in tr) == ts["preemptions"]


def test_request_stats_match_reference_on_one_trace(weights, rng):
    """`Request.stats()` and `Request.queue_wait_s` (ROADMAP C.5): both
    engines' requests report the same keys, the same values apart from the
    two times, and times that are set and consistent (the wait ends before
    the first token); a request not yet admitted has no wait."""
    jp, tp = weights
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in (12, 30, 20)]
    _, _, jr = _serve(JEngine, JRequest, JCFG, jp, prompts)
    _, _, tr = _serve(TEngine, TRequest, TCFG, tp, prompts, device="cpu")
    for j, t in zip(jr, tr):
        js, ts = j.stats(), t.stats()
        assert ts.keys() == js.keys()
        assert {k: ts[k] for k in ts if not _timing(k)} == {k: js[k] for k in js if not _timing(k)}
        assert 0.0 <= ts["queue_wait_s"] <= ts["ttft_s"] and ts["queue_wait_s"] == t.queue_wait_s
    assert TRequest(rid=9, prompt=prompts[0]).queue_wait_s is None


def test_summary_sharded_keys_and_rounding_match_reference():
    """Both packages' ServeStats, filled with the same counters (two
    shards, a block pool, the host tier, unrounded times), give the same
    value under every key both summaries have, shard_block_utilization
    included."""
    shared = ({f.name for f in dataclasses.fields(TStats)}
              & {f.name for f in dataclasses.fields(JStats)})
    vals = {}
    for i, name in enumerate(sorted(shared)):
        kind = type(getattr(TStats(), name))
        vals[name] = (True if kind is bool else 1.0 / (7 + i) + i if kind is float
                      else 3 * i + 1)
    vals.update(shards=2, block_pool_size=64, peak_blocks_in_use=45,
                peak_shard_blocks_in_use=25, block_size=16)
    j, t = JStats(**vals).summary(), TStats(**vals).summary()
    assert "shard_block_utilization" in t
    assert t.keys() == j.keys()
    keys = sorted(set(j) & set(t))
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}


@pytest.mark.parametrize("pool", ["unsharded", "paged", "sharded"])
def test_summary_keys_equal_reference(pool):
    """ROADMAP C.7: both packages' ServeStats filled with the same counters
    (every field both have, the fault, audit and monitor counters nonzero)
    give summaries with exactly the same keys, in the same order, and the
    same values: a contiguous engine (no block pool), a paged one and one
    over two pool shards. Both keep the ``prefill_tokens`` counter; neither
    emits it."""
    shared = ({f.name for f in dataclasses.fields(TStats)}
              & {f.name for f in dataclasses.fields(JStats)})
    vals = {}
    for i, name in enumerate(sorted(shared)):
        kind = type(getattr(TStats(), name))
        vals[name] = (True if kind is bool else 1.0 / (7 + i) + i if kind is float
                      else 3 * i + 1)
    vals.update(shards=1, block_pool_size=0, block_size=16, peak_shard_blocks_in_use=25)
    if pool != "unsharded":
        vals.update(block_pool_size=64, peak_blocks_in_use=45)
    if pool == "sharded":
        vals.update(shards=2)
    j = JStats(**vals).summary()
    t = TStats(**vals).summary()
    assert list(t) == list(j) and t == j
    assert "prefill_tokens" not in t and vals["prefill_tokens"] > 0
    assert ("block_pool_size" in t) == (pool != "unsharded")
    assert ("shards" in t) == (pool == "sharded")


# ---------------------------------------------------------------------------
# no pool-wide copies in the paged tick
# ---------------------------------------------------------------------------

class PoolWideOps(TorchDispatchMode):
    """Records every op, outside the kernel wrappers, whose output has a
    pool-sized leading shape: a flat view or copy of the pool, (P·BS, KV, ·)
    or (KV, P·BS, ·); a logical-order copy, (S, L, KV, ·); or a new tensor
    of the pool's own (P, BS, KV, ·) shape that is not the pool itself (an
    in-place write returns the pool). ``depth`` counts the kernel wrappers
    (functions of ``repro_torch/kernels/*/ops.py``) on the stack: their ops
    are the kernels' plain versions and are allowed."""

    def __init__(self, pool, slots: int):
        super().__init__()
        p, bs, kv = pool.k_codes.shape[:3]
        self.flat = {(p * bs, kv), (kv, p * bs), (slots, pool.max_seq, kv)}
        self.whole = (p, bs, kv)
        self.depth = 0
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.depth == 0:
            inputs = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)}
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                shape = tuple(t.shape)
                fresh = t.untyped_storage().data_ptr() not in inputs
                if shape[:2] in self.flat or shape[:3] in self.flat or (
                        shape[:3] == self.whole and fresh):
                    self.bad.append((str(func), shape))
        return out


def _kernel_wrappers():
    """Every function defined in a ``repro_torch/kernels/*/ops.py`` module."""
    for name in ("flash_decode", "flash_prefill", "hist_topk", "maxpool", "score_est",
                 "selection_fused"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
        for attr, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__ \
                    and not isinstance(fn, type):
                yield fn


def _watch_wrappers(mode: PoolWideOps, monkeypatch) -> None:
    """Replace each kernel wrapper, wherever a port module holds it, by one
    that raises ``mode.depth`` while it runs."""
    wrapped = {}
    for fn in _kernel_wrappers():
        def run(*a, _fn=fn, **kw):
            mode.depth += 1
            try:
                return _fn(*a, **kw)
            finally:
                mode.depth -= 1
        wrapped[fn] = run
    for name, mod in list(sys.modules.items()):
        if not name.startswith("repro_torch") or mod is None:
            continue
        for attr, val in list(vars(mod).items()):
            if callable(val) and val in wrapped:
                monkeypatch.setattr(mod, attr, wrapped[val])


def _one_paged_tick(weights, rng, sharded: bool, monkeypatch, inject=None, **engine_kw):
    """One decode tick of a paged engine (12 blocks of 16 for 2 slots of
    128 positions, so P·BS differs from S·L) holding two prompts, under
    PoolWideOps; ``inject`` wraps the tick's attention call."""
    _, tp = weights
    ctx = init_decode_ctx("cpu") if sharded else None
    eng = TEngine(TCFG, tp, max_seq=128, slots=2, paged=True, block_size=16, num_blocks=12,
                  device="cpu", ctx=ctx, **engine_kw)
    for i, n in enumerate((40, 70)):
        eng.submit(TRequest(rid=i, prompt=rng.integers(0, 500, n).astype(np.int32),
                            max_new_tokens=3))
    eng._admit()
    pool = eng._state.caches[0]
    mode = PoolWideOps(pool, eng.slots)
    _watch_wrappers(mode, monkeypatch)
    if inject is not None:
        import repro_torch.models.blocks as blocks
        name = "sp_salca_decode_paged" if sharded else "salca_decode_attention_paged"
        monkeypatch.setattr(blocks, name, inject(getattr(blocks, name)))
    with mode:
        eng._decode(eng._tokens.copy(), eng._mask.copy())
    return mode


@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "sharded_world1"])
def test_paged_tick_has_no_pool_wide_ops(weights, rng, sharded, monkeypatch):
    mode = _one_paged_tick(weights, rng, sharded, monkeypatch)
    assert mode.depth == 0
    assert not mode.bad, f"pool-wide ops in the paged tick: {mode.bad}"


@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "sharded_world1"])
def test_pool_wide_op_check_catches_an_injected_pool_copy(weights, rng, sharded,
                                                          monkeypatch):
    """The check can fail: a `pool.k_codes.clone()` slipped into the tick's
    attention call is reported (once per layer)."""
    def inject(attend):
        def run(q, pool, *a, **kw):
            pool.k_codes.clone()
            return attend(q, pool, *a, **kw)
        return run

    mode = _one_paged_tick(weights, rng, sharded, monkeypatch, inject)
    pool_shape = mode.whole + (TCFG.resolved_head_dim,)
    assert [s for _, s in mode.bad] == [pool_shape] * TCFG.num_layers


@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "sharded_world1"])
def test_unfused_tick_reports_pool_wide_ops(weights, rng, sharded, monkeypatch):
    """The converse: the reference's unfused baselines make logical-order
    copies of the pool by design, and the same check reports them — the
    engine's ``fused_decode=False`` unsharded; at one rank, where the knob
    steers the unsharded flag as in the reference, ``sharded_fused_decode``
    off (the logical-gather island)."""
    with perf_flags(sharded_fused_decode=not sharded):
        mode = _one_paged_tick(weights, rng, sharded, monkeypatch, fused_decode=False)
    assert mode.depth == 0
    logical = [s for _, s in mode.bad if s[:3] == (2, 128, TCFG.num_kv_heads)]
    assert len(logical) >= 3 * TCFG.num_layers, mode.bad

