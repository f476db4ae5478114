"""Port parity, the engines over the sequence-sharded flat tick and
``ring_local_cache``, against the JAX engine.

* `ServingEngine(paged=False, ctx=world1)` on qwen3-0.6b and gemma3-12b
  and `ServingEngine(paged=True, ctx=world1)` on gemma3-12b (block-sharded
  "A" pools, sequence-sharded rings) against the JAX engine on a one-device
  mesh: tokens identical, tick logits by
  `_torch_bridge.assert_code_ticks_close`.
* The same three at two gloo ranks (spawned, `_torch_dist_worker.py
  sp_engine`) against the JAX unsharded engine: tokens equal up to each
  request's first tick whose rows kept more than the unsharded capacity
  k_cap, which the flat tick's per-rank capacity does not cut (printed).
* `perf_flags(ring_local_cache=False)` (gemma3's "L" layers at full context
  under the window mask) paged and contiguous, unsharded and at one rank,
  against the JAX engine under the same flag.
* The ``ctx`` validation, the flag's name check, and the launcher's
  ``--sharded`` without ``--paged``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import assert_code_ticks_close, record_code_ticks
from repro import compat
from repro import flags as jflags
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.models.blocks import DecodeCtx as JCtx
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch import flags as tflags
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed.sharding import DecodeCtx, init_decode_ctx
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world1():
    """The in-process world of one rank (gloo over a HashStore)."""
    return init_decode_ctx("cpu")


def _spawn(task, inp, world, tmp_path):
    """Run ``world`` ranks of `_torch_dist_worker.py` over a FileStore in
    ``tmp_path``; returns each rank's results."""
    torch.save(inp, tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               task, str(tmp_path), str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


def _cfgs(arch):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype="float32")
                 for get in (jget_config, tget_config))


ARCHS = ("qwen3-0.6b", "gemma3-12b")
PROMPT_LENS, NEW_TOKENS = (100, 150, 40), 5


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        out[arch] = (jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu"))
    return out


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


# the JAX engines' jitted steps that close over the model API and max_seq
# only, shared by the JAX engines of this file with the same config, pool
# and flag (jit keys its compilations on the argument shapes; the flag is
# read at trace time, so it is part of the key)
_JAX_STEPS: dict = {}


def _share_jax_steps(eng, cfg, paged: bool) -> None:
    flag = jflags.PERF.ring_local_cache
    for name, key in (("_prefill", (cfg.name, flag)), ("_write", (cfg.name, paged, flag)),
                      ("_reset", (cfg.name, paged, flag)),
                      ("_map_block", (cfg.name, paged, flag))):
        if hasattr(eng, name):
            setattr(eng, name, _JAX_STEPS.setdefault((name,) + key, getattr(eng, name)))


def _serve(engine_cls, req_cls, cfg, params, **kw):
    eng = engine_cls(cfg, params, max_seq=256, slots=2, **kw)
    if engine_cls is JEngine:
        _share_jax_steps(eng, cfg, kw.get("paged", False))
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    ticks = record_code_ticks(eng, cfg)
    stats = eng.run()
    return [r.output for r in reqs], ticks, stats, eng


ENGINES = {"qwen3_contiguous": ("qwen3-0.6b", dict(paged=False)),
           "gemma3_contiguous": ("gemma3-12b", dict(paged=False)),
           "gemma3_paged": ("gemma3-12b", dict(paged=True, block_size=16))}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_world1_vs_jax_one_device_mesh(weights, world1, name):
    """The port's engine with ``ctx`` at one rank against the JAX engine
    with a one-device mesh ctx: greedy tokens identical, every tick's
    logits within the code-step policy; the contiguous engine counts one
    pool shard, as the reference's."""
    arch, kw = ENGINES[name]
    jcfg, tcfg = _cfgs(arch)
    jp, tp = weights[arch]
    mesh = compat.make_mesh((1,), ("seq",))
    jout, jticks, _, _ = _serve(JEngine, JRequest, jcfg, jp, ctx=JCtx(axis="seq", mesh=mesh),
                                **kw)
    tout, tticks, stats, eng = _serve(TEngine, TRequest, tcfg, tp, device="cpu", ctx=world1,
                                      **kw)
    assert tout == jout
    assert_code_ticks_close(jticks, tticks)
    assert stats.completed == 3 and eng.n_shards == stats.shards == 1


def _compared_tokens(counts, ticks, k_cap, n_req) -> tuple[list, list]:
    """Where a slot's rows kept more than ``k_cap`` tokens (summed over the
    ranks, in any "A" layer) the unsharded tick cuts and the flat tick does
    not: per request the number of its tokens made before its first such
    tick, and the (tick, rid) of those ticks."""
    limit, over = [None] * n_req, []
    for tick, (cs, (_, _, who)) in enumerate(zip(zip(*counts), ticks)):
        total = None if cs[0] is None else sum(c.to(torch.int64) for c in cs)
        for slot, rid, j in who:
            if total is not None and int(total[:, slot].max()) > k_cap:
                over.append((tick, rid))
                if limit[rid] is None:
                    limit[rid] = j
    return limit, over


def test_engines_two_gloo_ranks_vs_jax_unsharded(weights, tmp_path):
    """The three engines of ENGINES over two gloo ranks against the JAX
    unsharded engine: greedy tokens equal up to each request's first tick
    whose rows kept more than k_cap (printed; none on qwen3, whose k_cap is
    the whole context), all of them where none did; ranks in lockstep (the
    same tokens and logits every tick)."""
    runs, refs = [], []
    for name, (arch, kw) in ENGINES.items():
        jcfg, _ = _cfgs(arch)
        jout, _, _, _ = _serve(JEngine, JRequest, jcfg, weights[arch][0], **kw)
        refs.append((name, jout))
        runs.append((arch, dict(max_seq=256, slots=2, **kw), _prompts(jcfg.vocab_size),
                     NEW_TOKENS, {}))
    res = _spawn("sp_engine", dict(runs=runs, weights={a: w[1] for a, w in weights.items()}),
                 2, tmp_path)
    for i, (name, jout) in enumerate(refs):
        r0, r1 = res[0][i], res[1][i]
        assert r0["outputs"] == r1["outputs"]
        for (m0, l0, _), (m1, l1, _) in zip(r0["ticks"], r1["ticks"]):
            np.testing.assert_array_equal(m0, m1)
            assert torch.equal(l0, l1)
        k_cap = _k_cap(ENGINES[name][0])
        limit, over = _compared_tokens([r0["counts"], r1["counts"]], r0["ticks"], k_cap,
                                       len(jout))
        print(f"{name}: (tick, request) with rows over k_cap {k_cap}: {over or 'none'}; "
              f"tokens compared per request: {limit} (None: all)")
        for rid, (t, j) in enumerate(zip(r0["outputs"], jout)):
            n = len(j) if limit[rid] is None else limit[rid]
            assert t[:n] == j[:n], (name, rid, t, j)
        if name == "qwen3_contiguous":
            assert not over


def _k_cap(arch) -> int:
    """The unsharded tick's capacity on the engines' state (`decode_salca_params`)."""
    from repro_torch.models.blocks import ring_size, salca_params_for
    cfg = _cfgs(arch)[1]
    return salca_params_for(cfg, max(ring_size(cfg, cfg.block_kinds()[0], 256), 128)).k_cap


@pytest.mark.parametrize("paged,sharded", [(True, False), (False, False), (False, True),
                                           (True, True)],
                         ids=["paged", "contiguous", "contiguous_world1", "paged_world1"])
def test_ring_local_cache_off_vs_jax(weights, world1, paged, sharded):
    """gemma3-12b.reduced() under ``ring_local_cache=False``: every "L"
    layer keeps max_seq rows (no ring), its decode masks to the window, and
    the engines match the JAX engine under the same flag: tokens, tick
    logits (code-step policy)."""
    jcfg, tcfg = _cfgs("gemma3-12b")
    jp, tp = weights["gemma3-12b"]
    kw = dict(paged=True, block_size=16) if paged else dict(paged=False)
    jctx = JCtx(axis="seq", mesh=compat.make_mesh((1,), ("seq",))) if sharded else None
    with jflags.perf_flags(ring_local_cache=False):
        jout, jticks, _, _ = _serve(JEngine, JRequest, jcfg, jp, ctx=jctx, **kw)
    with tflags.perf_flags(ring_local_cache=False):
        tout, tticks, _, eng = _serve(TEngine, TRequest, tcfg, tp, device="cpu",
                                      ctx=world1 if sharded else None, **kw)
    assert all(c.max_seq == 256 for c in eng._state.caches)
    assert tout == jout
    assert_code_ticks_close(jticks, tticks)


def test_flat_ctx_validation(weights, world1):
    """``max_seq`` or a ring that does not split across the ranks raises
    with the reason; the reference's refusals without ``paged=True`` stay;
    ``set_flags`` takes ``ring_local_cache`` and still refuses a name the
    port does not have."""
    _, tp = weights["gemma3-12b"]
    _, tcfg = _cfgs("gemma3-12b")
    three = DecodeCtx(world1.group, 0, 3, "gloo")
    with pytest.raises(ValueError, match="ring of 64 does not split evenly"):
        TEngine(tcfg, tp, max_seq=258, device="cpu", ctx=three)
    with pytest.raises(ValueError, match="max_seq 250 does not split evenly"):
        TEngine(dataclasses.replace(tcfg, local_window=0), tp, max_seq=250, device="cpu",
                ctx=DecodeCtx(world1.group, 0, 4, "gloo"))
    with pytest.raises(ValueError, match="prefix_sharing requires paged=True"):
        TEngine(tcfg, tp, max_seq=256, device="cpu", ctx=world1, prefix_sharing=True)
    tflags.set_flags(ring_local_cache=True)
    with pytest.raises(AttributeError, match="unknown perf flag"):
        tflags.set_flags(hist_scatter_add=False)


def test_launcher_sharded_without_paged_serves_the_flat_tick(monkeypatch, capsys):
    """``--sharded`` without ``--paged``: the contiguous engine over a
    one-rank ctx, and it serves."""
    from repro_torch.launch import serve as launcher
    built = {}
    real = launcher.ServingEngine

    def engine(*a, **kw):
        built.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(launcher, "ServingEngine", engine)
    monkeypatch.setattr(sys, "argv", ["serve", "--local", "--device", "cpu", "--sharded",
                                      "--requests", "2", "--prompt-len", "40",
                                      "--new-tokens", "3"])
    launcher.main()
    assert built["paged"] is False and built["ctx"].world_size == 1
    assert '"completed": 2' in capsys.readouterr().out
