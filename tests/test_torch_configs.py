"""Port parity, the dense configs beyond qwen3-0.6b: qwen3-8b,
phi3-medium-14b and gemma3-12b ("LLLLLA", sliding window 1024).

The port's copies of the configs equal the reference's field for field
(mamba2-2.7b's and recurrentgemma-2b's too);
`weights.params_from_numpy` maps the reference's stacked layout (one tree
per position of the layer pattern, stacked over the periods, then a tail)
to one dict per layer (recurrentgemma at 8 layers too); the registry serves
every config, the enc-dec family and the frontends included, and refuses
what the port has no path for;
gemma3 refuses chunked prefill (the reference's message) and the
block-sharded tick (the port's, when the engine is built); and
`ServingEngine` on the reduced configs gives the JAX engine's greedy
tokens: qwen3-8b and phi3-medium-14b on the paged pool, gemma3 with the host
tier under pressure and with prefix sharing and the persistent prefix cache
(its hits equal, no zero-prefill adoption: the reference allows that only
where chunked prefill runs). Both sides compute in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_code_ticks_close, record_code_ticks, tn
from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.models import blocks as jB
from repro.models import get_model as jget_model
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.configs import ARCH_NAMES, get_config as tget_config
from repro_torch.core.cache import PagedSalcaCache, SalcaCache
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.models import blocks as tB
from repro_torch.models import get_model as tget_model
from repro_torch.models.registry import unsupported_reason
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import init_lm_params, params_from_numpy

NEW_ARCHS = ("qwen3-8b", "phi3-medium-14b", "gemma3-12b")
RECURRENT_ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")
FRONTEND_ARCHS = ("whisper-small", "llava-next-mistral-7b")


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype="float32", **kw)
                 for get in (jget_config, tget_config))


_WEIGHTS: dict = {}


def _weights(arch, **kw):
    """The JAX init tree of ``arch``'s reduced f32 config (``kw`` replaced)
    and the port's conversion of it; one per config in this module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch, **kw)
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        _WEIGHTS[key] = (jcfg, tcfg, jp,
                         params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu"))
    return _WEIGHTS[key]


@pytest.mark.parametrize("arch", ("qwen3-0.6b",) + NEW_ARCHS + RECURRENT_ARCHS + FRONTEND_ARCHS)
def test_config_copies_equal_the_reference(arch):
    """Every field of the full and the reduced config (the SSM, RG-LRU,
    enc-dec and frontend fields included), the layer kinds and the ring
    sizes of both attention kinds equal the reference's; the port lists
    every architecture of the reference, in its order, and refuses an
    unknown name."""
    jc, tc = jget_config(arch), tget_config(arch)
    for j, t in ((jc, tc), (jc.reduced(), tc.reduced())):
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        assert td == {k: jd[k] for k in td}
        assert t.block_kinds() == j.block_kinds()
        for kind in "AL":
            for max_seq in (32, 64, 65, 256, 1024, 1025, 8192):
                assert tB.ring_size(t, kind, max_seq) == jB.ring_size(j, kind, max_seq)
    assert ARCH_NAMES == JARCH_NAMES
    with pytest.raises(KeyError, match="available"):
        tget_config("whisper-large")


@pytest.mark.parametrize("arch,layers", [("gemma3-12b", 12), ("gemma3-12b", 8),
                                         ("qwen3-8b", 2), ("phi3-medium-14b", 2),
                                         ("recurrentgemma-2b", 8)],
                         ids=["gemma3_two_periods", "gemma3_period_and_tail", "qwen3_8b",
                              "phi3_medium", "recurrentgemma_periods_and_tail"])
def test_params_from_numpy_maps_periods_and_tail(arch, layers):
    """Layer l of the port's tree is ``periods[l % P][l // P]`` of the
    reference's, then the tail (gemma3 at 8 layers: one period and an "LL"
    tail; recurrentgemma at 8: two "RRL" periods and an "RR" tail), leaf for
    leaf; the whole model's prefill then gives the reference's logits, with
    a W-slot ring in each "L" layer and a recurrent state in each "R"
    layer; a tree of another depth is refused. `init_lm_params` makes the
    same tree (keys, shapes, an untied head where the config has one)."""
    jcfg, tcfg, jp, tp = _weights(arch, num_layers=layers)
    pattern = jcfg.layer_pattern
    n_periods = layers // len(pattern)
    assert len(tp["layers"]) == layers
    for i, layer in enumerate(tp["layers"]):
        if i < n_periods * len(pattern):
            want = jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i // len(pattern)],
                                          jp["periods"][i % len(pattern)])
        else:
            want = jp["tail"][i - n_periods * len(pattern)]
        got = jax.tree_util.tree_map(lambda t: t.numpy(), layer)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, want))
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    prompt = np.random.default_rng(layers).integers(0, jcfg.vocab_size, (1, 90)).astype(np.int32)
    jl, _ = jget_model(jcfg).prefill(jp, {"tokens": jnp.asarray(prompt)}, 128)
    tl, ts = tget_model(tcfg).prefill(tp, torch.from_numpy(prompt), 128)
    np.testing.assert_allclose(tn(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for c, kind in zip(ts.caches, tcfg.block_kinds()):
        if kind in "AL":
            assert c.max_seq == tB.ring_size(tcfg, kind, 128)
        else:
            assert isinstance(c, tB.RECURRENT) and c.h.shape[0] == 1
    with pytest.raises(ValueError, match="config expects"):
        params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                          dataclasses.replace(tcfg, num_layers=layers + 1), "cpu")
    init = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), init)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    assert ("head" in init["embed"]) == (not tcfg.tie_embeddings)


def test_registry_admits_global_and_local_layers_only():
    """Every config is served, full and reduced, "S" and "R" layers, the
    enc-dec family (whisper-small) and the vision frontend (llava-next, and
    a vision frontend ahead of gemma3's rings) included: `get_model` builds
    each one's API, the enc-dec family's with the reference's fields (the
    paged and chunked ones None). What remains refused is refused with its
    reason: a family the port does not know, an MoE flag outside the
    "moe" family, a layer kind the reference does not have, the audio
    frontend without the enc-dec family, the enc-dec family without it or
    with non-global layers."""
    for arch in ARCH_NAMES:
        for cfg in (tget_config(arch), tget_config(arch).reduced()):
            assert unsupported_reason(cfg) is None
            api = tget_model(cfg)
            assert (api.init_paged_state is None) == cfg.encdec
            assert (api.prefill_chunk_unsupported is None) == cfg.encdec
    base = tget_config("gemma3-12b")
    whisper = tget_config("whisper-small")
    assert unsupported_reason(dataclasses.replace(base, frontend="vision")) is None
    for cfg, why in ((dataclasses.replace(base, moe=True), "MoE FFN"),
                     (dataclasses.replace(base, family="diffusion"), "serves the families"),
                     (dataclasses.replace(base, layer_pattern="LXA"), "layer pattern"),
                     (dataclasses.replace(base, frontend="audio"), "audio frontend"),
                     (dataclasses.replace(whisper, frontend="none"), "audio frontend"),
                     (dataclasses.replace(whisper, layer_pattern="LA"), "layer pattern")):
        reason = unsupported_reason(cfg)
        assert reason is not None and why in reason
        with pytest.raises(NotImplementedError, match=why):
            tget_model(cfg)


def test_gemma3_refuses_chunks_and_serves_the_sharded_tick():
    """Chunked prefill: the reference's refusal, message for message (with
    static heavy channels, so the layer pattern is the reason). The
    block-sharded tick over rings: the engine builds with its rings split
    by rows (the sequence-sharded flat tick) and serves a request; a pool
    whose window spans max_seq has no ring and builds."""
    jcfg, tcfg, jp, tp = _weights("gemma3-12b", salca_static_channels=True)
    kw = dict(max_seq=256, slots=2, paged=True, block_size=16, prefill_chunk=32)
    with pytest.raises(ValueError) as jerr:
        JEngine(jcfg, jp, **kw)
    with pytest.raises(ValueError) as terr:
        TEngine(tcfg, tp, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert "non-global layers" in str(terr.value)
    ctx = init_decode_ctx("cpu")
    eng = TEngine(tcfg, tp, max_seq=256, slots=2, paged=True, block_size=16, device="cpu",
                  ctx=ctx)
    rings = [c for c in eng._state.caches if not isinstance(c, PagedSalcaCache)]
    assert len(rings) == tcfg.block_kinds().count("L") and rings[0].max_seq == 64
    req = TRequest(rid=0, prompt=np.arange(90, dtype=np.int32) % tcfg.vocab_size,
                   max_new_tokens=3)
    eng.submit(req)
    stats = eng.run()
    assert stats.completed == 1 and len(req.output) == 3 and req.stop_reason == "length"
    eng = TEngine(tcfg, tp, max_seq=64, slots=2, paged=True, block_size=16, device="cpu",
                  ctx=ctx)
    assert all(isinstance(c, PagedSalcaCache) for c in eng._state.caches)


def _serve(engine_cls, req_cls, cfg, params, prompts, new_tokens=6, **kw):
    eng = engine_cls(cfg, params, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = record_code_ticks(eng, cfg)
    stats = eng.run()
    return eng, reqs, stats, ticks


@pytest.mark.parametrize("arch,pool", [("qwen3-8b", "int8"), ("phi3-medium-14b", "int8"),
                                       ("gemma3-12b", "fp16")])
def test_dense_engine_matches_reference(arch, pool):
    """Three requests of 150, 200 and 170 tokens × 6 new tokens on two slots
    of the paged pool at max_seq 256 (k = 128: a sparse tick), blocks reused
    after the first completion; gemma3 on an fp16 pool beside its int8 rings
    (every prompt wraps them): tokens and tick count equal, logits within
    tolerance, the pool drained."""
    jcfg, tcfg, jp, tp = _weights(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (150, 200, 170)]
    kw = dict(max_seq=256, slots=2, paged=True, block_size=32, num_blocks=16,
              kv_pool_dtype=pool)
    _, jr, js, jticks = _serve(JEngine, JRequest, jcfg, jp, prompts, **kw)
    te, tr, ts, tticks = _serve(TEngine, TRequest, tcfg, tp, prompts, device="cpu", **kw)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert ts.ticks == js.ticks
    assert_code_ticks_close(jticks, tticks)
    assert sorted(te._free_blocks) == list(range(16)) and te.check_invariants().ok


def test_gemma3_host_spill_waves_match_reference():
    """A 100-token prompt (7 blocks) into a 4-block pool at max_seq 128,
    beside rings of 64: it admits in waves, demoting the "A" layers' blocks
    to the host (the rings never move), and decodes to completion with the
    reference's tokens, counts and transfer bytes (the paged layers' bytes
    only); nothing leaks."""
    jcfg, tcfg, jp, tp = _weights("gemma3-12b")
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, 100).astype(np.int32)
    kw = dict(max_seq=128, slots=1, paged=True, block_size=16, num_blocks=4, host_spill=True,
              demote_after=10 ** 6, spill_keep_recent=2)
    je, jr, js, _ = _serve(JEngine, JRequest, jcfg, jp, [prompt], new_tokens=4, **kw)
    te, tr, ts, _ = _serve(TEngine, TRequest, tcfg, tp, [prompt], new_tokens=4, device="cpu",
                           **kw)
    assert tr[0].output == jr[0].output and tr[0].stop_reason == "length"
    assert ts.demotions >= 3 and ts.overflows == 0
    for key in ("completed", "demotions", "promotions", "pcie_bytes", "peak_cold_blocks",
                "ticks"):
        assert getattr(ts, key) == getattr(js, key), key
    n_paged = tcfg.block_kinds().count("A")
    assert te._block_bytes == je._block_bytes == n_paged * sum(
        t.numel() * t.element_size() for t in te.api.read_block(te._state, 0)[0])
    assert ts.pcie_bytes == (ts.demotions + ts.promotions) * te._block_bytes
    assert not te._spilled and te._alloc.total_free == 4


CACHE_COUNTERS = ("cache_hits", "cache_hit_blocks", "zero_prefill_hits", "prefix_hits",
                  "shared_blocks", "cow_copies", "cache_evictions", "peak_cache_blocks",
                  "admissions", "completed")


def test_gemma3_prefix_cache_matches_reference():
    """Two users' prompts after a common 100-token header, each served
    twice, one at a time (static heavy sets, prefix sharing and the
    persistent cache): every visit after the first hits the cache as the
    reference's does; a repeated prompt is prefilled again (no zero-prefill
    adoption where chunked prefill is refused) with its rings rebuilt;
    tokens, logits and counters equal the JAX engine's, and the flushed pool
    drains."""
    jcfg, tcfg, jp, tp = _weights("gemma3-12b", salca_static_channels=True)
    rng = np.random.default_rng(4)
    header = rng.integers(0, jcfg.vocab_size, 100).astype(np.int32)
    users = [np.concatenate([header, rng.integers(0, jcfg.vocab_size, 37).astype(np.int32)])
             for _ in range(2)]
    kw = dict(max_seq=256, slots=2, paged=True, block_size=16, num_blocks=24,
              prefix_sharing=True, prefix_cache=True)
    runs = []
    for engine_cls, req_cls, cfg, params, extra in (
            (JEngine, JRequest, jcfg, jp, {}), (TEngine, TRequest, tcfg, tp, {"device": "cpu"})):
        eng = engine_cls(cfg, params, **kw, **extra)
        ticks = record_code_ticks(eng, cfg)
        outs = []
        for i, prompt in enumerate(users + users):
            req = req_cls(rid=i, prompt=prompt.copy(), max_new_tokens=5)
            eng.submit(req)
            eng.run()
            assert req.stop_reason == "length"
            outs.append(req.output)
        runs.append((eng, outs, ticks))
    (je, jouts, jticks), (te, touts, tticks) = runs
    assert touts == jouts
    assert_code_ticks_close(jticks, tticks)
    for key in CACHE_COUNTERS:
        assert getattr(te.stats, key) == getattr(je.stats, key), key
    assert te.stats.cache_hits == 3 and te.stats.zero_prefill_hits == 0
    assert isinstance(te._state.caches[0], SalcaCache)
    assert te.check_invariants().ok
    te.flush_prefix_cache()
    assert sorted(te._free_blocks) == list(range(24))
