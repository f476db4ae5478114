"""Port parity, sliding-window ("L") layers: gemma3-12b.reduced()'s ring
caches in prefill and across a wrap in decode, the paged "L" layer whose
window spans the context, the tick's `SalcaParams`, and `ServingEngine` on
gemma3 against the JAX engine on the paged and the contiguous pool.

gemma3-12b.reduced() has 12 layers, "LLLLLA" twice, a window of W = 64,
head dim 32; both sides compute in float32. Ring leaves are compared bit
for bit on inputs that give both sides the same q, k and v: in prefill the
block's projection returns the same numpy arrays on both sides; in decode
the activations and q/k/v weights are small integers, the q/k norms are off
and RoPE is the identity on both sides, so every product and sum is exact.
The leaves then test the ring's slot arithmetic and the quantizer alone.
Attention outputs and activations agree to 1e-5 (float32 summed in other
orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import (
    CACHE_FIELDS, POOL_FIELDS, assert_code_ticks_close, record_code_ticks, tn)
from repro.configs import get_config as jget_config
from repro.models import blocks as jB
from repro.models import get_model as jget_model
from repro.models import transformer as jT
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.core.cache import PagedSalcaCache, SalcaCache
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tB
from repro_torch.models import transformer as tT
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    return tuple(dataclasses.replace(get("gemma3-12b").reduced(), dtype="float32", **kw)
                 for get in (jget_config, tget_config))


JCFG, TCFG = _cfgs()
W = TCFG.local_window


def _torch_tree(node):
    if isinstance(node, dict):
        return {k: _torch_tree(v) for k, v in node.items()}
    return torch.from_numpy(np.array(node, np.float32))


def _fields_equal(jc, tc, fields):
    for f in fields:
        j = np.asarray(getattr(jc, f))
        np.testing.assert_array_equal(tn(getattr(tc, f), j), j, err_msg=f)


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


@pytest.mark.parametrize("kind,t,static", [
    ("L", 40, False), ("L", W, False), ("L", 150, False), ("L", 150, True), ("A", 150, False)],
    ids=["L_shorter", "L_equal", "L_longer", "L_longer_static", "A"])
def test_block_prefill_ring_leaves_bitwise(monkeypatch, kind, t, static):
    """A prompt shorter than, equal to and longer than the window: the "L"
    layer's cache is a ring of W slots holding the prompt's last W tokens at
    slot j % W, its leaves (codes, scales, features, heavy set, length) bit
    for bit the reference's `block_prefill`'s, per-input and static heavy
    sets; the "A" layer keeps max_seq rows. The activations, through the
    windowed attention, within 1e-5."""
    jcfg, tcfg = _cfgs(salca_static_channels=static)
    max_seq = 256
    jp = jB.block_init(jax.random.PRNGKey(1), kind, jcfg)
    tp = _torch_tree(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(t)
    h, kv, hd = jcfg.num_heads, jcfg.num_kv_heads, jcfg.resolved_head_dim
    x = rng.standard_normal((1, t, jcfg.d_model)).astype(np.float32)
    q, k, v = (rng.standard_normal((1, t, n, hd)).astype(np.float32) for n in (h, kv, kv))
    monkeypatch.setattr(jB, "qkv_project",
                        lambda *a, **kw: tuple(jnp.asarray(z) for z in (q, k, v)))
    monkeypatch.setattr(tB, "qkv_project",
                        lambda *a, **kw: tuple(torch.from_numpy(z.copy()) for z in (q, k, v)))
    jx, jcache = jB.block_prefill(jp, kind, jnp.asarray(x), jcfg, max_seq)
    tx, tcache = tB.block_prefill(tp, torch.from_numpy(x), tcfg, max_seq, kind)
    assert tcache.max_seq == (W if kind == "L" else max_seq) == jcache.k_codes.shape[1]
    _fields_equal(jcache, tcache, CACHE_FIELDS)
    assert int(tcache.length[0]) == min(t, tcache.max_seq)
    np.testing.assert_allclose(tn(tx), np.asarray(jx), **TOL)


def _exact_attn(rng, cfg):
    """Attention weights whose q/k/v products are exact in float32: small
    integers (a sum of 128 products of at most 4 stays an integer below
    2^24); wo is any float."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    npw = {"wq": rng.integers(-2, 3, (d, h, hd)), "wk": rng.integers(-2, 3, (d, kv, hd)),
           "wv": rng.integers(-2, 3, (d, kv, hd)),
           "wo": rng.standard_normal((h * hd, d)) * 0.05}
    npw = {k: v.astype(np.float32) for k, v in npw.items()}
    return ({k: jnp.asarray(v) for k, v in npw.items()},
            {k: torch.from_numpy(v.copy()) for k, v in npw.items()})


def _no_rope(monkeypatch):
    monkeypatch.setattr(jB, "rope", lambda x, positions, theta: x)
    monkeypatch.setattr(tattn, "rope", lambda x, positions, theta: x)


def _decode_steps(rng, jattn, tattn_p, jcache, tcache, cfgs, pos, actives, decode, fields):
    """Run one decode step per entry of ``actives`` on both sides with the
    same integer activations; the leaves bit for bit and the outputs within
    1e-5 after every step. Returns the final positions."""
    jcfg, tcfg = cfgs
    jsalca = jB.salca_params_for(jcfg, 128)
    tsalca = tB.salca_params_for(tcfg, 128)
    pos = np.asarray(pos, np.int32)
    for act in actives:
        act = np.asarray(act, bool)
        x = rng.integers(-2, 3, (len(pos), jcfg.d_model)).astype(np.float32)
        jo, jcache = jB._attn_decode(jattn, jnp.asarray(x), jcache, jcfg, jnp.asarray(pos),
                                     jcfg.local_window, False, jB.DecodeCtx(), jsalca,
                                     jnp.asarray(act))
        to = decode(tattn_p, torch.from_numpy(x), tcache, tcfg, torch.from_numpy(pos.copy()),
                    tsalca, torch.from_numpy(act))
        _fields_equal(jcache, tcache, fields)
        np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
        pos = pos + act
    return pos


@pytest.mark.parametrize("state", ["contiguous", "paged"])
def test_ring_decode_across_a_wrap_bitwise(monkeypatch, state):
    """An "L" layer's ring in the contiguous state and in the paged state
    (where it stays a contiguous W-slot cache beside the "A" layers' block
    pools): 30 ticks over three slots whose cursors start at 40, 5 and 60
    (slot 2 masked off for the first 8 ticks, its writes dropped), so slots
    0 and 2 wrap past W. Every leaf bit for bit after every tick."""
    jcfg, tcfg = cfgs = _cfgs(qk_norm=False)
    _no_rope(monkeypatch)
    rng = np.random.default_rng(3)
    jattn, tattn_p = _exact_attn(rng, jcfg)
    slots, max_seq = 3, 256
    if state == "contiguous":
        jcache = jB.block_init_state("L", slots, max_seq, jcfg)
        tstate = tT.lm_init_state(tcfg, slots, max_seq, "cpu")
    else:
        jcache = jB.block_init_paged_state("L", slots, max_seq, jcfg, 16, 48)
        tstate = tT.lm_init_paged_state(tcfg, slots, max_seq, 16, 48, "cpu")
    kinds = tcfg.block_kinds()
    for c, kind in zip(tstate.caches, kinds):
        if kind == "L" or state == "contiguous":
            assert isinstance(c, SalcaCache) and c.max_seq == (W if kind == "L" else max_seq)
        else:
            assert isinstance(c, PagedSalcaCache) and c.max_seq == max_seq
    tcache = tstate.caches[0]
    heavy = np.sort(rng.permuted(np.tile(np.arange(jcfg.resolved_head_dim),
                                         (slots, jcfg.num_kv_heads, 1)), axis=-1)
                    [..., :tcache.heavy_idx.shape[-1]], axis=-1).astype(np.int32)
    jcache = jcache._replace(heavy_idx=jnp.asarray(heavy))
    tcache.heavy_idx.copy_(torch.from_numpy(heavy))
    actives = [(True, True, t >= 8) for t in range(30)]
    pos = _decode_steps(rng, jattn, tattn_p, jcache, tcache, cfgs, (40, 5, 60), actives,
                        lambda *a: tB.attn_decode_contiguous(*a, kind="L"), CACHE_FIELDS)
    assert (pos > W).tolist() == [True, False, True]
    assert tcache.length.tolist() == [W, 35, W]


def test_paged_l_layer_within_its_window_is_dense(monkeypatch):
    """At max_seq <= W an "L" layer is a block pool like an "A" layer, read
    densely over every valid key with no Salca (the reference's window mask
    keeps them all): the pool's leaves bit for bit the reference's after
    every tick, no selection recorded."""
    jcfg, tcfg = cfgs = _cfgs(qk_norm=False)
    _no_rope(monkeypatch)
    rng = np.random.default_rng(4)
    jattn, tattn_p = _exact_attn(rng, jcfg)
    max_seq, bs, slots = W, 16, 2
    tstate = tT.lm_init_paged_state(tcfg, slots, max_seq, bs, 8, "cpu")
    assert all(isinstance(c, PagedSalcaCache) for c in tstate.caches)
    tpool = tstate.caches[0]
    jpool = jB.block_init_paged_state("L", slots, max_seq, jcfg, bs, 8)
    pt = np.arange(8, dtype=np.int32).reshape(slots, 4)[:, ::-1].copy()
    heavy = np.sort(rng.permuted(np.tile(np.arange(jcfg.resolved_head_dim),
                                         (slots, jcfg.num_kv_heads, 1)), axis=-1)
                    [..., :tpool.heavy_idx.shape[-1]], axis=-1).astype(np.int32)
    jpool = jpool._replace(page_table=jnp.asarray(pt), refcount=jnp.ones(8, jnp.int32),
                           heavy_idx=jnp.asarray(heavy))
    tpool.page_table.copy_(torch.from_numpy(pt))
    tpool.refcount.fill_(1)
    tpool.heavy_idx.copy_(torch.from_numpy(heavy))

    def no_salca(*a, **kw):
        raise AssertionError("an 'L' layer ran Salca")

    monkeypatch.setattr(tB, "salca_decode_attention_paged", no_salca)
    actives = [(True, t % 3 != 1) for t in range(10)]
    _decode_steps(rng, jattn, tattn_p, jpool, tpool, cfgs, (10, 50), actives,
                  lambda p, x, c, cfg, pos, sp, act: tB.attn_decode_paged(
                      p, x, c, cfg, pos, sp, act, None, "L"), POOL_FIELDS)
    assert int(tpool.sel_hist.abs().sum()) == 0


@pytest.mark.parametrize("max_seq", [256, 1024])
def test_decode_salca_params_come_from_the_first_cache(monkeypatch, weights, max_seq):
    """The reference's `lm_decode_step` takes the tick's `SalcaParams` from
    the first attention cache of its state: for "LLLLLA" a ring of W = 64
    slots, so the global layers select with k = k_cap = 128 from max(W,
    128), not from max_seq (256: k 128, k_cap 256; 1024: k 256, k_cap
    384). The port's tick passes the same (k, k_cap) to every layer."""
    want = (128, 128)
    jp, tp = weights
    seen = {"jax": set(), "torch": set()}
    real_j, real_t = jB.block_decode, tB.block_decode

    def jwrap(params, kind, x, state, cfg, pos, ctx, salca, active=None):
        seen["jax"].add((salca.k, salca.k_cap))
        return real_j(params, kind, x, state, cfg, pos, ctx, salca, active)

    def twrap(params, x, pool, cfg, pos, salca, active, ctx=None, kind="A"):
        seen["torch"].add((salca.k, salca.k_cap))
        return real_t(params, x, pool, cfg, pos, salca, active, ctx, kind)

    monkeypatch.setattr(jB, "block_decode", jwrap)
    monkeypatch.setattr(tB, "block_decode", twrap)
    nb = 2 * max_seq // 16
    token, active = np.array([3, 7], np.int32), np.array([True, False])
    jT.lm_decode_step(jp, JCFG, jT.lm_init_paged_state(JCFG, 2, max_seq, 16, nb),
                      jnp.asarray(token), None, jnp.asarray(active))
    tT.lm_decode_step(tp, TCFG, tT.lm_init_paged_state(TCFG, 2, max_seq, 16, nb, "cpu"),
                      torch.from_numpy(token), torch.from_numpy(active))
    from_max_seq = tB.salca_params_for(TCFG, max_seq)
    assert seen["jax"] == seen["torch"] == {want}
    assert want != (from_max_seq.k, from_max_seq.k_cap)
    # an all-"A" stack's first cache is a global one: the numbers follow max_seq
    qcfg = tget_config("qwen3-0.6b").reduced()
    sp = tT.decode_salca_params(qcfg, tT.lm_init_paged_state(qcfg, 2, max_seq, 16, nb, "cpu"))
    assert (sp.k, sp.k_cap) == (from_max_seq.k, from_max_seq.k_cap)


def _serve(engine_cls, req_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, max_seq=256, slots=2, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = record_code_ticks(eng, cfg)
    stats = eng.run()
    return eng, reqs, stats, ticks


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_gemma3_engine_matches_reference(weights, paged):
    """Three requests of 100, 150 and 40 tokens (two wrap their rings) × 6
    new tokens on two slots at max_seq 256 (the "A" layers select k = 128
    of up to 256): greedy tokens equal the JAX engine's, every tick's logits
    within `_torch_bridge.assert_code_ticks_close`'s tolerance, the same tick
    count; the paged engine drains."""
    jp, tp = weights
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32) for n in (100, 150, 40)]
    kw = dict(paged=True, block_size=16) if paged else dict(paged=False)
    _, jr, js, jticks = _serve(JEngine, JRequest, JCFG, jp, prompts, **kw)
    te, tr, ts, tticks = _serve(TEngine, TRequest, TCFG, tp, prompts, device="cpu", **kw)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert all(r.stop_reason == "length" for r in tr)
    assert len(tticks) == ts.ticks == js.ticks
    assert_code_ticks_close(jticks, tticks)
    if paged:
        assert sorted(te._free_blocks) == list(range(te.num_blocks))
        assert te.check_invariants().ok
