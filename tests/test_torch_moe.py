"""Port parity, the MoE family (granite-moe-3b-a800m, arctic-480b) against
the JAX package on the CPU.

* `models.moe.moe_apply` under the four settings of ``moe_flat_dispatch``
  and ``moe_gather_dispatch``, with phantom experts (6 of 8 real): the
  routing indices, their positions in the experts' queues, the keep mask
  and the gather dispatch's (expert, slot) token indices bit for bit
  against the reference's lines (`_jax_routing` restates them on the
  reference's inputs), the slots' weights within 1e-6 relative (the gates'
  exp rounds an ulp apart between XLA and torch), out and aux within 1e-5
  of the reference's `moe_apply`; a router biased to one expert makes the
  capacity bind.
* `weights.params_from_numpy` keeps ``router`` in float32 in a bf16 tree;
  `init_lm_params` makes the reference's tree (arctic's dense residual).
* Engines against the JAX engine (tokens; tick logits under
  `_torch_bridge.assert_code_ticks_close`): granite.reduced() paged and
  contiguous, arctic.reduced() paged (the dense residual), and granite at
  G 3 / HD 64 (``num_heads=6, num_kv_heads=2, head_dim=64`` on both
  packages' configs: the card's shapes), where B2 / B6 / B8's plain
  versions at G 3 are also held to the Pallas kernels in interpret mode.
* Chunked prefill refused with the reference's reason; a granite tick at
  one in-process rank equal to the unsharded one; the MoE tick (and the
  unfused baseline's) under tests/test_torch_steps.py's `HostData` mode.

Run alone: ~90 s on this container's CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_code_ticks_close, record_code_ticks, tn, tt
from repro import flags as jflags
from repro.configs import get_config as jget_config
from repro.kernels.flash_decode.kernel import (
    sparse_flash_decode_paged_pallas, sparse_flash_decode_paged_partials_pallas,
    sparse_flash_decode_pallas)
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch import flags as tflags
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.kernels.flash_decode.ops import (
    _selected_block_plan, sparse_flash_decode, sparse_flash_decode_paged_kernel,
    sparse_flash_decode_paged_partials_kernel)
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import salca_params_for
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import init_lm_params, params_from_numpy
from test_torch_steps import HostData

GRANITE, ARCTIC = "granite-moe-3b-a800m", "arctic-480b"
G3 = dict(num_heads=6, num_kv_heads=2, head_dim=64)
TOL = dict(rtol=1e-5, atol=1e-5)
# Tick logits where a stored K/V code is a step apart. The MoE layer's f32
# combine and gates round apart from XLA's, so more K/V values land on
# adjacent codes than on the dense configs (15 at the G 3 engine's first
# tick, against 1-2): measured up to 1.42e-3 over those ticks; the dense
# policy (`_torch_bridge.CODE_STEP_TOL`, 1e-3) was set from one or two.
# While the codes agree the rows stay within 1e-5, as everywhere.
MOE_CODE_STEP_TOL = dict(rtol=1e-5, atol=3e-3)


def _cfgs(arch, dtype="float32", **kw):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype, **kw)
                 for get in (jget_config, tget_config))


_WEIGHTS: dict = {}


def _weights(arch, **kw):
    """The JAX init tree of ``arch``'s reduced f32 config (``kw`` replaced)
    and the port's conversion of it."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch, **kw)
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        _WEIGHTS[key] = (jcfg, tcfg, jp,
                         params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu"))
    return _WEIGHTS[key]


@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_config_copies_equal_the_reference(arch):
    """Every field of the full and the reduced config, and the padded
    expert count, equal the reference's."""
    jc, tc = jget_config(arch), tget_config(arch)
    for j, t in ((jc, tc), (jc.reduced(), tc.reduced())):
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        assert td == {k: jd[k] for k in td}
        assert t.padded_experts == j.padded_experts
    assert tc.padded_experts == 48 and tc.groups == 3 and tc.resolved_head_dim == 64 \
        if arch == GRANITE else tc.padded_experts == 128


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _jax_routing(params, x, cfg):
    """The reference `moe_apply`'s routing lines on the same inputs, under
    the current flags: (topi, pos_in_e, keep, idx_ec, w_ec) of the
    (possibly flattened) token axis."""
    b_in, t_in, d = x.shape
    if jflags.PERF.moe_flat_dispatch and b_in > 1 and t_in <= 16:
        x = x.reshape(1, b_in * t_in, d)
    b, t, d = x.shape
    e, k = cfg.padded_experts, cfg.experts_per_token
    cap = jmoe._capacity(t, cfg, tight=jflags.PERF.moe_flat_dispatch)
    logits = x.astype(jnp.float32) @ params["router"]
    if e != cfg.num_experts:
        logits = jnp.where(jnp.arange(e) < cfg.num_experts, logits, -1e30)
    gates = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(gates, k)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    sel = jax.nn.one_hot(topi, e, dtype=jnp.int32)
    pos = (jnp.cumsum(sel.reshape(b, t * k, e), axis=1) - 1).reshape(b, t, k, e)
    pos_in_e = jnp.sum(sel * pos, axis=-1)
    keep = pos_in_e < cap
    w = topw * keep.astype(topw.dtype)
    e_flat = topi.reshape(b, t * k)
    p_flat = jnp.where(keep, pos_in_e, cap).reshape(b, t * k)

    def scat(vals, fill):
        buf = jnp.full((e, cap + 1), fill, vals.dtype)
        return jax.vmap(lambda ef, pf, vf: buf.at[ef, pf].set(vf, mode="drop")
                        )(e_flat, p_flat, vals)[:, :, :cap]

    tok = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None, :, None], (b, t, k))
    return (topi, pos_in_e, keep, scat(tok.reshape(b, t * k), jnp.int32(0)),
            scat(w.reshape(b, t * k).astype(jnp.float32), jnp.float32(0)), cap)


CASES = {"prefill": (1, 40), "decode": (4, 1), "rows": (3, 5), "capacity_binds": (1, 40)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gather", [True, False], ids=["gather", "onehot"])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_row"])
def test_moe_apply_vs_reference(rng, case, gather, flat):
    jcfg, tcfg = _cfgs(GRANITE, num_experts=6)           # 2 phantom experts of 8
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    if case == "capacity_binds":                        # every token's first pick: expert 0
        jp = dict(jp, router=jp["router"].at[:, 0].add(0.5))
    tp = {k: tt(v) for k, v in jp.items()}
    x = rng.normal(size=CASES[case] + (jcfg.d_model,)).astype(np.float32)
    if case == "capacity_binds":
        x[..., :] += np.sign(np.asarray(jp["router"][:, 0]))
    with jflags.perf_flags(moe_flat_dispatch=flat, moe_gather_dispatch=gather), \
            tflags.perf_flags(moe_flat_dispatch=flat, moe_gather_dispatch=gather):
        jo, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
        to, taux = tmoe.moe_apply(tp, tt(x), tcfg)
        topi, pos, keep, idx_ec, w_ec, cap = _jax_routing(jp, jnp.asarray(x), jcfg)
        xf = tt(x).reshape(np.asarray(topi).shape[:2] + (jcfg.d_model,))
        r = tmoe.route(tp["router"], xf, tcfg, tmoe.capacity(xf.shape[1], tcfg, tight=flat))
    assert r.cap == cap
    np.testing.assert_array_equal(tn(r.topi), np.asarray(topi))
    np.testing.assert_array_equal(tn(r.pos), np.asarray(pos))
    np.testing.assert_array_equal(tn(r.keep), np.asarray(keep))
    idx, w = tmoe.dispatch_indices(r, xf.shape[1])
    np.testing.assert_array_equal(tn(idx), np.asarray(idx_ec))
    # the gates' exp rounds an ulp apart between XLA and torch: weights by value
    np.testing.assert_allclose(tn(w), np.asarray(w_ec), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(tn(w) > 0, np.asarray(w_ec) > 0)
    assert (tn(r.topi) < jcfg.num_experts).all()
    if case == "capacity_binds":
        assert not tn(r.keep).all() and (tn(r.topi)[..., 0] == 0).all()
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_params_from_numpy_keeps_router_f32():
    """A bf16 tree: every MoE leaf in bf16 but the router, kept in float32
    bit for bit; `init_lm_params` makes the same tree, arctic's dense
    residual GLU included."""
    for arch in (GRANITE, ARCTIC):
        jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), jp), tcfg, "cpu")
        for i, layer in enumerate(tp["layers"]):
            moe = layer["ffn"]["moe"]
            assert moe["router"].dtype == torch.float32
            np.testing.assert_array_equal(
                tn(moe["router"]), np.asarray(jp["periods"][0]["ffn"]["moe"]["router"][i]))
            assert {moe[k].dtype for k in ("w_gate", "w_up", "w_down")} == {torch.bfloat16}
            assert ("dense" in layer["ffn"]) == (arch == ARCTIC)
        init = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), init)
        assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), tp)


# ---------------------------------------------------------------------------
# B2 / B6 / B8 at G 3 and HD 64
# ---------------------------------------------------------------------------

def test_b2_b6_b8_plain_at_g3_hd64_vs_pallas(rng):
    """The granite tick's kernel operands at G 3 and HD 64 (one layer of the
    G 3 engine after a prompt): B2 and B6's plain versions in all three pool
    modes, and B8's, within 1e-5 of the Pallas kernels in interpret mode."""
    from repro_torch.core.attention import salca_decode_attention_paged as t_attn
    from repro_torch.core.cache import gather_selected_paged
    jcfg, tcfg, _, tp = _weights(GRANITE, **G3)
    for mode in ("int8", "fp16", "int4"):
        eng = TEngine(tcfg, tp, max_seq=256, slots=2, paged=True, block_size=16,
                      num_blocks=32, device="cpu", kv_pool_dtype=mode)
        eng.submit(TRequest(rid=0, prompt=rng.integers(0, 500, 200).astype(np.int32),
                            max_new_tokens=2))
        eng._admit()
        pool = eng._state.caches[0]
        q = torch.from_numpy(rng.normal(size=(2, 6, 64)).astype(np.float32))
        _, sel = t_attn(q, pool, salca_params_for(tcfg, 256), return_selection=True)
        pblk, counts, bmask = _selected_block_plan(pool, sel)
        ops = (q.reshape(4, 3, 64), pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale)
        j_ops = [jnp.asarray(tn(t)) for t in ops]
        j_plan = [jnp.asarray(tn(t)) for t in (pblk, counts, bmask)]
        kw = dict(num_kv=2, kv_dtype=mode)
        out = sparse_flash_decode_paged_kernel(*ops, pblk, counts, bmask, 2, mode)
        np.testing.assert_allclose(
            tn(out), np.asarray(sparse_flash_decode_paged_pallas(*j_ops, *j_plan,
                                                                 interpret=True, **kw)), **TOL)
        part = sparse_flash_decode_paged_partials_kernel(*ops, pblk, counts, bmask, 2, mode)
        jpart = sparse_flash_decode_paged_partials_pallas(*j_ops, *j_plan, interpret=True, **kw)
        for a, b in zip(part, jpart):
            np.testing.assert_allclose(tn(a), np.asarray(b), **TOL)
        if mode == "int8":
            kc, ks, vc, vs = gather_selected_paged(pool, sel)
            c = kc.shape[2]
            args = (q.reshape(4, 3, 64), kc.reshape(4, c, 64), ks.reshape(4, c),
                    vc.reshape(4, c, 64), vs.reshape(4, c), sel.mask.reshape(4, c))
            np.testing.assert_allclose(
                tn(sparse_flash_decode(*args)),
                np.asarray(sparse_flash_decode_pallas(*(jnp.asarray(tn(a)) for a in args),
                                                      interpret=True)), **TOL)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _serve(engine_cls, req_cls, cfg, params, prompts, new_tokens=5, **kw):
    eng = engine_cls(cfg, params, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = record_code_ticks(eng, cfg)
    stats = eng.run()
    return eng, reqs, stats, ticks


ENGINES = {"granite_paged": (GRANITE, {}, dict(paged=True)),
           "granite_contiguous": (GRANITE, {}, dict(paged=False)),
           "arctic_paged": (ARCTIC, {}, dict(paged=True)),
           "granite_g3_hd64_paged": (GRANITE, G3, dict(paged=True))}


@pytest.mark.parametrize("run", list(ENGINES))
def test_moe_engine_matches_reference(run):
    """Three requests of 150, 200 and 170 tokens × 5 new tokens on two slots
    (k 128 of 256: a sparse tick; blocks reused after the first completion;
    the tick routes both slots, an idle one included): tokens, tick count
    and tick logits equal the JAX engine's."""
    arch, over, pool = ENGINES[run]
    jcfg, tcfg, jp, tp = _weights(arch, **over)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (150, 200, 170)]
    kw = dict(max_seq=256, slots=2, **pool)
    if pool["paged"]:
        kw.update(block_size=32, num_blocks=16)
    _, jr, js, jticks = _serve(JEngine, JRequest, jcfg, jp, prompts, **kw)
    te, tr, ts, tticks = _serve(TEngine, TRequest, tcfg, tp, prompts, device="cpu", **kw)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert ts.ticks == js.ticks and ts.completed == 3
    assert_code_ticks_close(jticks, tticks, MOE_CODE_STEP_TOL)


def test_chunked_prefill_refused_with_the_reference_reason():
    jcfg, tcfg, jp, tp = _weights(GRANITE, salca_static_channels=True)
    kw = dict(max_seq=256, slots=2, paged=True, block_size=16, prefill_chunk=32)
    with pytest.raises(ValueError) as jerr:
        JEngine(jcfg, jp, **kw)
    with pytest.raises(ValueError) as terr:
        TEngine(tcfg, tp, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value) and "MoE routing" in str(terr.value)


def test_granite_tick_at_one_rank_equals_unsharded():
    """The block-sharded tick at one in-process rank (B4-B6's plain
    versions, the MoE FFN unchanged) against the unsharded paged tick:
    tokens equal, tick logits within 1e-5."""
    _, tcfg, _, tp = _weights(GRANITE, **G3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (150, 90)]
    kw = dict(max_seq=256, slots=2, paged=True, block_size=32, num_blocks=16, device="cpu")
    _, ur, _, uticks = _serve(TEngine, TRequest, tcfg, tp, prompts, **kw)
    _, sr, _, sticks = _serve(TEngine, TRequest, tcfg, tp, prompts,
                              ctx=init_decode_ctx("cpu"), **kw)
    assert [r.output for r in sr] == [r.output for r in ur]
    assert len(sticks) == len(uticks) > 0
    for (um, ul, _), (sm, sl, _) in zip(uticks, sticks):
        np.testing.assert_array_equal(um, sm)
        np.testing.assert_allclose(sl[sm], ul[um], **TOL)


@pytest.mark.parametrize("pool", ["moe_int8", "moe_contiguous", "unfused_int8"])
def test_tick_makes_no_tensor_of_host_data(pool):
    """The MoE tick (routing, the static (E, C + 1) dispatch buffers, the
    ordered combine) and the unfused baseline's tick make no tensor of host
    data and read nothing back (tests/test_torch_steps.py's `HostData`), so
    both capture into a CUDA graph."""
    arch = "qwen3-0.6b" if pool == "unfused_int8" else GRANITE
    cfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = (dict(paged=False) if pool == "moe_contiguous" else
          dict(paged=True, block_size=16, num_blocks=12))
    if pool == "unfused_int8":
        kw["fused_decode"] = False
    eng = TEngine(cfg, params, max_seq=128, slots=2, device="cpu", **kw)
    rng = np.random.default_rng(0)
    for i, n in enumerate((40, 70)):
        eng.submit(TRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                            max_new_tokens=4))
    eng._admit()
    with HostData() as mode:
        eng._decode(eng._tokens.copy(), eng._mask.copy())
    assert mode.bad == []
