"""Port parity, the enc-dec family (whisper-small: Salca on the
cross-attention stream) against the JAX package on the CPU, at float32
compute, on whisper-small.reduced() (2 encoder and 2 decoder layers, 4 H /
2 KV, HD 32, decoder_max_len 64) with frames of 256 rows from a numpy seed.

* `encdec.encode` (the encoder: B3 with ``causal=False`` over the frames,
  RoPE over their positions) within `TOL`.
* `encdec_prefill` through the model API (``frames=``): logits within
  `TOL`; both cache stacks field by field — K/V codes equal or one step
  apart (`_torch_bridge.CODE_STEP_TOL`'s policy: the two packages' f32
  forwards may round a stored value to adjacent codes), the 2-bit feature
  codes likewise, scales within `TOL`, heavy sets, lengths and cursors
  equal; the self cache at decoder_max_len rows, the cross cache at T_enc.
* `init_state`'s cursor clamp to decoder_max_len - 1, and the state's shapes.
* `write_into_slot` and `reset_slot` bit for bit, from the same batch=1
  prefill state.
* Six `decode_step` ticks over a pool of three slots, slot 1 inactive:
  greedy tokens identical, logits within `TOL` while the self caches hold
  the same codes, the inactive slot's self caches and cursor bit for bit
  unchanged; on every layer's cross cache the Salca selection of one query
  equal to the reference's (the cross codes are equal: both pools hold the
  reference's prefill).
* The ``ctx`` branch (the flat sequence-sharded tick): at one in-process
  gloo rank equal to the unsharded step (tokens; logits within `TOL`), and
  at two spawned gloo ranks (`_torch_dist_worker.py encdec`) with the
  unsharded step's tokens.
* `runtime.steps.PooledServer` (the model-API server): three requests on
  two slots, each with the tokens it gets alone; the launcher through it.
* `ServingEngine` refuses the enc-dec family at construction.

Run alone: ~31 s on this container's CPU.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import CACHE_FIELDS, tn, tt
from repro.configs import get_config as jget_config
from repro.core import quantization as jqz
from repro.core.attention import salca_decode_attention as jsalca
from repro.core.cache import SalcaCache as JCache
from repro.models import blocks as jB
from repro.models import encdec as jencdec
from repro.models import get_model as jget_model
from repro_torch.configs import get_config as tget_config
from repro_torch.core.attention import salca_decode_attention as tsalca
from repro_torch.core.cache import SalcaCache
from repro_torch.core.quantization import unpack2bit
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.launch import serve as launcher
from repro_torch.models import encdec as tencdec
from repro_torch.models import get_model as tget_model
from repro_torch.models.blocks import salca_params_for
from repro_torch.runtime.serve import ServingEngine
from repro_torch.runtime.steps import PooledServer
from repro_torch.weights import init_lm_params, params_from_numpy
from test_torch_steps import HostData

ARCH = "whisper-small"
ROOT = pathlib.Path(__file__).resolve().parents[1]
T_ENC = 256
# f32 on both sides, summed in other orders (XLA's einsums and scan against
# torch's matmuls and B3's plain version)
TOL = dict(rtol=1e-5, atol=1e-5)
SCALES = ("k_scale", "v_scale", "feat_scale", "feat_zero")
PROMPTS = (5, 9, 3)          # decoder prompts of the three slots
TICKS = 6
ACTIVE = np.array([True, False, True])


def _cfgs():
    return tuple(dataclasses.replace(get(ARCH).reduced(), dtype="float32")
                 for get in (jget_config, tget_config))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    japi = jget_model(jcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, japi, jp, tp


def _inputs(cfg, seed, batch=1, td=5):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, T_ENC, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (batch, td)).astype(np.int32)
    return frames, tokens


@pytest.fixture(scope="module")
def prefills(model):
    """The reference's and the port's batch=1 prefills of the three slots'
    requests (frames from seeds 10, 11, 12; PROMPTS tokens)."""
    jcfg, tcfg, japi, jp, tp = model
    jpre = jax.jit(lambda p, f, t: japi.prefill(p, {"frames": f, "tokens": t}, T_ENC))
    tapi = tget_model(tcfg)
    out = []
    for i, td in enumerate(PROMPTS):
        frames, tokens = _inputs(jcfg, 10 + i, td=td)
        jl, js = jpre(jp, jnp.asarray(frames), jnp.asarray(tokens))
        tl, ts = tapi.prefill(tp, tt(tokens), frames=tt(frames))
        out.append(((jl, js), (tl, ts), frames, tokens))
    return out


def test_encode_matches_reference(model):
    jcfg, tcfg, _, jp, tp = model
    frames, _ = _inputs(jcfg, 0, batch=2)
    want = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp, jnp.asarray(frames))
    got = tencdec.encode(tp, tcfg, tt(frames))
    np.testing.assert_allclose(tn(got), np.asarray(want), **TOL)


def _codes_close(got: np.ndarray, want: np.ndarray, what: str) -> int:
    """Integer codes equal or one step apart; returns how many differ."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max(initial=0) <= 1, f"{what}: codes {diff.max()} steps apart"
    return int((diff > 0).sum())


def _assert_cache_close(tc: SalcaCache, jc, what: str, r: int) -> None:
    for f in ("k_codes", "v_codes"):
        _codes_close(tn(getattr(tc, f)), np.asarray(getattr(jc, f)), f"{what}.{f}")
    _codes_close(tn(unpack2bit(tc.feat_words, r)),
                 np.asarray(jqz.unpack2bit(jc.feat_words, r)), f"{what}.feat codes")
    for f in SCALES:
        np.testing.assert_allclose(tn(getattr(tc, f)), np.asarray(getattr(jc, f)), **TOL,
                                   err_msg=f"{what}.{f}")
    for f in ("heavy_idx", "length"):
        np.testing.assert_array_equal(tn(getattr(tc, f)), np.asarray(getattr(jc, f)),
                                      err_msg=f"{what}.{f}")


def test_prefill_matches_reference(model, prefills):
    """Logits, both cache stacks field by field, the cursor; the self cache
    holds decoder_max_len rows, the cross cache T_enc, each with the
    `SalcaParams` of its own length."""
    jcfg, tcfg, *_ = model
    r = salca_params_for(tcfg, T_ENC).r(tcfg.resolved_head_dim)
    for (jl, js), (tl, ts), _, tokens in prefills:
        np.testing.assert_allclose(tn(tl), np.asarray(jl), **TOL)
        assert len(ts.self_caches) == len(ts.cross_caches) == tcfg.num_layers
        for layer in range(tcfg.num_layers):
            for name, tc in (("self_caches", ts.self_caches[layer]),
                             ("cross_caches", ts.cross_caches[layer])):
                jc = jax.tree_util.tree_map(lambda a, layer=layer: a[layer], getattr(js, name))
                _assert_cache_close(tc, jc, f"layer {layer} {name}", r)
            assert ts.self_caches[layer].max_seq == tcfg.decoder_max_len
            assert ts.cross_caches[layer].max_seq == T_ENC
        np.testing.assert_array_equal(tn(ts.pos), np.asarray(js.pos))
        assert int(ts.pos[0]) == tokens.shape[1]


def test_init_state_clamps_the_decoder_cursor(model):
    jcfg, tcfg, japi, *_ = model
    tapi = tget_model(tcfg)
    for want_len in (0, 7, 1000):
        js = japi.init_state(3, T_ENC, want_len)
        ts = tapi.init_state(3, T_ENC, "cpu", prefill_len=want_len)
        np.testing.assert_array_equal(tn(ts.pos), np.asarray(js.pos))
        assert int(ts.pos[0]) == min(want_len, tcfg.decoder_max_len - 1)
        for name in ("self_caches", "cross_caches"):
            for layer, tc in enumerate(getattr(ts, name)):
                for f in CACHE_FIELDS:
                    want = np.asarray(getattr(getattr(js, name), f))[layer]
                    np.testing.assert_array_equal(tn(getattr(tc, f), want), want,
                                                  err_msg=f"{name}[{layer}].{f}")


def _port_state(js) -> tencdec.EncDecState:
    """The port's EncDecState holding the reference's state, bit for bit."""
    def caches(stack):
        n = np.asarray(stack.length).shape[0]
        return [SalcaCache(*(tt(np.asarray(getattr(stack, f))[layer]) for f in CACHE_FIELDS))
                for layer in range(n)]
    return tencdec.EncDecState(caches(js.self_caches), caches(js.cross_caches),
                               tt(np.asarray(js.pos)))


def _assert_state_equal(ts, js) -> None:
    for name in ("self_caches", "cross_caches"):
        for layer, tc in enumerate(getattr(ts, name)):
            jc = getattr(js, name)
            for f in CACHE_FIELDS:
                want = np.asarray(getattr(jc, f))[layer]
                np.testing.assert_array_equal(tn(getattr(tc, f), want), want,
                                              err_msg=f"{name}[{layer}].{f}")
    np.testing.assert_array_equal(tn(ts.pos), np.asarray(js.pos))


def _pools(model, prefills):
    """The reference's pool of three slots with every request written, and
    the port's pool written from the same reference prefills."""
    jcfg, tcfg, japi, *_ = model
    tapi = tget_model(tcfg)
    jpool = japi.init_state(3, T_ENC)
    tpool = tapi.init_state(3, T_ENC, "cpu")
    for slot, ((_, js), *_rest) in enumerate(prefills):
        jpool = japi.write_into_slot(jpool, js, slot)
        tapi.write_into_slot(tpool, _port_state(js), slot)
    return jpool, tpool


def test_write_into_slot_and_reset_slot_bitwise(model, prefills):
    jcfg, tcfg, japi, *_ = model
    jpool, tpool = _pools(model, prefills)
    _assert_state_equal(tpool, jpool)
    jpool = japi.reset_slot(jpool, 1)
    tget_model(tcfg).reset_slot(tpool, 1)
    _assert_state_equal(tpool, jpool)
    assert int(tpool.pos[1]) == 0 and int(tpool.self_caches[0].length[1]) == 0


def _ticks(step, pool, first, n=TICKS):
    """``n`` greedy ticks from ``first`` (S,) tokens; returns the tokens and
    logits of each tick."""
    tok, out = first, []
    for _ in range(n):
        logits, pool = step(pool, tok)
        logits = np.asarray(logits)
        tok = logits.argmax(-1).astype(np.int32)
        out.append((tok, logits))
    return out


def _first_tokens(prefills):
    return np.array([int(np.asarray(jl)[0].argmax()) for (jl, _), *_ in prefills], np.int32)


@pytest.fixture(scope="module")
def reference_ticks(model, prefills):
    jcfg, _, japi, jp, _ = model
    jpool, _ = _pools(model, prefills)
    jstep = jax.jit(lambda p, st, t, a: japi.decode_step(p, st, t, active=a))
    act = jnp.asarray(ACTIVE)
    return _ticks(lambda st, t: jstep(jp, st, jnp.asarray(t), act), jpool,
                  _first_tokens(prefills))


def _port_ticks(model, prefills, ctx=None):
    _, tcfg, _, _, tp = model
    _, tpool = _pools(model, prefills)
    api = tget_model(tcfg)
    act = torch.from_numpy(ACTIVE.copy())

    def step(st, t):
        logits, st = api.decode_step(tp, st, torch.from_numpy(t), act, ctx)
        return tn(logits), st
    return tpool, _ticks(step, tpool, _first_tokens(prefills))


def test_decode_ticks_with_an_inactive_slot(model, prefills, reference_ticks):
    """Six ticks: greedy tokens identical, logits within TOL, the inactive
    slot's self caches and cursor bit for bit unchanged, every state tensor
    updated in place, and no tensor made of host data in the tick."""
    _, tcfg, _, _, tp = model
    _, tpool = _pools(model, prefills)
    before = {(l, f): getattr(c, f).clone() for l, c in enumerate(tpool.self_caches)
              for f in CACHE_FIELDS}
    pos1 = int(tpool.pos[1])
    where = [t.untyped_storage().data_ptr() for c in tpool.self_caches + tpool.cross_caches
             for t in c] + [tpool.pos.untyped_storage().data_ptr()]
    api = tget_model(tcfg)
    act = torch.from_numpy(ACTIVE.copy())
    tok = _first_tokens(prefills)
    for i, (jtok, jlogits) in enumerate(reference_ticks):
        tok_t = torch.from_numpy(tok)
        with HostData() as mode:
            logits, tpool = api.decode_step(tp, tpool, tok_t, act)
        assert mode.bad == [], mode.bad
        np.testing.assert_allclose(tn(logits)[ACTIVE], jlogits[ACTIVE], **TOL,
                                   err_msg=f"tick {i}")
        tok = tn(logits).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tok[ACTIVE], jtok[ACTIVE], err_msg=f"tick {i}")
    for (layer, f), old in before.items():
        assert torch.equal(getattr(tpool.self_caches[layer], f)[1], old[1]), (layer, f)
    assert int(tpool.pos[1]) == pos1
    np.testing.assert_array_equal(tn(tpool.pos), [p + TICKS * a for p, a in
                                                  zip(PROMPTS, ACTIVE)])
    assert where == [t.untyped_storage().data_ptr() for c in tpool.self_caches
                     + tpool.cross_caches for t in c] + [tpool.pos.untyped_storage().data_ptr()]


def test_cross_stream_selection_matches_reference(model, prefills):
    """On every layer's cross cache of the pool (the reference's prefills,
    so the cross codes are equal), one query's Salca selection and output:
    the selection bit for bit, the output within TOL."""
    jcfg, tcfg, *_ = model
    jpool, tpool = _pools(model, prefills)
    jsp, tsp = jB.salca_params_for(jcfg, T_ENC), salca_params_for(tcfg, T_ENC)
    q = np.random.default_rng(3).standard_normal(
        (3, tcfg.num_heads, tcfg.resolved_head_dim)).astype(np.float32)
    for layer, tc in enumerate(tpool.cross_caches):
        jc = JCache(*(getattr(jpool.cross_caches, f)[layer] for f in CACHE_FIELDS))
        jo, jsel = jsalca(jnp.asarray(q), jc, jsp, return_selection=True)
        to, tsel = tsalca(tt(q), tc, tsp, return_selection=True)
        for f in ("indices", "mask", "count", "threshold"):
            np.testing.assert_array_equal(tn(getattr(tsel, f)), np.asarray(getattr(jsel, f)),
                                          err_msg=f"layer {layer} {f}")
        np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
        assert 0 < int(tsel.count.min()) and int(tsel.count.max()) < T_ENC


def test_ctx_branch_at_one_rank_equals_the_unsharded_step(model, prefills):
    ctx = init_decode_ctx("cpu")
    _, flat = _port_ticks(model, prefills)
    _, sharded = _port_ticks(model, prefills, ctx)
    for i, ((tok_f, lg_f), (tok_s, lg_s)) in enumerate(zip(flat, sharded)):
        np.testing.assert_array_equal(tok_s[ACTIVE], tok_f[ACTIVE], err_msg=f"tick {i}")
        np.testing.assert_allclose(lg_s[ACTIVE], lg_f[ACTIVE], **TOL, err_msg=f"tick {i}")


def test_ctx_branch_at_two_ranks_gives_the_unsharded_tokens(model, prefills, tmp_path):
    """Two spawned gloo ranks, each holding half the rows of every cache
    (the self caches 32 of 64, the cross caches 128 of 256), written from the
    replicated batch=1 prefills: every tick's tokens equal the unsharded
    step's on both ranks."""
    _, _, _, _, tp = model
    _, flat = _port_ticks(model, prefills)
    inp = dict(weights=tp, prefills=[(tt(f), tt(t)) for *_, f, t in prefills],
               first=_first_tokens(prefills), active=ACTIVE, ticks=TICKS, t_enc=T_ENC)
    torch.save(inp, tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               "encdec", str(tmp_path), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    for r in range(2):
        out = torch.load(tmp_path / f"out{r}.pt", weights_only=False)
        for i, ((tok_f, lg_f), (tok_s, lg_s)) in enumerate(zip(flat, out)):
            np.testing.assert_array_equal(tok_s[ACTIVE], tok_f[ACTIVE],
                                          err_msg=f"rank {r} tick {i}")
            np.testing.assert_allclose(lg_s[ACTIVE], lg_f[ACTIVE], **TOL)


def test_pooled_server_serves_each_request_as_alone(model, prefills, monkeypatch, capsys):
    """`runtime.steps.PooledServer` (the model-API server): three requests
    on two slots, the third admitted into a slot freed by a finished one,
    give each request the tokens it gets served alone on one slot, the
    first of them the reference prefill's; every slot is freed at the end.
    The launcher serves the family through it."""
    _, tcfg, _, _, tp = model
    api = tget_model(tcfg)
    reqs = [(tt(t), {"frames": tt(f)}) for *_, f, t in prefills]
    server = PooledServer(api, tp, 2, T_ENC, "cpu")
    out = server.serve(reqs, 4)
    alone = [PooledServer(api, tp, 1, T_ENC, "cpu").serve([r], 4)[0] for r in reqs]
    assert out == alone and [o[0] for o in out] == _first_tokens(prefills).tolist()
    assert server.ticks == 6 and server.nonfinite == []
    assert int(server.pool.pos.abs().sum()) == 0
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--local", "--device", "cpu",
                                      "--requests", "3", "--slots", "2", "--prompt-len", "5",
                                      "--new-tokens", "3", "--frames", "256"])
    launcher.main()
    assert '"completed": 3' in capsys.readouterr().out


def test_engine_refuses_the_enc_dec_family(model):
    _, tcfg, *_ = model
    params = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(params) == ["dec", "embed", "enc", "ln_enc", "ln_f"]
    with pytest.raises(ValueError, match="no frames"):
        ServingEngine(tcfg, params, max_seq=256, slots=2, device="cpu")
    with pytest.raises(ValueError, match="frames="):
        tget_model(tcfg).prefill(params, torch.zeros((1, 3), dtype=torch.int32))
