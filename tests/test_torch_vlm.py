"""Port parity, the vision frontend (llava-next-mistral-7b: a linear
projector of stub patch embeddings ahead of a dense "A" stack) against the
JAX package on the CPU, at float32 compute, on llava.reduced() (8 image
tokens, frontend dim 64; 2 layers, 4 H / 2 KV, HD 32).

* `transformer.embed_inputs`: the projected patches ahead of the text,
  within `TOL` (the token rows bit for bit); no patches → the text alone.
* `lm_prefill(patches=)` through the model API: logits within `TOL`, the
  cursor at P + T_text, the stored K/V codes equal or one step apart.
* Six decode ticks over the contiguous pool that the image prefills were
  written into (two requests): greedy tokens identical, logits within
  `_torch_bridge`'s code-step policy.
* The text-only engine (``patches`` default None, as the reference's engine
  serves llava) against the JAX engine, contiguous and paged: tokens and
  tick counts equal, logits within the code-step policy; each reference
  engine runs once in this module.
* `runtime.steps.PooledServer` (the model-API server) on the two image
  requests: the reference's tokens; the launcher's ``--image`` through it.
* Chunked prefill's refusal (the frontend), message for message.

Run alone: ~25 s on this container's CPU.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_code_ticks_close, layer_codes, record_code_ticks, tn, tt
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.models import transformer as jtransformer
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as launcher
from repro_torch.models import get_model as tget_model
from repro_torch.models import transformer as ttransformer
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.runtime.steps import PooledServer
from repro_torch.weights import init_lm_params, params_from_numpy

ARCH = "llava-next-mistral-7b"
# f32 on both sides, summed in other orders
TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 256
TEXT = (60, 90)              # the image requests' text tokens
TICKS = 6


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = (dataclasses.replace(get(ARCH).reduced(), dtype="float32")
                  for get in (jget_config, tget_config))
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")


def _request(cfg, seed, text):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((1, cfg.num_image_tokens, cfg.frontend_dim)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (1, text)).astype(np.int32)
    return patches, tokens


def test_embed_inputs_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    patches, tokens = _request(jcfg, 0, 7)
    want = np.asarray(jtransformer.embed_inputs(jp, jcfg, jnp.asarray(tokens),
                                                jnp.asarray(patches)))
    got = tn(ttransformer.embed_inputs(tp, tcfg, tt(tokens), tt(patches)))
    assert got.shape == (1, jcfg.num_image_tokens + 7, jcfg.d_model)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[:, jcfg.num_image_tokens:], want[:, jcfg.num_image_tokens:])
    np.testing.assert_array_equal(tn(ttransformer.embed_inputs(tp, tcfg, tt(tokens))),
                                  want[:, jcfg.num_image_tokens:])
    assert tp["projector"].shape == (jcfg.frontend_dim, jcfg.d_model)
    init = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert init["projector"].shape == tp["projector"].shape


@pytest.fixture(scope="module")
def image_runs(model):
    """Both sides' image prefills of two requests, written into a
    contiguous pool of two slots, then TICKS greedy ticks: per side the
    prefills' (logits, state) and each tick's (mask, logits, codes)."""
    jcfg, tcfg, jp, tp = model
    japi, tapi = jget_model(jcfg), tget_model(tcfg)
    jpre = jax.jit(lambda p, t, im: japi.prefill(p, {"tokens": t, "patches": im}, MAX_SEQ))
    jstep = jax.jit(lambda p, st, t, a: japi.decode_step(p, st, t, active=a))
    reqs = [_request(jcfg, 1 + i, n) for i, n in enumerate(TEXT)]
    active = np.array([True, True])
    out = []
    for side in ("jax", "torch"):
        pool = (japi.init_state(2, MAX_SEQ) if side == "jax"
                else tapi.init_state(2, MAX_SEQ, "cpu"))
        prefills, first = [], []
        for slot, (patches, tokens) in enumerate(reqs):
            if side == "jax":
                lg, st = jpre(jp, jnp.asarray(tokens), jnp.asarray(patches))
                pool = japi.write_into_slot(pool, st, slot)
            else:
                lg, st = tapi.prefill(tp, tt(tokens), MAX_SEQ, patches=tt(patches))
                tapi.write_into_slot(pool, st, slot)
            prefills.append((np.asarray(lg) if side == "jax" else tn(lg), st))
            first.append(int(prefills[-1][0][0].argmax()))
        tok, ticks = np.array(first, np.int32), []
        for _ in range(TICKS):
            if side == "jax":
                lg, pool = jstep(jp, pool, jnp.asarray(tok), jnp.asarray(active))
                lg = np.asarray(lg)
            else:
                lg, pool = tapi.decode_step(tp, pool, torch.from_numpy(tok),
                                            torch.from_numpy(active.copy()))
                lg = tn(lg)
            ticks.append((active.copy(), lg, layer_codes(pool, tcfg)))
            tok = lg.argmax(-1).astype(np.int32)
        out.append((prefills, ticks))
    return out


def test_image_prefill_matches_reference(model, image_runs):
    """Logits within TOL, the cursor at P + T_text, stored codes at most one
    step apart."""
    jcfg, tcfg, *_ = model
    (jpre, _), (tpre, _) = image_runs
    for n, (jl, js), (tl, ts) in zip(TEXT, jpre, tpre):
        np.testing.assert_allclose(tl, jl, **TOL)
        assert int(ts.pos[0]) == int(np.asarray(js.pos)[0]) == jcfg.num_image_tokens + n
        jc, tc = layer_codes(js, jcfg), layer_codes(ts, tcfg)
        assert jc.shape == tc.shape and np.abs(jc.astype(np.int32) - tc).max() <= 1


def test_image_decode_ticks_match_reference(image_runs):
    (_, jticks), (_, tticks) = image_runs
    assert_code_ticks_close(jticks, tticks)
    for (_, jl, _), (_, tl, _) in zip(jticks, tticks):
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def test_pooled_server_serves_the_reference_tokens(model, image_runs, monkeypatch, capsys):
    """`runtime.steps.PooledServer` on the two image requests (prefill,
    write into a slot, greedy ticks, reset): each request's tokens equal
    the reference's prefill token and tick tokens, every slot is freed at
    the end; the launcher's ``--image`` serves through it."""
    jcfg, tcfg, _, tp = model
    (jpre, jticks), _ = image_runs
    reqs = [_request(jcfg, 1 + i, n) for i, n in enumerate(TEXT)]
    server = PooledServer(tget_model(tcfg), tp, 2, MAX_SEQ, "cpu")
    out = server.serve([(tt(t), {"patches": tt(p)}) for p, t in reqs], TICKS + 1)
    want = [[int(lg[0].argmax())] + [int(lg[s].argmax()) for _, lg, _ in jticks]
            for s, (lg, _) in enumerate(jpre)]
    assert out == want and server.ticks == TICKS and server.nonfinite == []
    assert int(server.pool.pos.abs().sum()) == 0
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--local", "--device", "cpu",
                                      "--image", "--requests", "3", "--slots", "2",
                                      "--prompt-len", "6", "--new-tokens", "3"])
    launcher.main()
    assert '"completed": 3' in capsys.readouterr().out


def _serve(engine_cls, req_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = record_code_ticks(eng, cfg)
    stats = eng.run()
    return eng, reqs, stats, ticks


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_text_only_engine_matches_reference(model, paged):
    """Three text prompts of 150, 200 and 170 tokens × 6 new tokens on two
    slots (k = 128 of 256: a sparse tick): tokens and tick counts equal,
    logits within the code-step policy; the paged pool drains."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (150, 200, 170)]
    kw = dict(max_seq=MAX_SEQ, slots=2, paged=paged)
    if paged:
        kw.update(block_size=32, num_blocks=16)
    _, jr, js, jticks = _serve(JEngine, JRequest, jcfg, jp, prompts, **kw)
    te, tr, ts, tticks = _serve(TEngine, TRequest, tcfg, tp, prompts, device="cpu", **kw)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert ts.ticks == js.ticks and ts.completed == 3
    assert_code_ticks_close(jticks, tticks)
    if paged:
        assert sorted(te._free_blocks) == list(range(16)) and te.check_invariants().ok


def test_chunked_prefill_refused_as_the_reference(model):
    jcfg, tcfg, jp, tp = model
    kw = dict(max_seq=MAX_SEQ, slots=2, paged=True, block_size=16, prefill_chunk=32)
    with pytest.raises(ValueError) as jerr:
        JEngine(jcfg, jp, **kw)
    with pytest.raises(ValueError) as terr:
        TEngine(tcfg, tp, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert "modality frontends" in str(terr.value)
