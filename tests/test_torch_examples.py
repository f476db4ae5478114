"""Port parity of the example entry points (`examples/torch_*.py`) on the CPU
at small sizes, against the reference's examples and engine on the same
numpy-seeded inputs, and the selection at k's cap (`salca_max_k`) through
both packages. ~50 s alone on this container's CPU.
"""

import dataclasses
import importlib.util
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import f32_configs, tn, tt

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks.common import overlap_coverage, synthetic_attention_case, true_scores  # noqa: E402
from repro.core import cache as jc  # noqa: E402
from repro.core.attention import dense_decode_attention as j_dense  # noqa: E402
from repro.core.attention import salca_decode_attention as j_attn  # noqa: E402
from repro.core.attention import salca_decode_attention_paged as j_attn_paged  # noqa: E402
from repro.core.selection import SalcaParams as JParams  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models.blocks import salca_params_for as j_salca_params_for  # noqa: E402
from repro.runtime.serve import Request as JRequest  # noqa: E402
from repro.runtime.serve import ServingEngine as JEngine  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core.attention import salca_decode_attention_paged as t_attn_paged  # noqa: E402
from repro_torch.models.blocks import salca_params_for as t_salca_params_for  # noqa: E402
from repro_torch.runtime.serve import Request as TRequest  # noqa: E402
from repro_torch.runtime.serve import ServingEngine as TEngine  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JCFG, TCFG = f32_configs()


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


def test_quickstart_twin():
    """The quickstart's step: thresholds and kept counts equal to the
    reference's, the recall equal, the output's error against dense within
    1e-5 of the reference's."""
    ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    got = _example("torch_quickstart").run("cpu")
    np.testing.assert_array_equal(got["threshold"], np.asarray(ref["sel"].threshold)[0])
    np.testing.assert_array_equal(got["kept"], ref["kept"])
    for h in range(4):
        chosen = set(np.asarray(ref["sel"].indices[0, h])[np.asarray(ref["sel"].mask[0, h])]
                     .tolist())
        assert got["recall"][h] == len(chosen & ref["relevant"][h]) / len(ref["relevant"][h])
    assert abs(got["rel"] - ref["rel"]) < 1e-5
    assert got["nbytes"] == {k: int(v) for k, v in ref["nbytes"].items()}
    assert (got["params"].k, got["params"].k_cap) == (ref["params"].k, ref["params"].k_cap)


def test_ablation_twin_three_rows():
    """Three rows of the 3 × 3 (s_f, r_q) sweep: overlap and coverage equal to
    the reference example's rows (its loop body, on its workload), the
    Selection's counts and thresholds equal, the error within 1e-5."""
    abl = _example("torch_ablation_selection")
    grid = [(0.25, 0.05), (0.375, 0.02), (0.5, 0.10)]
    rows = abl.sweep("cpu", grid)
    q, k, v, _ = synthetic_attention_case(0, T=abl.T)
    s_true = true_scores(q, k)
    dense = j_dense(q, k, v)
    for (s_f, r_q), row in zip(grid, rows):
        kk = max(64, int(2048 * r_q))
        params = JParams(feature_sparsity=s_f, k=kk, k_cap=(int(kk * 1.25) // 128 + 1) * 128,
                         use_pool=False)
        assert dataclasses.asdict(params) == dataclasses.asdict(abl.row_params(s_f, r_q))
        cache = jc.prefill_cache(k, v, max_seq=2048, params=params)
        # the decode jitted, as the quickstart runs it (the eager one compiles
        # op by op, ~9 s here); the prefill eager, as the example runs it
        out, sel = jax.jit(lambda q, c, p=params: j_attn(q, c, p, return_selection=True))(
            q, cache)
        ov, cov = overlap_coverage(sel.indices, sel.mask, s_true, k_top=kk)
        rel = float(jnp.linalg.norm(out - dense) / jnp.linalg.norm(dense))
        assert (row["overlap"], row["coverage"]) == (ov, cov), (s_f, r_q)
        np.testing.assert_array_equal(tn(row["count"]), np.asarray(sel.count))
        np.testing.assert_array_equal(tn(row["threshold"]), np.asarray(sel.threshold))
        assert abs(row["rel_err"] - rel) < 1e-5


def test_serve_longcontext_twin_tokens_equal_reference(weights):
    """The serving twin at the reduced config (f32), paged, on the
    reference's weights: every request's tokens equal the reference
    engine's on the same prompts; its summary has the reference's keys."""
    jp, tp = weights
    tsl = _example("torch_serve_longcontext")
    args = tsl.parse_args().parse_args(["--device", "cpu", "--paged", "--new-tokens", "5",
                                        "--prompt-lens", "150,90,170"])
    cfg = tsl.model_config(args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(dataclasses.replace(TCFG,
                                                                           dtype="bfloat16"))
    out = tsl.serve(args, TCFG, tp)           # the twin's engine at f32, for token parity
    max_seq = out["engine"].max_seq
    assert max_seq == 256
    je = JEngine(JCFG, jp, max_seq=max_seq, slots=args.slots, paged=True,
                 block_size=args.block_size)
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens)
             for r in out["requests"]]
    for r in jreqs:
        je.submit(r)
    js = je.run().summary()
    for a, b in zip(jreqs, out["requests"]):
        assert a.output == b.output and a.stop_reason == b.stop_reason == "length", a.rid
    assert out["summary"]["completed"] == js["completed"] == 3
    assert out["summary"]["ticks"] == js["ticks"]
    assert set(out["summary"]) == set(js)


def test_serve_longcontext_shards_capacity_demo():
    """``--shards 2`` on the CPU: the request overflows a 1-shard pool (rejected
    at submit) and completes on two spawned gloo ranks, its blocks spanning
    both shards."""
    tsl = _example("torch_serve_longcontext")
    argv = ["--device", "cpu", "--shards", "2", "--new-tokens", "6"]
    args = tsl.parse_args().parse_args(argv)
    args.paged = True
    cfg = tsl.model_config(args)
    from repro_torch.weights import init_lm_params
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    one, two = tsl.sharded_demo(args, cfg, params, argv)
    assert "needs 16 blocks" in one["rejected"] and one["blocks"] == 8
    assert two["stop_reason"] == "length" and len(two["output"]) == 6
    assert two["world"] == 2 and two["peak_blocks"] == 16 and two["peak_shard_blocks"] == 8


def test_train_small_twin_three_steps(tmp_path):
    """Three steps of the twin's Trainer on the reduced config: finite losses,
    the final step and the checkpoint written on exit."""
    tts = _example("torch_train_small")
    args = tts.parse_args(["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = tts.run(args)
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert np.all(np.isfinite(out["losses"])) and out["recoveries"] == 0
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())


CAP = dict(salca_max_k=160)
CAP_MAX_SEQ = 4096


def test_cap_selection_equal_through_both_packages(rng):
    """k's cap binds (qwen3-0.6b.reduced() with ``salca_max_k`` 160 at max_seq
    4096: k 160 in place of the retention's 1024, k_cap 256): one layer's
    paged Selection over 3000 stored tokens, from the same pool leaves,
    bit for bit through both packages."""
    jcfg, tcfg = (dataclasses.replace(c, **CAP) for c in (JCFG, TCFG))
    jsp, tsp = j_salca_params_for(jcfg, CAP_MAX_SEQ), t_salca_params_for(tcfg, CAP_MAX_SEQ)
    assert (tsp.k, tsp.k_cap) == (jsp.k, jsp.k_cap) == (160, 256)
    kv, hd, bs, s, mb = 2, 32, 32, 2, CAP_MAX_SEQ // 32
    jpool = jc.empty_paged_cache(s * mb, bs, s, mb, kv, hd, jsp.r(hd))
    for slot, n in ((0, 3000), (1, 1200)):
        k = rng.normal(size=(1, n, kv, hd)).astype(np.float32)
        v = rng.normal(size=(1, n, kv, hd)).astype(np.float32)
        # jitted (one compile in place of one per op): its leaves are copied
        # into the port's pool, so both packages select from the same bits
        src = jax.jit(lambda k, v: jc.prefill_cache(k, v, max_seq=CAP_MAX_SEQ, params=jsp))(
            jnp.asarray(k), jnp.asarray(v))
        pages = np.full(mb, -1, np.int32)
        pages[:-(-n // bs)] = np.arange(slot * mb, slot * mb + -(-n // bs))
        jpool = jc.prefill_into_pages(jpool, src, slot, jnp.asarray(pages))
    tpool = tcache.empty_paged_cache(s * mb, bs, s, mb, kv, hd, tsp.r(hd))
    for f in ("k_codes", "k_scale", "v_codes", "v_scale", "feat_words", "feat_scale",
              "feat_zero", "heavy_idx", "length", "page_table", "refcount"):
        getattr(tpool, f).copy_(tt(getattr(jpool, f)))
    q = rng.normal(size=(s, 4, hd)).astype(np.float32)
    jo, jsel = jax.jit(lambda q, p: j_attn_paged(q, p, jsp, return_selection=True))(
        jnp.asarray(q), jpool)
    to, tsel = t_attn_paged(tt(q), tpool, tsp, return_selection=True)
    for t, j in zip(tsel, jsel):
        np.testing.assert_array_equal(tn(t), np.asarray(j))
    assert int(np.asarray(jsel.count).min()) >= 160
    np.testing.assert_allclose(tn(to), np.asarray(jo), rtol=1e-5, atol=1e-5)


def test_cap_engines_tokens_and_selections_equal(weights, rng):
    """The two engines at the cap (paged, max_seq 4096, prompts of 700 and 380
    tokens, 4 new tokens each): tokens identical, and every layer's
    selection histogram (`sel_hist`) equal after every tick."""
    jp, tp = weights
    jcfg, tcfg = (dataclasses.replace(c, **CAP) for c in (JCFG, TCFG))
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (700, 380)]
    runs = []
    for engine_cls, req_cls, cfg, params, kw in ((JEngine, JRequest, jcfg, jp, {}),
                                                 (TEngine, TRequest, tcfg, tp, {"device": "cpu"})):
        eng = engine_cls(cfg, params, max_seq=CAP_MAX_SEQ, slots=2, paged=True, block_size=32,
                         **kw)
        reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=4) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        hists, orig = [], eng._decode

        def recording(*a, eng=eng, orig=orig, hists=hists):
            out = orig(*a)          # the reference returns its new state, the port's is in place
            hists.append(np.asarray(out[3].period_states[0].sel_hist) if len(out) > 3
                         else np.stack([c.sel_hist.numpy() for c in eng._state.caches]))
            return out

        eng._decode = recording
        eng.run()
        runs.append(([r.output for r in reqs], hists))
    (jtok, jh), (ttok, th) = runs
    assert jtok == ttok
    assert len(jh) == len(th) == 3
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b, a)
    assert int(th[0].sum()) >= 2 * 2 * 2 * 160       # layers × slots × kv heads × k
