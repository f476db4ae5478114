"""Port parity, kernels B1-B3 (plain versions on the CPU) and the paged
decode attention built on them.

* B1 (paged relevance scores): bit for bit against the reference's
  `paged_score_estimate_ref` AND `paged_score_estimate_pallas(interpret=True)`
  under the default bf16-pinned dequant chain.
* B2 (sparse attention over selected physical blocks) and B3 (causal flash
  prefill): within 1e-5 of the reference oracle and the interpret-mode
  Pallas kernel (f32; only the summation order differs —
  tests/test_kernels.py uses the same bound).
* `_selected_block_plan` bit for bit; `salca_decode_attention_paged`: the
  Selection bit for bit, the output within 1e-5.

The CUDA kernels themselves are checked against these plain versions on
the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import tn, tt
from repro.core import cache as jc
from repro.core.attention import exact_sparse_attention as j_exact
from repro.core.attention import salca_decode_attention_paged as j_attn
from repro.core.selection import SalcaParams as JParams
from repro.flags import perf_flags as j_flags
from repro.kernels.flash_decode.kernel import sparse_flash_decode_paged_pallas
from repro.kernels.flash_decode.ops import _selected_block_plan as j_plan
from repro.kernels.flash_decode.ref import sparse_flash_decode_paged_ref
from repro.kernels.flash_prefill.kernel import flash_attention_pallas
from repro.kernels.flash_prefill.ref import flash_attention_ref
from repro.kernels.score_est.kernel import paged_score_estimate_pallas
from repro.kernels.score_est.ref import paged_score_estimate_ref
from repro.models.attention import flash_attention_xla
from repro_torch.core import cache as tc
from repro_torch.core.attention import exact_sparse_attention as t_exact
from repro_torch.core.attention import salca_decode_attention_paged as t_attn
from repro_torch.core.selection import SalcaParams as TParams
from repro_torch.flags import perf_flags as t_flags
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_decode.ops import _selected_block_plan as t_plan
from repro_torch.kernels.flash_decode.ops import sparse_flash_decode_paged_kernel
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.kernels.score_est.ops import paged_score_estimate

TOL = dict(rtol=1e-5, atol=1e-5)


def _score_inputs(rng, s=3, kv=2, g=1, r=32, p=20, bs=16, mb=4):
    q_codes = rng.integers(-3, 4, (s, kv, g, r)).astype(np.int8)
    return dict(
        q_codes=q_codes,
        q_scale=rng.uniform(1e-3, 1.0, (s, kv, g)).astype(np.float32),
        q_sums=q_codes.astype(np.int32).sum(-1).astype(np.int32),
        feat_words=rng.integers(0, 2 ** 32, (p, bs, kv, r // 16), dtype=np.uint64)
        .astype(np.uint32),
        feat_scale=rng.uniform(1e-3, 0.5, (p, bs, kv)).astype(np.float32),
        feat_zero=rng.normal(size=(p, bs, kv)).astype(np.float32),
        pages=rng.integers(0, p, (s, mb)).astype(np.int32))


@pytest.mark.parametrize("g,bf16", [(1, True), (2, True), (1, False), (2, False)])
def test_b1_plain_bitwise_vs_ref_and_pallas(rng, g, bf16):
    x = _score_inputs(rng, g=g)
    names = list(x)
    ref = paged_score_estimate_ref(*(jnp.asarray(x[n]) for n in names), bf16=bf16)
    pal = paged_score_estimate_pallas(*(jnp.asarray(x[n]) for n in names), bf16=bf16,
                                      interpret=True)
    before = dict(LAUNCHES)
    out = paged_score_estimate(*(tt(x[n]) for n in names), bf16=bf16)
    assert dict(LAUNCHES) == before          # CPU tensors never count a launch
    if bf16:   # the default: rounding pinned after every op → bit-identical
        np.testing.assert_array_equal(tn(out), np.asarray(ref))
        np.testing.assert_array_equal(tn(out), np.asarray(pal))
    else:      # the reference leaves the f32 chain unpinned (XLA may contract
        #        a·d + z·qm into an FMA), so only float agreement is defined
        np.testing.assert_allclose(tn(out), np.asarray(ref), **TOL)
        np.testing.assert_allclose(tn(out), np.asarray(pal), **TOL)


def _decode_inputs(rng, bh=6, g=2, hd=32, p=12, bs=16, kv=2, nsb=4):
    counts = rng.integers(0, nsb + 1, (bh,)).astype(np.int32)
    counts[0] = nsb
    mask = rng.integers(0, 2, (bh, nsb, bs)).astype(bool)
    mask &= (np.arange(nsb)[None, :] < counts[:, None])[..., None]   # padding masked
    return dict(
        q=rng.normal(size=(bh, g, hd)).astype(np.float32),
        k_codes=rng.integers(-127, 128, (p, bs, kv, hd)).astype(np.int8),
        k_scale=rng.uniform(1e-3, 0.05, (p, bs, kv)).astype(np.float32),
        v_codes=rng.integers(-127, 128, (p, bs, kv, hd)).astype(np.int8),
        v_scale=rng.uniform(1e-3, 0.05, (p, bs, kv)).astype(np.float32),
        pblk=rng.integers(0, p, (bh, nsb)).astype(np.int32),
        counts=counts, blk_mask=mask)


def test_b2_plain_vs_ref_and_pallas(rng):
    x = _decode_inputs(rng)
    j = {n: jnp.asarray(a) for n, a in x.items()}
    ref = sparse_flash_decode_paged_ref(j["q"], j["k_codes"], j["k_scale"], j["v_codes"],
                                        j["v_scale"], j["pblk"], j["blk_mask"], 2)
    pal = sparse_flash_decode_paged_pallas(j["q"], j["k_codes"], j["k_scale"],
                                           j["v_codes"], j["v_scale"], j["pblk"],
                                           j["counts"], j["blk_mask"], num_kv=2,
                                           interpret=True)
    t = {n: tt(a) for n, a in x.items()}
    out = sparse_flash_decode_paged_kernel(t["q"], t["k_codes"], t["k_scale"], t["v_codes"],
                                           t["v_scale"], t["pblk"], t["counts"],
                                           t["blk_mask"], 2)
    np.testing.assert_allclose(tn(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tn(out), np.asarray(pal), **TOL)


@pytest.mark.parametrize("t_len,window,q_offset", [(24, 0, 0), (40, 0, 0), (32, 8, 0),
                                                   (16, 0, 16)])
def test_b3_plain_vs_xla_ref_and_pallas(rng, t_len, window, q_offset):
    h, kvh, hd = 4, 2, 32
    s_len = t_len + q_offset
    q = rng.normal(size=(h, t_len, hd)).astype(np.float32)
    k = rng.normal(size=(kvh, s_len, hd)).astype(np.float32)
    v = rng.normal(size=(kvh, s_len, hd)).astype(np.float32)
    out = tn(flash_attention(tt(q), tt(k), tt(v), causal=True, window=window,
                             q_offset=q_offset))
    kr, vr = (jnp.asarray(np.repeat(a, h // kvh, axis=0)) for a in (k, v))
    ref = flash_attention_ref(jnp.asarray(q), kr, vr, causal=True, window=window,
                              q_offset=q_offset)
    pal = flash_attention_pallas(jnp.asarray(q), kr, vr, causal=True, window=window,
                                 q_offset=q_offset, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(out, np.asarray(pal), **TOL)
    # the model's XLA twin, in its (B, T, H, HD) layout with GQA by repeat
    with j_flags(bf16_collectives=False):
        xla = flash_attention_xla(jnp.asarray(q.transpose(1, 0, 2)[None]),
                                  jnp.asarray(k.transpose(1, 0, 2)[None]),
                                  jnp.asarray(v.transpose(1, 0, 2)[None]),
                                  causal=True, window=window, q_offset=q_offset,
                                  chunk=s_len)
    np.testing.assert_allclose(out, np.asarray(xla)[0].transpose(1, 0, 2), **TOL)


def _scrambled(rng, t=40):
    k = rng.normal(size=(1, t, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, t, 2, 32)).astype(np.float32)
    jp_ = JParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
    tp_ = TParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
    pages = np.full(4, -1, np.int32)
    pages[:3] = [13, 2, 7]
    jpool = jc.prefill_into_pages(
        jc.empty_paged_cache(20, 16, 3, 4, kv_heads=2, head_dim=32, r=16),
        jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=64, params=jp_), 1,
        jnp.asarray(pages))
    tpool = tc.prefill_into_pages(
        tc.empty_paged_cache(20, 16, 3, 4, kv_heads=2, head_dim=32, r=16),
        tc.prefill_cache(tt(k), tt(v), max_seq=64, params=tp_), 1, tt(pages))
    return jpool, tpool, jp_, tp_


@pytest.mark.parametrize("group_sum", [True, False])
def test_paged_decode_attention_parity(rng, group_sum):
    """One layer's fused paged tick (B1 → selection → plan → B2) on a pool
    over scrambled pages: Selection and block plan bit for bit, output
    within 1e-5 of the reference's default CPU path."""
    jpool, tpool, jp_, tp_ = _scrambled(rng)
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    with j_flags(group_sum_query=group_sum), t_flags(group_sum_query=group_sum):
        # jit: one compile instead of op-by-op dispatch (flags read at trace)
        jo, jsel = jax.jit(lambda q_, p_: j_attn(q_, p_, jp_, return_selection=True))(
            jnp.asarray(q), jpool)
        to, tsel = t_attn(tt(q), tpool, tp_, return_selection=True)
    for a, b in zip(tsel, jsel):
        np.testing.assert_array_equal(tn(a), np.asarray(b))
    for a, b in zip(t_plan(tpool, tsel), j_plan(jpool, jsel)):
        np.testing.assert_array_equal(tn(a), np.asarray(b))
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    # the gather-path oracle over the same selected rows, on both sides
    rows = jc.gather_selected_paged(jpool, jsel)
    jex = j_exact(jnp.asarray(q), *rows, jsel.mask)
    tex = t_exact(tt(q), *(tt(r) for r in rows), tt(jsel.mask))
    np.testing.assert_allclose(tn(tex), np.asarray(jex), **TOL)
    np.testing.assert_allclose(tn(to), tn(tex), **TOL)


def test_dense_oracle_matches_reference(rng):
    from repro.core.attention import dense_decode_from_paged as jd
    from repro_torch.core.attention import dense_decode_from_paged as td
    jpool, tpool, _, _ = _scrambled(rng)
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    np.testing.assert_allclose(tn(td(tt(q), tpool)), np.asarray(jd(jnp.asarray(q), jpool)),
                               **TOL)
