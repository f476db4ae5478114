"""Port parity, the tiered KV pool: fp16/int4 storage, B2/B6's per-block
branches, kernels B10/B11 and the host-spill engine, against the JAX
reference on the CPU.

* Bit for bit: int4 nibble packing over the full code range,
  `sym_quantize_axes`, every pool leaf after prefill and appends in all
  three modes (the int4 block append across its ``off == 0`` resets, over
  scrambled pages and reused blocks), the dequantized logical view, the
  block rows' read → write round trip, `paged_cache_bytes`; B10 and B11's
  plain versions against the Pallas kernels in interpret mode (the cases
  of tests/test_kernels.py); the paged tick's selection per mode.
* Within 1e-5 (the reference's own bound): B2 and B6's fp16/int4 plain
  versions against the interpreted Pallas kernels and the reference's
  oracles; the paged tick's and the dense oracle's outputs.
* The validation errors of the tiered knobs equal the reference's.

Engine parity (greedy tokens per mode, sharded, spill scenarios) is in
tests/test_torch_tiered_engine.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import POOL_FIELDS, assert_fields_equal, f32_configs, tn, tt
from repro.core import cache as jc
from repro.core import quantization as jq
from repro.core.attention import dense_decode_from_paged as j_dense
from repro.core.attention import salca_decode_attention_paged as j_attn
from repro.core.selection import SalcaParams as JParams
from repro.kernels.flash_decode.kernel import (
    sparse_flash_decode_paged_pallas, sparse_flash_decode_paged_partials_pallas)
from repro.kernels.flash_decode.ref import (
    sparse_flash_decode_paged_partials_ref, sparse_flash_decode_paged_ref)
from repro.kernels.hist_topk.kernel import hist_threshold_pallas
from repro.kernels.maxpool.kernel import maxpool_pallas
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.core import cache as tc
from repro_torch.core import quantization as tq
from repro_torch.core.attention import dense_decode_from_paged as t_dense
from repro_torch.core.attention import salca_decode_attention_paged as t_attn
from repro_torch.core.selection import SalcaParams as TParams
from repro_torch.core.sp_decode import sp_dense_decode_paged as t_sp_dense
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_decode.ops import _selected_block_plan as t_plan
from repro_torch.kernels.flash_decode.ops import (
    sparse_flash_decode_paged_kernel, sparse_flash_decode_paged_partials_kernel)
from repro_torch.kernels.hist_topk.ops import hist_threshold
from repro_torch.kernels.maxpool.ops import maxpool_int8
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import init_lm_params

MODES = ("int8", "fp16", "int4")
MAX_SEQ, BS = 64, 16
MB = MAX_SEQ // BS
TOL = dict(rtol=1e-5, atol=1e-5)
JP = JParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
TP = TParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)


def _pages(ids):
    p = np.full(MB, -1, np.int32)
    p[:len(ids)] = ids
    return p


def _prefill(rng, t, scale=1.0):
    k = (rng.normal(size=(1, t, 2, 32)) * scale).astype(np.float32)
    v = rng.normal(size=(1, t, 2, 32)).astype(np.float32)
    return (jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=MAX_SEQ, params=JP),
            tc.prefill_cache(tt(k), tt(v), max_seq=MAX_SEQ, params=TP))


def _pools(mode, num_blocks=20, slots=3):
    kw = dict(kv_heads=2, head_dim=32, r=16, kv_pool_dtype=mode)
    return (jc.empty_paged_cache(num_blocks, BS, slots, MB, **kw),
            tc.empty_paged_cache(num_blocks, BS, slots, MB, **kw))


def _filled(rng, mode):
    """Both pools with slot 1 holding a 40-token prompt over scrambled blocks
    and slot 0 a 25-token one."""
    jp, tp = _pools(mode)
    for slot, t, ids in ((1, 40, [13, 2, 7]), (0, 25, [5, 11])):
        jd, td = _prefill(rng, t)
        jp = jc.prefill_into_pages(jp, jd, slot, jnp.asarray(_pages(ids)))
        tc.prefill_into_pages(tp, td, slot, tt(_pages(ids)))
    return jp, tp


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_pack_unpack_int4_full_code_range():
    """Every pair of codes in [-7, 7] packs to the reference's byte, and
    every byte (all 256, the high nibble's -8 included) unpacks to the
    reference's pair."""
    c = np.arange(-7, 8, dtype=np.int8)
    codes = np.stack([np.repeat(c, 15), np.tile(c, 15)], -1).reshape(3, 150)
    packed = tq.pack_int4(tt(codes))
    np.testing.assert_array_equal(tn(packed), np.asarray(jq.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tn(tq.unpack_int4(packed)), codes)
    every = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(2, 128)
    np.testing.assert_array_equal(tn(tq.unpack_int4(tt(every))),
                                  np.asarray(jq.unpack_int4(jnp.asarray(every))))


@pytest.mark.parametrize("bits,axes,shape", [(4, (1, 3), (4, 16, 2, 32)),
                                             (4, (-3, -1), (16, 2, 32)),
                                             (8, (-3, -1), (16, 2, 32))])
def test_sym_quantize_axes_bitwise(rng, bits, axes, shape):
    for scale in (1e-3, 1.0, 37.5, 0.0):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        jcodes, jscale = jq.sym_quantize_axes(jnp.asarray(x), bits, axes=axes)
        tcodes, tscale = tq.sym_quantize_axes(tt(x), bits, axes=axes)
        np.testing.assert_array_equal(tn(tcodes), np.asarray(jcodes))
        np.testing.assert_array_equal(tn(tscale), np.asarray(jscale))


# ---------------------------------------------------------------------------
# the pool in three modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_pool_leaves_prefill_append_free_reuse_bitwise(rng, mode):
    """Prefill over scrambled pages, 30 appends into slot 1 (two int4
    scale resets at fresh blocks, token magnitudes that grow and shrink the
    block scale) while slot 2 is masked (cursor -1, the write goes to the
    sink), a free, and a new prompt reusing a freed block: every public
    leaf equals the reference's after every step, and so do the dequantized
    logical view and the mode/head-dim inference."""
    jp, tp = _filled(rng, mode)
    assert_fields_equal(jp, tp, POOL_FIELDS)
    assert tp.kv_pool_dtype == jp.kv_pool_dtype == mode and tp.head_dim == jp.head_dim == 32
    jp = jp._replace(length=jp.length.at[2].set(-1))
    tp.length[2] = -1
    fresh = [17, 18]
    for i in range(30):
        k3 = (rng.normal(size=(3, 2, 32)) * (4.0 if i % 5 == 2 else 0.5)).astype(np.float32)
        v3 = rng.normal(size=(3, 2, 32)).astype(np.float32)
        cur = int(jp.length[1])
        if cur % BS == 0 and cur < MAX_SEQ and int(jp.page_table[1, cur // BS]) < 0:
            b = fresh.pop(0)
            jp = jc.map_block(jp, 1, cur // BS, b)
            tc.map_block(tp, 1, cur // BS, b)
        jp = jc.append_token_paged(jp, jnp.asarray(k3), jnp.asarray(v3))
        tc.append_token_paged(tp, tt(k3), tt(v3))
        assert_fields_equal(jp, tp, POOL_FIELDS)
    assert int(tp.length[1]) == MAX_SEQ and int(tp.length[2]) == -1
    for a, b in zip(jc.paged_logical_kv(jp), tc.paged_logical_kv(tp)):
        np.testing.assert_array_equal(tn(b), np.asarray(a))
    jp, tp = jc.free_pages(jp, 1), tc.free_pages(tp, 1)
    jd, td = _prefill(rng, 20, scale=3.0)
    jp = jc.prefill_into_pages(jp, jd, 2, jnp.asarray(_pages([17, 13])))
    tc.prefill_into_pages(tp, td, 2, tt(_pages([17, 13])))
    assert_fields_equal(jp, tp, POOL_FIELDS)
    if mode == "fp16":      # the unit scales, the sink's included, stay 1
        assert bool((tp.data["k_scale"] == 1).all() and (tp.data["v_scale"] == 1).all())


@pytest.mark.parametrize("mode", MODES)
def test_block_rows_roundtrip_and_bytes(rng, mode):
    """`read_block_rows` of a block written into another block reproduces
    the reference's `write_block_rows` bit for bit; the byte counts equal
    the reference's."""
    jp, tp = _filled(rng, mode)
    rows_j = jc.read_block_rows(jp, 2)
    rows_t = tuple(r.clone() for r in tc.read_block_rows(tp, 2))
    for a, b in zip(rows_j, rows_t):
        np.testing.assert_array_equal(tn(b, a), np.asarray(a))
    jp = jc.write_block_rows(jp, 19, rows_j)
    tc.write_block_rows(tp, 19, rows_t)
    assert_fields_equal(jp, tp, POOL_FIELDS)
    assert tc.block_data_bytes(tp) == jc.block_data_bytes(jp)
    assert tc.paged_cache_bytes(tp) == jc.paged_cache_bytes(jp)


# ---------------------------------------------------------------------------
# B2 / B6 per-block branches, the paged tick and the dense oracle per mode
# ---------------------------------------------------------------------------

def _plan_inputs(rng, mode, g=2):
    jp, tp = _filled(rng, mode)
    q = rng.normal(size=(3, 2 * g, 32)).astype(np.float32)
    _, sel = t_attn(tt(q), tp, TP, return_selection=True)
    pblk, counts, bmask = t_plan(tp, sel)
    ops = (tt(q.reshape(6, g, 32)), tp.k_codes, tp.k_scale, tp.v_codes, tp.v_scale)
    return jp, tp, q, ops, (pblk, counts, bmask)


@pytest.mark.parametrize("mode,g", [("fp16", 2), ("int4", 2), ("int4", 1), ("fp16", 4)])
def test_b2_b6_per_block_plain_vs_pallas(rng, mode, g):
    _, tp, _, ops, (pblk, counts, bmask) = _plan_inputs(rng, mode, g)
    assert int(counts.sum()) > 0 and int((counts == 0).sum()) > 0   # slot 2 holds nothing
    j_ops = [jnp.asarray(tn(x)) for x in ops]
    j_plan = (jnp.asarray(tn(pblk)), jnp.asarray(tn(counts)), jnp.asarray(tn(bmask)))
    kw = dict(num_kv=2, kv_dtype=mode)
    n0 = dict(LAUNCHES)
    out = sparse_flash_decode_paged_kernel(*ops, pblk, counts, bmask, 2, mode)
    np.testing.assert_allclose(
        tn(out), np.asarray(sparse_flash_decode_paged_pallas(*j_ops, *j_plan, interpret=True,
                                                             **kw)), **TOL)
    np.testing.assert_allclose(
        tn(out), np.asarray(sparse_flash_decode_paged_ref(*j_ops, j_plan[0], j_plan[2], **kw)),
        **TOL)
    acc, m, l = sparse_flash_decode_paged_partials_kernel(*ops, pblk, counts, bmask, 2, mode)
    jacc, jm, jl = sparse_flash_decode_paged_partials_pallas(*j_ops, *j_plan, interpret=True,
                                                              **kw)
    racc, rm, rl = sparse_flash_decode_paged_partials_ref(*j_ops, j_plan[0], j_plan[2], **kw)
    for a, b, c in ((acc, jacc, racc), (m, jm, rm), (l, jl, rl)):
        np.testing.assert_allclose(tn(a), np.asarray(b), **TOL)
        np.testing.assert_allclose(tn(a), np.asarray(c), **TOL)
    empty = tn(counts) == 0                   # exact (0, -1e30, 0) rows
    assert (tn(acc)[empty] == 0).all() and (tn(m)[empty] == -1e30).all()
    assert (tn(l)[empty] == 0).all()
    assert dict(LAUNCHES) == n0               # CPU tensors launch nothing


@pytest.mark.parametrize("mode", ("fp16", "int4"))
def test_paged_tick_and_dense_oracle_per_mode(rng, mode):
    """The fused paged tick over a fp16/int4 pool: the Selection equals the
    reference's bit for bit (the feature stream does not depend on the
    mode), the output and the dense oracles' (unsharded, and sharded at
    one rank) within 1e-5."""
    jp, tp, q, _, _ = _plan_inputs(rng, mode)
    jo, jsel = j_attn(jnp.asarray(q), jp, JP, return_selection=True)
    to, tsel = t_attn(tt(q), tp, TP, return_selection=True)
    for a, b in zip(jsel, tsel):
        np.testing.assert_array_equal(tn(b), np.asarray(a))
    np.testing.assert_allclose(tn(to), np.asarray(jo), **TOL)
    jd = np.asarray(j_dense(jnp.asarray(q), jp))
    np.testing.assert_allclose(tn(t_dense(tt(q), tp)), jd, **TOL)
    # the block-sharded dense path at one rank reads the pool's mode too
    np.testing.assert_allclose(tn(t_sp_dense(tt(q), tp, init_decode_ctx("cpu"))), jd, **TOL)


# ---------------------------------------------------------------------------
# B10 and B11 (cases of tests/test_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,n,window,block", [
    (1, 512, 3, 4096), (2, 4096, 7, 1024), (3, 8192, 11, 2048), (2, 256, 7, 128)])
def test_b10_plain_bitwise_vs_pallas(rng, bh, n, window, block):
    bins = rng.integers(0, 256, size=(bh, n)).astype(np.uint8)
    want = maxpool_pallas(jnp.asarray(bins), window, block_n=block, interpret=True)
    np.testing.assert_array_equal(tn(maxpool_int8(tt(bins), window)), np.asarray(want))


def _skewed_bins(rng, bh, n):
    """Bins as pooling leaves them: most of a row in bin 0 past its length,
    long runs of equal bins below it, one row all one bin."""
    out = np.zeros((bh, n), np.uint8)
    for r in range(bh):
        length = int(rng.integers(n // 4, n // 2))
        runs = np.repeat(rng.integers(1, 256, size=length // 7 + 1), 7)[:length]
        out[r, :length] = runs
    out[-1] = 200
    return out


@pytest.mark.parametrize("bh,n,k,skewed", [
    pytest.param(1, 256, 16, False, id="1-256-16"),
    pytest.param(4, 4096, 200, False, id="4-4096-200"),
    pytest.param(2, 8192, 1024, False, id="2-8192-1024"),
    pytest.param(3, 4096, 200, True, id="skewed-4096-200"),
    pytest.param(3, 1024, 5000, True, id="skewed-k-above-N")])
def test_b11_plain_bitwise_vs_pallas(rng, bh, n, k, skewed):
    bins = (_skewed_bins(rng, bh, n) if skewed
            else rng.integers(0, 256, size=(bh, n)).astype(np.uint8))
    jh, jt = hist_threshold_pallas(jnp.asarray(bins), jnp.full((bh,), k, jnp.int32),
                                   interpret=True)
    th, tt_ = hist_threshold(tt(bins), k)
    np.testing.assert_array_equal(tn(th), np.asarray(jh))
    np.testing.assert_array_equal(tn(tt_), np.asarray(jt))


# ---------------------------------------------------------------------------
# the engine's validation of the tiered knobs
# ---------------------------------------------------------------------------

def test_tiered_engine_validation_matches_reference():
    """The cases of tests/test_quantized_pool.py::test_spill_engine_validation
    (and ``demote_after=0``): the port raises the reference's ValueError,
    message included; a valid tiered engine builds in every mode."""
    jcfg, tcfg = f32_configs()
    tp = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    cases = (dict(host_spill=True), dict(kv_pool_dtype="fp16"),
             dict(paged=True, block_size=BS, host_spill=True, spill_keep_recent=0),
             dict(paged=True, block_size=BS, host_spill=True, demote_after=0))
    for kw in cases:
        with pytest.raises(ValueError) as je:
            JEngine(jcfg, None, max_seq=MAX_SEQ, slots=1, **kw)
        with pytest.raises(ValueError) as te:
            TEngine(tcfg, tp, max_seq=MAX_SEQ, slots=1, device="cpu", **kw)
        assert str(te.value) == str(je.value), kw
    for mode in MODES:
        eng = TEngine(tcfg, tp, max_seq=MAX_SEQ, slots=1, paged=True, block_size=BS,
                      device="cpu", kv_pool_dtype=mode, host_spill=True)
        assert eng._state.caches[0].kv_pool_dtype == mode and eng.stats.host_spill
        assert "pcie_bytes" in eng.stats.summary()
