"""Port parity, core numerics: quantization, 2-bit packing, the dequant
chain, binning, max-pool, histogram Top-K and the blocked selection.

The same numpy inputs go through the JAX reference and the PyTorch port;
every output here is exact in the reference, so the port must match it
bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import tn, tt
from repro.core import heavy_channels as jhc
from repro.core import quantization as jqz
from repro.core import selection as jsel
from repro.core.maxpool import maxpool1d_blocked as j_maxpool_blocked
from repro_torch.core import heavy_channels as thc
from repro_torch.core import histogram_topk as tht
from repro_torch.core import quantization as tqz
from repro_torch.core import selection as tsel
from repro_torch.core.maxpool import maxpool1d_blocked as t_maxpool_blocked
from repro_torch.flags import perf_flags as t_flags
from repro.flags import perf_flags as j_flags

# `repro.core` re-exports a function named `histogram_topk`, which shadows
# the submodule on attribute access.
jht = importlib.import_module("repro.core.histogram_topk")


def _eq(t, j):
    j = np.asarray(j)
    np.testing.assert_array_equal(tn(t, j), j)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 50.0])
def test_int8_and_feature_quantization_bitwise(rng, scale):
    x = (rng.normal(size=(3, 7, 2, 32)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                                    # all-zero row → eps scale
    j8, t8 = jqz.quantize_kv_int8(jnp.asarray(x)), tqz.quantize_kv_int8(tt(x))
    _eq(t8.codes, j8.codes)
    _eq(t8.scale, j8.scale)
    feat = x[..., :16]
    jf, tf = jqz.quantize_key_features(jnp.asarray(feat)), tqz.quantize_key_features(tt(feat))
    for a, b in zip(tf, jf):
        _eq(a, b)
    jq, tq = jqz.quantize_query_features(jnp.asarray(feat)), tqz.quantize_query_features(tt(feat))
    _eq(tq.codes, jq.codes)
    _eq(tq.scale, jq.scale)


def test_pack_unpack_2bit_bitwise(rng):
    codes = rng.integers(0, 4, (4, 5, 2, 64)).astype(np.int8)
    codes[0, 0, 0, :] = 3                               # top bits set: sign of int32
    jw = jqz.pack2bit(jnp.asarray(codes))
    tw = tqz.pack2bit(tt(codes))
    _eq(tw, jw)
    _eq(tqz.unpack2bit(tw, 64), jqz.unpack2bit(jw, 64))
    _eq(tqz.unpack2bit(tw, 64), codes)


@pytest.mark.parametrize("bf16", [True, False])
def test_dequant_score_chain_bitwise(rng, bf16):
    shape = (2, 3, 1, 40)
    qs = rng.uniform(1e-3, 2.0, shape).astype(np.float32)
    a = rng.uniform(1e-3, 1.0, shape).astype(np.float32)
    z = rng.normal(size=shape).astype(np.float32)
    d = rng.integers(-300, 300, shape).astype(np.int32)
    qm = rng.integers(-60, 60, shape).astype(np.int32)
    j = jqz.dequant_score_chain(*map(jnp.asarray, (qs, a, z, d, qm)), bf16)
    t = tqz.dequant_score_chain(*map(tt, (qs, a, z, d, qm)), bf16)
    _eq(t, j)


def test_score_binning_bitwise(rng):
    s = rng.normal(size=(2, 3, 64)).astype(np.float32)
    s[1, 2] = 0.5                                       # constant row
    valid = rng.integers(0, 2, (2, 1, 64)).astype(bool)
    valid[0, 0, :] = False                              # all-masked row
    j = jqz.quantize_scores_uint8(jnp.asarray(s), jnp.asarray(valid))
    t = tqz.quantize_scores_uint8(tt(s), tt(valid))
    _eq(t, j)
    _eq(tqz.quantize_scores_uint8(tt(s)), jqz.quantize_scores_uint8(jnp.asarray(s)))


def test_heavy_channels_ties_break_low(rng):
    keys = rng.normal(size=(2, 3, 20, 32)).astype(np.float32)
    keys[0, 0] = np.round(keys[0, 0])                  # integer columns: exact ties
    keys[1, 1] = 1.0                                    # every channel tied
    j = jhc.heavy_channel_indices(jnp.asarray(keys), 16)
    _eq(thc.heavy_channel_indices(tt(keys), 16), j)


@pytest.mark.parametrize("window", [3, 7])
def test_maxpool_blocked_bitwise(rng, window):
    x = rng.integers(0, 256, (2, 3, 4, 16)).astype(np.uint8)
    _eq(t_maxpool_blocked(tt(x), window), j_maxpool_blocked(jnp.asarray(x), window))


@pytest.mark.parametrize("k", [0, 10, 64, 200])
def test_histogram_topk_blocked_bitwise(rng, k):
    bins = rng.integers(0, 256, (2, 2, 4, 16)).astype(np.uint8)
    j = jht.histogram_topk_blocked(jnp.asarray(bins), k, 16)
    t = tht.histogram_topk_blocked(tt(bins), k, 16)
    for a, b in zip(t, j):
        _eq(a, b)
    _eq(tht.histogram256(tt(bins)), jht.histogram256(jnp.asarray(bins)))


@pytest.mark.parametrize("k,k_cap,const", [(10, 16, False), (0, 16, False),
                                           (64, 64, False), (200, 64, False),
                                           (10, 16, True)])
def test_select_sparse_pattern_blocked_bitwise(rng, k, k_cap, const):
    scores = (np.full((2, 2, 64), 0.25) if const
              else rng.normal(size=(2, 2, 64))).astype(np.float32)
    valid = rng.integers(0, 2, (2, 1, 64)).astype(bool)
    jp = jsel.SalcaParams(feature_sparsity=0.5, k=k, k_cap=k_cap, pool_window=7)
    tp = tsel.SalcaParams(feature_sparsity=0.5, k=k, k_cap=k_cap, pool_window=7)
    j = jsel.select_sparse_pattern_blocked(jnp.asarray(scores), jp, jnp.asarray(valid), 16)
    t = tsel.select_sparse_pattern_blocked(tt(scores), tp, tt(valid), 16)
    for a, b in zip(t, j):
        _eq(a, b)


@pytest.mark.parametrize("group_sum", [True, False])
def test_quantized_query_groups_bitwise(rng, group_sum):
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    heavy = np.sort(rng.permuted(np.tile(np.arange(32), (3, 2, 1)), axis=-1)[..., :16],
                    axis=-1).astype(np.int32)
    jf = jsel.query_heavy_features(jnp.asarray(q), jnp.asarray(heavy), 2)
    tf = tsel.query_heavy_features(tt(q), tt(heavy), 2)
    _eq(tf, jf)
    with j_flags(group_sum_query=group_sum), t_flags(group_sum_query=group_sum):
        for a, b in zip(tsel._quantized_query_groups(tf, 2),
                        jsel._quantized_query_groups(jf, 2)):
            _eq(a, b)


def test_salca_params_rule_matches():
    from repro.models.blocks import salca_params_for as jrule
    from repro_torch.models.blocks import salca_params_for as trule
    from _torch_bridge import f32_configs
    jc, tc = f32_configs()
    for n in (64, 256, 8192, 100_000):
        j, t = jrule(jc, n), trule(tc, n)
        assert (t.k, t.k_cap, t.pool_window, t.r(32)) == (j.k, j.k_cap, j.pool_window, j.r(32))
