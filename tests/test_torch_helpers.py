"""Port parity of the core helpers the benchmarks call: the dequantizers, the
score estimate and the Table 7 schemes (`core/quantization.py`),
`extract_channels` and `static_channel_indices` (`core/heavy_channels.py`)
and `exact_topk_indices` (`core/histogram_topk.py`), against the JAX
package on the same numpy-seeded inputs, bit for bit. The reference runs
eagerly (op by op, as its own tests run these helpers), so no fused
multiply-add enters either side. ~15 s alone on this container's CPU
(the reference's eager ops compile one by one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import tn, tt
from repro.core import heavy_channels as jhc
from repro.core.histogram_topk import exact_topk_indices as jexact_topk
from repro.core import quantization as jq
from repro_torch.core import heavy_channels as thc
from repro_torch.core import histogram_topk as tht
from repro_torch.core import quantization as tq


def _eq(t, j):
    np.testing.assert_array_equal(tn(t), np.asarray(j))


def _x(rng, shape, scale=2.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, -2, 0])
def test_asym_and_sym_dequantize(rng, axis):
    """Codes, scales and dequantized values of 2-bit asymmetric and 3/8-bit
    symmetric quantization along ``axis``."""
    x = _x(rng, (3, 5, 16))
    jx = jnp.asarray(x)
    xt = tt(x)
    if axis == -1:
        ja, ta = jq.asym_quantize(jx, 2), tq.asym_quantize(xt, 2)
        for f in ("codes", "scale", "zero"):
            _eq(getattr(ta, f), getattr(ja, f))
        _eq(tq.asym_dequantize(ta), jq.asym_dequantize(ja))
    for bits in (3, 8):
        js, ts = jq.sym_quantize(jx, bits, axis=axis), tq.sym_quantize(xt, bits, axis=axis)
        _eq(ts.codes, js.codes)
        _eq(ts.scale, js.scale)
        _eq(tq.sym_dequantize(ts, axis=axis), jq.sym_dequantize(js, axis=axis))


def test_asym_dequantize_along_another_axis(rng):
    """The reference's dequantizer broadcasts its per-row factors along any
    axis: rows quantized along the last dim of a transposed array."""
    x = _x(rng, (4, 16, 6))
    ja = jq.asym_quantize(jnp.asarray(np.swapaxes(x, -1, -2)), 2)
    ta = tq.asym_quantize(tt(np.swapaxes(x, -1, -2).copy()), 2)
    j = jq.AsymQuant(jnp.swapaxes(ja.codes, -1, -2), ja.scale, ja.zero)
    t = tq.AsymQuant(ta.codes.transpose(-1, -2), ta.scale, ta.zero)
    _eq(tq.asym_dequantize(t, axis=-2), jq.asym_dequantize(j, axis=-2))


def test_sym_dequantize_axes(rng):
    """The tiered pool's per-block, per-head scale: (MB, BS, KV, HD) blocks
    quantized over (BS, HD) at 8 and 4 bits, and back."""
    x = _x(rng, (3, 16, 2, 32))
    for bits in (8, 4):
        jc, js = jq.sym_quantize_axes(jnp.asarray(x), bits, axes=(-3, -1))
        tc, ts = tq.sym_quantize_axes(tt(x), bits, axes=(1, 3))
        _eq(tc, jc)
        _eq(ts, js)
        _eq(tq.sym_dequantize_axes(tc, ts), jq.sym_dequantize_axes(jc, js))


@pytest.mark.parametrize("r", [16, 64, 128])
def test_estimate_scores(rng, r):
    """Scores of 3-bit query features against 2-bit key features, batched
    (B, KV) with G query heads a kv head, equal to the reference's int32 dot
    and its dequantization."""
    q = _x(rng, (2, 3, 4, r))
    k = _x(rng, (2, 3, 300, r))
    j = jq.estimate_scores(jq.quantize_query_features(jnp.asarray(q)),
                           jq.quantize_key_features(jnp.asarray(k)))
    t = tq.estimate_scores(tq.quantize_query_features(tt(q)), tq.quantize_key_features(tt(k)))
    assert t.dtype == torch.float32 and t.shape == (2, 3, 4, 300)
    _eq(t, j)


def test_quantize_sign_and_msb(rng):
    """Table 7's schemes: the sign (zeros map to +1) and int8 truncated to
    its top 2 or 3 magnitude bits, negatives included (arithmetic shift)."""
    x = _x(rng, (4, 8, 64))
    x[0, 0, :4] = 0.0
    x[1, 1] *= -1
    _eq(tq.quantize_sign(tt(x)), jq.quantize_sign(jnp.asarray(x)))
    for keep in (2, 3):
        for axis in (-1, 1):
            _eq(tq.quantize_msb(tt(x), keep, axis=axis),
                jq.quantize_msb(jnp.asarray(x), keep, axis=axis))


def test_extract_and_static_channels(rng):
    """Heavy channels from calibration keys (salience with ties: whole
    channels equal, so the lower index wins as in `lax.top_k`), and the
    gather of those channels from other keys."""
    calib = _x(rng, (2, 4, 96, 128))
    calib[:, :, :, 7] = calib[:, :, :, 5]          # a tie of two channel saliences
    calib[:, :, :, 5] *= 20
    calib[:, :, :, 7] *= 20
    for r in (16, 64):
        ji = jhc.static_channel_indices(jnp.asarray(calib), r)
        ti = thc.static_channel_indices(tt(calib), r)
        _eq(ti, ji)
        keys = _x(rng, (2, 4, 50, 128))
        _eq(thc.extract_channels(tt(keys), ti), jhc.extract_channels(jnp.asarray(keys), ji))


def test_exact_topk_indices_with_ties(rng):
    """Exact top-k, in descending order; where scores tie (integer-valued
    scores, many equal), the lower index comes first, as in `lax.top_k`."""
    s = rng.integers(0, 20, size=(3, 4, 500)).astype(np.float32)
    for k in (1, 17, 128, 500):
        _eq(tht.exact_topk_indices(tt(s), k), jexact_topk(jnp.asarray(s), k))
    s = _x(rng, (2, 1000))
    _eq(tht.exact_topk_indices(tt(s), 50), jexact_topk(jnp.asarray(s), 50))
