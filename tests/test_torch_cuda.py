"""Card-only checks of the port's CUDA kernels (B1-B9) against their plain versions.

Marked ``cuda``: they skip on a machine without a CUDA device and run on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
The plain versions are held against the JAX reference by the CPU tests
(tests/test_torch_kernels.py), so agreement here closes the chain.
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(dev, gen, slots=3, max_seq=128, bs=16, kv=2, hd=32, r=16, lengths=(40, 0, 100)):
    from repro_torch.core.cache import empty_paged_cache
    mb = max_seq // bs
    pool = empty_paged_cache(slots * mb, bs, slots, mb, kv, hd, r, device=dev)
    for f, lo, hi in (("k_codes", -127, 128), ("v_codes", -127, 128),
                      ("feat_words", -2 ** 31, 2 ** 31 - 1)):
        t = pool.data[f]
        t.copy_(torch.randint(lo, hi, t.shape, generator=gen, device=dev, dtype=t.dtype))
    for f in ("k_scale", "v_scale", "feat_scale", "feat_zero"):
        pool.data[f].copy_(torch.rand(pool.data[f].shape, generator=gen, device=dev) + 1e-3)
    perm = torch.randperm(slots * mb, generator=gen, device=dev).to(torch.int32)
    for s, n in enumerate(lengths):
        need = -(-n // bs)
        pool.page_table[s, :need] = perm[s * mb: s * mb + need]
        pool.length[s] = n
    pool.heavy_idx.copy_(torch.rand((slots, kv, hd), generator=gen, device=dev)
                         .argsort(-1)[..., :r].sort(-1).values.to(torch.int32))
    return pool


@pytest.mark.parametrize("g,bf16", [(1, True), (2, True), (2, False)])
def test_b1_kernel_bitwise(dev, g, bf16):
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.score_est.ops import (
        paged_score_estimate, paged_score_estimate_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = _pool(dev, gen)
    s, kv, r = 3, 2, 16
    qc = torch.randint(-3, 4, (s, kv, g, r), generator=gen, device=dev, dtype=torch.int8)
    qs = torch.rand((s, kv, g), generator=gen, device=dev)
    qsum = qc.to(torch.int32).sum(-1, dtype=torch.int32)
    args = (qc, qs, qsum, pool.feat_words, pool.feat_scale, pool.feat_zero,
            pool.clamped_pages())
    n0 = LAUNCHES["paged_score_estimate"]
    out = paged_score_estimate(*args, bf16=bf16)
    assert LAUNCHES["paged_score_estimate"] == n0 + 1
    assert torch.equal(out, paged_score_estimate_plain(*args, bf16=bf16))


def test_b2_kernel_matches_plain(dev):
    from repro_torch.core.selection import SalcaParams
    from repro_torch.core.attention import salca_decode_attention_paged
    from repro_torch.kernels.flash_decode.ops import (
        _selected_block_plan, sparse_flash_decode_paged_kernel,
        sparse_flash_decode_paged_plain)
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = _pool(dev, gen)
    q = torch.randn((3, 4, 32), generator=gen, device=dev)
    params = SalcaParams(k=24, k_cap=48, pool_window=7)
    _, sel = salca_decode_attention_paged(q, pool, params, return_selection=True)
    pblk, counts, bmask = _selected_block_plan(pool, sel)
    qr = q.reshape(6, 2, 32)
    out = sparse_flash_decode_paged_kernel(qr, pool.k_codes, pool.k_scale, pool.v_codes,
                                           pool.v_scale, pblk, counts, bmask, 2)
    ref = sparse_flash_decode_paged_plain(qr, pool.k_codes, pool.k_scale, pool.v_codes,
                                          pool.v_scale, pblk, bmask, 2)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,t,window,q_offset,hd", [
    (torch.float32, 100, 0, 0, 32), (torch.float32, 64, 16, 0, 64),
    (torch.float32, 48, 0, 80, 128), (torch.bfloat16, 300, 0, 0, 128)])
def test_b3_kernel_matches_plain(dev, dtype, t, window, q_offset, hd):
    from repro_torch.kernels.flash_prefill.ops import flash_attention, flash_attention_plain
    gen = torch.Generator(device=dev).manual_seed(2)
    s_len = t + q_offset
    q = torch.randn((4, t, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, s_len, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, s_len, hd), generator=gen, device=dev).to(dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    # both sides work in f32; a bf16 output rounds once, so an element may
    # differ by one bf16 ulp of itself (<= 2^-7 |x|)
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-4)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


def _blk_valid(pool):
    """Owned-and-stored columns (S, MB, BS) of a pool at one rank; slot 1
    holds nothing, so its row is all masked."""
    s, mb, bs = pool.num_slots, pool.max_blocks, pool.block_size
    pos = torch.arange(mb * bs, device=pool.length.device).reshape(mb, bs)
    return (pool.page_table >= 0)[..., None] & (pos[None] < pool.length[:, None, None])


@pytest.mark.parametrize("g,bf16", [(1, True), (2, True), (2, False)])
def test_b4_kernel_bitwise(dev, g, bf16):
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.score_est.ops import paged_score_bounds, paged_score_bounds_plain
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = _pool(dev, gen)
    s, kv, r = 3, 2, 16
    qc = torch.randint(-3, 4, (s, kv, g, r), generator=gen, device=dev, dtype=torch.int8)
    qs = torch.rand((s, kv, g), generator=gen, device=dev)
    qsum = qc.to(torch.int32).sum(-1, dtype=torch.int32)
    args = (qc, qs, qsum, pool.feat_words, pool.feat_scale, pool.feat_zero,
            pool.clamped_pages(), _blk_valid(pool))
    n0 = LAUNCHES["paged_score_bounds"]
    out = paged_score_bounds(*args, bf16=bf16)
    assert LAUNCHES["paged_score_bounds"] == n0 + 1
    for t, p in zip(out, paged_score_bounds_plain(*args, bf16=bf16)):
        assert torch.equal(t, p)
    assert torch.isposinf(out[1][1]).all()        # slot 1: nothing valid


@pytest.mark.parametrize("window", [1, 7])
def test_b5_kernel_bitwise(dev, window):
    from repro_torch.kernels.selection_fused.ops import (
        paged_fused_select, paged_fused_select_plain)
    gen = torch.Generator(device=dev).manual_seed(4)
    s, kv, mb, bs = 3, 2, 9, 32
    valid = torch.rand((s, mb, bs), generator=gen, device=dev) < 0.8
    valid[1] = False
    scores = torch.randn((s, kv, mb, bs), generator=gen, device=dev)
    scores = torch.where(valid[:, None], scores, torch.full_like(scores, -3.0e38))
    lo = torch.where(valid.any(-1).any(-1)[:, None], scores.amin((2, 3)) - 0.5,
                     torch.full((s, kv), float("inf"), device=dev))
    hi = scores.amax((2, 3)) + torch.rand((s, kv), generator=gen, device=dev)
    halo = max(window // 2, 1)
    fl, fr = (torch.randint(0, 256, (s, kv, mb, halo), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(2))
    force = torch.zeros((s, mb, bs), dtype=torch.bool, device=dev)
    force[:, 0, :4] = True
    force[0, -1, -16:] = True
    args = (scores, lo, hi, fl, fr, valid, force)
    for t, p in zip(paged_fused_select(*args, window=window),
                    paged_fused_select_plain(*args, window=window)):
        assert torch.equal(t, p)


def test_b6_kernel_matches_plain(dev):
    """Partials over a rank-local plan (half the pool's blocks), so some
    rows own nothing: those are exactly (0, -1e30, 0); the rest within
    1e-5 + 1e-5·scale (f32 on both sides, other summation order)."""
    from repro_torch.core.attention import salca_decode_attention_paged
    from repro_torch.core.selection import SalcaParams
    from repro_torch.kernels.flash_decode.ops import (
        _selected_block_plan, sparse_flash_decode_paged_partials_kernel,
        sparse_flash_decode_paged_partials_plain)
    gen = torch.Generator(device=dev).manual_seed(5)
    pool = _pool(dev, gen)
    q = torch.randn((3, 4, 32), generator=gen, device=dev)
    params = SalcaParams(k=24, k_cap=48, pool_window=7)
    _, sel = salca_decode_attention_paged(q, pool, params, return_selection=True)
    pblk, counts, bmask = _selected_block_plan(pool, sel, (0, pool.num_blocks // 2))
    assert (counts == 0).any() and (counts > 0).any()
    qr = q.reshape(6, 2, 32)
    ops = (qr, pool.k_codes[:pool.num_blocks // 2].contiguous(),
           pool.k_scale[:pool.num_blocks // 2].contiguous(),
           pool.v_codes[:pool.num_blocks // 2].contiguous(),
           pool.v_scale[:pool.num_blocks // 2].contiguous(), pblk)
    got = sparse_flash_decode_paged_partials_kernel(*ops, counts, bmask, 2)
    want = sparse_flash_decode_paged_partials_plain(*ops, bmask, 2)
    # acc is an unnormalised sum whose terms cancel: its rounding error
    # scales with sum(p·|v|), the same sum over |v| (m and l have no
    # cancellation: |plain| is their scale)
    mag = sparse_flash_decode_paged_partials_plain(*ops[:3], ops[3].abs(), *ops[4:], bmask, 2)
    empty = counts == 0
    for t, p, scale in zip(got, want, (mag[0], want[1].abs(), want[2])):
        assert torch.equal(t[empty], p[empty])
        assert ((t - p).abs()[~empty] <= 1e-5 + 1e-5 * scale[~empty]).all()
    assert (got[0][empty] == 0).all() and (got[1][empty] == -1e30).all()


def test_quantization_on_card_bitwise_equals_cpu(dev):
    """The exact quantizers give the same bits on the card as on the CPU
    (where they match the reference): 2-bit asymmetric features, 3-bit and
    8-bit symmetric codes and their scales, and the uint8 score bins. A
    division by a Python scalar would run as a reciprocal multiply on the
    card and move some scales by one ulp."""
    from repro_torch.core import quantization as qz
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((4096, 64), generator=gen) * torch.rand((4096, 1), generator=gen) * 10
    for fn in (lambda t: qz.asym_quantize(t, 2), lambda t: qz.sym_quantize(t, 3),
               lambda t: qz.sym_quantize(t, 8)):
        for a, b in zip(fn(x), fn(x.to(dev))):
            assert torch.equal(a, b.cpu())
    s = torch.randn((64, 8, 2048), generator=gen) * 5
    lo, hi = s.amin(-1), s.amax(-1)
    assert torch.equal(qz.bins_from_bounds(s, lo, hi),
                       qz.bins_from_bounds(s.to(dev), lo.to(dev), hi.to(dev)).cpu())


@pytest.mark.parametrize("b,kv,g,r,n,bf16", [
    (2, 4, 1, 32, 300, True), (3, 2, 2, 64, 1024, True), (2, 4, 2, 32, 300, False),
    (1, 8, 1, 64, 2048, True)])
def test_b7_kernel_bitwise_on_cache_layout(dev, b, kv, g, r, n, bf16):
    """B7 reading a contiguous cache's (B, N, KV, ·) fields through their
    strides, both chains, bit for bit (N not a multiple of the CTA's run)."""
    from repro_torch.core.cache import empty_cache
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.score_est.ops import flat_score_estimate, flat_score_estimate_plain
    gen = torch.Generator(device=dev).manual_seed(7)
    cache = empty_cache(b, n, kv, 32, r, device=dev)
    cache.feat_words.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, cache.feat_words.shape,
                                         generator=gen, device=dev, dtype=torch.int32))
    cache.feat_scale.copy_(torch.rand(cache.feat_scale.shape, generator=gen, device=dev))
    cache.feat_zero.copy_(torch.randn(cache.feat_zero.shape, generator=gen, device=dev))
    qc = torch.randint(-3, 4, (b, kv, g, r), generator=gen, device=dev, dtype=torch.int8)
    qs = torch.rand((b, kv, g), generator=gen, device=dev)
    args = (qc, qs, cache.feat_words, cache.feat_scale, cache.feat_zero)
    n0 = LAUNCHES["score_estimate"]
    out = flat_score_estimate(*args, bf16=bf16)
    assert LAUNCHES["score_estimate"] == n0 + 1
    assert torch.equal(out, flat_score_estimate_plain(*args, bf16=bf16))


@pytest.mark.parametrize("bh,g,r,n", [(1, 1, 16, 256), (3, 2, 32, 1000), (2, 8, 128, 2048)])
def test_b7_kernel_bitwise_reference_op(dev, bh, g, r, n):
    """The reference op's (BH, N, ·) form and its unpinned f32 chain."""
    from repro_torch.kernels.score_est.ops import score_estimate, score_estimate_plain
    gen = torch.Generator(device=dev).manual_seed(8)
    qc = torch.randint(-3, 4, (bh, g, r), generator=gen, device=dev, dtype=torch.int8)
    qs = torch.rand((bh, g), generator=gen, device=dev)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (bh, n, r // 16), generator=gen, device=dev,
                          dtype=torch.int32)
    fs = torch.rand((bh, n), generator=gen, device=dev)
    fz = torch.randn((bh, n), generator=gen, device=dev)
    assert torch.equal(score_estimate(qc, qs, words, fs, fz),
                       score_estimate_plain(qc, qs, words, fs, fz))


@pytest.mark.parametrize("bh,g,c,hd,density", [
    (1, 1, 256, 64, 1.0), (2, 4, 512, 128, 0.7), (3, 2, 100, 128, 0.3), (2, 8, 256, 256, 0.9)])
def test_b8_kernel_matches_plain(dev, bh, g, c, hd, density):
    """B8 within 1e-5 + 1e-5·|plain| (f32, other summation order), C not a
    multiple of 32 included; a row with nothing selected is exactly zero."""
    from repro_torch.kernels.flash_decode.ops import sparse_flash_decode, sparse_flash_decode_plain
    gen = torch.Generator(device=dev).manual_seed(9)
    kc, vc = (torch.randint(-127, 128, (bh, c, hd), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((bh, c), generator=gen, device=dev) * 0.02 + 1e-3 for _ in range(2))
    mask = torch.rand((bh, c), generator=gen, device=dev) < density
    mask[:, 0] = True
    mask[-1] = False
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    args = (q, kc, ks, vc, vs, mask)
    out = sparse_flash_decode(*args)
    ref = sparse_flash_decode_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert (out[-1] == 0).all()


@pytest.mark.parametrize("bh,n,window", [(2, 1024, 7), (1, 4096, 1), (3, 2050, 11), (4, 8192, 7)])
def test_b9_kernel_bitwise(dev, bh, n, window):
    """Pooled bins, histogram and threshold bit for bit: ragged lengths,
    one empty row, halos across the CTAs' runs."""
    from repro_torch.kernels.selection_fused.ops import (
        fused_bin_pool_threshold, fused_bin_pool_threshold_plain)
    gen = torch.Generator(device=dev).manual_seed(10)
    scores = torch.randn((bh, n), generator=gen, device=dev) * 4
    lengths = torch.randint(n // 2, n + 1, (bh,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = 0
    lo = scores.amin(-1) - 0.25
    hi = scores.amax(-1)
    k = torch.full((bh,), max(8, n // 16), dtype=torch.int32, device=dev)
    args = (scores, lo, hi, k, lengths)
    for t, p in zip(fused_bin_pool_threshold(*args, window=window),
                    fused_bin_pool_threshold_plain(*args, window=window)):
        assert torch.equal(t, p)
