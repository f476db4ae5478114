"""Card-only checks of the port's CUDA kernels (B1-B11, B2/B6's storage
branches) against their plain versions.

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


@pytest.mark.parametrize("dtype,t,window,q_offset,hd,groups", [
    (torch.float32, 100, 0, 0, 32, 2), (torch.float32, 64, 16, 0, 64, 2),
    (torch.float32, 48, 0, 80, 128, 2), (torch.bfloat16, 300, 0, 0, 128, 2),
    # the bf16 branch (tensor cores, 64-row query tiles, 64-key tiles):
    # every HD, T ragged against the tiles and T < 16, a q_offset with
    # S > T, windows crossing tile edges, groups 1, 2 and 8
    (torch.bfloat16, 77, 0, 0, 32, 1), (torch.bfloat16, 100, 0, 0, 64, 8),
    (torch.bfloat16, 5, 0, 0, 128, 2), (torch.bfloat16, 48, 0, 80, 128, 2),
    (torch.bfloat16, 300, 100, 0, 64, 1), (torch.bfloat16, 200, 70, 130, 128, 8),
    (torch.bfloat16, 1030, 0, 0, 128, 8)])
def test_b3_kernel_matches_plain(dev, dtype, t, window, q_offset, hd, groups):
    from repro_torch.kernels.flash_prefill.ops import flash_attention, flash_attention_plain
    gen = torch.Generator(device=dev).manual_seed(2)
    s_len = t + q_offset
    q = torch.randn((2 * groups, t, hd), generator=gen, device=dev).to(dtype)
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


def _score_operands(dev, seed, kv, g, r, bs, slots=4, max_seq=1024,
                    lengths=(1000, 0, 700, 77)):
    """B1's operands on a random pool of ``slots`` × ``max_seq`` tokens, and
    a B4 validity mask that holds every case the kernel treats apart: slot
    0 stored up to a partly valid last block, slot 1 empty, slot 2 owning
    every other block (a two-rank stripe), slot 3 with its first block
    masked inside a valid run."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = _pool(dev, gen, slots=slots, max_seq=max_seq, bs=bs, kv=kv, hd=2 * r, r=r,
                 lengths=lengths)
    qc = torch.randint(-3, 4, (slots, kv, g, r), generator=gen, device=dev, dtype=torch.int8)
    qs = torch.rand((slots, kv, g), generator=gen, device=dev)
    qsum = qc.to(torch.int32).sum(-1, dtype=torch.int32)
    b1 = (qc, qs, qsum, pool.feat_words, pool.feat_scale, pool.feat_zero,
          pool.clamped_pages())
    valid = _blk_valid(pool)
    mb = pool.max_blocks
    valid[2] &= (torch.arange(mb, device=dev) % 2 == 0)[:, None]
    valid[3, 0] = False
    return b1, valid


@pytest.mark.parametrize("kv,g,r,bs,bf16", [
    (8, 1, 64, 32, True),     # the main path (qwen3-0.6b, group-summed query): registers
    (8, 1, 64, 32, False),
    (8, 1, 16, 32, True),     # the reduced config; from here on the wide layout
    (8, 1, 32, 32, True),     # head dim 64
    (8, 1, 128, 32, False),   # head dim 256
    (8, 2, 64, 32, True),     # qwen3-0.6b without the group sum
    (8, 2, 64, 32, False),
    (8, 2, 32, 32, False),
    (8, 4, 16, 32, True),
    (8, 4, 32, 32, False),
    (8, 4, 64, 32, True),     # qwen3-8b
    (10, 4, 64, 32, True),    # phi3-medium: threads not a multiple of 32
    (8, 2, 128, 32, True),
    (8, 4, 128, 32, False),
    (8, 2, 64, 16, True),
    (8, 2, 64, 64, False),
    (1, 2, 64, 32, True),
])
def test_b1_b4_bitwise_at_serving_shapes(dev, kv, g, r, bs, bf16):
    """B1 and B4 equal their plain versions bit for bit at the serving
    models' widths, in both the register and the wide layout; B4 on a mask
    with a partly valid block, an all-invalid block inside a valid slot, a
    two-rank stripe and an empty slot, whose bounds are exactly lo = +inf
    and hi = SCORE_NEG_INF."""
    from repro_torch.core.quantization import SCORE_NEG_INF
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.score_est import ops as se
    b1, valid = _score_operands(dev, 13, kv, g, r, bs)
    n0 = dict(LAUNCHES)
    assert torch.equal(se.paged_score_estimate(*b1, bf16=bf16),
                       se.paged_score_estimate_plain(*b1, bf16=bf16))
    out = se.paged_score_bounds(*b1, valid, bf16=bf16)
    for t, p in zip(out, se.paged_score_bounds_plain(*b1, valid, bf16=bf16)):
        assert torch.equal(t, p)
    assert torch.isposinf(out[1][1]).all()
    assert (out[2][1] == SCORE_NEG_INF).all()
    assert torch.isfinite(out[1][[0, 2, 3]]).all()
    assert LAUNCHES["paged_score_estimate"] == n0.get("paged_score_estimate", 0) + 1
    assert LAUNCHES["paged_score_bounds"] == n0.get("paged_score_bounds", 0) + 1


@pytest.mark.parametrize("case", ["unaligned", "kv1030"])
def test_b1_b4_wide_layout_cases_bitwise(dev, case):
    """Shapes and operands off the register layout still launch the kernel
    and equal the plain versions: query codes and key words off their
    vector alignment at the main path's G and r, and more kv heads than a
    CTA has threads (each thread's kv head changes from task to task)."""
    from repro_torch.kernels.score_est import ops as se
    if case == "unaligned":
        b1, valid = _score_operands(dev, 14, 8, 1, 64, 32, max_seq=512,
                                    lengths=(500, 0, 300, 40))
        qc, words = b1[0], b1[3]
        qbuf = torch.empty(qc.numel() + 1, dtype=torch.int8, device=dev)
        qbuf[1:] = qc.reshape(-1)
        wbuf = torch.empty(words.numel() + 1, dtype=torch.int32, device=dev)
        wbuf[1:] = words.reshape(-1)
        args = (qbuf[1:].view(qc.shape), *b1[1:3], wbuf[1:].view(words.shape), *b1[4:])
        assert args[0].data_ptr() % 16 and args[3].data_ptr() % 16
    else:
        b1, valid = _score_operands(dev, 15, 1030, 1, 16, 16, max_seq=64,
                                    lengths=(60, 0, 40, 20))
        args = b1
    assert torch.equal(se.paged_score_estimate(*args), se.paged_score_estimate_plain(*b1))
    for t, p in zip(se.paged_score_bounds(*args, valid),
                    se.paged_score_bounds_plain(*b1, valid)):
        assert torch.equal(t, p)


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


def _b5_operands(dev, seed, s, kv, mb, bs, window, empty_share=0.64):
    """B5's operands with every case the kernel treats apart: per slot, about
    ``empty_share`` of the blocks hold nothing valid, interleaved with partly
    and fully valid ones; the last slot holds nothing (lo = +inf); force set
    on valid and on invalid positions; random halo columns."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    empty = torch.rand((s, mb, 1), generator=gen, device=dev) < empty_share
    part = torch.rand((s, mb, 1), generator=gen, device=dev) < 0.5
    valid = ~empty & (~part | (torch.rand((s, mb, bs), generator=gen, device=dev) < 0.7))
    valid[-1] = False
    scores = torch.randn((s, kv, mb, bs), generator=gen, device=dev) * 3
    scores = torch.where(valid[:, None], scores, torch.full_like(scores, -3.0e38))
    vmin = torch.where(valid[:, None], scores, torch.full_like(scores, float("inf")))
    lo = vmin.amin((2, 3)) - 0.5                             # +inf on the empty slot
    hi = scores.amax((2, 3)) + torch.rand((s, kv), generator=gen, device=dev)
    halo = max(window // 2, 1)
    fl, fr = (torch.randint(0, 256, (s, kv, mb, halo), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(2))
    force = torch.rand((s, mb, bs), generator=gen, device=dev) < 0.1
    force[:, 0, :4] = True                                   # sink columns
    return scores, lo, hi, fl, fr, valid, force


@pytest.mark.parametrize("s,kv,mb,bs,window", [
    (4, 8, 256, 32, 7),       # the main path: S 4 x KV 8 rows of 256 blocks of 32
    (4, 8, 256, 32, 1),
    (4, 8, 256, 32, 3),
    (3, 2, 77, 32, 7),        # MB not a multiple of a CTA's 24 warp units
    (2, 2, 2000, 32, 7),      # 84 CTAs per row
    (3, 2, 100, 16, 7),       # two blocks per warp unit
    (1, 1, 5000, 8, 5),
    (2, 3, 33, 16, 33),       # halo = block size
    (3, 2, 40, 64, 7),        # a warp per block, staged in shared memory
    (2, 2, 20, 128, 7),
    (3, 2, 50, 12, 7),        # a block size that is not a multiple of 4
    (3, 2, 50, 12, 3),
])
def test_b5_bitwise_at_serving_shapes(dev, s, kv, mb, bs, window):
    """B5 equals its plain version bit for bit on empty blocks interleaved
    with partly valid ones, an all-empty slot, force on valid and invalid
    positions, at the main path's shape and at other block sizes and
    windows; and its outputs do not depend on what the memory they are
    given held: the blocks that the wrapper's outputs land on were filled
    with 0xFF just before."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.selection_fused.ops import (
        paged_fused_select, paged_fused_select_plain)
    args = _b5_operands(dev, 21 + mb, s, kv, mb, bs, window)
    want = paged_fused_select_plain(*args, window=window)
    # the outputs' blocks, filled with 0xFF and freed; a guard after each
    # keeps a freed block from merging with its neighbours, so that the
    # wrapper's allocations of the same sizes take them
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk, guards = [], []
    for t in want:
        junk.append(torch.full_like(t, 255 if t.dtype == torch.uint8 else -1))
        guards.append(torch.empty(1, device=dev))
    hist_ptr = junk[1].data_ptr()
    del junk
    n0 = LAUNCHES["paged_fused_select"]
    got = paged_fused_select(*args, window=window)
    assert LAUNCHES["paged_fused_select"] == n0 + 1
    assert got[1].data_ptr() == hist_ptr
    for t, p in zip(got, want):
        assert torch.equal(t, p)
    assert (got[1].sum(-1) == mb * bs).all()


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


@pytest.mark.parametrize("b,kv,g,r,n,unaligned,bf16", [
    (4, 8, 1, 64, 8192, False, True),    # the main path: registers, float4 stores
    (4, 8, 1, 64, 8192, False, False),
    (4, 8, 1, 64, 1001, True, True),     # words one word off: the wide layout
    (2, 1, 1, 64, 999, False, False),    # KV 1 (the reference op's form), N % 4 != 0
    (3, 10, 1, 64, 514, False, True),    # KV 10: 250 threads
    (2, 10, 2, 32, 300, False, False),
    (2, 8, 2, 64, 1030, False, True),
    (2, 4, 8, 128, 257, False, False),
    (1, 1030, 1, 16, 37, False, True),   # more kv heads than a CTA has threads
])
def test_b7_bitwise_register_and_wide_layouts(dev, b, kv, g, r, n, unaligned, bf16):
    """B7 on B1's template: the register layout at G 1 / r 64 with aligned
    operands, the wide layout for every other shape and for a ``words`` view
    that starts one word off its 16 B alignment; both chains, bit for bit."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.score_est.ops import flat_score_estimate, flat_score_estimate_plain
    gen = torch.Generator(device=dev).manual_seed(9)
    shape = (b, n, kv, r // 16)
    flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (math.prod(shape) + 1,), generator=gen,
                         device=dev, dtype=torch.int32)
    words = flat[1:].view(shape) if unaligned else flat[:-1].view(shape)
    assert (words.data_ptr() % 16 != 0) == unaligned
    fs = torch.rand((b, n, kv), generator=gen, device=dev)
    fz = torch.randn((b, n, kv), generator=gen, device=dev)
    qc = torch.randint(-3, 4, (b, kv, g, r), generator=gen, device=dev, dtype=torch.int8)
    qs = torch.rand((b, kv, g), generator=gen, device=dev)
    args = (qc, qs, words, fs, fz)
    n0 = LAUNCHES["score_estimate"]
    out = flat_score_estimate(*args, bf16=bf16)
    assert LAUNCHES["score_estimate"] == n0 + 1
    assert torch.equal(out, flat_score_estimate_plain(*args, bf16=bf16))


@pytest.mark.parametrize("bh,g,c,hd,density", [
    (1, 1, 256, 64, 1.0), (2, 4, 512, 128, 0.7), (3, 2, 100, 128, 0.3), (2, 8, 256, 256, 0.9),
    # with bh >= 4 the last rows are edge rows of B8's 64-token staging
    # chunks: live only in the last chunk, one live token, nothing live
    (4, 2, 40, 128, 0.5), (5, 2, 200, 128, 0.5), (4, 8, 300, 256, 0.6),
    (4, 1, 1000, 32, 0.2), (6, 4, 512, 64, 0.05),
    # HD 1024: the chunk's staged codes take over 48 KB of shared memory
    (2, 8, 130, 1024, 0.5)])
def test_b8_kernel_matches_plain(dev, bh, g, c, hd, density):
    """B8 within 1e-5 + 1e-5·|plain| (f32, other summation order), C not a
    multiple of 32 included; a row with nothing selected is exactly zero."""
    from repro_torch.kernels.flash_decode.ops import (
        FLAT_CHUNK, sparse_flash_decode, sparse_flash_decode_plain)
    gen = torch.Generator(device=dev).manual_seed(9)
    kc, vc = (torch.randint(-127, 128, (bh, c, hd), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((bh, c), generator=gen, device=dev) * 0.02 + 1e-3 for _ in range(2))
    mask = torch.rand((bh, c), generator=gen, device=dev) < density
    mask[:, 0] = True
    if bh >= 4:
        last = (c - 1) // FLAT_CHUNK * FLAT_CHUNK          # the last chunk's first token
        mask[-3] = False
        mask[-3, last:] = torch.rand((c - last,), generator=gen, device=dev) < 0.5
        mask[-3, c - 1] = True
        mask[-2] = False
        mask[-2, int(torch.randint(0, c, (1,), generator=gen, device=dev))] = True
    mask[-1] = False
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    args = (q, kc, ks, vc, vs, mask)
    out = sparse_flash_decode(*args)
    ref = sparse_flash_decode_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert (out[-1] == 0).all()


@pytest.mark.parametrize("g,hd,c", [(2, 128, 512), (8, 64, 150), (1, 256, 96), (4, 128, 300)])
def test_b8_equals_b2_bitwise_on_the_same_runs(dev, g, hd, c):
    """Where a row's gathered tokens are B2's blocks in order, masked at the
    same positions (blocks of 32; dead positions, a dead block and a short
    last run included), B8 walks B2's runs and gives B2's output bit for
    bit; an all-masked row is zero in both."""
    from repro_torch.kernels.flash_decode.ops import (
        sparse_flash_decode, sparse_flash_decode_paged_kernel)
    gen = torch.Generator(device=dev).manual_seed(11)
    bs, kv, bh = 32, 2, 4
    nsb = -(-c // bs)
    p = bh * nsb + 3
    kc, vc = (torch.randint(-127, 128, (p, bs, kv, hd), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((p, bs, kv), generator=gen, device=dev) * 0.02 + 1e-3
              for _ in range(2))
    pblk = torch.randperm(p, generator=gen, device=dev)[:bh * nsb].reshape(bh, nsb)
    mask = torch.rand((bh, c), generator=gen, device=dev) < 0.7
    mask[0, bs:2 * bs] = False                     # a dead block inside row 0
    mask[-1] = False
    bmask = torch.zeros((bh, nsb * bs), dtype=torch.bool, device=dev)
    bmask[:, :c] = mask
    # row b's tokens in block order: pool[pblk[b, n], t, b % kv]
    rows = (pblk.long()[:, :, None], torch.arange(bs, device=dev)[None, None, :],
            (torch.arange(bh, device=dev) % kv)[:, None, None])
    gk, gks, gv, gvs = (x[rows].reshape(bh, nsb * bs, *x.shape[3:])[:, :c].contiguous()
                        for x in (kc, ks, vc, vs))
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    out2 = sparse_flash_decode_paged_kernel(
        q, kc, ks, vc, vs, pblk.to(torch.int32),
        torch.full((bh,), nsb, dtype=torch.int32, device=dev),
        bmask.reshape(bh, nsb, bs), kv)
    out8 = sparse_flash_decode(q, gk, gks, gv, gvs, mask)
    assert torch.equal(out8, out2)
    assert (out8[-1] == 0).all()


def _random_rows(dev, mode, bh=6, g=2, hd=128, bs=32, kv=2, nsb=5, seed=12):
    """B2/B6 operands over a random pool in storage mode ``mode``: random
    codes (int4: any byte), scales per token (int8) or per block, lists of
    random length over scrambled blocks (row 0 lists nothing, row 1 all nsb)
    and random block masks, False past each row's count."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = bh * nsb + 3
    width = hd // 2 if mode == "int4" else hd
    if mode == "fp16":
        kc, vc = (torch.randn((p, bs, kv, hd), generator=gen, device=dev).half()
                  for _ in range(2))
    else:
        kc, vc = (torch.randint(-128, 128, (p, bs, kv, width), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
    srows = bs if mode == "int8" else 1
    ks, vs = (torch.rand((p, srows, kv), generator=gen, device=dev) * 0.02 + 1e-3
              for _ in range(2))
    pblk = torch.randperm(p, generator=gen, device=dev)[:bh * nsb].reshape(bh, nsb)
    counts = torch.randint(1, nsb + 1, (bh,), generator=gen, device=dev)
    counts[0], counts[1] = 0, nsb
    live = torch.arange(nsb, device=dev)[None, :] < counts[:, None]
    bmask = (torch.rand((bh, nsb, bs), generator=gen, device=dev) < 0.6) & live[..., None]
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    return (q, kc, ks, vc, vs, pblk.to(torch.int32), counts.to(torch.int32), bmask, kv, mode)


@pytest.mark.parametrize("mode", ["int8", "fp16", "int4"])
@pytest.mark.parametrize("bs", [16, 32])
def test_b2_equals_normalised_b6_bitwise(dev, mode, bs):
    """B2 is B6's walk normalised: its output equals acc / max(l, 1e-20) of
    B6 bit for bit in every branch, a row that lists nothing included."""
    from repro_torch.kernels.flash_decode.ops import (
        sparse_flash_decode_paged_kernel, sparse_flash_decode_paged_partials_kernel)
    args = _random_rows(dev, mode, bs=bs)
    out = sparse_flash_decode_paged_kernel(*args)
    acc, m, l = sparse_flash_decode_paged_partials_kernel(*args)
    assert torch.equal(out, acc / torch.clamp_min(l, 1e-20)[..., None])
    assert (out[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()


@pytest.mark.parametrize("mode,hd,bs,g", [("int8", 512, 32, 2), ("fp16", 512, 16, 4),
                                          ("int4", 288, 20, 1), ("int8", 128, 48, 8),
                                          ("fp16", 96, 6, 2), ("int4", 64, 24, 2)])
def test_b2_b6_wide_heads_and_odd_blocks_match_plain(dev, mode, hd, bs, g):
    """HD 512 (eight CTAs of 64 channels per row, the cap), HD 288 (a last
    CTA of 32 of its 64 channels), blocks of 6-48 tokens (a mask row copied
    byte by byte, a max over two lane passes, steps of 2-21 blocks): B2
    within 1e-5 + 1e-5·|plain| of its plain version, and B6 normalised
    equal to B2."""
    from repro_torch.kernels.flash_decode import ops as fd
    args = _random_rows(dev, mode, g=g, hd=hd, bs=bs, nsb=4)
    q, kc, ks, vc, vs, pblk, counts, bmask, kv, _ = args
    out = fd.sparse_flash_decode_paged_kernel(*args)
    want = fd.sparse_flash_decode_paged_plain(q, kc, ks, vc, vs, pblk, bmask, kv, mode)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    acc, _, l = fd.sparse_flash_decode_paged_partials_kernel(*args)
    assert torch.equal(out, acc / torch.clamp_min(l, 1e-20)[..., None])


def test_b3_b8_refuse_misaligned_operands(dev):
    """B3's bf16 branch and B8 copy their operands in 16-byte units: a
    contiguous view that does not start 16-byte aligned is refused with a
    ValueError instead of faulting on the card."""
    from repro_torch.kernels.flash_decode.ops import sparse_flash_decode
    from repro_torch.kernels.flash_prefill.ops import flash_attention

    def off_by_one(shape, dtype):
        n = math.prod(shape)
        return torch.zeros(n + 1, dtype=dtype, device=dev)[1:].view(shape)

    k = torch.zeros((2, 64, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(off_by_one((4, 64, 32), torch.bfloat16), k, k)
    bh, g, c, hd = 2, 2, 64, 32
    q = torch.zeros((bh, g, hd), device=dev)
    ks = torch.ones((bh, c), device=dev)
    vc = torch.zeros((bh, c, hd), dtype=torch.int8, device=dev)
    mask = torch.ones((bh, c), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        sparse_flash_decode(q, off_by_one((bh, c, hd), torch.int8), ks, vc, ks, mask)


@pytest.mark.parametrize("bh,n,window,lengths,k", [
    (2, 1024, 7, None, None), (1, 4096, 1, None, None), (3, 2050, 11, None, None),
    (4, 8192, 7, None, None),
    (3, 8192, 7, (0, 1, 8192), None),                   # rows of length 0, 1 and N
    (9, 4096, 7, (3, 4, 5, 15, 16, 17, 31, 32, 33), None),  # 16 B and 32-position edges
    (4, 1001, 7, (1001, 997, 15, 17), None),            # N % 4 != 0: the scalar path
    (2, 4096, 67, (4096, 2049), None), (2, 4096, 129, (4095, 1), None),  # HALO 33, 64
    (2, 300_000, 7, (300_000, 262_147), None),          # chunked: the row exceeds the stage
    (2, 250_002, 129, (250_002, 249_999), None),        # chunked, N % 4 != 0, wide halo
    (3, 2048, 7, None, 0), (3, 2048, 7, None, 5000)])   # k = 0, k > N
@pytest.mark.parametrize("unaligned", [False, True])
def test_b9_kernel_bitwise(dev, monkeypatch, bh, n, window, lengths, k, unaligned):
    """Pooled bins, histogram and threshold bit for bit: ragged lengths,
    one empty row, halos across the CTAs' runs, and scores 4 B off a 16 B
    boundary (the scalar path). The outputs land on 0xFF-filled memory, so a
    position the kernel does not write shows."""
    from repro_torch.kernels.selection_fused import ops as sf
    gen = torch.Generator(device=dev).manual_seed(10)
    buf = torch.randn((bh * n + 1,), generator=gen, device=dev) * 4
    scores = (buf[1:] if unaligned else buf[:-1]).view(bh, n)
    if lengths is None:
        lengths = torch.randint(n // 2, n + 1, (bh,), generator=gen, device=dev,
                                dtype=torch.int32)
        lengths[0] = 0
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    lo = scores.amin(-1) - 0.25
    hi = scores.amax(-1)
    k = torch.full((bh,), max(8, n // 16) if k is None else k, dtype=torch.int32, device=dev)
    args = (scores, lo, hi, k, lengths)
    real_empty = torch.empty
    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", lambda *a, **kw: real_empty(*a, **kw).fill_(-1))
        got = sf.fused_bin_pool_threshold(*args, window=window)
    for t, p in zip(got, sf.fused_bin_pool_threshold_plain(*args, window=window)):
        assert torch.equal(t, p)


@pytest.mark.parametrize("wrapper", ["fused_bin_pool_threshold", "hist_threshold",
                                     "maxpool_int8"])
def test_b9_b10_b11_one_launch_per_call(dev, wrapper):
    """A call of each wrapper is one kernel in the profiler's trace: no fill,
    no memset, no copy (B11 with an int k, as the public API calls it)."""
    import json
    import os
    import tempfile
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.hist_topk.ops import hist_threshold
    from repro_torch.kernels.maxpool.ops import maxpool_int8
    from repro_torch.kernels.selection_fused.ops import fused_bin_pool_threshold
    gen = torch.Generator(device=dev).manual_seed(11)
    bh, n = 32, 8192
    scores = torch.randn((bh, n), generator=gen, device=dev)
    lo, hi = scores.amin(-1), scores.amax(-1)
    k = torch.full((bh,), 409, dtype=torch.int32, device=dev)
    lengths = torch.randint(1, n, (bh,), generator=gen, device=dev, dtype=torch.int32)
    bins = torch.randint(0, 256, (bh, n), generator=gen, device=dev, dtype=torch.uint8)
    call, kernel = {
        "fused_bin_pool_threshold": (lambda: fused_bin_pool_threshold(scores, lo, hi, k, lengths),
                                     "fused_bin_pool_threshold_kernel"),
        "hist_threshold": (lambda: hist_threshold(bins, 409), "hist_threshold_kernel"),
        "maxpool_int8": (lambda: maxpool_int8(bins, 7), "maxpool_u8_kernel")}[wrapper]
    call()
    torch.cuda.synchronize()
    for _ in range(3):              # a profiler session can lose its launches (PERF.md)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            call()
            torch.cuda.synchronize()
            time.sleep(0.05)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        device = [e["name"] for e in events
                  if str(e.get("cat", "")).lower() in ("kernel", "gpu_memset", "gpu_memcpy")]
        if device:
            break
    assert len(device) == 1 and kernel in device[0], device


def _mode_pools(mode, dev, seed=7, slots=3, max_seq=128, bs=16, lengths=(40, 0, 100)):
    """A pool in storage mode ``mode`` built on the CPU from prefills over
    scrambled blocks, and the same pool copied to the card."""
    import dataclasses

    from repro_torch.core import cache as tc
    from repro_torch.core.selection import SalcaParams
    gen = torch.Generator().manual_seed(seed)
    mb = max_seq // bs
    cpu = tc.empty_paged_cache(slots * mb, bs, slots, mb, 2, 32, 16, kv_pool_dtype=mode)
    perm = torch.randperm(slots * mb, generator=gen).to(torch.int32)
    for s, n in enumerate(lengths):
        if n:
            need = -(-n // bs)
            k, v = (torch.randn((1, n, 2, 32), generator=gen) for _ in range(2))
            src = tc.prefill_cache(k, v, max_seq=max_seq, params=SalcaParams(k=24, k_cap=48))
            pages = torch.full((mb,), -1, dtype=torch.int32)
            pages[:need] = perm[s * mb: s * mb + need]
            tc.prefill_into_pages(cpu, src, s, pages)
    card = dataclasses.replace(
        cpu, data={f: t.to(dev) for f, t in cpu.data.items()},
        **{f: getattr(cpu, f).to(dev) for f in ("heavy_idx", "length", "page_table",
                                                 "refcount", "sel_hist")})
    return cpu, card, perm


@pytest.mark.parametrize("mode", ["fp16", "int4"])
def test_b2_b6_per_block_branches_match_plain(dev, mode):
    """B2's and B6's fp16/int4 branches (f16 values or nibbles unpacked in
    the kernel, one scale word per block) against their plain versions on
    the same card inputs, with the launch counted under the branch's name."""
    from repro_torch.core.attention import salca_decode_attention_paged
    from repro_torch.core.selection import SalcaParams
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.flash_decode.ops import (
        _selected_block_plan, sparse_flash_decode_paged_kernel,
        sparse_flash_decode_paged_partials_kernel, sparse_flash_decode_paged_partials_plain,
        sparse_flash_decode_paged_plain)
    _, pool, _ = _mode_pools(mode, dev)
    q = torch.randn((3, 4, 32), generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev)
    _, sel = salca_decode_attention_paged(q, pool, SalcaParams(k=24, k_cap=48),
                                          return_selection=True)
    pblk, counts, bmask = _selected_block_plan(pool, sel)
    ops = (q.reshape(6, 2, 32), pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk)
    n0 = LAUNCHES[f"sparse_flash_decode_paged[{mode}]"]
    out = sparse_flash_decode_paged_kernel(*ops, counts, bmask, 2, mode)
    assert LAUNCHES[f"sparse_flash_decode_paged[{mode}]"] == n0 + 1
    torch.testing.assert_close(out, sparse_flash_decode_paged_plain(*ops, bmask, 2, mode),
                               rtol=1e-5, atol=1e-5)
    got = sparse_flash_decode_paged_partials_kernel(*ops, counts, bmask, 2, mode)
    want = sparse_flash_decode_paged_partials_plain(*ops, bmask, 2, mode)
    # acc's rounding scales with sum(p·|v|) (see test_b6_kernel_matches_plain)
    from repro_torch.core.quantization import pack_int4, unpack_int4
    vabs = ops[3].abs() if mode == "fp16" else pack_int4(unpack_int4(ops[3]).abs())
    mag = sparse_flash_decode_paged_partials_plain(*ops[:3], vabs, *ops[4:], bmask, 2, mode)[0]
    empty = counts == 0
    for t, p, scale in zip(got, want, (mag, want[1].abs(), want[2])):
        assert torch.equal(t[empty], p[empty])
        assert ((t - p).abs()[~empty] <= 1e-5 + 1e-5 * scale[~empty]).all()


@pytest.mark.parametrize("bh,n,window,k,kind", [
    (1, 512, 3, 16, "random"), (2, 4096, 7, 200, "random"), (3, 8192, 11, 1024, "random"),
    (32, 8192, 7, 409, "random"), (2, 1000, 7, 5000, "random"),
    (4, 8192, 7, 409, "equal"), (4, 8192, 7, 409, "zero"), (3, 1000, 7, 100, "zero"),
    (4, 8192, 7, 409, "runs"), (3, 1000, 7, 50, "runs"), (256, 8192, 7, 409, "random"),
    (256, 2048, 7, 100, "runs")])
def test_b10_b11_kernels_bitwise(dev, bh, n, window, k, kind):
    """B10 (max-pool) and B11 (histogram + threshold) equal their plain
    versions bit for bit, a ragged last run (N = 1000) and a k above N
    (threshold clamped to 1) included, on uniform bins and on skewed ones:
    every bin equal, all zero, and pooled rows (long runs of equal bins,
    zero past a length)."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.hist_topk.ops import hist_threshold, hist_threshold_plain
    from repro_torch.kernels.maxpool.ops import maxpool_int8, maxpool_int8_plain
    gen = torch.Generator(device=dev).manual_seed(9)
    bins = torch.randint(0, 256, (bh, n), generator=gen, device=dev, dtype=torch.uint8)
    if kind == "equal":
        bins.fill_(173)
    elif kind == "zero":
        bins.zero_()
    elif kind == "runs":
        bins = maxpool_int8_plain(bins, 7)
        bins[torch.arange(n, device=dev)[None, :] >= torch.randint(
            0, n + 1, (bh, 1), generator=gen, device=dev)] = 0
    n0 = dict(LAUNCHES)
    assert torch.equal(maxpool_int8(bins, window), maxpool_int8_plain(bins, window))
    kk = torch.full((bh,), k, dtype=torch.int32, device=dev)
    want = hist_threshold_plain(bins, kk)
    for kernel_k in (k, kk):        # an int, by value; a (BH,) tensor, by pointer
        for t, p in zip(hist_threshold(bins, kernel_k), want):
            assert torch.equal(t, p)
    assert LAUNCHES["maxpool_int8"] == n0.get("maxpool_int8", 0) + 1
    assert LAUNCHES["hist_threshold"] == n0.get("hist_threshold", 0) + 2


@pytest.mark.parametrize("n", [1, 17, 1000, 4097, 8192])
@pytest.mark.parametrize("window", [3, 7, 9, 33, 35, 129, 2049])
def test_b10_kernel_bitwise(dev, monkeypatch, window, n):
    """B10 equals its plain version bit for bit: windows pooled in registers
    (3-33; 7 by pool7) and by doubling in shared memory (35-2049), rows of 1,
    17 and 1000 bins (partial head and tail vectors), 4097 and 8192 (across
    CTAs), 1, 32 and 256 rows, rows that start off a 16 B boundary, on
    uniform, equal, zero and pooled bins. The outputs land on 0xFF-filled
    memory, so a position the kernel does not write shows."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.maxpool.ops import maxpool_int8, maxpool_int8_plain
    gen = torch.Generator(device=dev).manual_seed(13)
    real_empty = torch.empty
    for bh in (1, 32, 256):
        buf = torch.randint(0, 256, (bh * n + 16,), generator=gen, device=dev,
                            dtype=torch.uint8)
        for skew in (0, 5):
            bins = buf[skew:skew + bh * n].view(bh, n)
            for kind in ("random", "equal", "zero", "runs"):
                if kind == "equal":
                    bins.fill_(173)
                elif kind == "zero":
                    bins.zero_()
                elif kind == "runs":
                    bins.copy_(maxpool_int8_plain(torch.randint(
                        0, 256, (bh, n), generator=gen, device=dev, dtype=torch.uint8), 7))
                    bins[torch.arange(n, device=dev)[None, :] >= torch.randint(
                        0, n + 1, (bh, 1), generator=gen, device=dev)] = 0
                n0 = LAUNCHES["maxpool_int8"]
                with monkeypatch.context() as mp:
                    mp.setattr(torch, "empty", lambda *a, **kw: real_empty(*a, **kw).fill_(-1))
                    got = maxpool_int8(bins, window)
                assert LAUNCHES["maxpool_int8"] == n0 + 1
                assert got.data_ptr() % 16 == bins.data_ptr() % 16
                assert torch.equal(got, maxpool_int8_plain(bins, window)), (bh, skew, kind)


def _graphed_and_eager_runs(dev, engine_kw):
    """The same requests through an engine whose step replays a CUDA graph
    and through one built under `steps.eager()`: per run, the greedy tokens,
    every tick's logits (the slots' mask beside them), the launch counts and
    the step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.runtime.serve import Request, ServingEngine
    from repro_torch.runtime.steps import eager
    from repro_torch.weights import init_lm_params
    cfg = get_config("qwen3-0.6b").reduced()
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (150, 200, 170)]
    runs = []
    for graphed in (True, False):
        kw = dict(max_seq=256, slots=2, block_size=32, device=dev, **engine_kw)
        if graphed:
            eng = ServingEngine(cfg, params, **kw)
        else:
            with eager():
                eng = ServingEngine(cfg, params, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        ticks = []
        orig = eng._decode

        def rec(tok, act, orig=orig, ticks=ticks):
            nxt, logits = orig(tok, act)
            ticks.append((act.copy(), logits))
            return nxt, logits

        eng._decode = rec
        reset_launches()
        eng.run()
        torch.cuda.synchronize()
        runs.append(([r.output for r in reqs], ticks, dict(LAUNCHES), eng._step))
    return runs


@pytest.mark.parametrize("engine_kw", [
    dict(paged=True), dict(paged=True, kv_pool_dtype="fp16"),
    dict(paged=True, kv_pool_dtype="int4"),
    dict(paged=True, kv_pool_dtype="int4", host_spill=True, num_blocks=8, demote_after=1,
         spill_keep_recent=2),
    dict(paged=False)], ids=["int8", "fp16", "int4", "int4_spill", "contiguous"])
def test_graphed_engine_equals_eager(dev, engine_kw):
    """The engine's tick as a CUDA graph (the first tick eager, the second
    captured, then replays) against the same engine built under
    `steps.eager()`: greedy tokens identical, every tick's logits bit for
    bit (kept across ticks: the step hands out copies of its static
    outputs), and the launch counts equal — a replay counts one tick's
    launches, the capture none."""
    (tok_g, ticks_g, launches_g, step_g), (tok_e, ticks_e, launches_e, step_e) = \
        _graphed_and_eager_runs(dev, engine_kw)
    assert step_g.graphed and step_g._graph is not None and not step_e.graphed
    assert tok_g == tok_e
    assert len(ticks_g) == len(ticks_e) >= 3
    for (act_g, lg_g), (act_e, lg_e) in zip(ticks_g, ticks_e):
        assert (act_g == act_e).all() and torch.equal(lg_g, lg_e)
    assert launches_g == launches_e
    per_tick = step_g.launches_per_tick
    assert per_tick and all(launches_e[k] == n * len(ticks_e) for k, n in per_tick.items())


def test_int4_pack_and_append_on_card_bitwise_equals_cpu(dev):
    """Nibble packing over the full code range and every byte, and the int4
    pool's prefill transcode and block append (scale growth, rescale,
    resets at fresh blocks, a dropped write into the sink) give the same
    bits on the card as on the CPU (where they match the reference)."""
    from repro_torch.core import cache as tc
    from repro_torch.core import quantization as qz
    c = torch.arange(-7, 8, dtype=torch.int8)
    codes = torch.stack([c.repeat_interleave(15), c.repeat(15)], -1).reshape(3, 150)
    every = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8).reshape(2, 128)
    assert torch.equal(qz.pack_int4(codes.to(dev)).cpu(), qz.pack_int4(codes))
    assert torch.equal(qz.unpack_int4(every.to(dev)).cpu(), qz.unpack_int4(every))
    cpu, card, perm = _mode_pools("int4", dev)
    gen = torch.Generator().manual_seed(10)
    cpu.length[1] = -1                      # a masked slot: its writes go to the sink
    card.length[1] = -1
    fresh = perm[8:10].tolist()             # slot 1's unused blocks
    for i in range(30):
        k, v = (torch.randn((3, 2, 32), generator=gen) * (4.0 if i % 5 == 2 else 0.5)
                for _ in range(2))
        cur = int(cpu.length[0])
        if cur % 16 == 0 and int(cpu.page_table[0, cur // 16]) < 0:
            b = fresh.pop(0)
            tc.map_block(cpu, 0, cur // 16, b)
            tc.map_block(card, 0, cur // 16, b)
        tc.append_token_paged(cpu, k, v)
        tc.append_token_paged(card, k.to(dev), v.to(dev))
    for f in cpu.data:
        assert torch.equal(card.data[f][:-1].cpu(), cpu.data[f][:-1]), f
    for f in ("length", "page_table", "refcount"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
