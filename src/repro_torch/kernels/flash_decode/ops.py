"""Kernels B2, B6 and B8: exact sparse attention over quantized K/V, their
plain PyTorch versions, and the paged front-ends.

B2 replaces `repro/kernels/flash_decode/kernel.py::sparse_flash_decode_paged_pallas`.
Each row b = slot·KV + kv walks its list of ``counts[b]`` physical blocks;
per block: K·q dot, scale and 1/sqrt(HD), the selection mask, online
softmax and the V sum, all in f32, normalised with ``max(l, 1e-20)``. The
pool's three storage modes are three branches of one kernel: int8 codes
with per-token scales (``s * ks * scale``), and f16 values or packed int4
codes with one scale per (block, kv head) (``s * (ks * scale)``, the
reference's order). B6 replaces `sparse_flash_decode_paged_partials_pallas`:
the same walk stopped before the normalisation, returning the online-softmax
state (acc, m, l) a block-sharded rank contributes to the cross-rank merge.
B8 replaces `sparse_flash_decode_pallas`: the same math over rows already
gathered into (BH, C, ·) arrays (the contiguous tick), scaled by a multiply
with 1/sqrt(HD) as the TPU kernel does.

CUDA source of all three: ``repro_torch/csrc/flash_decode.cu`` (one template).
Launch counters: ``sparse_flash_decode_paged`` / ``…_partials`` for the
int8 branch, with ``[fp16]`` or ``[int4]`` appended for the others.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.cache import _localize_pages
from repro_torch.core.histogram_topk import compact_indices
from repro_torch.core.quantization import unpack_int4
from repro_torch.kernels import common

NEG_INF = -1e30
GROUPS = (1, 2, 4, 8)    # query heads per kv head the CUDA kernel is built for
CODES = {"int8": 0, "fp16": 1, "int4": 2}   # the kernel's storage branch


def _counter(name: str, kv_dtype: str) -> str:
    return name if kv_dtype == "int8" else f"{name}[{kv_dtype}]"


def _paged_scores_plain(q, k_codes, k_scale, v_codes, v_scale, pblk, blk_mask, num_kv,
                        kv_dtype):
    """The plain versions' shared front: gather each row's listed blocks
    (int4 unpacked, per-block scales broadcast over the block's tokens) and
    score them. Returns (masked scores (BH, G, C), V (BH, C, HD) f32, mask
    (BH, 1, C)) over the flattened (BH, NSB·BS) stream."""
    bh, g, hd = q.shape
    bs = k_codes.shape[1]
    nsb = pblk.shape[1]
    kvb = (torch.arange(bh, device=q.device) % num_kv)[:, None, None]
    tok = torch.arange(bs, device=q.device)[None, None, :]
    pb = pblk.long()[:, :, None]
    kc, vc = k_codes[pb, tok, kvb], v_codes[pb, tok, kvb]
    if kv_dtype == "int4":
        kc, vc = unpack_int4(kc), unpack_int4(vc)
    kc = kc.reshape(bh, nsb * bs, hd).float()
    vc = vc.reshape(bh, nsb * bs, hd).float()
    stok = tok if kv_dtype == "int8" else torch.zeros_like(tok)
    ks = k_scale[pb, stok, kvb].reshape(bh, nsb * bs)
    vs = v_scale[pb, stok, kvb].reshape(bh, nsb * bs)
    mask = blk_mask.reshape(bh, 1, nsb * bs)
    s = torch.einsum("bgd,bcd->bgc", q.float(), kc)
    if kv_dtype == "int8":
        s = s * ks[:, None, :] / math.sqrt(hd)
    else:
        s = s * (ks[:, None, :] * (1.0 / math.sqrt(hd)))     # the kernels' per-block order
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), vc * vs[..., None], mask


def sparse_flash_decode_paged_plain(q, k_codes, k_scale, v_codes, v_scale, pblk,
                                    blk_mask, num_kv: int,
                                    kv_dtype: str = "int8") -> torch.Tensor:
    """Plain version (mirrors the reference `sparse_flash_decode_paged_ref`):
    gather each row's listed blocks, then softmax attention over the
    flattened (BH, NSB·BS) stream with the block masks."""
    s, v, mask = _paged_scores_plain(q, k_codes, k_scale, v_codes, v_scale, pblk, blk_mask,
                                     num_kv, kv_dtype)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    return torch.einsum("bgc,bcd->bgd", p, v) / torch.clamp_min(l, 1e-20)


def sparse_flash_decode_plain(q, k_codes, k_scale, v_codes, v_scale, mask) -> torch.Tensor:
    """Plain version of B8 (mirrors the reference `sparse_flash_decode_ref`)."""
    hd = q.shape[-1]
    s = torch.einsum("bgd,bcd->bgc", q.float(), k_codes.float())
    s = s * k_scale[:, None, :] / math.sqrt(hd)
    m3 = mask[:, None, :]
    s = torch.where(m3, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(m3, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    v = v_codes.float() * v_scale[..., None]
    return torch.einsum("bgc,bcd->bgd", p, v) / torch.clamp_min(l, 1e-20)


def sparse_flash_decode(q, k_codes, k_scale, v_codes, v_scale, mask) -> torch.Tensor:
    """Exact attention of q (BH, G, HD) f32 over gathered int8 K/V codes (BH,
    C, HD) with scales (BH, C) f32 and mask (BH, C) bool → (BH, G, HD) f32;
    a row with nothing selected returns zeros. CPU tensors take the plain
    version; CUDA tensors launch kernel B8."""
    if q.device.type == "cpu":
        return sparse_flash_decode_plain(q, k_codes, k_scale, v_codes, v_scale, mask)
    bh, g, hd = q.shape
    c = k_codes.shape[1]
    dev = q.device
    if hd % 32 or hd > 1024 or g not in GROUPS or c < 1:
        raise ValueError(f"kernel B8 needs HD a multiple of 32 (≤1024), G in {GROUPS} and "
                         f"C ≥ 1; got HD={hd}, G={g}, C={c}")
    common.require(q, "q", torch.float32, (bh, g, hd), dev)
    common.require(k_codes, "k_codes", torch.int8, (bh, c, hd), dev)
    common.require(k_scale, "k_scale", torch.float32, (bh, c), dev)
    common.require(v_codes, "v_codes", torch.int8, (bh, c, hd), dev)
    common.require(v_scale, "v_scale", torch.float32, (bh, c), dev)
    common.require(mask, "mask", torch.bool, (bh, c), dev)
    out = torch.empty((bh, g, hd), dtype=torch.float32, device=dev)
    fn = common.load("flash_decode", "sparse_flash_decode",
                     [common.P] * 7 + [common.I] * 4 + [common.F, common.P])
    err = fn(q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
             v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), bh, g, hd, c,
             1.0 / math.sqrt(hd), common.stream_ptr(out))
    common.check(err, "sparse_flash_decode")
    common.LAUNCHES["sparse_flash_decode"] += 1
    return out


def _check_b2_operands(q, k_codes, k_scale, v_codes, v_scale, pblk, counts, blk_mask,
                       num_kv, kv_dtype):
    """Validate the CUDA operands shared by B2 and B6 in pool mode
    ``kv_dtype``; returns (BH, G, HD)."""
    bh, g, hd = q.shape
    p, bs = k_codes.shape[:2]
    nsb = pblk.shape[1]
    dev = q.device
    if kv_dtype not in CODES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    if hd % 32 or hd > 1024 or g not in GROUPS:
        raise ValueError(f"kernels B2/B6 need HD a multiple of 32 (≤1024) and G in "
                         f"{GROUPS}; got HD={hd}, G={g}")
    code_dt = torch.float16 if kv_dtype == "fp16" else torch.int8
    code_shape = (p, bs, num_kv, hd // 2 if kv_dtype == "int4" else hd)
    scale_shape = (p, bs if kv_dtype == "int8" else 1, num_kv)
    common.require(q, "q", torch.float32, (bh, g, hd), dev)
    common.require(k_codes, "k_codes", code_dt, code_shape, dev)
    common.require(k_scale, "k_scale", torch.float32, scale_shape, dev)
    common.require(v_codes, "v_codes", code_dt, code_shape, dev)
    common.require(v_scale, "v_scale", torch.float32, scale_shape, dev)
    common.require(pblk, "pblk", torch.int32, (bh, nsb), dev)
    common.require(counts, "counts", torch.int32, (bh,), dev)
    common.require(blk_mask, "blk_mask", torch.bool, (bh, nsb, bs), dev)
    return bh, g, hd


def sparse_flash_decode_paged_kernel(q, k_codes, k_scale, v_codes, v_scale, pblk,
                                     counts, blk_mask, num_kv: int,
                                     kv_dtype: str = "int8") -> torch.Tensor:
    """q (BH, G, HD) f32 with BH = slots·KV (kv = row % KV); the pool's K/V
    in mode ``kv_dtype``: int8 codes (P, BS, KV, HD) + scales (P, BS, KV),
    f16 values (P, BS, KV, HD) or packed int4 codes (P, BS, KV, HD/2) +
    scales (P, 1, KV); pblk (BH, NSB) int32; counts (BH,) int32; blk_mask
    (BH, NSB, BS) bool → (BH, G, HD) f32. CPU tensors take the plain
    version; CUDA tensors launch kernel B2's branch for the mode."""
    if q.device.type == "cpu":
        return sparse_flash_decode_paged_plain(q, k_codes, k_scale, v_codes, v_scale,
                                               pblk, blk_mask, num_kv, kv_dtype)
    bh, g, hd = _check_b2_operands(q, k_codes, k_scale, v_codes, v_scale, pblk, counts,
                                   blk_mask, num_kv, kv_dtype)
    out = torch.empty((bh, g, hd), dtype=torch.float32, device=q.device)
    fn = common.load("flash_decode", "sparse_flash_decode_paged",
                     [common.P] * 9 + [common.I] * 6 + [common.F, common.I, common.P])
    err = fn(q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
             v_scale.data_ptr(), pblk.data_ptr(), counts.data_ptr(),
             blk_mask.data_ptr(), out.data_ptr(), bh, g, hd, k_codes.shape[1], num_kv,
             pblk.shape[1], 1.0 / math.sqrt(hd), CODES[kv_dtype], common.stream_ptr(out))
    name = _counter("sparse_flash_decode_paged", kv_dtype)
    common.check(err, name)
    common.LAUNCHES[name] += 1
    return out


def sparse_flash_decode_paged_partials_plain(q, k_codes, k_scale, v_codes, v_scale, pblk,
                                             blk_mask, num_kv: int, kv_dtype: str = "int8"):
    """Plain version (mirrors the reference `sparse_flash_decode_paged_partials_ref`):
    the gather of `sparse_flash_decode_paged_plain`, then the unnormalised
    softmax state. Rows with nothing selected give (0, NEG_INF, 0)."""
    s, v, mask = _paged_scores_plain(q, k_codes, k_scale, v_codes, v_scale, pblk, blk_mask,
                                     num_kv, kv_dtype)
    m = s.amax(-1)                     # all-masked rows: exactly NEG_INF
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum("bgc,bcd->bgd", p, v), m, p.sum(-1)


def sparse_flash_decode_paged_partials_kernel(q, k_codes, k_scale, v_codes, v_scale, pblk,
                                              counts, blk_mask, num_kv: int,
                                              kv_dtype: str = "int8"):
    """B2's operands → (acc (BH, G, HD), m (BH, G), l (BH, G)) f32, the
    unnormalised online-softmax state. CPU tensors take the plain version;
    CUDA tensors launch kernel B6's branch for the pool mode ``kv_dtype``."""
    if q.device.type == "cpu":
        return sparse_flash_decode_paged_partials_plain(q, k_codes, k_scale, v_codes,
                                                        v_scale, pblk, blk_mask, num_kv,
                                                        kv_dtype)
    bh, g, hd = _check_b2_operands(q, k_codes, k_scale, v_codes, v_scale, pblk, counts,
                                   blk_mask, num_kv, kv_dtype)
    acc = torch.empty((bh, g, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, g), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, g), dtype=torch.float32, device=q.device)
    fn = common.load("flash_decode", "sparse_flash_decode_paged_partials",
                     [common.P] * 11 + [common.I] * 6 + [common.F, common.I, common.P])
    err = fn(q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
             v_scale.data_ptr(), pblk.data_ptr(), counts.data_ptr(), blk_mask.data_ptr(),
             acc.data_ptr(), m.data_ptr(), l.data_ptr(), bh, g, hd, k_codes.shape[1],
             num_kv, pblk.shape[1], 1.0 / math.sqrt(hd), CODES[kv_dtype],
             common.stream_ptr(acc))
    name = _counter("sparse_flash_decode_paged_partials", kv_dtype)
    common.check(err, name)
    common.LAUNCHES[name] += 1
    return acc, m, l


def _selected_block_plan(pool, sel, block_range=None):
    """Resolve a Selection (S, KV, C) to per-row physical block lists:

    * pblk (S·KV, NSB) int32 — physical ids of the logical blocks the
      selection touches, ascending, padding at the clamped block of
      logical 0;
    * counts (S·KV,) int32 — live entries per row;
    * bmask (S·KV, NSB, BS) bool — the selected tokens of each listed block
      (False on padding).

    With ``block_range`` the plan is rank-local: only selected blocks this
    rank owns are listed, with local ids; a row owning none of its
    selection gets ``counts == 0``.
    """
    s, kv, c = sel.indices.shape
    bs, mb, l = pool.block_size, pool.max_blocks, pool.max_seq
    nsb = max(1, min(mb, c))
    bh = s * kv
    idx = torch.clamp(sel.indices, 0, l - 1).reshape(bh, c).long()
    m = sel.mask.reshape(bh, c).to(torch.int32)
    tok = torch.zeros((bh, l), dtype=torch.int32, device=idx.device)
    tok.scatter_add_(1, idx, m)
    blk_active = torch.zeros((bh, mb), dtype=torch.int32, device=idx.device)
    blk_active.scatter_add_(1, torch.div(idx, bs, rounding_mode="floor"), m)
    active = blk_active > 0
    if block_range is None:
        pt = pool.clamped_pages()
    else:
        local = _localize_pages(pool.page_table, block_range)
        active &= torch.repeat_interleave(local >= 0, kv, dim=0)
        pt = torch.clamp_min(local, 0)
    lblk, lmask, cnt = compact_indices(active, nsb)
    pt = torch.repeat_interleave(pt, kv, dim=0)
    pblk = torch.gather(pt, 1, lblk.long())
    bmask = torch.gather((tok > 0).reshape(bh, mb, bs), 1,
                         lblk.long()[:, :, None].expand(bh, nsb, bs))
    return pblk.to(torch.int32), cnt.to(torch.int32), bmask & lmask[:, :, None]


def sparse_flash_decode_paged(q: torch.Tensor, pool, sel) -> torch.Tensor:
    """Exact attention of q (S, H, HD) over the tokens a Selection names,
    fetching only the selected physical blocks. Returns (S, H, HD) f32."""
    s, h, hd = q.shape
    kv = pool.num_kv_heads
    pblk, counts, bmask = _selected_block_plan(pool, sel)
    out = sparse_flash_decode_paged_kernel(
        q.reshape(s * kv, h // kv, hd).contiguous(), pool.k_codes, pool.k_scale,
        pool.v_codes, pool.v_scale, pblk, counts, bmask, kv, pool.kv_pool_dtype)
    return out.reshape(s, h, hd)


def sparse_flash_decode_paged_partials(q: torch.Tensor, pool, sel, block_range=None):
    """Rank-local leg of the block-sharded exact attention: the unnormalised
    (acc (S, KV, G, HD), m (S, KV, G), l (S, KV, G)) over the selected blocks
    this rank holds (``block_range``), for the caller's cross-rank merge."""
    s, h, hd = q.shape
    kv = pool.num_kv_heads
    g = h // kv
    pblk, counts, bmask = _selected_block_plan(pool, sel, block_range)
    acc, m, l = sparse_flash_decode_paged_partials_kernel(
        q.reshape(s * kv, g, hd).contiguous(), pool.k_codes, pool.k_scale, pool.v_codes,
        pool.v_scale, pblk, counts, bmask, kv, pool.kv_pool_dtype)
    return acc.reshape(s, kv, g, hd), m.reshape(s, kv, g), l.reshape(s, kv, g)
