"""Salca KV cache in PyTorch: quantized K/V + packed 2-bit heavy-channel features.

Port of the reference `core/cache.py`: the contiguous int8 cache
(`SalcaCache`: a prefill's cache, and the slot pool of the contiguous
engine with its primitives) and the paged block pool (`PagedSalcaCache`
and its primitives) in its three storage modes, ``kv_pool_dtype``:

* ``"int8"`` — int8 codes (P, BS, KV, HD) with per-token scales (P, BS, KV);
* ``"fp16"`` — f16 values (P, BS, KV, HD) with unit per-block scales
  (P, 1, KV) that nothing rewrites;
* ``"int4"`` — two signed nibbles per byte (P, BS, KV, HD/2) with one
  per-block, per-head scale (P, 1, KV).

The mode is inferred from the leaves, as in the reference. The 2-bit
feature stream is the same in every mode.

Layouts match the reference at every public field: contiguous leaves are
``(B, S, KV, ·)``, pool data leaves ``(P, BS, KV, ·)``, per-slot metadata
``(S, ·)``. Packed feature words are int32 tensors with the reference's
uint32 bits.

**In place.** The reference returns new caches; the port's primitives
update the cache's tensors in place (``index_put_``/``scatter_add_``/
``copy_``) and return the same object. No write needs a host-side mask and
no step syncs with the device: a contiguous append the reference drops
(cursor at or past ``max_seq``) writes the row's old values back through a
clamped index; a paged write the reference drops (unmapped block, full
slot, shared block) goes to one spare *sink* block kept past the public
``P`` blocks.

**Block-sharded pools.** The physical block dim can be split across the
ranks of a `distributed.sharding.DecodeCtx`: rank i holds only the data of
global ids ``[lo, hi) = [i·P/n, (i+1)·P/n)`` (plus its own sink block),
while the page table (global ids), lengths, heavy sets, refcount and
``sel_hist`` stay replicated. The primitives that take ``block_range`` see
such a local pool: resolutions into blocks outside ``[lo, hi)`` are flagged
unowned (reads) or land in the sink (writes) — the reference's
`_localize_pages` rule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import heavy_channels as hc
from repro_torch.core import quantization as qz
from repro_torch.core.selection import SalcaParams

PAGE_UNMAPPED = -1


class SalcaCache(NamedTuple):
    """Contiguous cache: one prefill's (the source of a slot or paged
    install), or the contiguous engine's slot pool (B = slots)."""
    k_codes: torch.Tensor     # (B, S, KV, HD) int8
    k_scale: torch.Tensor     # (B, S, KV) f32
    v_codes: torch.Tensor     # (B, S, KV, HD) int8
    v_scale: torch.Tensor     # (B, S, KV) f32
    feat_words: torch.Tensor  # (B, S, KV, R//16) int32 (uint32 bits)
    feat_scale: torch.Tensor  # (B, S, KV) f32
    feat_zero: torch.Tensor   # (B, S, KV) f32
    heavy_idx: torch.Tensor   # (B, KV, R) int32
    length: torch.Tensor      # (B,) int32

    @property
    def max_seq(self) -> int:
        return self.k_codes.shape[1]

    @property
    def num_kv_heads(self) -> int:
        return self.k_codes.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k_codes.shape[3]

    def valid_mask(self) -> torch.Tensor:
        """(B, S) bool: True where a real token is stored."""
        pos = torch.arange(self.max_seq, device=self.length.device)
        return pos[None, :] < self.length[:, None]


def empty_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int, r: int,
                device="cpu") -> SalcaCache:
    """An all-zero contiguous cache of ``batch`` rows (lengths 0)."""
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return SalcaCache(
        k_codes=z((batch, max_seq, kv_heads, head_dim), torch.int8),
        k_scale=z((batch, max_seq, kv_heads), torch.float32),
        v_codes=z((batch, max_seq, kv_heads, head_dim), torch.int8),
        v_scale=z((batch, max_seq, kv_heads), torch.float32),
        feat_words=z((batch, max_seq, kv_heads, r // qz.CODES_PER_WORD), torch.int32),
        feat_scale=z((batch, max_seq, kv_heads), torch.float32),
        feat_zero=z((batch, max_seq, kv_heads), torch.float32),
        heavy_idx=z((batch, kv_heads, r), torch.int32),
        length=z((batch,), torch.int32))


def _encode_tokens(k: torch.Tensor, v: torch.Tensor, heavy_idx: torch.Tensor):
    """Quantize K/V tokens (B, T, KV, HD) into cache field values, with the
    key features taken at heavy_idx (B, KV, R)."""
    k8 = qz.quantize_kv_int8(k)
    v8 = qz.quantize_kv_int8(v)
    r = heavy_idx.shape[-1]
    idx = heavy_idx[:, None].expand(k.shape[:3] + (r,)).long()
    f2 = qz.quantize_key_features(torch.gather(k.float(), -1, idx))
    return k8, v8, qz.pack2bit(f2.codes), f2.scale, f2.zero


def prefill_cache(k: torch.Tensor, v: torch.Tensor, max_seq: int,
                  params: SalcaParams,
                  heavy_idx: torch.Tensor | None = None) -> SalcaCache:
    """Cache of prefill K/V (B, T, KV, HD), zero-padded to ``max_seq``.
    The heavy channels are identified here, per kv head from Σ|K| over the
    prompt, unless ``heavy_idx`` (B, KV, R) is given."""
    b, t, kv, hd = k.shape
    r = params.r(hd)
    if heavy_idx is None:
        heavy_idx = hc.heavy_channel_indices(k.transpose(1, 2), r)
    k8, v8, words, fs, fz = _encode_tokens(k, v, heavy_idx)
    pad = max_seq - t
    assert pad >= 0, f"prefill length {t} exceeds cache capacity {max_seq}"

    def padt(x):  # pad the token dim (1)
        return torch.cat([x, x.new_zeros((b, pad) + x.shape[2:])], dim=1)

    return SalcaCache(
        k_codes=padt(k8.codes), k_scale=padt(k8.scale),
        v_codes=padt(v8.codes), v_scale=padt(v8.scale),
        feat_words=padt(words), feat_scale=padt(fs), feat_zero=padt(fz),
        heavy_idx=heavy_idx.to(torch.int32),
        length=torch.full((b,), t, dtype=torch.int32, device=k.device))


_DATA_FIELDS = ("k_codes", "k_scale", "v_codes", "v_scale",
                "feat_words", "feat_scale", "feat_zero")


def append_token(cache: SalcaCache, k: torch.Tensor, v: torch.Tensor) -> SalcaCache:
    """Append one decoded token's K/V (B, KV, HD) at each row's cursor
    (`cache.length`), which then advances to ``min(length + 1, max_seq)``.
    A cursor outside [0, max_seq) drops the write, as the reference's
    ``mode="drop"`` scatter does at ``max_seq`` (its callers never pass a
    negative cursor): the row's old values are written back through the
    clamped index, so nothing syncs with the host. In place."""
    b = k.shape[0]
    cur = cache.length
    ok = (cur >= 0) & (cur < cache.max_seq)
    rows = torch.arange(b, device=cur.device)
    at = torch.clamp(cur, 0, cache.max_seq - 1).long()
    k8, v8, words, fs, fz = _encode_tokens(k[:, None], v[:, None], cache.heavy_idx)
    vals = (k8.codes, k8.scale, v8.codes, v8.scale, words, fs, fz)
    for f, val in zip(_DATA_FIELDS, vals):
        buf = getattr(cache, f)
        keep = ok.reshape((b,) + (1,) * (val.ndim - 2))
        buf[rows, at] = torch.where(keep, val[:, 0], buf[rows, at])
    cache.length.copy_(torch.clamp_max(cur + 1, cache.max_seq))
    return cache


def write_prefill_into_slot(pool: SalcaCache, src: SalcaCache, slot: int) -> SalcaCache:
    """Write a batch=1 cache into row ``slot`` of a pooled cache: every field,
    the heavy-channel set and the length cursor included; other rows are
    untouched. ``src`` must match ``pool`` on every trailing dim. In place."""
    if src.k_codes.shape[0] != 1:
        raise ValueError(f"src cache must have batch 1, got {src.k_codes.shape[0]}")
    if pool.k_codes.shape[1:] != src.k_codes.shape[1:]:
        raise ValueError(f"slot shape mismatch: pool {tuple(pool.k_codes.shape[1:])} "
                         f"vs src {tuple(src.k_codes.shape[1:])}")
    for p, x in zip(pool, src):
        p[slot] = x[0].to(p.dtype)
    return pool


def reset_slot(pool: SalcaCache, slot: int) -> SalcaCache:
    """Mark row ``slot`` empty (length 0); its data rows stay for the next
    admission to overwrite (the valid mask gates every read). In place."""
    pool.length[slot] = 0
    return pool


def append_token_masked(cache: SalcaCache, k: torch.Tensor, v: torch.Tensor,
                        active: torch.Tensor | None) -> SalcaCache:
    """`append_token` under an active-row mask (B,) bool: inactive rows drop
    the write (cursor forced to ``max_seq``) and keep their stored length;
    active rows advance to ``min(length + 1, max_seq)``. In place."""
    if active is None:
        return append_token(cache, k, v)
    old_len = cache.length.clone()
    cache.length.copy_(torch.where(active, old_len, cache.max_seq))
    append_token(cache, k, v)
    cache.length.copy_(torch.where(active, torch.clamp_max(old_len + 1, cache.max_seq),
                                   old_len))
    return cache


def cache_bytes(cache: SalcaCache) -> dict[str, int]:
    """Physical bytes of a contiguous cache by region."""
    def nbytes(x):
        return x.numel() * x.element_size()
    kv = sum(nbytes(getattr(cache, f)) for f in ("k_codes", "v_codes", "k_scale", "v_scale"))
    feats = sum(nbytes(getattr(cache, f)) for f in ("feat_words", "feat_scale", "feat_zero"))
    return {"kv_region": kv, "feature_region": feats, "total": kv + feats}


@dataclass
class PagedSalcaCache:
    """One layer's paged block pool: shared physical blocks + per-slot
    page tables. ``data`` holds the seven data leaves with one extra sink
    block at index P; the public leaves are the views of blocks [0, P)."""
    data: dict
    heavy_idx: torch.Tensor   # (S, KV, R) int32
    length: torch.Tensor      # (S,) int32
    page_table: torch.Tensor  # (S, MB) int32, -1 = unmapped
    refcount: torch.Tensor    # (P,) int32
    sel_hist: torch.Tensor    # (S, MB) int32, selected tokens per logical block

    k_codes = property(lambda self: self.data["k_codes"][:-1])        # (P, BS, KV, HD | HD/2)
    k_scale = property(lambda self: self.data["k_scale"][:-1])        # (P, BS | 1, KV) f32
    v_codes = property(lambda self: self.data["v_codes"][:-1])
    v_scale = property(lambda self: self.data["v_scale"][:-1])
    feat_words = property(lambda self: self.data["feat_words"][:-1])  # (P, BS, KV, R//16)
    feat_scale = property(lambda self: self.data["feat_scale"][:-1])
    feat_zero = property(lambda self: self.data["feat_zero"][:-1])

    @property
    def num_blocks(self) -> int:
        """Pool size P as the refcount counts it (global on a block-sharded
        rank, whose refcount is replicated)."""
        return self.refcount.shape[0]

    @property
    def sink(self) -> int:
        """Index of the sink block = the number of blocks held locally."""
        return self.data["k_codes"].shape[0] - 1

    @property
    def block_size(self) -> int:
        return self.data["k_codes"].shape[1]

    @property
    def num_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_blocks(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_seq(self) -> int:
        return self.max_blocks * self.block_size

    @property
    def num_kv_heads(self) -> int:
        return self.data["k_codes"].shape[2]

    @property
    def head_dim(self) -> int:
        hd = self.data["k_codes"].shape[3]
        return 2 * hd if self.kv_pool_dtype == "int4" else hd

    @property
    def kv_pool_dtype(self) -> str:
        """K/V storage mode, inferred from the leaves: f16 codes → "fp16";
        int8 codes with per-token scales → "int8"; with per-block scales
        (scale dim 1; the per-block modes need block_size > 1) → "int4"."""
        if self.data["k_codes"].dtype == torch.float16:
            return "fp16"
        if self.data["k_scale"].shape[1] == self.data["k_codes"].shape[1]:
            return "int8"
        return "int4"

    def valid_mask(self) -> torch.Tensor:
        """(S, L) bool: True where a real token is stored."""
        pos = torch.arange(self.max_seq, device=self.length.device)
        return pos[None, :] < self.length[:, None]

    def mapped_valid_mask(self) -> torch.Tensor:
        """(S, L) bool: stored AND its block mapped."""
        resident = torch.repeat_interleave(self.page_table >= 0, self.block_size, dim=-1)
        return self.valid_mask() & resident

    def clamped_pages(self) -> torch.Tensor:
        """Page table with unmapped entries clamped to block 0 for reads."""
        return torch.clamp_min(self.page_table, 0)

    def check_invariants(self, free_blocks=None, host_refcount=None) -> "InvariantReport":
        """Audit of the pool's bookkeeping (host-side, one device sync):
        refcount == page-table references, ids in range, cursors in
        [0, max_seq], mapped entries contiguous from logical 0, and — when
        given — the free list disjoint from every mapped block and covering
        every unreferenced block, the host refcount mirror equal to the
        device's. Never raises; returns an `InvariantReport`."""
        pt = self.page_table.cpu().numpy()
        rc = self.refcount.cpu().numpy()
        ln = self.length.cpu().numpy()
        p, mb = self.num_blocks, self.max_blocks
        rep = InvariantReport(checked={"slots": self.num_slots, "blocks": p,
                                       "max_blocks": mb})
        if ((ln < 0) | (ln > self.max_seq)).any():
            rep.fail(f"length out of [0, {self.max_seq}]")
        if (rc < 0).any():
            rep.fail(f"negative refcount at blocks {np.where(rc < 0)[0].tolist()}")
        if ((pt < PAGE_UNMAPPED) | (pt >= p)).any():
            rep.fail("page-table entry outside [-1, num_blocks)")
            pt = np.clip(pt, PAGE_UNMAPPED, p - 1)
        derived = np.bincount(pt[pt >= 0], minlength=p).astype(rc.dtype)
        if not (derived == rc).all():
            bad = np.where(derived != rc)[0]
            rep.fail(f"refcount mismatch at blocks {bad.tolist()[:8]}")
        if host_refcount is not None and not (np.asarray(host_refcount) == rc).all():
            rep.fail("host refcount mirror diverges from device")
        if free_blocks is not None:
            free = np.asarray(list(free_blocks), dtype=np.int64)
            if len(set(free.tolist())) != len(free):
                rep.fail("duplicate ids in the free list")
            elif free.size and ((free < 0) | (free >= p)).any():
                rep.fail("free-list id outside the pool")
            else:
                free_mask = np.zeros(p, bool)
                free_mask[free] = True
                if (free_mask & (derived > 0)).any():
                    rep.fail("free ∩ mapped ≠ ∅")
                if (~free_mask & (derived == 0)).any():
                    rep.fail(f"leaked blocks: "
                             f"{np.where(~free_mask & (derived == 0))[0].tolist()[:8]}")
        mapped = pt >= 0
        first_unmapped = np.where(mapped.all(axis=1), mb, np.argmin(mapped, axis=1))
        if (mapped & (np.arange(mb)[None, :] >= first_unmapped[:, None])).any():
            rep.fail("page-table hole below a mapped block")
        return rep


@dataclass
class InvariantReport:
    violations: list = field(default_factory=list)
    checked: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def fail(self, msg: str) -> None:
        self.violations.append(msg)


def empty_paged_cache(num_blocks: int, block_size: int, slots: int,
                      max_blocks: int, kv_heads: int, head_dim: int, r: int,
                      kv_pool_dtype: str = "int8", device="cpu",
                      local_blocks: int | None = None) -> PagedSalcaCache:
    """A pool of ``num_blocks`` blocks in storage mode ``kv_pool_dtype``
    (module docstring) whose data leaves hold ``local_blocks`` of them
    (default: all; a block-sharded rank holds its ``P/n``)."""
    n = (num_blocks if local_blocks is None else local_blocks) + 1   # + the sink block

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    # K/V codes and scales by mode; fp16's unit scales are never rewritten
    code_shape, code_dt = (n, block_size, kv_heads, head_dim), torch.int8
    scale_shape, scale_fill = (n, 1, kv_heads), 0.0
    if kv_pool_dtype == "int8":
        scale_shape = (n, block_size, kv_heads)
    elif kv_pool_dtype == "fp16":
        assert block_size > 1, "fp16 pool needs block_size > 1 (mode inference)"
        code_dt, scale_fill = torch.float16, 1.0
    elif kv_pool_dtype == "int4":
        assert block_size > 1, "int4 pool needs block_size > 1 (mode inference)"
        assert head_dim % 2 == 0, f"head_dim {head_dim} not packable to int4"
        code_shape = (n, block_size, kv_heads, head_dim // 2)
    else:
        raise ValueError(f"unknown kv_pool_dtype {kv_pool_dtype!r}")

    def scale():
        return torch.full(scale_shape, scale_fill, dtype=torch.float32, device=device)

    data = {
        "k_codes": z(code_shape, code_dt), "k_scale": scale(),
        "v_codes": z(code_shape, code_dt), "v_scale": scale(),
        "feat_words": z((n, block_size, kv_heads, r // qz.CODES_PER_WORD), torch.int32),
        "feat_scale": z((n, block_size, kv_heads), torch.float32),
        "feat_zero": z((n, block_size, kv_heads), torch.float32),
    }
    return PagedSalcaCache(
        data=data,
        heavy_idx=z((slots, kv_heads, r), torch.int32),
        length=z((slots,), torch.int32),
        page_table=torch.full((slots, max_blocks), PAGE_UNMAPPED, dtype=torch.int32,
                              device=device),
        refcount=z((num_blocks,), torch.int32),
        sel_hist=z((slots, max_blocks), torch.int32))


def _localize_pages(pages: torch.Tensor, block_range) -> torch.Tensor:
    """Global physical block ids → this rank's local ids; unowned and
    unmapped ids map to ``PAGE_UNMAPPED``. Identity without a range."""
    if block_range is None:
        return pages
    lo, hi = block_range
    owned = (pages >= lo) & (pages < hi)
    return torch.where(owned, pages - lo, PAGE_UNMAPPED)


def _refcount_add(refcount: torch.Tensor, pages: torch.Tensor, delta: int) -> None:
    """Add ``delta`` to refcount at every mapped (≥ 0) page id, in place."""
    pages = pages.reshape(-1).long()
    refcount.scatter_add_(0, pages.clamp_min(0),
                          torch.where(pages >= 0, delta, 0).to(refcount.dtype))


def prefill_into_pages(pool: PagedSalcaCache, src: SalcaCache, slot: int,
                       pages, block_range=None) -> PagedSalcaCache:
    """Write a batch=1 contiguous cache into the physical blocks named by
    ``pages`` (MB,) (-1 = not allocated: the write is dropped) and install
    the page table for ``slot``, which must be unmapped. In place.

    The int8 K/V rows are transcoded into the pool's mode: fp16 stores the
    dequantized rows verbatim (the unit scales stay), int4 requantizes each
    block with one scale per kv head (`sym_quantize_axes` over the block's
    tokens and channels).

    With ``block_range`` (a block-sharded rank, the prefill replicated on
    every rank) only the blocks this rank owns are written; the page table
    and refcount take the global ids everywhere."""
    if src.k_codes.shape[0] != 1:
        raise ValueError(f"src cache must have batch 1, got {src.k_codes.shape[0]}")
    if (pool.num_kv_heads, pool.head_dim) != tuple(src.k_codes.shape[2:]):
        raise ValueError("kv-head/head-dim mismatch between pool and src")
    if src.max_seq > pool.max_seq:
        raise ValueError(f"src length {src.max_seq} exceeds paged logical capacity "
                         f"{pool.max_seq}")
    bs, mb = pool.block_size, pool.max_blocks
    dev = pool.refcount.device
    pages = torch.as_tensor(pages, dtype=torch.int32).to(dev)
    local = _localize_pages(pages, block_range)
    sink = torch.where(local >= 0, local, pool.sink).long()
    pad = pool.max_seq - src.max_seq

    def to_blocks(f):     # (1, src_seq, KV, ·) → (MB, BS, KV, ·)
        val = getattr(src, f)[0]
        val = torch.cat([val, val.new_zeros((pad,) + val.shape[1:])], dim=0)
        return val.reshape((mb, bs) + val.shape[1:])

    blocks = {f: to_blocks(f) for f in _DATA_FIELDS}
    mode = pool.kv_pool_dtype
    if mode != "int8":
        for c, sc in (("k_codes", "k_scale"), ("v_codes", "v_scale")):
            x = blocks[c].float() * blocks.pop(sc)[..., None]
            if mode == "fp16":
                blocks[c] = x
            else:
                q, scale = qz.sym_quantize_axes(x, bits=4, axes=(1, 3))
                blocks[c], blocks[sc] = qz.pack_int4(q), scale[..., 0]    # (MB, 1, KV)
    for f, val in blocks.items():
        pool.data[f][sink] = val.to(pool.data[f].dtype)
    pool.heavy_idx[slot] = src.heavy_idx[0]
    pool.length[slot] = src.length[0]
    pool.page_table[slot] = pages
    _refcount_add(pool.refcount, pages, +1)
    pool.sel_hist[slot] = 0
    return pool


def append_token_paged(pool: PagedSalcaCache, k: torch.Tensor,
                       v: torch.Tensor, block_range=None) -> PagedSalcaCache:
    """Append one decoded token's K/V (S, KV, HD) at each slot's cursor
    (`pool.length`), resolved through the page table. Writes to unmapped
    blocks, past the logical capacity, or into a shared block (refcount > 1)
    are dropped and the cursor holds. In place.

    By mode: int8 stores the token's codes and scale; fp16 stores the raw
    row (no scale is written); int4 requantizes the target block
    (`_int4_block_append`).

    With ``block_range`` the cursor walk and the length advance run alike on
    every rank, but the data lands only on the rank owning the block."""
    s = k.shape[0]
    bs, mb = pool.block_size, pool.max_blocks
    cur = pool.length
    blk = torch.clamp(torch.div(cur, bs, rounding_mode="floor"), 0, mb - 1).long()
    sidx = torch.arange(s, device=cur.device)
    page = pool.page_table[sidx, blk]
    rc = pool.refcount[page.clamp_min(0).long()]
    ok = (cur >= 0) & (cur < pool.max_seq) & (page >= 0) & (rc <= 1)
    local = _localize_pages(page, block_range)
    pg = local.masked_fill_(~(ok & (local >= 0)), pool.sink).long()   # local: a temporary
    off = torch.remainder(cur, bs).long()
    k8, v8, words, fs, fz = _encode_tokens(k[:, None], v[:, None], pool.heavy_idx)
    vals = {"feat_words": words, "feat_scale": fs, "feat_zero": fz}
    mode = pool.kv_pool_dtype
    if mode == "int8":
        vals.update(k_codes=k8.codes, k_scale=k8.scale, v_codes=v8.codes, v_scale=v8.scale)
    elif mode == "fp16":
        vals.update(k_codes=k[:, None], v_codes=v[:, None])
    else:
        for c, sc, tok in (("k_codes", "k_scale", k), ("v_codes", "v_scale", v)):
            _int4_block_append(pool.data[c], pool.data[sc], tok, pg, off)
    for f, val in vals.items():
        pool.data[f][pg, off] = val[:, 0].to(pool.data[f].dtype)
    pool.length.add_(ok)
    return pool


def _int4_block_append(codes_buf: torch.Tensor, scale_buf: torch.Tensor, tok: torch.Tensor,
                       pg: torch.Tensor, off: torch.Tensor) -> None:
    """One token's int4 append for K or V, in place: the target block's
    per-head scale grows monotonically (``max(old, amax/7)``), the block's
    stored codes are rescaled into it and the token's row is set. At
    ``off == 0`` the scale resets to the token's own range, so a fresh or
    reused block inherits nothing. Dropped writes (``pg`` = the sink)
    requantize the sink, which nothing reads."""
    m = qz.INT4_MAXABS
    bs = codes_buf.shape[1]
    old_codes = qz.unpack_int4(codes_buf[pg]).float()            # (S, BS, KV, HD)
    old_scale = scale_buf[pg, 0]                                 # (S, KV)
    t32 = tok.float()                                            # (S, KV, HD)
    reset = (off == 0)[:, None]
    base = torch.where(reset, torch.zeros_like(old_scale), old_scale)
    new_scale = torch.clamp_min(torch.maximum(base, qz.div_const(t32.abs().amax(-1), m)),
                                1e-6)
    ratio = torch.where(reset, torch.zeros_like(old_scale), old_scale / new_scale)
    rescaled = torch.clamp(torch.round(old_codes * ratio[:, None, :, None]), -m, m)
    tok_codes = torch.clamp(torch.round(t32 / new_scale[..., None]), -m, m)
    row = torch.arange(bs, device=pg.device)[None, :, None, None] == off[:, None, None, None]
    merged = torch.where(row, tok_codes[:, None], rescaled).to(torch.int8)
    codes_buf[pg] = qz.pack_int4(merged)
    scale_buf[pg, 0] = new_scale


def map_block(pool: PagedSalcaCache, slot: int, logical_block: int,
              page: int, block_range=None) -> PagedSalcaCache:
    """Map one logical block of ``slot`` to physical block ``page``; the new
    page gains a reference and a previously mapped one releases it.

    ``block_range``: the reference's layout with a sharded refcount (each
    rank's ``refcount`` holds only its blocks) — the page-table write
    applies everywhere, the refcount deltas only on the owner."""
    old = pool.page_table[slot, logical_block].clone()
    new = torch.tensor([page], dtype=torch.int32, device=old.device)
    _refcount_add(pool.refcount, _localize_pages(new, block_range), +1)
    _refcount_add(pool.refcount, _localize_pages(old, block_range), -1)
    pool.page_table[slot, logical_block] = page
    return pool


def free_pages(pool: PagedSalcaCache, slot: int, block_range=None) -> PagedSalcaCache:
    """Release a slot: decref every block it maps, unmap its row, zero its
    length. Data rows stay for the next owner to overwrite. In place.
    ``block_range``: sharded-refcount form, as in `map_block`."""
    _refcount_add(pool.refcount, _localize_pages(pool.page_table[slot], block_range), -1)
    pool.length[slot] = 0
    pool.page_table[slot] = PAGE_UNMAPPED
    pool.sel_hist[slot] = 0
    return pool


def record_selection(pool: PagedSalcaCache, sel_indices: torch.Tensor,
                     sel_mask: torch.Tensor) -> PagedSalcaCache:
    """Add this tick's selected tokens (S, KV, C) per logical block into
    `sel_hist`. In place."""
    s = sel_indices.shape[0]
    blk = torch.clamp(torch.div(sel_indices, pool.block_size, rounding_mode="floor"),
                      0, pool.max_blocks - 1)
    pool.sel_hist.scatter_add_(1, blk.reshape(s, -1).long(),
                               sel_mask.reshape(s, -1).to(torch.int32))
    return pool


def _resolve_pages(pool: PagedSalcaCache, idx: torch.Tensor, block_range=None):
    """Walk the page table for logical token indices idx (S, ...): returns
    (page, offset, mapped). Unmapped — and, with ``block_range``, unowned —
    resolutions clamp to (block 0, offset 0) with ``mapped`` False; owned
    pages come back in the local coordinate."""
    bs = pool.block_size
    blk = torch.clamp(torch.div(idx, bs, rounding_mode="floor"), 0, pool.max_blocks - 1)
    pt = pool.page_table.reshape((pool.num_slots,) + (1,) * (idx.ndim - 2)
                                 + (pool.max_blocks,))
    page = torch.gather(pt.expand(idx.shape[:-1] + (pool.max_blocks,)), -1, blk.long())
    page = _localize_pages(page, block_range)
    mapped = page >= 0
    return (torch.where(mapped, page, 0), torch.where(mapped, torch.remainder(idx, bs), 0),
            mapped)


def paged_logical_kv(pool: PagedSalcaCache):
    """Dequantized dense logical K/V (S, L, KV, HD) f32 — the dense oracle's
    read of a paged pool, in every mode: int4 codes unpack first, and the
    scale gather broadcasts whether it is per token or per block."""
    pt = pool.clamped_pages().long()
    s, l = pt.shape[0], pool.max_seq
    unpack = qz.unpack_int4 if pool.kv_pool_dtype == "int4" else (lambda x: x)
    k = (unpack(pool.k_codes[pt]).float() * pool.k_scale[pt][..., None]).reshape(
        s, l, pool.num_kv_heads, -1)
    v = (unpack(pool.v_codes[pt]).float() * pool.v_scale[pt][..., None]).reshape(
        s, l, pool.num_kv_heads, -1)
    return k, v


# One physical block's data rows in storage format (codes stay packed,
# scales ride along): a host-spill demote → promote round trip is bit-exact.

def read_block_rows(pool: PagedSalcaCache, page: int) -> tuple:
    """The seven data-field rows of physical block ``page`` (views)."""
    return tuple(pool.data[f][page] for f in _DATA_FIELDS)


def write_block_rows(pool: PagedSalcaCache, page: int, rows: tuple) -> PagedSalcaCache:
    """Install rows captured by `read_block_rows` into block ``page``. In place."""
    for f, r in zip(_DATA_FIELDS, rows):
        pool.data[f][page].copy_(r, non_blocking=True)
    return pool


def block_data_bytes(pool: PagedSalcaCache) -> int:
    """Bytes of one physical block across the seven data fields — the unit
    of a host-spill transfer."""
    return sum(pool.data[f][0].numel() * pool.data[f].element_size() for f in _DATA_FIELDS)


def paged_cache_bytes(pool: PagedSalcaCache) -> dict[str, int]:
    """Physical bytes of the public pool by region (the sink block not
    counted), plus the page-table, refcount and histogram overhead."""
    def nbytes(x):
        return x.numel() * x.element_size()
    kv = sum(nbytes(getattr(pool, f)) for f in ("k_codes", "v_codes", "k_scale", "v_scale"))
    feats = sum(nbytes(getattr(pool, f)) for f in ("feat_words", "feat_scale", "feat_zero"))
    table = nbytes(pool.page_table) + nbytes(pool.refcount) + nbytes(pool.sel_hist)
    return {"kv_region": kv, "feature_region": feats, "page_table": table,
            "total": kv + feats + table}
