"""Low-precision quantization primitives of Salca (paper §3.1), in PyTorch.

Port of the reference `core/quantization.py`, restricted to what the
decode paths use: 2-bit asymmetric key features, 3-bit symmetric query
features, int8 per-token K/V, the tiered pool's per-block symmetric codes
and int4 nibble packing, uint8 score binning and 2-bit packing. Every
function reproduces the reference bit for bit on the same float32 inputs:
`torch.round` rounds half to even like `jnp.round`, and a bf16 round trip
rounds to nearest even like `lax.reduce_precision(·, 8, 7)`.

Packed feature words are kept as ``int32`` tensors holding the reference's
``uint32`` bits (PyTorch's ``uint32`` lacks most ops).

Divisions by a constant go through `div_const`: PyTorch's CUDA kernels turn
a division by a Python scalar into a multiplication by its reciprocal,
which is one ulp off IEEE division on some rows; the reference and the CPU
divide.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CODES_PER_WORD = 16
INT4_MAXABS = 7          # 4-bit symmetric codes {-7..7} (nibble-packed)

_EPS = 1e-6

_CONSTS: dict = {}


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` with IEEE division on every device: the divisor is a 0-dim
    tensor on x's device (cached), which no backend rewrites into a
    multiplication by ``1/c``. It is made by a fill, not copied from the
    host, and never while a CUDA graph is being captured: the eager first
    tick of a graphed step (`runtime.steps`) makes every one the tick uses,
    and one made during capture would live in the graph's memory."""
    key = (c, x.dtype, x.device)
    t = _CONSTS.get(key)
    if t is None:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"div_const({c}, {x.dtype}): constant first needed while "
                               "capturing a CUDA graph; run the step eagerly once first")
        t = _CONSTS[key] = torch.full((), c, dtype=x.dtype, device=x.device)
    return x / t


class AsymQuant(NamedTuple):
    """``x ≈ scale * codes + zero``."""
    codes: torch.Tensor   # int8
    scale: torch.Tensor   # f32, per row
    zero: torch.Tensor    # f32, per row (= row min)


class SymQuant(NamedTuple):
    """``x ≈ scale * codes``."""
    codes: torch.Tensor   # int8
    scale: torch.Tensor   # f32, per row


def asym_quantize(x: torch.Tensor, bits: int) -> AsymQuant:
    """Asymmetric quantization along the last dim with ``2**bits`` levels."""
    levels = (1 << bits) - 1
    x32 = x.float()
    lo = x32.amin(dim=-1, keepdim=True)
    hi = x32.amax(dim=-1, keepdim=True)
    safe = torch.clamp_min(div_const(hi - lo, levels), _EPS)
    codes = torch.clamp(torch.round((x32 - lo) / safe), 0, levels).to(torch.int8)
    return AsymQuant(codes, safe.squeeze(-1), lo.squeeze(-1))


def sym_quantize(x: torch.Tensor, bits: int) -> SymQuant:
    """Symmetric quantization along the last dim; codes in ±(2^(b-1)-1)."""
    m = (1 << (bits - 1)) - 1
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(div_const(amax, m), _EPS)
    codes = torch.clamp(torch.round(x32 / scale), -m, m)
    return SymQuant(codes.to(torch.int8), scale.squeeze(-1))


def sym_quantize_axes(x: torch.Tensor, bits: int,
                      axes: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization with ONE shared scale over ``axes`` (the
    tiered pool's per-block, per-head scheme: for blocks (MB, BS, KV, HD),
    ``axes=(1, 3)``). Returns (codes int8, scale f32) with the reduced axes
    kept as size-1 dims."""
    m = (1 << (bits - 1)) - 1
    x32 = x.float()
    amax = x32.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp_min(div_const(amax, m), _EPS)
    codes = torch.clamp(torch.round(x32 / scale), -m, m)
    return codes.to(torch.int8), scale


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8 in [-7, 7], even last dim) two per byte: the
    even channel in the low nibble, the odd one in the high nibble. The
    byte is assembled in int16 and reinterpreted as int8, so no int8 shift
    overflows on any device."""
    *lead, d = codes.shape
    assert d % 2 == 0, f"head dim {d} not divisible by 2 for int4 packing"
    c = codes.to(torch.int16).reshape(*lead, d // 2, 2)
    byte = ((c[..., 1] & 0x0F) << 4) | (c[..., 0] & 0x0F)        # [0, 255]
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4`; returns int8 codes, last dim doubled. The high
    nibble comes out sign-extended by the arithmetic shift ``b >> 4``; the
    low one is the remainder ``b - 16·hi`` in [0, 15], sign-extended."""
    b = packed.to(torch.int16)
    hi = b >> 4
    lo = b - (hi << 4)
    lo = lo - ((lo & 8) << 1)
    return torch.stack([lo, hi], dim=-1).reshape(*b.shape[:-1], 2 * b.shape[-1]).to(torch.int8)


def quantize_key_features(k_feat: torch.Tensor) -> AsymQuant:
    """2-bit asymmetric quantization of heavy-channel key features."""
    return asym_quantize(k_feat, bits=2)


def quantize_query_features(q_feat: torch.Tensor) -> SymQuant:
    """3-bit symmetric quantization of heavy-channel query features."""
    return sym_quantize(q_feat, bits=3)


def quantize_kv_int8(x: torch.Tensor) -> SymQuant:
    """INT8 symmetric per-token quantization of K or V."""
    return sym_quantize(x, bits=8)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 (ties to even) and back to f32."""
    return t.to(torch.bfloat16).float()


def dequant_score_chain(q_scale, a, z, int_dot, q_sums, bf16: bool) -> torch.Tensor:
    """``s_q · (a · Σq̂ĉ + z · Σq̂)`` — the shared phase-1 dequant chain.

    With ``bf16`` every intermediate is rounded to bf16, at exactly the
    points the reference pins with `lax.reduce_precision`; the CUDA score
    kernel rounds at the same points, so all three agree bit for bit.
    Operands broadcast against each other; returns f32.
    """
    d = int_dot.float()
    qm = q_sums.float()
    a, z, qs = a.float(), z.float(), q_scale.float()
    if not bf16:
        return qs * (a * d + z * qm)
    rp = bf16_round
    return rp(rp(qs) * rp(rp(rp(a) * rp(d)) + rp(rp(z) * rp(qm))))


SCORE_NEG_INF = -3.0e38     # masked-score sentinel for the binning affine map


def masked_scores(scores: torch.Tensor, valid_mask: torch.Tensor | None) -> torch.Tensor:
    s = scores.float()
    if valid_mask is not None:
        s = torch.where(valid_mask, s, torch.full_like(s, SCORE_NEG_INF))
    return s


def score_bounds(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw per-row (lo, hi) of masked scores; all-masked rows give lo=+inf."""
    lo = torch.where(s <= SCORE_NEG_INF / 2, torch.full_like(s, float("inf")), s).amin(-1)
    return lo, s.amax(-1)


def binning_affine(lo: torch.Tensor, hi: torch.Tensor):
    """(lo, hi) → (offset, scale) with ``bin = clip(round((s-offset)/scale)+1, 1, 255)``."""
    offset = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    scale = torch.clamp_min(div_const(hi - offset, 254.0), _EPS)
    return offset, scale


def bins_from_bounds(s, lo, hi, valid_mask=None) -> torch.Tensor:
    """Affine-map masked scores to uint8 bins; masked positions land on 0."""
    offset, scale = binning_affine(lo, hi)
    bins = torch.clamp(torch.round((s - offset[..., None]) / scale[..., None]) + 1.0,
                       1.0, 255.0)
    if valid_mask is not None:
        bins = torch.where(valid_mask, bins, torch.zeros_like(bins))
    return bins.to(torch.uint8)


def quantize_scores_uint8(scores: torch.Tensor,
                          valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Map FP scores to uint8 bins [0, 255] per row (last dim)."""
    if valid_mask is not None:
        valid_mask = valid_mask.expand(scores.shape)
    s = masked_scores(scores, valid_mask)
    lo, hi = score_bounds(s)
    return bins_from_bounds(s, lo, hi, valid_mask)


def _shifts(device, dtype) -> torch.Tensor:
    return torch.arange(0, 2 * CODES_PER_WORD, 2, dtype=dtype, device=device)


def pack2bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack 2-bit codes (int8 in {0..3}, last dim a multiple of 16) into
    int32 words holding the reference's uint32 bits: code j of a word sits
    at bits 2j."""
    *lead, r = codes.shape
    assert r % CODES_PER_WORD == 0, f"feature dim {r} not divisible by 16"
    c = codes.to(torch.int64).reshape(*lead, r // CODES_PER_WORD, CODES_PER_WORD)
    w = (c << _shifts(codes.device, torch.int64)).sum(dim=-1)  # disjoint fields
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack2bit(words: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of `pack2bit`: int32 words → int8 codes of feature dim ``r``.
    The ``& 3`` mask removes the sign bits the arithmetic shift brings in."""
    *lead, nw = words.shape
    assert nw * CODES_PER_WORD == r
    c = (words[..., None] >> _shifts(words.device, torch.int32)) & 3
    return c.reshape(*lead, r).to(torch.int8)
