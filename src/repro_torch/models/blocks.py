"""The LM's blocks: global ("A") and sliding-window ("L") attention, the
SSD ("S") and the RG-LRU ("R"): prefill and decode.

Port of the reference `models/blocks.py` for the dense LM: the
`salca_params_for` rule, the static heavy set of
``salca_static_channels``, `ring_size`, the block prefill (dense causal or
windowed attention through kernel B3, then `prefill_cache`), the A block's
chunked form, and the four branches of `_attn_decode` (append, then Salca
selection and sparse attention for "A", dense attention for "L"): over the
contiguous slot pool or a paged pool on one device, and — given a
`DecodeCtx` — over a block-sharded paged pool or a contiguous cache split
by rows (the sequence-sharded flat tick, `core.sp_decode.sp_salca_decode`).

An "L" layer whose window is shorter than the context keeps a ring of
W = ``cfg.local_window`` slots per request slot (a contiguous `SalcaCache`,
on the paged engine too; ``PERF.ring_local_cache``, the default): token j
lives at slot j % W, so the ring holds exactly the last min(pos + 1, W)
tokens and needs no window mask. With the flag off it keeps the full
context and its decode masks to the trailing window. Under a `DecodeCtx`
every contiguous cache and ring is split by rows across the ranks (rank r
holds ``[r·n/world, (r+1)·n/world)``), the reference's `cache_pspec`.
Salca accelerates the "A" layers only.

`block_train` is the training forward of every kind (the reference's
`block_train`): attention through `models.attention.attention_train`, so
that B3-bwd differentiates it, and the recurrent kinds through the same
forward as their prefill (`_recurrent_block`) without the state.

Every layer's FFN goes through `ffn_apply`: the dense GLU, or the MoE
branch (`models.moe`) with arctic's dense residual GLU beside it.

The recurrent kinds: an "S" block is ln1 + the SSD mixer (`models.ssm`, no
FFN) and an "R" block ln1 + the RG-LRU (`models.rglru`), then ln2 + the
FFN. Their state (`SSMState`, `RGLRUState`) is per slot and dense on the
contiguous and the paged engine alike; a decode step computes every slot
and writes the new state back in place for the active slots only
(`merge_masked_state`). Under a `DecodeCtx` every rank holds the whole
state and updates it identically, with no collective.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (
    dense_decode_attention, dense_decode_from_paged, salca_decode_attention,
    salca_decode_attention_paged)
from repro_torch.core.cache import (
    PagedSalcaCache, SalcaCache, append_token, append_token_paged, prefill_cache,
    record_selection)
from repro_torch.core.heavy_channels import top_channels
from repro_torch.core.selection import SalcaParams
from repro_torch.core.sp_decode import (
    local_lengths, sp_append_token, sp_dense_decode, sp_dense_decode_paged, sp_salca_decode,
    sp_salca_decode_paged)
from repro_torch.distributed.sharding import DecodeCtx, local_block_range
from repro_torch.models import rglru, ssm
from repro_torch.models.attention import (
    attention_train, fold_heads, prefill_attention, qkv_project)
from repro_torch.models.common import parallel_glu, rmsnorm
from repro_torch.models.moe import moe_apply

RECURRENT = (ssm.SSMState, rglru.RGLRUState)


def salca_params_for(cfg: ModelConfig, seq_len: int) -> SalcaParams:
    k = max(128, min(int(seq_len * cfg.salca_retention), cfg.salca_max_k, seq_len))
    k_cap = min(((int(k * 1.25) + 127) // 128) * 128, seq_len)
    return SalcaParams(feature_sparsity=cfg.salca_feature_sparsity, k=k, k_cap=k_cap,
                       pool_window=cfg.salca_pool_window, use_pool=cfg.salca_use_pool)


def ring_size(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    """Cache length of a layer: a sliding-window ("L") layer keeps a
    ``local_window``-slot ring instead of the full context when the window
    is the shorter and ``PERF.ring_local_cache`` is on (the default)."""
    from repro_torch.flags import PERF
    if kind == "L" and PERF.ring_local_cache and 0 < cfg.local_window < max_seq:
        return cfg.local_window
    return max_seq


def global_rows(cache, ctx: DecodeCtx | None) -> int:
    """A layer cache's logical length: a paged pool's ``max_seq``; a
    contiguous cache's rows, times the world size under ``ctx`` (each rank
    holds an even share of them)."""
    if isinstance(cache, SalcaCache) and ctx is not None:
        return cache.max_seq * ctx.world_size
    return cache.max_seq


def local_rows(cfg: ModelConfig, rows: int, max_seq: int, ctx: DecodeCtx | None) -> int:
    """Rows of a layer's contiguous cache (or ring) on this rank: all of
    them, or under ``ctx`` an even share; raises when they do not split."""
    if ctx is None:
        return rows
    if rows % ctx.world_size:
        what = f"the ring of {rows}" if rows < max_seq else f"max_seq {rows}"
        raise ValueError(f"{cfg.name}: {what} does not split evenly across "
                         f"{ctx.world_size} ranks (the sequence-sharded cache holds "
                         "rows/world per rank)")
    return rows // ctx.world_size


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.local_window if kind == "L" else 0


def static_heavy_idx(attn_params: dict, cfg: ModelConfig, sp: SalcaParams,
                     batch: int) -> torch.Tensor | None:
    """The request-independent heavy set of ``cfg.salca_static_channels``:
    per kv head the top-r channels by key-projection weight mass
    Σ_d |W_k[d, ·, j]|, or by the layer's ``calib_salience`` leaf when it
    carries one; ties go to the lower index, as in ``jax.lax.top_k``.
    Returns (B, KV, R) int32 broadcast over the batch, or None for the
    paper's per-input identification. A static set is what lets requests
    whose prompts diverge share the feature rows of a common prefix."""
    if not cfg.salca_static_channels:
        return None
    sal = attn_params.get("calib_salience")
    sal = attn_params["wk"].float().abs().sum(dim=0) if sal is None else sal.float()
    idx = top_channels(sal, sp.r(cfg.resolved_head_dim))                  # (KV, R)
    return idx[None].expand((batch,) + idx.shape)


def ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, split: bool = False):
    """A layer's FFN on x (..., D) of 2 or 3 dims → (out, aux): the dense
    GLU (aux 0.0, no tensor made), or the MoE branch (a (S, D) decode input
    routes as (S, 1, D); aux an f32 scalar) plus arctic's dense residual GLU
    (the reference's `ffn_apply`). In training on a mesh x is in the
    residual's layout (``split``): the MoE takes its layouts over the mesh
    (`models.moe`) and the dense residual is `parallel_glu` (the
    ``(glu|dense)`` rules split its d_ff over "model")."""
    if not cfg.moe:
        return parallel_glu(params["glu"], x, cfg, split), 0.0
    squeeze = x.dim() == 2
    x3 = x[:, None] if squeeze else x
    out, aux = moe_apply(params["moe"], x3, cfg, split)
    if cfg.dense_residual:
        out = out + parallel_glu(params["dense"], x3, cfg, split)
    return (out[:, 0] if squeeze else out), aux


def _recurrent_block(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                     return_state: bool, split: bool = False):
    """An "S" block (ln1 + the SSD mixer) or an "R" block (ln1 + the
    RG-LRU, then ln2 + the FFN) on x (B, T, D) → (x_out, aux, the state
    after the prompt or None). In training on a mesh x is in the residual's
    layout (``split``): the norms act on the rank's rows, the mixer and the
    FFN move what they need."""
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    mixer = (ssm.ssd_train(params["ssd"], xn, cfg, return_state, split) if kind == "S"
             else rglru.rglru_train(params["rglru"], xn, cfg, return_state, split))
    h, st = mixer if return_state else (mixer, None)
    x = x + h
    if kind == "S":
        return x, 0.0, st
    f, aux = ffn_apply(params["ffn"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg, split)
    return x + f, aux, st


def block_train(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str = "A",
                split: bool = False):
    """A layer's training forward: x (B, T, D) → (x_out, aux), aux the MoE
    FFN's load-balancing loss (0.0 for a dense FFN or an "S" block). Under
    a model axis above 1, x and x_out are in the residual's layout (the
    sequence split over "model" where ``split``): the norms act on the
    rank's rows, attention and the GLU move the data they need
    (`models.attention`, `models.common.parallel_glu`, `models.ssm`,
    `models.rglru`)."""
    if kind in ("S", "R"):
        x, aux, _ = _recurrent_block(params, x, cfg, kind, False, split)
        return x, aux
    x = x + attention_train(params["attn"], rmsnorm(params["ln1"], x, cfg.norm_eps), cfg,
                            window=_window(cfg, kind), split=split)
    f, aux = ffn_apply(params["ffn"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg, split)
    return x + f, aux


def block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, max_seq: int,
                  kind: str = "A"):
    """x (B, T, D) → (x_out, the layer's state): for "A" and "L" a
    SalcaCache of the layer's K/V, padded to ``max_seq``, or for an "L"
    layer with a ring (`ring_size`) to its W slots, holding the prompt's
    last W tokens at their ring slots; for "S" and "R" the recurrent state
    after the prompt."""
    if kind in ("S", "R"):
        x, _, st = _recurrent_block(params, x, cfg, kind, return_state=True)
        return x, st
    t = x.shape[1]
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    positions = torch.arange(t, device=x.device)
    q, k, v = qkv_project(params["attn"], xn, cfg, positions)
    o = prefill_attention(q, fold_heads(k), fold_heads(v), window=_window(cfg, kind))
    x = x + o.reshape(x.shape[0], t, -1) @ params["attn"]["wo"]
    f, _ = ffn_apply(params["ffn"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg)
    sp = salca_params_for(cfg, max_seq)
    w_ring = ring_size(cfg, kind, max_seq)
    if w_ring < max_seq and t >= w_ring:
        # token j at slot j % W, so decode's wrap stays aligned
        base = t - w_ring
        slot_tok = base + (torch.arange(w_ring, device=x.device) - base) % w_ring
        k, v = k[:, slot_tok], v[:, slot_tok]
    cache = prefill_cache(k, v, max_seq=w_ring, params=sp,
                          heavy_idx=static_heavy_idx(params["attn"], cfg, sp, x.shape[0]))
    return x + f, cache


def block_prefill_chunk(params: dict, x: torch.Tensor, kbuf: torch.Tensor,
                        vbuf: torch.Tensor, t0: int, cfg: ModelConfig):
    """One layer's chunked-prefill step (reference `block_prefill_chunk`).

    ``x`` (1, C, D): the chunk's activations at positions [t0, t0+C);
    ``kbuf``/``vbuf`` (KV, T, HD): the prompt's full-precision K/V in B3's
    operand layout (the reference carries (1, T, KV, HD)), rows [0, t0)
    filled by earlier chunks. The chunk's k/v land in rows [t0, t0+C) in
    place, and its queries attend over the whole buffers with the causal
    mask shifted by t0: each row equals `block_prefill`'s row at the same
    position (`flash_attention_chunked`). Returns (x_out, kbuf, vbuf, k, v)
    with the chunk's raw k/v (1, C, KV, HD) for the pool install
    (`cache.prefill_chunk_into_pages`)."""
    c = x.shape[1]
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    positions = t0 + torch.arange(c, device=x.device)
    q, k, v = qkv_project(params["attn"], xn, cfg, positions)
    kbuf[:, t0:t0 + c] = k[0].transpose(0, 1)
    vbuf[:, t0:t0 + c] = v[0].transpose(0, 1)
    o = prefill_attention(q, kbuf, vbuf, q_offset=t0)
    x = x + o.reshape(1, c, -1) @ params["attn"]["wo"]
    f, _ = ffn_apply(params["ffn"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg)
    return x + f, kbuf, vbuf, k, v


def attn_decode_paged(params: dict, x: torch.Tensor, pool: PagedSalcaCache,
                      cfg: ModelConfig, pos: torch.Tensor, salca: SalcaParams,
                      active: torch.Tensor, ctx: DecodeCtx | None = None,
                      kind: str = "A") -> torch.Tensor:
    """One token per slot: x (S, D) → attention output (S, D). Updates the
    layer's pool in place. Inactive slots write nothing (their write cursor
    is forced out of range) and read as holding 0 tokens. An "A" layer runs
    Salca (with ``cfg.salca``); an "L" layer, paged when it keeps the full
    context (`ring_size`), attends densely over the valid keys at
    positions p > pos - window.

    With ``ctx`` the pool is this rank's share of a block-sharded pool: q,
    k and v are replicated (every rank runs the whole dense model), the
    append lands only on the rank owning the cursor's block, and the
    attention is the two-collective sharded tick (`core.sp_decode`)."""
    s = x.shape[0]
    use_salca = cfg.salca and kind == "A"
    window = _window(cfg, kind)
    q, k, v = qkv_project(params, x[:, None], cfg, pos[:, None])
    q, k, v = q[:, 0].float(), k[:, 0], v[:, 0]
    inactive = ~active
    pool.length.copy_(pos).masked_fill_(inactive, -1)
    if ctx is not None:
        append_token_paged(pool, k, v, block_range=local_block_range(pool.num_blocks, ctx))
        torch.add(pos, 1, out=pool.length).masked_fill_(inactive, 0)
        o = (sp_salca_decode_paged(q, pool, salca, ctx) if use_salca
             else sp_dense_decode_paged(q, pool, ctx, window=window, global_pos=pos))
        return o.to(x.dtype).reshape(s, -1) @ params["wo"]
    append_token_paged(pool, k, v)
    torch.add(pos, 1, out=pool.length).masked_fill_(inactive, 0)
    if use_salca:
        o, sel = salca_decode_attention_paged(q, pool, salca, return_selection=True)
        record_selection(pool, sel.indices, sel.mask)
    else:
        o = dense_decode_from_paged(q, pool, _window_mask(pool.valid_mask(), pos, window))
    return o.to(x.dtype).reshape(s, -1) @ params["wo"]


def _window_mask(valid: torch.Tensor, pos: torch.Tensor, window: int) -> torch.Tensor:
    """``valid`` (S, N) restricted to the positions p > pos - window (a
    sliding-window layer's full-context cache); ``window`` 0 keeps all."""
    if window <= 0:
        return valid
    p = torch.arange(valid.shape[1], device=valid.device)
    return valid & (p[None, :] > (pos[:, None] - window))


def attn_decode_contiguous(params: dict, x: torch.Tensor, cache: SalcaCache,
                           cfg: ModelConfig, pos: torch.Tensor, salca: SalcaParams,
                           active: torch.Tensor, kind: str = "A",
                           ctx: DecodeCtx | None = None) -> torch.Tensor:
    """One token per slot over the contiguous slot pool, or over an "L"
    layer's ring: x (S, D) → attention output (S, D). Updates the layer's
    cache in place. Inactive slots write nothing (their cursor is forced to
    ``max_seq``, where the append drops the write) and read as holding 0
    tokens. A ring (rows <= the window) writes at pos % W and holds
    min(pos + 1, W) valid tokens, attended with no window mask over its
    dequantized rows (plain torch ops, as the reference's XLA); an "L"
    layer with the full context masks to p > pos - window.

    With ``ctx`` the cache holds this rank's rows (`global_rows`): an
    inactive slot's cursor is -1, the append writes at the cursor and the
    local lengths come from the valid length (the carried ``length`` is
    never read), and attention is the sequence-sharded flat tick
    (`core.sp_decode`)."""
    s = x.shape[0]
    window = _window(cfg, kind)
    rows = global_rows(cache, ctx)
    ring = window > 0 and rows <= window
    q, k, v = qkv_project(params, x[:, None], cfg, pos[:, None])
    q, k, v = q[:, 0].float(), k[:, 0], v[:, 0]
    inactive = ~active
    use_salca = cfg.salca and kind == "A"
    if ctx is not None:
        cursor = torch.remainder(pos, rows) if ring else pos.clone()
        cursor.masked_fill_(inactive, -1)
        valid_len = torch.clamp_max(pos + 1, rows) if ring else pos + 1
        valid_len.masked_fill_(inactive, 0)
        sp_append_token(cache, k, v, cursor, ctx)
        cache.length.copy_(local_lengths(valid_len, cache.max_seq, ctx))
        o = (sp_salca_decode(q, cache, salca, ctx) if use_salca else
             sp_dense_decode(q, cache, ctx, window=0 if ring else window,
                             global_len=valid_len))
        return o.to(x.dtype).reshape(s, -1) @ params["wo"]
    if ring:
        torch.remainder(pos, cache.max_seq, out=cache.length)
    else:
        cache.length.copy_(pos)
    cache.length.masked_fill_(inactive, cache.max_seq)
    append_token(cache, k, v)
    torch.add(pos, 1, out=cache.length)
    if ring:
        cache.length.clamp_max_(cache.max_seq)
    cache.length.masked_fill_(inactive, 0)
    if use_salca:
        o = salca_decode_attention(q, cache, salca)
    else:
        kd = cache.k_codes.float() * cache.k_scale[..., None]
        vd = cache.v_codes.float() * cache.v_scale[..., None]
        o = dense_decode_attention(q, kd, vd,
                                   _window_mask(cache.valid_mask(), pos, 0 if ring else window))
    return o.to(x.dtype).reshape(s, -1) @ params["wo"]


def merge_masked_state(new, old, active: torch.Tensor) -> None:
    """Write ``new`` into the recurrent state ``old`` in place, slot by slot
    where ``active`` (S,) holds; the inactive slots' rows keep their bits
    (the reference's `merge_masked_state`, a per-slot select)."""
    for n, o in zip(new, old):
        a = active.reshape(active.shape + (1,) * (n.dim() - 1))
        o.copy_(torch.where(a, n, o))


def block_init_state(kind: str, slots: int, cfg: ModelConfig, device):
    """An empty recurrent state for an "S" or "R" layer (zeros)."""
    if kind == "S":
        return ssm.ssd_init_state(slots, cfg, device)
    if kind == "R":
        return rglru.rglru_init_state(slots, cfg, device)
    raise ValueError(f"block kind {kind!r} keeps an attention cache, not a recurrent state")


def block_decode(params: dict, x: torch.Tensor, pool, cfg: ModelConfig, pos: torch.Tensor,
                 salca: SalcaParams, active: torch.Tensor,
                 ctx: DecodeCtx | None = None, kind: str = "A") -> torch.Tensor:
    """x (S, D) → (S, D) over the layer's state: a `SalcaCache` (the
    contiguous engine's slot pool, or an "L" layer's ring; ``ctx``: split
    by rows), a `PagedSalcaCache` (``ctx``: block-sharded), or an "S" or
    "R" layer's recurrent state (whole on every rank)."""
    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind == "S":
        h, new = ssm.ssd_decode(params["ssd"], xn, pool, cfg)
        merge_masked_state(new, pool, active)
        return x + h
    if kind == "R":
        h, new = rglru.rglru_decode(params["rglru"], xn, pool, cfg)
        x = x + h
        out = x + ffn_apply(params["ffn"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg)[0]
        merge_masked_state(new, pool, active)
        return out
    if isinstance(pool, SalcaCache):
        h = attn_decode_contiguous(params["attn"], xn, pool, cfg, pos, salca, active, kind,
                                   ctx)
    else:
        h = attn_decode_paged(params["attn"], xn, pool, cfg, pos, salca, active, ctx, kind)
    x = x + h
    return x + ffn_apply(params["ffn"], rmsnorm(params["ln2"], x, cfg.norm_eps), cfg)[0]
