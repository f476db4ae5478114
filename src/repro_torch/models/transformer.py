"""Decoder-only LM over a stack of global ("A") and sliding-window ("L")
attention blocks, SSD ("S") and RG-LRU ("R") blocks: the vision frontend's
projector (`embed_inputs`: image rows ahead of the text), the training
forward and loss (`lm_forward`, `lm_loss`; each layer under activation
checkpointing where the reference checkpoints each period), prefill (whole,
or by chunks for all-"A" stacks without a frontend), pooled decode state (contiguous slot pool or
paged), the zero-prefill adoption of a cached prompt, the calibration of
the static heavy sets, and the decode step.

Port of the reference `models/transformer.py` for the dense LM. Where the
reference scans stacked per-period states (one per position of the layer
pattern, then the tail), the port keeps a Python list with one entry per
layer, of kind ``cfg.block_kinds()[layer]``. An "L" layer's ring
(`blocks.ring_size`) stays a contiguous `SalcaCache` on the paged engine
too; the paged pool's helpers (growth, sharing, copy on write, the host
tier's block moves, the selection histogram) pass it through, as the
reference's ``_map_paged_substates`` does. So do they pass an "S" or "R"
layer's recurrent state (`models.ssm.SSMState`, `models.rglru.RGLRUState`),
which admission writes as a plain row copy and release zeroes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import (
    PagedSalcaCache, SalcaCache, adopt_pages, cow_block, empty_cache, empty_paged_cache,
    free_pages, map_block, prefill_chunk_into_pages, prefill_into_pages, read_block_rows,
    reset_slot, share_blocks, write_block_rows, write_prefill_into_slot)
from repro_torch.distributed.sharding import (
    DecodeCtx, constrain, constrain_residual, local_block_range, local_row_range, model_group,
    reduce_scatter_to_sequence, sequence_split)
from repro_torch.models import blocks as B
from repro_torch.models.common import (
    cdtype, cross_entropy, embed_tokens, embed_tokens_parallel, lm_logits, rmsnorm,
    vocab_mask_logits)


@dataclass
class LMState:
    """Per-layer states (attention layers: a `SalcaCache` in prefill and the
    contiguous slot pool, a `PagedSalcaCache` on the paged engine; "S" and
    "R" layers: their recurrent state) and the (B,) position cursor."""
    caches: list
    pos: torch.Tensor


def _has_image(cfg: ModelConfig, patches) -> bool:
    return cfg.frontend == "vision" and patches is not None


def embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 patches: torch.Tensor | None = None, split: bool = False) -> torch.Tensor:
    """tokens (B, T_text) → (B, T, D) in the compute dtype; with the vision
    frontend and ``patches`` (B, P, F), the projected patches come first:
    ``patches @ projector`` in the compute dtype, then the text (T = P +
    T_text).

    Under a model axis above 1 (training) the result is in the residual's
    layout: each rank's part of the vocab-parallel lookup (the text rows,
    zero rows where the image goes) is reduced into its sequence shard
    (``split``) or summed whole, and the projector (replicated) acts on the
    image rows that the rank holds."""
    if model_group() is None:
        h = embed_tokens(params["embed"], tokens).to(cdtype(cfg))
        if _has_image(cfg, patches):
            img = patches.to(cdtype(cfg)) @ params["projector"]
            h = torch.cat([img, h], dim=1)
        return h
    h = embed_tokens_parallel(params["embed"], tokens, cfg).to(cdtype(cfg))
    n_img = patches.shape[1] if _has_image(cfg, patches) else 0
    if n_img:
        h = torch.cat([h.new_zeros((h.shape[0], n_img, h.shape[2])), h], dim=1)
    h = reduce_scatter_to_sequence(h, split)
    lo = model_group().rank * h.shape[1] if split else 0
    mine = min(max(n_img - lo, 0), h.shape[1])        # image rows among this rank's
    if mine:
        img = patches[:, lo:lo + mine].to(cdtype(cfg)) @ params["projector"]
        h = torch.cat([img, h[:, mine:]], dim=1)
    return h


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               patches: torch.Tensor | None = None):
    """Full-sequence training forward → (logits (B, T, V_pad), aux): aux the
    MoE layers' load-balancing losses summed (0.0 without MoE). Each layer
    runs under activation checkpointing (its inputs kept, its inside
    recomputed in the backward, collectives included): memory only, the
    same numbers.

    The reference's sharding hints stand where it calls them: under a model
    axis above 1 the residual stream is split over "model" along the
    sequence where the axis divides it (``split``, `sequence_split`),
    ``ln_f`` acts on the rank's rows, and the sequence is gathered whole
    for the vocab-parallel head (logits (B, T, V_pad / M): this rank's
    columns)."""
    t = tokens.shape[1] + (patches.shape[1] if _has_image(cfg, patches) else 0)
    split = sequence_split(t)
    h = constrain_residual(embed_inputs(params, cfg, tokens, patches, split), split)
    aux = 0.0
    for layer, kind in zip(params["layers"], cfg.block_kinds()):
        h, a = checkpoint(B.block_train, layer, h, cfg, kind, split, use_reentrant=False)
        h = constrain_residual(h, split)
        aux = aux + a
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    h = constrain(h, "dp", None, None, split=split)    # the whole sequence for the head
    return lm_logits(params["embed"], h, cfg), aux


def lm_loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor,
            patches: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy (over the text positions only, behind
    the vision frontend's patches) + 0.01 · aux."""
    logits, aux = lm_forward(params, cfg, tokens, patches)
    if _has_image(cfg, patches):
        logits = logits[:, patches.shape[1]:]
    return cross_entropy(logits, labels, cfg) + 0.01 * aux


def lm_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_seq: int,
               patches: torch.Tensor | None = None):
    """tokens (B, T_text), with the vision frontend's ``patches`` (B, P, F)
    ahead of them (`embed_inputs`) → (last-position logits (B, V_pad),
    LMState of per-layer `SalcaCache`s and recurrent states, its cursor at
    P + T_text)."""
    h = embed_inputs(params, cfg, tokens, patches)
    caches = []
    for layer, kind in zip(params["layers"], cfg.block_kinds()):
        h, cache = B.block_prefill(layer, h, cfg, max_seq, kind)
        caches.append(cache)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = vocab_mask_logits(lm_logits(params["embed"], h[:, -1], cfg), cfg)
    pos = torch.full((h.shape[0],), h.shape[1], dtype=torch.int32, device=h.device)
    return logits, LMState(caches, pos)


# ---------------------------------------------------------------------------
# Chunked prefill (reference `models/transformer.py`, "Chunked prefill"): a
# prompt streams into its paged slot in C-token chunks between decode ticks.
# Each chunk attends over full-precision K/V buffers carried from chunk to
# chunk (not the quantized pool), so every activation row, the final logits
# and every pool row equal the monolithic `lm_prefill`'s.
# ---------------------------------------------------------------------------

@dataclass
class PrefillCursor:
    """One request's chunked prefill in flight (batch 1): per layer the
    prompt's full-precision (kbuf, vbuf), each (KV, T, HD) in kernel B3's
    operand layout (the reference: (1, T, KV, HD)), rows [0, t0) filled;
    and ``t0``, the logical position of the next chunk."""
    kv: list
    t0: int = 0


def lm_prefill_chunk_unsupported(cfg: ModelConfig) -> str | None:
    """Why chunked prefill cannot run for ``cfg``; None when it can."""
    if set(cfg.layer_pattern) != {"A"}:
        return (f"layer pattern {cfg.layer_pattern!r} has non-global layers; "
                'chunked prefill supports all-"A" stacks only')
    if cfg.moe:
        return "MoE routing is not guaranteed chunk-invariant"
    if cfg.frontend != "none":
        return "modality frontends are not supported by chunked prefill"
    if not cfg.salca_static_channels:
        return ("per-input heavy-channel identification needs the full "
                "prompt's K at once; chunked prefill requires "
                "cfg.salca_static_channels")
    return None


def lm_prefill_begin(cfg: ModelConfig, t_total: int, device) -> PrefillCursor:
    """A fresh cursor for a prompt of ``t_total`` tokens: zero buffers."""
    def buf():
        return torch.zeros((cfg.num_kv_heads, t_total, cfg.resolved_head_dim),
                           dtype=cdtype(cfg), device=device)
    return PrefillCursor([(buf(), buf()) for _ in range(cfg.num_layers)])


def lm_prefill_chunk(params: dict, cfg: ModelConfig, pool: LMState, tokens: torch.Tensor,
                     cursor: PrefillCursor, slot: int, pages, n_shared: int, max_seq: int,
                     *, final: bool, ctx: DecodeCtx | None = None):
    """Advance a chunked prefill by one chunk: ``tokens`` (1, C) at logical
    positions [t0, t0+C). Streams the chunk's K/V into row ``slot`` of every
    layer's paged pool (`prefill_chunk_into_pages`; with ``ctx`` each rank
    writes the blocks it owns) — the engine keeps the slot masked off until
    the final chunk — and carries the buffers forward. Returns (logits,
    pool, cursor): the (1, V_pad) next-token logits on the final chunk,
    where ``pos[slot]`` is set in place to where `lm_prefill` +
    `lm_write_into_slot` would leave it; None otherwise. In place."""
    reason = lm_prefill_chunk_unsupported(cfg)
    if reason is not None:
        raise ValueError(f"chunked prefill unsupported: {reason}")
    h = embed_tokens(params["embed"], tokens).to(cdtype(cfg))
    t0, c = cursor.t0, tokens.shape[1]
    sp = B.salca_params_for(cfg, max_seq)
    pages = torch.as_tensor(pages, dtype=torch.int32).to(pool.pos.device)
    for layer, dst, (kb, vb) in zip(params["layers"], pool.caches, cursor.kv):
        h, _, _, k, v = B.block_prefill_chunk(layer, h, kb, vb, t0, cfg)
        block_range = None if ctx is None else local_block_range(dst.num_blocks, ctx)
        prefill_chunk_into_pages(dst, k, v, B.static_heavy_idx(layer["attn"], cfg, sp, 1),
                                 slot, pages, t0, n_shared, block_range)
    logits = None
    if final:
        h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
        logits = vocab_mask_logits(lm_logits(params["embed"], h[:, -1], cfg), cfg)
        pool.pos[slot] = t0 + c
    cursor.t0 = t0 + c
    return logits, pool, cursor


def lm_static_heavy(params: dict, cfg: ModelConfig, max_seq: int):
    """The static heavy sets of the attention layers, each (1, KV, R) int32
    — the layout of a batch=1 prefill state's ``heavy_idx`` leaves, so the
    engine hashes a chunked admission's sets as it hashes a monolithic
    one's. None without ``salca_static_channels``."""
    if not cfg.salca_static_channels:
        return None
    sp = B.salca_params_for(cfg, max_seq)
    return tuple(B.static_heavy_idx(layer["attn"], cfg, sp, 1)
                 for layer, kind in zip(params["layers"], cfg.block_kinds()) if kind in "AL")


def lm_adopt_pages(params: dict, cfg: ModelConfig, pool: LMState, slot: int, pages,
                   length: int) -> LMState:
    """The zero-prefill warm hit (reference `lm_adopt_pages`): map an
    already written, cache-pinned prompt into row ``slot`` of every layer's
    paged pool without touching a data row — the page-table row, the
    references, the cursor and each layer's static heavy set, the one the
    kept rows were encoded against (so ``salca_static_channels`` is
    required) — and set ``pos[slot] = length``. ``pages`` (MB,) covers
    exactly the prompt's blocks (-1 beyond). It writes only metadata, which
    a block-sharded rank holds replicated, so it applies unchanged to a
    rank's share of a pool. In place."""
    if not cfg.salca_static_channels:
        raise ValueError("adopt_pages requires cfg.salca_static_channels: the kept rows "
                         "were encoded against the static heavy-channel set")
    paged = _paged(pool)
    if not paged:
        raise ValueError("adopt_pages requires a paged pool state")
    sp = B.salca_params_for(cfg, paged[0].max_seq)
    pages = torch.as_tensor(pages, dtype=torch.int32).to(pool.pos.device)
    for layer, c in zip(params["layers"], pool.caches):
        if isinstance(c, PagedSalcaCache):
            adopt_pages(c, slot, pages, length, B.static_heavy_idx(layer["attn"], cfg, sp, 1))
    pool.pos[slot] = length
    return pool


def lm_calibrate_static_heavy(params: dict, cfg: ModelConfig, tokens) -> dict:
    """Static heavy channels from activations (reference
    `lm_calibrate_static_heavy`): prefill a calibration batch ``tokens``
    (B, T), and per layer sum |K| = |k_codes · k_scale| over the valid rows
    of its cache into a (KV, HD) float32 salience, installed as the
    layer's ``calib_salience`` leaf. `blocks.static_heavy_idx` prefers that
    leaf over the weight mass Σ|W_k|, so the static sets follow the prompts
    a deployment serves. Returns a new tree (the layers' dicts copied, the
    tensors shared); ``params`` is left as it was."""
    tokens = torch.as_tensor(tokens, dtype=torch.int32).to(params["embed"]["tok"].device)
    _, state = lm_prefill(params, cfg, tokens, max_seq=tokens.shape[1])
    layers = []
    for layer, c in zip(params["layers"], state.caches):
        if not isinstance(c, SalcaCache):       # a recurrent layer has no K
            layers.append(layer)
            continue
        k = c.k_codes.float() * c.k_scale[..., None]                    # (B, T, KV, HD)
        valid = (torch.arange(k.shape[1], device=k.device)[None, :]
                 < c.length[:, None]).float()
        sal = (k.abs() * valid[..., None, None]).sum(dim=(0, 1))         # (KV, HD) f32
        layers.append({**layer, "attn": {**layer["attn"], "calib_salience": sal}})
    return {**params, "layers": layers}


def lm_init_state(cfg: ModelConfig, batch: int, max_seq: int, device,
                  ctx: DecodeCtx | None = None) -> LMState:
    """Contiguous decode state: one empty ``(batch, max_seq, ·)`` cache per
    attention layer (the contiguous engine's slot pool; an "L" layer's ring
    has `ring_size` slots) and a zeroed recurrent state per "S" or "R"
    layer, cursors at 0. With ``ctx`` each cache holds only this rank's rows
    (the sequence-sharded flat tick); a recurrent state is whole."""
    r = B.salca_params_for(cfg, max_seq).r(cfg.resolved_head_dim)
    caches = [B.block_init_state(kind, batch, cfg, device) if kind in "SR" else
              empty_cache(batch, B.local_rows(cfg, B.ring_size(cfg, kind, max_seq), max_seq, ctx),
                          cfg.num_kv_heads, cfg.resolved_head_dim, r, device=device)
              for kind in cfg.block_kinds()]
    return LMState(caches, torch.zeros(batch, dtype=torch.int32, device=device))


def lm_init_paged_state(cfg: ModelConfig, slots: int, max_seq: int, block_size: int,
                        num_blocks: int, device, ctx: DecodeCtx | None = None) -> LMState:
    """Pooled decode state: one paged block pool per layer, storing K/V in
    ``cfg.kv_pool_dtype`` (the engine's knob); an "L" layer whose window is
    shorter than ``max_seq`` keeps its ring instead, a contiguous
    ``(slots, W, ·)`` cache (paging a ring buys nothing); an "S" or "R"
    layer keeps its dense per-slot recurrent state. With ``ctx`` each pool
    holds only this rank's ``num_blocks / world_size`` blocks and each ring
    this rank's ``W / world_size`` rows (its decode is the sequence-sharded
    flat tick)."""
    r = B.salca_params_for(cfg, max_seq).r(cfg.resolved_head_dim)
    max_blocks = -(-max_seq // block_size)
    rings = [B.ring_size(cfg, kind, max_seq) for kind in cfg.block_kinds()]
    local = None
    if ctx is not None:
        lo, hi = local_block_range(num_blocks, ctx)
        local = hi - lo

    def cache(kind, w):
        if kind in "SR":
            return B.block_init_state(kind, slots, cfg, device)
        if w < max_seq:
            return empty_cache(slots, B.local_rows(cfg, w, max_seq, ctx), cfg.num_kv_heads,
                               cfg.resolved_head_dim, r, device=device)
        return empty_paged_cache(num_blocks, block_size, slots, max_blocks,
                                 cfg.num_kv_heads, cfg.resolved_head_dim, r,
                                 kv_pool_dtype=cfg.kv_pool_dtype, device=device,
                                 local_blocks=local)
    return LMState([cache(kind, w) for kind, w in zip(cfg.block_kinds(), rings)],
                   torch.zeros(slots, dtype=torch.int32, device=device))


def _paged(pool: LMState) -> list:
    """The state's paged pools, in layer order (rings and recurrent states
    left out)."""
    return [c for c in pool.caches if isinstance(c, PagedSalcaCache)]


def lm_write_into_slot(pool: LMState, src: LMState, slot: int, pages=None,
                       ctx: DecodeCtx | None = None, n_shared: int = 0) -> LMState:
    """Install a batch=1 prefill state into row ``slot``. In place.

    Contiguous pools take ``pages=None`` (`write_prefill_into_slot`); paged
    pools take the same physical blocks ``pages`` (MB,) in every layer
    (`prefill_into_pages`) — with ``ctx`` the prefill is replicated and each
    rank writes only the blocks it owns, and of a contiguous cache or a
    ring only its rows. ``n_shared`` marks the leading entries of ``pages``
    as prefix-shared: mapped and counted in every layer, not written. A
    recurrent state's rows are copied whole, in the pool's dtype
    (`_write_recurrent_row`)."""
    for dst, s in zip(pool.caches, src.caches):
        if isinstance(dst, B.RECURRENT):
            for d, t in zip(dst, s):
                _write_recurrent_row(d, t, slot)
        elif isinstance(dst, PagedSalcaCache):
            if pages is None:
                raise ValueError("paged cache substate requires a pages array "
                                 "(use write_into_pages)")
            block_range = None if ctx is None else local_block_range(dst.num_blocks, ctx)
            prefill_into_pages(dst, s, slot, pages, block_range, n_shared)
        else:
            rows = None if ctx is None else local_row_range(s.max_seq, ctx)
            write_prefill_into_slot(dst, s, slot, rows)
    pool.pos[slot] = src.pos[0]
    return pool


def _write_recurrent_row(dst: torch.Tensor, src: torch.Tensor, slot: int) -> None:
    """Row ``slot`` of a recurrent state's leaf ``dst`` := the batch=1
    prefill's row ``src[0]``, broadcast as the reference's ``.at[slot].set``
    broadcasts it: an RG-LRU prompt of one token has one conv row, copied
    into all W-1 rows of the window; a prompt of 2..W-2 tokens has too few
    rows for the window and raises the reference's ValueError."""
    row = src[0]
    try:
        ok = torch.broadcast_shapes(row.shape, dst.shape[1:]) == dst.shape[1:]
    except RuntimeError:
        ok = False
    if not ok:
        raise ValueError(f"Incompatible shapes for broadcasting: {tuple(row.shape)} and "
                         f"requested shape {tuple(dst.shape[1:])}")
    dst[slot].copy_(row)


def lm_map_block(pool: LMState, slot: int, logical_block: int, page: int) -> LMState:
    """On-demand growth: map ``logical_block`` of ``slot`` to block ``page``
    in every paged layer. In place."""
    for c in _paged(pool):
        map_block(c, slot, logical_block, page)
    return pool


def lm_share_blocks(pool: LMState, src_slot: int, n_blocks: int, dst_slot: int) -> LMState:
    """Prefix sharing: alias the first ``n_blocks`` logical blocks of
    ``src_slot`` into ``dst_slot`` in every layer's pool (the same block ids
    in every layer; `core.cache.share_blocks`). Rings pass through: the
    admission's prefill writes them whole. In place."""
    for c in _paged(pool):
        share_blocks(c, src_slot, n_blocks, dst_slot)
    return pool


def lm_cow_block(pool: LMState, slot: int, logical_block: int, new_page: int,
                 ctx: DecodeCtx | None = None) -> LMState:
    """Copy-on-write service in every layer's pool: copy the shared block
    mapped at (``slot``, ``logical_block``) into ``new_page`` and remap only
    this slot's entry (`core.cache.cow_block`). With ``ctx`` every rank
    makes the call and the rows cross ranks when the two blocks' owners
    differ. In place."""
    for c in _paged(pool):
        if ctx is None:
            cow_block(c, slot, logical_block, new_page)
        else:
            cow_block(c, slot, logical_block, new_page,
                      local_block_range(c.num_blocks, ctx), ctx.group)
    return pool


def lm_read_block(pool: LMState, page: int) -> tuple:
    """Host-spill transport, read side: the data rows of physical block
    ``page`` in every paged layer's pool, in storage format (views; the
    caller copies them out), one tuple of seven per paged layer."""
    return tuple(read_block_rows(c, page) for c in _paged(pool))


def lm_write_block(pool: LMState, page: int, payload: tuple) -> LMState:
    """Host-spill transport, write side: install a payload captured by
    `lm_read_block` into block ``page`` of every paged layer. Data only;
    the page tables and refcounts are `lm_map_block`'s. In place."""
    for c, rows in zip(_paged(pool), payload):
        write_block_rows(c, page, rows)
    return pool


def lm_selection_hist(pool: LMState) -> torch.Tensor | None:
    """Cumulative selected-token counts per (slot, logical block), summed
    over the paged layers — the signal of the host-spill demotion policy.
    Returns (slots, MB) int32, or None when no layer is paged (as the
    reference)."""
    paged = _paged(pool)
    if not paged:
        return None
    return torch.stack([c.sel_hist for c in paged]).sum(0, dtype=torch.int32)


def lm_reset_slot(pool: LMState, slot: int) -> LMState:
    """Free row ``slot``: caches marked empty (paged: page table unmapped and
    blocks decref'd), recurrent states and the position cursor zeroed. In
    place; resetting a free row again changes nothing (its page-table row
    is unmapped)."""
    for c in pool.caches:
        if isinstance(c, B.RECURRENT):
            for leaf in c:
                leaf[slot].zero_()
        elif isinstance(c, PagedSalcaCache):
            free_pages(c, slot)
        else:
            reset_slot(c, slot)
    pool.pos[slot] = 0
    return pool


def decode_salca_params(cfg: ModelConfig, state: LMState, ctx: DecodeCtx | None = None):
    """The tick's `SalcaParams`, as the reference's `lm_decode_step` derives
    them: from the first attention cache of its state, in its order
    (pattern positions' stacked states, then the tail), which is the first
    attention layer's; from 128 when no layer attends (mamba2). Layer 0 of
    "LLLLLA" is an "L" layer, so where it keeps a ring the global layers
    select with k and k_cap from max(W, 128), not from ``max_seq`` (gemma3
    at W 1024 and max_seq 8192: k 128 and k_cap 256, where ``max_seq``
    would give 409 and 512); recurrentgemma's is layer 2's ring. Under
    ``ctx`` a contiguous cache counts the rows of every rank."""
    rows = next((B.global_rows(c, ctx) for c in state.caches
                 if not isinstance(c, B.RECURRENT)), 0)
    return B.salca_params_for(cfg, max(rows, 128))


def lm_decode_step(params: dict, cfg: ModelConfig, state: LMState, token: torch.Tensor,
                   active: torch.Tensor, ctx: DecodeCtx | None = None):
    """One token for every active slot: token (S,) int → (logits (S, V_pad),
    state). Inactive slots write nothing and hold their cursor; their
    logits are garbage the caller ignores. The state's caches are the
    contiguous slot pool or paged pools; ``ctx``: the paged pools are
    block-sharded over its ranks and the contiguous caches and rings split
    by rows (the logits are identical on every rank).
    Every state tensor is updated in place, never rebound, so a CUDA graph
    of the step (`runtime.steps`) stays valid across ticks."""
    h = embed_tokens(params["embed"], token).to(cdtype(cfg))
    pos = state.pos
    salca = decode_salca_params(cfg, state, ctx)
    for layer, pool, kind in zip(params["layers"], state.caches, cfg.block_kinds()):
        h = B.block_decode(layer, h, pool, cfg, pos, salca, active, ctx, kind)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = vocab_mask_logits(lm_logits(params["embed"], h, cfg), cfg)
    state.pos.add_(active)
    return logits, state
