"""Uniform model API (the LM part of the reference's `ModelAPI`).

The port serves the decoder-only LM with global ("A") and sliding-window
("L") attention layers, SSD ("S", the "ssm" family: mamba2) and RG-LRU
("R", the "hybrid" family: recurrentgemma) layers, its FFN dense or MoE
(the "moe" family, arctic's dense residual included); the enc-dec family
(whisper) and the VLM frontend (llava) are later slices of the port and
raise here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class ModelAPI(NamedTuple):
    prefill: Callable[..., Any]            # (params, tokens, max_seq) -> (logits, state)
    decode_step: Callable[..., Any]        # (params, state, token, active, ctx) -> (logits, state)
    init_state: Callable[..., Any]         # (slots, max_seq, device, ctx) -> contiguous pool
    write_into_slot: Callable[..., Any]    # (pool, src, slot, None, ctx) -> pool
    init_paged_state: Callable[..., Any]   # (slots, max_seq, block_size, num_blocks, device, ctx)
    write_into_pages: Callable[..., Any]   # (pool, src, slot, pages, ctx, n_shared) -> pool
    map_block: Callable[..., Any]          # (pool, slot, logical_block, page) -> pool
    share_blocks: Callable[..., Any]       # (pool, src_slot, n_blocks, dst_slot) -> pool
    cow_block: Callable[..., Any]          # (pool, slot, logical_block, new_page, ctx) -> pool
    reset_slot: Callable[..., Any]         # (pool, slot) -> pool, contiguous or paged
    read_block: Callable[..., Any]         # (pool, page) -> payload (storage format)
    write_block: Callable[..., Any]        # (pool, page, payload) -> pool
    selection_hist: Callable[..., Any]     # (pool) -> (slots, MB) int32
    # chunked prefill: a cursor, one budgeted chunk streamed into the paged
    # pool, and why a config cannot use it; the static heavy sets by layer
    prefill_begin: Callable[..., Any]      # (t_total, device) -> cursor
    prefill_chunk: Callable[..., Any]      # (params, pool, tokens, cursor, slot, pages,
    #                                         n_shared, max_seq, *, final, ctx)
    #                                         -> (logits | None, pool, cursor)
    prefill_chunk_unsupported: Callable[..., Any]   # () -> str | None
    static_heavy: Callable[..., Any]       # (params, max_seq) -> per-layer sets | None
    # the persistent prefix cache: install a cache-pinned, already written
    # prompt into a slot by reference (metadata only, no prefill), and the
    # static heavy sets from activation statistics over a calibration batch
    adopt_pages: Callable[..., Any]        # (params, pool, slot, pages, length) -> pool
    calibrate: Callable[..., Any]          # (params, tokens) -> params with calib_salience


def unsupported_reason(cfg: ModelConfig) -> str | None:
    """Why this port slice cannot serve ``cfg`` — None when it can."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid") \
            or cfg.moe != (cfg.family == "moe") or cfg.encdec or cfg.frontend != "none":
        return (f"family {cfg.family!r} (moe={cfg.moe}, encdec={cfg.encdec}, frontend="
                f"{cfg.frontend!r}): only the decoder-only LMs (dense, MoE, SSM and hybrid) "
                "are ported so far; the enc-dec family and modality frontends are not")
    if set(cfg.layer_pattern) - {"A", "L", "S", "R"}:
        return (f"layer pattern {cfg.layer_pattern!r}: only global ('A'), sliding-window "
                "('L'), SSD ('S') and RG-LRU ('R') layers are ported so far")
    return None


def get_model(cfg: ModelConfig) -> ModelAPI:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")

    def prefill(params, tokens, max_seq):
        return transformer.lm_prefill(params, cfg, tokens, max_seq)

    def decode_step(params, state, token, active, ctx=None):
        return transformer.lm_decode_step(params, cfg, state, token, active, ctx)

    def init_state(slots, max_seq, device, ctx=None):
        return transformer.lm_init_state(cfg, slots, max_seq, device, ctx)

    def init_paged_state(slots, max_seq, block_size, num_blocks, device, ctx=None):
        return transformer.lm_init_paged_state(cfg, slots, max_seq, block_size,
                                               num_blocks, device, ctx)

    def prefill_begin(t_total, device):
        return transformer.lm_prefill_begin(cfg, t_total, device)

    def prefill_chunk(params, pool, tokens, cursor, slot, pages, n_shared, max_seq, *,
                      final, ctx=None):
        return transformer.lm_prefill_chunk(params, cfg, pool, tokens, cursor, slot, pages,
                                            n_shared, max_seq, final=final, ctx=ctx)

    def prefill_chunk_unsupported():
        return transformer.lm_prefill_chunk_unsupported(cfg)

    def static_heavy(params, max_seq):
        return transformer.lm_static_heavy(params, cfg, max_seq)

    def adopt_pages(params, pool, slot, pages, length):
        return transformer.lm_adopt_pages(params, cfg, pool, slot, pages, length)

    def calibrate(params, tokens):
        return transformer.lm_calibrate_static_heavy(params, cfg, tokens)

    return ModelAPI(prefill, decode_step, init_state, transformer.lm_write_into_slot,
                    init_paged_state, transformer.lm_write_into_slot,
                    transformer.lm_map_block, transformer.lm_share_blocks,
                    transformer.lm_cow_block, transformer.lm_reset_slot,
                    transformer.lm_read_block, transformer.lm_write_block,
                    transformer.lm_selection_hist, prefill_begin, prefill_chunk,
                    prefill_chunk_unsupported, static_heavy, adopt_pages, calibrate)
