"""Uniform model API (the LM part of the reference's `ModelAPI`).

The port serves the dense decoder-only LM with all-global attention; other
families (MoE, SSM, RG-LRU, enc-dec, VLM frontends) are later slices of the
port and raise here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class ModelAPI(NamedTuple):
    prefill: Callable[..., Any]            # (params, tokens, max_seq) -> (logits, state)
    decode_step: Callable[..., Any]        # (params, state, token, active, ctx) -> (logits, state)
    init_state: Callable[..., Any]         # (slots, max_seq, device) -> contiguous pool
    write_into_slot: Callable[..., Any]    # (pool, src, slot) -> pool
    init_paged_state: Callable[..., Any]   # (slots, max_seq, block_size, num_blocks, device, ctx)
    write_into_pages: Callable[..., Any]   # (pool, src, slot, pages, ctx) -> pool
    map_block: Callable[..., Any]          # (pool, slot, logical_block, page) -> pool
    reset_slot: Callable[..., Any]         # (pool, slot) -> pool, contiguous or paged
    read_block: Callable[..., Any]         # (pool, page) -> payload (storage format)
    write_block: Callable[..., Any]        # (pool, page, payload) -> pool
    selection_hist: Callable[..., Any]     # (pool) -> (slots, MB) int32


def unsupported_reason(cfg: ModelConfig) -> str | None:
    """Why this port slice cannot serve ``cfg`` — None when it can."""
    if cfg.family != "dense" or cfg.moe or cfg.encdec or cfg.frontend != "none":
        return f"family {cfg.family!r}: only the dense LM is ported so far"
    if set(cfg.layer_pattern) != {"A"}:
        return (f"layer pattern {cfg.layer_pattern!r}: only global-attention "
                "stacks are ported so far")
    if cfg.salca_static_channels:
        return "salca_static_channels comes with the prefix-sharing slice of the port"
    return None


def get_model(cfg: ModelConfig) -> ModelAPI:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")

    def prefill(params, tokens, max_seq):
        return transformer.lm_prefill(params, cfg, tokens, max_seq)

    def decode_step(params, state, token, active, ctx=None):
        return transformer.lm_decode_step(params, cfg, state, token, active, ctx)

    def init_state(slots, max_seq, device):
        return transformer.lm_init_state(cfg, slots, max_seq, device)

    def init_paged_state(slots, max_seq, block_size, num_blocks, device, ctx=None):
        return transformer.lm_init_paged_state(cfg, slots, max_seq, block_size,
                                               num_blocks, device, ctx)

    return ModelAPI(prefill, decode_step, init_state, transformer.lm_write_into_slot,
                    init_paged_state, transformer.lm_write_into_slot,
                    transformer.lm_map_block, transformer.lm_reset_slot,
                    transformer.lm_read_block, transformer.lm_write_block,
                    transformer.lm_selection_hist)
