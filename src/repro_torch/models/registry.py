"""Uniform model API (the reference's `ModelAPI`): serving, and the
training loss.

The port serves the decoder-only LM with global ("A") and sliding-window
("L") attention layers, SSD ("S", the "ssm" family: mamba2) and RG-LRU
("R", the "hybrid" family: recurrentgemma) layers, its FFN dense or MoE
(the "moe" family, arctic's dense residual included), with the vision
frontend's projector ahead of the text (the "vlm" family: llava); and the
enc-dec family (whisper, `models.encdec`), whose API has the reference's
shape: prefill, decode step, contiguous state, slot write and reset, every
other field None (its state is not paged, and the serving engine, whose
requests carry no frames, refuses it).

Prefill takes the reference's batch keys as keywords: ``frames=`` (B, T_enc,
D), required for the enc-dec family, and ``patches=`` (B, P, F), optional
for the vision frontend.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


class ModelAPI(NamedTuple):
    prefill: Callable[..., Any]            # (params, tokens, max_seq, *, frames | patches)
    #                                         -> (logits, state)
    decode_step: Callable[..., Any]        # (params, state, token, active, ctx) -> (logits, state)
    init_state: Callable[..., Any]         # (slots, max_seq, device, ctx) -> contiguous pool
    #                                         (enc-dec: (slots, t_enc, device, ctx,
    #                                         prefill_len))
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
    # training: the mean loss of a batch {"tokens", "labels", "patches"? |
    # "frames"} of tensors (the reference's `loss`)
    loss: Callable[..., Any] = None        # (params, batch) -> scalar loss


# the config families the port serves (`ModelConfig.family`)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def unsupported_reason(cfg: ModelConfig) -> str | None:
    """Why the port cannot serve ``cfg`` — None when it can."""
    if cfg.family not in FAMILIES:
        return f"family {cfg.family!r}: the port serves the families {', '.join(FAMILIES)}"
    if cfg.moe != (cfg.family == "moe"):
        return (f"family {cfg.family!r} with moe={cfg.moe}: the MoE FFN belongs to the "
                "'moe' family and only to it")
    if cfg.encdec != (cfg.frontend == "audio"):
        return (f"encdec={cfg.encdec} with frontend {cfg.frontend!r}: the audio frontend's "
                "frames feed the enc-dec family's encoder, and only it takes them")
    if cfg.encdec and cfg.layer_pattern != "A":
        return (f"layer pattern {cfg.layer_pattern!r}: the enc-dec family's blocks are "
                "global attention ('A') only")
    if set(cfg.layer_pattern) - {"A", "L", "S", "R"}:
        return (f"layer pattern {cfg.layer_pattern!r}: only global ('A'), sliding-window "
                "('L'), SSD ('S') and RG-LRU ('R') layers are ported so far")
    return None


def get_model(cfg: ModelConfig) -> ModelAPI:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")
    if cfg.encdec:
        return _encdec_model(cfg)

    def prefill(params, tokens, max_seq, *, patches=None):
        return transformer.lm_prefill(params, cfg, tokens, max_seq, patches=patches)

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

    def loss(params, batch):
        return transformer.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                                   patches=batch.get("patches"))

    return ModelAPI(prefill, decode_step, init_state, transformer.lm_write_into_slot,
                    init_paged_state, transformer.lm_write_into_slot,
                    transformer.lm_map_block, transformer.lm_share_blocks,
                    transformer.lm_cow_block, transformer.lm_reset_slot,
                    transformer.lm_read_block, transformer.lm_write_block,
                    transformer.lm_selection_hist, prefill_begin, prefill_chunk,
                    prefill_chunk_unsupported, static_heavy, adopt_pages, calibrate, loss)


def _encdec_model(cfg: ModelConfig) -> ModelAPI:
    """The enc-dec family's API (the reference's `get_model` enc-dec branch)."""
    def prefill(params, tokens, max_seq=None, *, frames=None):
        del max_seq         # the cross cache holds the frames; the self cache decoder_max_len
        if frames is None:
            raise ValueError(f"{cfg.name}: the enc-dec prefill needs frames= (B, T_enc, D)")
        return encdec.encdec_prefill(params, cfg, frames, tokens)

    def decode_step(params, state, token, active, ctx=None):
        return encdec.encdec_decode_step(params, cfg, state, token, active, ctx)

    def init_state(batch, t_enc, device, ctx=None, prefill_len=0):
        # the decoder cursor is bounded by the short target stream; the long
        # context (t_enc frames) is the cross-attention cache
        return encdec.encdec_init_state(cfg, batch, t_enc,
                                        prefill_len=min(int(prefill_len),
                                                        cfg.decoder_max_len - 1),
                                        device=device, ctx=ctx)

    def loss(params, batch):
        return encdec.encdec_loss(params, cfg, batch["frames"], batch["tokens"],
                                  batch["labels"])

    none = dict.fromkeys(ModelAPI._fields)
    return ModelAPI(**{**none, "prefill": prefill, "decode_step": decode_step, "loss": loss,
                       "init_state": init_state,
                       "write_into_slot": encdec.encdec_write_into_slot,
                       "reset_slot": encdec.encdec_reset_slot})
