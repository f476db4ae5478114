"""Whisper-style encoder–decoder (the audio family): serving and training.

Port of the reference `models/encdec.py`: `encode`, `EncDecState`,
`encdec_prefill`, `encdec_init_state`, `encdec_write_into_slot`,
`encdec_reset_slot` and `encdec_decode_step`, and the training half
(`cross_attention_full`, `decode_train`, `encdec_loss`), whose attention
goes through `models.attention.train_attention` (B3, then B3-bwd) and whose
encoder and decoder layers each run under activation checkpointing, as the
reference's under ``jax.checkpoint``.

The conv audio frontend is a STUB: the caller delivers precomputed frame
embeddings (B, T_enc, D), post-conv, pre-encoder. The encoder attends both
ways over the frames (kernel B3 with ``causal=False``, RoPE over the frame
positions). Decoder blocks: causal self-attention over the short target
stream (≤ ``cfg.decoder_max_len`` tokens) + cross-attention over the
encoder states (no positions, no q/k norm) + GLU FFN. **Salca applies to
the cross-attention stream**: decode reads the whole T_enc-frame context
every step, the paper's bandwidth-bound regime; the self-attention cache is
short and read densely. As in the reference, RoPE stands in for whisper's
learned/sinusoidal positions (self-attention only).

Parameters (`weights.params_from_numpy` unstacks the reference's tree)::

    {"embed": {"tok", "head"?}, "enc": [{"ln1", "attn", "ln2", "glu"}, ...],
     "ln_enc": {"scale"}, "dec": [{"ln1", "self_attn", "ln_x", "cross_attn",
     "ln2", "glu"}, ...], "ln_f": {"scale"}}

with the attention and GLU leaves in the reference's layouts.

Where the reference stacks each cache over a leading layer axis, the port
keeps a list with one `SalcaCache` per decoder layer. Every update is in
place (the self caches' appends, ``pos += active``), so the serving tick
can be captured as a CUDA graph (`runtime.steps.ServeDecodeStep`); the
cross caches are never written after their prefill.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import dense_decode_from_cache, salca_decode_attention
from repro_torch.core.cache import (
    append_token_masked, empty_cache, prefill_cache, reset_slot, write_prefill_into_slot)
from repro_torch.core.sp_decode import (
    local_lengths, sp_append_token, sp_dense_decode, sp_salca_decode)
from repro_torch.distributed.sharding import DecodeCtx, local_row_range
from repro_torch.models import blocks as B
from repro_torch.models.attention import (
    attention_train, bidirectional_attention, fold_heads, prefill_attention, proj,
    qkv_project, train_attention)
from repro_torch.models.common import (
    cdtype, cross_entropy, embed_tokens, glu_apply, lm_logits, rmsnorm, rope,
    vocab_mask_logits)


def _enc_layer(lp: dict, h: torch.Tensor, cfg: ModelConfig, attend) -> torch.Tensor:
    """One encoder layer on h (B, T_enc, D); ``attend(q, k, v)`` is the
    unmasked attention (serving's `bidirectional_attention`, or training's
    differentiable `train_attention`)."""
    b, t, _ = h.shape
    q, k, v = qkv_project(lp["attn"], rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg,
                          torch.arange(t, device=h.device))
    h = h + attend(q, k, v).reshape(b, t, -1) @ lp["attn"]["wo"]
    return h + glu_apply(lp["glu"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg.act)


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           train: bool = False) -> torch.Tensor:
    """frames (B, T_enc, D) stub embeddings → encoder states (B, T_enc, D).
    ``train``: differentiable, each layer under activation checkpointing."""
    h = frames.to(cdtype(cfg))
    attend = partial(train_attention, causal=False) if train else bidirectional_attention
    for lp in params["enc"]:
        h = (checkpoint(_enc_layer, lp, h, cfg, attend, use_reentrant=False) if train
             else _enc_layer(lp, h, cfg, attend))
    return rmsnorm(params["ln_enc"], h, cfg.norm_eps)


def cross_attention_full(lp: dict, x: torch.Tensor, enc: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """Training cross-attention of x (B, Td, D) over the encoder states enc
    (B, T_enc, D): no positions, no mask (the reference's
    `_cross_attention_full`)."""
    o = train_attention(proj(x, lp["wq"]), proj(enc, lp["wk"]), proj(enc, lp["wv"]),
                        causal=False)
    return o.reshape(x.shape[0], x.shape[1], -1) @ lp["wo"]


def _dec_layer_train(lp: dict, h: torch.Tensor, enc: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    h = h + attention_train(lp["self_attn"], rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg)
    h = h + cross_attention_full(lp["cross_attn"], rmsnorm(lp["ln_x"], h, cfg.norm_eps), enc,
                                 cfg)
    return h + glu_apply(lp["glu"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg.act)


def decode_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 enc: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder forward → logits (B, Td, V_pad), each layer
    under activation checkpointing."""
    h = embed_tokens(params["embed"], tokens).to(cdtype(cfg))
    for lp in params["dec"]:
        h = checkpoint(_dec_layer_train, lp, h, enc, cfg, use_reentrant=False)
    return lm_logits(params["embed"], rmsnorm(params["ln_f"], h, cfg.norm_eps), cfg)


def encdec_loss(params: dict, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the decoder's next-token logits over the labels."""
    enc = encode(params, cfg, frames, train=True)
    return cross_entropy(decode_train(params, cfg, tokens, enc), labels, cfg)


@dataclass
class EncDecState:
    """Per decoder layer a self-attention cache (B, S_self, ·) and a
    cross-attention cache (B, T_enc, ·), and the (B,) decoder cursor. Under a
    `DecodeCtx` each cache holds this rank's rows (`encdec_init_state`)."""
    self_caches: list
    cross_caches: list
    pos: torch.Tensor


def encdec_prefill(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor):
    """Encode, then the teacher-forced decoder prefill of ``tokens`` (B, Td):
    → (last-position logits (B, V_pad), EncDecState) with the self cache at
    ``decoder_max_len`` rows and the cross cache at T_enc rows, each with
    the `SalcaParams` of its own length."""
    self_max = cfg.decoder_max_len
    enc = encode(params, cfg, frames)
    h = embed_tokens(params["embed"], tokens).to(cdtype(cfg))
    t_enc = enc.shape[1]
    sp_cross = B.salca_params_for(cfg, t_enc)
    sp_self = B.salca_params_for(cfg, self_max)
    positions = torch.arange(h.shape[1], device=h.device)
    self_caches, cross_caches = [], []
    for lp in params["dec"]:
        xn = rmsnorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = qkv_project(lp["self_attn"], xn, cfg, positions)
        o = prefill_attention(q, fold_heads(k), fold_heads(v))
        h = h + o.reshape(h.shape[0], h.shape[1], -1) @ lp["self_attn"]["wo"]
        self_caches.append(prefill_cache(k, v, max_seq=self_max, params=sp_self))
        xn = rmsnorm(lp["ln_x"], h, cfg.norm_eps)
        ca = lp["cross_attn"]
        kx, vx = proj(enc, ca["wk"]), proj(enc, ca["wv"])
        ox = bidirectional_attention(proj(xn, ca["wq"]), kx, vx)
        h = h + ox.reshape(h.shape[0], h.shape[1], -1) @ ca["wo"]
        cross_caches.append(prefill_cache(kx, vx, max_seq=t_enc, params=sp_cross))
        h = h + glu_apply(lp["glu"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg.act)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = vocab_mask_logits(lm_logits(params["embed"], h[:, -1], cfg), cfg)
    pos = torch.full((h.shape[0],), tokens.shape[1], dtype=torch.int32, device=h.device)
    return logits, EncDecState(self_caches, cross_caches, pos)


def encdec_init_state(cfg: ModelConfig, batch: int, t_enc: int, prefill_len: int = 0,
                      device="cpu", ctx: DecodeCtx | None = None) -> EncDecState:
    """An empty pooled decode state on ``device``: per decoder layer an
    empty self cache of ``decoder_max_len`` rows and an empty cross cache of
    ``t_enc`` rows, cursors at ``prefill_len``. With ``ctx`` each cache
    holds this rank's even share of its rows."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    r = B.salca_params_for(cfg, t_enc).r(hd)
    n_self, n_cross = (B.local_rows(cfg, n, n, ctx) for n in (cfg.decoder_max_len, t_enc))
    return EncDecState(
        self_caches=[empty_cache(batch, n_self, kv, hd, r, device=device)
                     for _ in range(cfg.num_layers)],
        cross_caches=[empty_cache(batch, n_cross, kv, hd, r, device=device)
                      for _ in range(cfg.num_layers)],
        pos=torch.full((batch,), prefill_len, dtype=torch.int32, device=device))


def encdec_write_into_slot(pool: EncDecState, src: EncDecState, slot: int,
                           ctx: DecodeCtx | None = None) -> EncDecState:
    """Install a batch=1 prefilled state into row ``slot`` of a pooled state
    (`core.cache.write_prefill_into_slot` for every layer's two caches);
    with ``ctx`` only this rank's rows of each. In place."""
    for dst, s in zip(pool.self_caches + pool.cross_caches,
                      src.self_caches + src.cross_caches):
        write_prefill_into_slot(dst, s, slot,
                                None if ctx is None else local_row_range(s.max_seq, ctx))
    pool.pos[slot] = src.pos[0]
    return pool


def encdec_reset_slot(pool: EncDecState, slot: int) -> EncDecState:
    """Free row ``slot``: both cache stacks marked empty, cursor zeroed. In
    place."""
    for c in pool.self_caches + pool.cross_caches:
        reset_slot(c, slot)
    pool.pos[slot] = 0
    return pool


def encdec_decode_step(params: dict, cfg: ModelConfig, state: EncDecState,
                       token: torch.Tensor, active: torch.Tensor,
                       ctx: DecodeCtx | None = None):
    """One decoder step for every slot: token (S,) int → (logits (S, V_pad),
    state). Salca runs on the cross-attention stream.

    Inactive slots compute (static shapes) but append nothing to their self
    cache and hold their cursor; their logits are garbage the caller
    ignores. Unsharded: the self cache takes the masked append and is read
    densely after f32 dequantisation; the cross cache is read by Salca
    (B7 → B9 → B8, `core.attention.salca_decode_attention`) with
    ``cfg.salca``, else densely.

    With ``ctx`` every cache holds this rank's rows (the flat sequence-
    sharded tick, `core.sp_decode`): the self cache appends at the global
    cursor, -1 for an inactive slot so that every rank drops its write
    (`sp_append_token`), and is read by `sp_dense_decode`; the cross cache by
    `sp_salca_decode` (`sp_dense_decode` without Salca) over T_enc valid
    rows in every slot, as the reference's island reads it. The reference
    shards the self cache over its model axis and the cross cache over the
    decode sequence axes; in the port's one-group `DecodeCtx` both are the
    same ranks."""
    h = embed_tokens(params["embed"], token).to(cdtype(cfg))
    pos = state.pos
    t_enc = B.global_rows(state.cross_caches[0], ctx)
    sp_cross = B.salca_params_for(cfg, t_enc)
    if ctx is not None:
        cursor = torch.where(active, pos, -1)
        enc_len = torch.full_like(pos, t_enc)
    for lp, sc, xc in zip(params["dec"], state.self_caches, state.cross_caches):
        # --- causal self-attention over the short target stream ---------
        xn = rmsnorm(lp["ln1"], h, cfg.norm_eps)
        sa = lp["self_attn"]
        q, k, v = proj(xn, sa["wq"]), proj(xn, sa["wk"]), proj(xn, sa["wv"])
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0].float()
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        if ctx is None:
            append_token_masked(sc, k, v, active)
            o = dense_decode_from_cache(q, sc)
        else:
            sp_append_token(sc, k, v, cursor, ctx)
            o = sp_dense_decode(q, sc, ctx, global_len=cursor + 1)
        h = h + o.to(h.dtype).reshape(h.shape[0], -1) @ sa["wo"]

        # --- Salca cross-attention over the encoder stream ---------------
        xn = rmsnorm(lp["ln_x"], h, cfg.norm_eps)
        ca = lp["cross_attn"]
        qx = proj(xn, ca["wq"]).float()
        if ctx is None:
            ox = (salca_decode_attention(qx, xc, sp_cross) if cfg.salca else
                  dense_decode_from_cache(qx, xc))
        else:
            xc = xc._replace(length=local_lengths(enc_len, xc.max_seq, ctx))
            ox = (sp_salca_decode(qx, xc, sp_cross, ctx) if cfg.salca else
                  sp_dense_decode(qx, xc, ctx, global_len=enc_len))
        h = h + ox.to(h.dtype).reshape(h.shape[0], -1) @ ca["wo"]
        h = h + glu_apply(lp["glu"], rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg.act)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    logits = vocab_mask_logits(lm_logits(params["embed"], h, cfg), cfg)
    state.pos.add_(active)
    return logits, state
