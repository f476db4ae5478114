"""Mixture-of-Experts FFN: top-k routing with expert capacity, and the two
dispatches (port of the reference `models/moe.py`).

Routing, as the reference computes it: float32 router logits, phantom
experts (ids >= ``num_experts``, padding up to ``padded_experts``) at
-1e30, softmax gates, the top k in the order of `jax.lax.top_k` (larger
gate first, the lower expert id first among equal gates: a stable
descending sort), the top-k weights renormalised, then each (token,
choice)'s position in its expert's queue by a cumulative count over the
(token, choice) pairs, token-major; pairs at or past the capacity are
dropped (their weight is not redistributed).

``PERF.moe_flat_dispatch``: (B, T) flattens into one token axis for
decode-like shapes (B > 1, T <= 16) and the capacity is sized from that
count, 4-aligned with no inflated floor; off, per row, 8-aligned with a
floor of 8. ``PERF.moe_gather_dispatch``: tokens reach their (expert, slot)
through index buffers of a static (E, C + 1) shape (the spare column takes
the dropped pairs) and come back through a combine that adds each token's
kept contributions in ascending expert id, rounding after each add — the
order of the reference's scatter-add, fixed, so a graphed tick equals its
eager twin bit for bit (no atomics); off, the one-hot einsums.

The expert products are `torch.einsum` over expert-major slot buffers,
(E, B, C, D) × (E, D, F), as the reference's are XLA einsums outside any
Pallas kernel. Nothing here makes a
tensor of host data, reads a value back to the host or calls `nonzero`,
so the decode tick captures into a CUDA graph.

In training on a data × model mesh (an ambient `ShardingCtx`:
`runtime.steps.ShardedTrainStep`) `moe_apply` takes the reference's layouts,
which move data but never change the result: every rank computes what one
device computes on the global batch.

* The capacity is sized from the global sequence (T, not this rank's
  shard) and the positions in the expert queues are the reference's
  cumulative count over the whole row: a rank that routes its own
  sequence shard adds to its local count the pairs each expert's queue
  holds from the lower model ranks' shards (`queue_offsets`, from one
  all-gather of the (B, E) counts).
* ``ep`` (the reference's default rule, ``w_gate`` / ``w_up`` P(m, f, None),
  ``w_down`` P(m, None, f)): this rank holds E/M experts and routes its
  sequence shard. Each rank writes its kept pairs into an expert-major
  (E, B, C, D) buffer that holds only its own slots (`gather_slots`); a
  reduce-scatter over the expert dim hands each rank its experts' slots
  (exact: every slot has one writer), the expert GLUs run there
  (`expert_glu`), an all-gather returns every expert's outputs, and each
  rank adds its tokens' contributions in `_combine`'s order
  (`combine_slots`).
  Where the sequence is whole every rank routes all of it and fills its
  experts' slots itself. Every buffer keeps its static shape, whatever
  drops.
* expert-TP (``moe_strategy="tp"``: P(None, f, m) and P(None, m, f)): the
  tokens stay whole inside the MoE (the sequence gathered), every rank
  routes all of them, each expert's GLU runs on this rank's d_ff columns,
  and the partial output is reduced back into the residual's layout.
* Where the spec leaves the experts whole (E, or d_ff under expert-TP, not
  divisible by M) every rank holds every expert and computes the slots of
  the tokens it routes; nothing is exchanged.
* ``PERF.moe_gather_dispatch`` off: the same layouts and exchanges, with
  the one-hot einsums (`onehot_slots`, `onehot_combine`) in place of the
  index buffers, as on one device.
* The load-balancing loss is the reference's product of two means over
  the global batch: each rank sums the gates and the top-1 counts over its
  share of the tokens (`aux_sums`), one all-reduce sums them over the mesh
  (`distributed.sharding.sum_over_tokens`, whose backward sums over the
  data ranks only), and each rank forms the product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

PHANTOM = -1e30


def capacity(tokens: int, cfg: ModelConfig, tight: bool) -> int:
    """Slots per expert for ``tokens`` routed tokens (the reference's
    `_capacity`): ``tight`` (flat dispatch) 4-aligned and at least k, else
    8-aligned and at least 8."""
    cap = int(cfg.capacity_factor * tokens * cfg.experts_per_token / max(cfg.num_experts, 1))
    if tight:
        return max(cfg.experts_per_token, ((cap + 3) // 4) * 4)
    return max(8, ((cap + 7) // 8) * 8)


class Routing(NamedTuple):
    """One routing of (B, T) tokens over E (padded) experts, k choices each."""
    gates: torch.Tensor      # (B, T, E) f32 softmax
    topi: torch.Tensor       # (B, T, k) int64 expert ids, the reference's order
    topw: torch.Tensor       # (B, T, k) f32 renormalised top-k gates
    pos: torch.Tensor        # (B, T, k) int32 position in the expert's queue
    keep: torch.Tensor       # (B, T, k) bool: pos < cap
    cap: int


def gate_top_k(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """Routing's first half on x (B, T, D) by the f32 ``router`` (D, E):
    (gates (B, T, E) f32 softmax, topi (B, T, k) int64 in the reference's
    order, topw (B, T, k) f32 renormalised)."""
    e, k = cfg.padded_experts, cfg.experts_per_token
    logits = x.float() @ router                                         # (B, T, E)
    if e != cfg.num_experts:
        phantom = torch.arange(e, device=x.device) >= cfg.num_experts
        logits = logits.masked_fill(phantom, PHANTOM)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return gates, topi, topw


def _one_hot(topi: torch.Tensor, e: int) -> torch.Tensor:
    return (topi[..., None] == torch.arange(e, device=topi.device)).to(torch.int32)


def expert_counts(topi: torch.Tensor, e: int) -> torch.Tensor:
    """(B, E) int32: the (token, choice) pairs of each row that choose each
    expert."""
    return _one_hot(topi, e).sum(dim=(1, 2), dtype=torch.int32)


def queue_offsets(counts: torch.Tensor, rank: int) -> torch.Tensor:
    """(B, E) int32: the pairs that each expert's queue holds, per row, from
    the sequence shards below model rank ``rank``, given every model rank's
    `expert_counts` stacked by rank (M, B, E): the first position of this
    rank's pairs."""
    return counts[:rank].sum(0, dtype=torch.int32)


def positions(gates, topi, topw, cap: int, offset: torch.Tensor | None = None) -> Routing:
    """Routing's second half: each (token, choice)'s position in its
    expert's queue, a cumulative count over the row's pairs, token-major,
    plus ``offset`` (B, E) (`queue_offsets`) for a sequence shard."""
    b, t, k = topi.shape
    sel = _one_hot(topi, gates.shape[-1])                               # (B,T,k,E)
    queue = torch.cumsum(sel.reshape(b, t * k, -1), dim=1).reshape(sel.shape) - 1
    pos = (sel * queue).sum(-1, dtype=torch.int32)
    if offset is not None:
        pos = pos + torch.gather(offset, 1, topi.reshape(b, t * k)).reshape(b, t, k)
    return Routing(gates, topi, topw, pos, pos < cap, cap)


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig, cap: int) -> Routing:
    """Routing of x (B, T, D) by the f32 ``router`` (D, E)."""
    return positions(*gate_top_k(router, x, cfg), cap)


def aux_loss(r: Routing) -> torch.Tensor:
    """Switch's load-balancing loss, E · Σ_e f_e · p_e (f32 scalar)."""
    b, t = r.topi.shape[:2]
    return aux_from_sums(aux_sums(r, 0, t), b * t)


def aux_sums(r: Routing, lo: int, hi: int) -> torch.Tensor:
    """(2E,) f32: the gates and the top-1 one-hots of the rows [lo, hi) of
    ``r``'s sequence, each summed over those tokens (a rank's share of the
    load-balancing loss's means)."""
    e = r.gates.shape[-1]
    top1 = (r.topi[:, lo:hi, 0, None] == torch.arange(e, device=r.gates.device)).float()
    return torch.cat([r.gates[:, lo:hi].sum(dim=(0, 1)), top1.sum(dim=(0, 1))])


def aux_from_sums(sums: torch.Tensor, tokens: int) -> torch.Tensor:
    """`aux_loss` from the global batch's `aux_sums` over ``tokens`` tokens."""
    e = sums.shape[0] // 2
    return ((sums[:e] / tokens) * (sums[e:] / tokens)).sum() * e


def dispatch_indices(r: Routing, t: int):
    """The gather dispatch's buffers: per (row, expert, slot) the token it
    holds (B, E, C) int64 and its weight (B, E, C) f32 (0: an unused slot),
    scattered through (E, C + 1) rows whose spare column takes the dropped
    pairs."""
    b, _, k = r.topi.shape
    e, cap = r.gates.shape[-1], r.cap
    slot = r.pos.masked_fill(~r.keep, cap).long()
    flat = (r.topi * (cap + 1) + slot).reshape(b, t * k)
    tok = torch.arange(t, device=flat.device).repeat_interleave(k).expand(b, t * k)
    w = (r.topw * r.keep).reshape(b, t * k)
    idx = torch.zeros((b, e * (cap + 1)), dtype=torch.int64, device=flat.device)
    wgt = torch.zeros((b, e * (cap + 1)), dtype=torch.float32, device=flat.device)
    idx.scatter_(1, flat, tok)
    wgt.scatter_(1, flat, w)
    return (idx.reshape(b, e, cap + 1)[..., :cap], wgt.reshape(b, e, cap + 1)[..., :cap])


def expert_glu(params: dict, xe: torch.Tensor, act: str) -> torch.Tensor:
    """The expert GLUs on an expert-major buffer xe (E', B, C, D) of the
    experts whose weights ``params`` holds (E', D, F) → (E', B, C, D)."""
    f = F.silu if act == "silu" else (lambda z: F.gelu(z, approximate="tanh"))
    hg = f(torch.einsum("ebcd,edf->ebcf", xe, params["w_gate"]))
    hu = torch.einsum("ebcd,edf->ebcf", xe, params["w_up"])
    return torch.einsum("ebcf,efd->ebcd", hg * hu, params["w_down"])


def gather_slots(x: torch.Tensor, r: Routing, experts: slice | None = None):
    """The gather dispatch: (the expert-major buffer (E', B, C, D) that
    holds, at each slot of the experts ``experts``, the token of x (B, T,
    D) that ``r`` puts there; the slot weights (B, E, C) of
    `dispatch_indices`). ``experts`` None: every expert, and only the slots
    of x's own tokens (zero elsewhere), the buffer of an ``ep`` rank's
    sequence shard: summed over the model ranks, the shards' buffers are
    the whole sequence's."""
    idx, w_ec = dispatch_indices(r, x.shape[1])
    sl = slice(None) if experts is None else experts
    xe = x[torch.arange(x.shape[0], device=x.device)[None, :, None], idx[:, sl].transpose(0, 1)]
    if experts is None:
        xe = torch.where((w_ec > 0).transpose(0, 1)[..., None], xe, 0.0)
    return xe, w_ec


def combine_slots(r: Routing, ye: torch.Tensor, w_ec: torch.Tensor) -> torch.Tensor:
    """The outputs (B, T, D) of ``r``'s tokens from every expert's slot
    outputs ye (E, B, C, D): weighted by the slot weights and added in
    `_combine`'s order."""
    return _combine(r, ye.transpose(0, 1) * w_ec[..., None].to(ye.dtype), w_ec)


def onehot_slots(x: torch.Tensor, r: Routing, experts: slice | None = None):
    """The one-hot dispatch (``moe_gather_dispatch`` off; the reference's
    einsums): (the expert-major buffer (E', B, C, D) of the experts
    ``experts`` (None: every expert) filled from x (B, T, D)'s tokens, the
    (token, choice) one-hots over experts and slots that `onehot_combine`
    takes). A sequence shard's buffer holds only its own tokens' slots, zero
    elsewhere, as `gather_slots`'s does."""
    e, cap = r.gates.shape[-1], r.cap
    sel = (r.topi[..., None] == torch.arange(e, device=x.device)).to(x.dtype)
    slot = r.pos.masked_fill(~r.keep, cap).long()
    cap_onehot = (slot[..., None] == torch.arange(cap, device=x.device)).to(x.dtype)
    disp = torch.einsum("btke,btkc->btec", sel, cap_onehot)
    if experts is not None:
        disp = disp[:, :, experts]
    return torch.einsum("btd,btec->ebcd", x, disp), (sel, cap_onehot)


def onehot_combine(r: Routing, ye: torch.Tensor, hots) -> torch.Tensor:
    """The one-hot combine: the outputs (B, T, D) of ``r``'s tokens from
    every expert's slot outputs ye (E, B, C, D), weighted by the kept
    top-k weights (one einsum over experts and slots)."""
    sel, cap_onehot = hots
    w = (r.topw * r.keep).to(ye.dtype)
    comb = torch.einsum("btke,btkc,btk->btec", sel, cap_onehot, w)
    return torch.einsum("btec,ebcd->btd", comb, ye)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, split: bool = False):
    """x (B, T, D) → (out (B, T, D) in x's dtype, aux f32 scalar). In
    training on a mesh of more than one rank, x and out are in the
    residual's layout (the sequence split over "model" where ``split``) and
    the layers are the reference's (`_moe_apply_mesh`)."""
    from repro_torch.distributed.sharding import current_ctx, data_size, model_size
    from repro_torch.flags import PERF
    if current_ctx() is not None and model_size() * data_size() > 1:
        return _moe_apply_mesh(params, x, cfg, split)
    b_in, t_in, d = x.shape
    if PERF.moe_flat_dispatch and b_in > 1 and t_in <= 16:
        x = x.reshape(1, b_in * t_in, d)
    b, t, _ = x.shape
    r = route(params["router"], x, cfg, capacity(t, cfg, tight=PERF.moe_flat_dispatch))
    if PERF.moe_gather_dispatch:
        xe, w_ec = gather_slots(x, r, slice(None))
        out = combine_slots(r, expert_glu(params, xe, cfg.act), w_ec)
    else:
        xe, hots = onehot_slots(x, r)
        out = onehot_combine(r, expert_glu(params, xe, cfg.act), hots)
    if (b, t) != (b_in, t_in):
        out = out.reshape(b_in, t_in, d)
    return out.to(x.dtype), aux_loss(r)


def _moe_apply_mesh(params: dict, x: torch.Tensor, cfg: ModelConfig, split: bool):
    """`moe_apply` on this rank's blocks of the weights and its rows of the
    batch under the ambient `ShardingCtx` (module docstring)."""
    from repro_torch.distributed.sharding import (
        all_gather_dim, current_ctx, data_size, gather_from_experts, gather_from_sequence,
        model_group, model_part, model_size, reduce_scatter_to_sequence, scatter_to_experts,
        sum_over_tokens)
    from repro_torch.flags import PERF
    ctx = current_ctx()
    b, t_loc, _ = x.shape
    m, n = model_size(), data_size()
    t = t_loc * m if split else t_loc
    if PERF.moe_flat_dispatch and b * n > 1 and t <= 16:
        raise NotImplementedError(f"{cfg.name}: MoE routing of a global batch of {b * n} rows "
                                  f"of {t} positions on a mesh: the flat dispatch merges rows "
                                  "that the data axes split")
    e = cfg.padded_experts
    cap = capacity(t, cfg, tight=PERF.moe_flat_dispatch)
    tp = ctx.moe_strategy == "tp" and model_part(cfg.moe_d_ff)[1] > 1
    ep = ctx.moe_strategy == "ep" and model_part(e)[1] > 1
    shard = split and not tp            # this rank routes its own sequence shard
    xr = gather_from_sequence(x, split) if tp else x
    gates, topi, topw = gate_top_k(params["router"], xr, cfg)
    offset = None
    if shard:                           # every model rank's counts: one all-gather
        counts = all_gather_dim(expert_counts(topi, e)[None], 0, model_group())
        offset = queue_offsets(counts, model_group().rank)
    r = positions(gates, topi, topw, cap, offset)
    slots, combine = ((gather_slots, combine_slots) if PERF.moe_gather_dispatch
                      else (onehot_slots, onehot_combine))
    if ep:
        i, parts = model_part(e)
        xe, held = slots(xr, r, None if shard else slice(i * e // parts, (i + 1) * e // parts))
        if shard:
            xe = scatter_to_experts(xe)
        ye = gather_from_experts(expert_glu(params, xe, cfg.act))
    else:
        xe, held = slots(xr, r, slice(None))
        ye = expert_glu(params, xe, cfg.act)
    out = combine(r, ye, held)
    if tp:
        out = reduce_scatter_to_sequence(out, split)
    # the load-balancing sums over this rank's share of the tokens: all that
    # it routes, or where every model rank routes the whole sequence its
    # M-th of the rows
    rows = xr.shape[1]
    lo, hi = (0, rows) if shard or m == 1 else (
        model_group().rank * rows // m, (model_group().rank + 1) * rows // m)
    aux = aux_from_sums(sum_over_tokens(aux_sums(r, lo, hi)), b * n * t)
    return out.to(x.dtype), aux


def _combine(r: Routing, ye: torch.Tensor, w_ec: torch.Tensor) -> torch.Tensor:
    """Each token's kept contributions ye[b, e, slot], added into zeros in
    ye's dtype in ascending expert id, one rounding per add — the
    reference's scatter-add in (expert, slot) order. A slot whose weight is
    0 is skipped, as the reference drops it."""
    b, t, k = r.topi.shape
    order = torch.argsort(r.topi, dim=-1)          # a token's experts are distinct
    e_s = torch.gather(r.topi, -1, order)
    p_s = torch.gather(r.pos.masked_fill(~r.keep, 0).long(), -1, order)
    bi = torch.arange(b, device=ye.device)[:, None, None]
    live = torch.gather(r.keep, -1, order) & (w_ec[bi, e_s, p_s] > 0)
    contrib = torch.where(live[..., None], ye[bi, e_s, p_s], torch.zeros_like(ye[:1, :1, :1]))
    out = torch.zeros((b, t, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        out = out + contrib[:, :, j]
    return out
