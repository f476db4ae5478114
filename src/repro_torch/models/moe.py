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

The expert products are `torch.einsum` over (E, C, D) × (E, D, F), as the
reference's are XLA einsums outside any Pallas kernel. Nothing here makes a
tensor of host data, reads a value back to the host or calls `nonzero`,
so the decode tick captures into a CUDA graph.
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


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig, cap: int) -> Routing:
    """Routing of x (B, T, D) by the f32 ``router`` (D, E)."""
    e, k = cfg.padded_experts, cfg.experts_per_token
    logits = x.float() @ router                                         # (B, T, E)
    if e != cfg.num_experts:
        phantom = torch.arange(e, device=x.device) >= cfg.num_experts
        logits = logits.masked_fill(phantom, PHANTOM)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    b, t = x.shape[:2]
    sel = (topi[..., None] == torch.arange(e, device=x.device)).to(torch.int32)  # (B,T,k,E)
    queue = torch.cumsum(sel.reshape(b, t * k, e), dim=1).reshape(b, t, k, e) - 1
    pos = (sel * queue).sum(-1, dtype=torch.int32)
    return Routing(gates, topi, topw, pos, pos < cap, cap)


def aux_loss(r: Routing) -> torch.Tensor:
    """Switch's load-balancing loss, E · Σ_e f_e · p_e (f32 scalar)."""
    e = r.gates.shape[-1]
    me = r.gates.mean(dim=(0, 1))
    top1 = (r.topi[..., 0, None] == torch.arange(e, device=r.gates.device)).float()
    return (me * top1.mean(dim=(0, 1))).sum() * e


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


def _experts(params: dict, xe: torch.Tensor, act: str) -> torch.Tensor:
    """The expert GLUs on xe (B, E, C, D) → (B, E, C, D)."""
    f = F.silu if act == "silu" else (lambda z: F.gelu(z, approximate="tanh"))
    hg = f(torch.einsum("becd,edf->becf", xe, params["w_gate"]))
    hu = torch.einsum("becd,edf->becf", xe, params["w_up"])
    return torch.einsum("becf,efd->becd", hg * hu, params["w_down"])


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, T, D) → (out (B, T, D) in x's dtype, aux f32 scalar)."""
    from repro_torch.flags import PERF
    b_in, t_in, d = x.shape
    if PERF.moe_flat_dispatch and b_in > 1 and t_in <= 16:
        x = x.reshape(1, b_in * t_in, d)
    b, t, _ = x.shape
    r = route(params["router"], x, cfg, capacity(t, cfg, tight=PERF.moe_flat_dispatch))
    if PERF.moe_gather_dispatch:
        idx, w_ec = dispatch_indices(r, t)
        xe = x[torch.arange(b, device=x.device)[:, None, None], idx]    # (B, E, C, D)
        ye = _experts(params, xe, cfg.act)
        ye = ye * w_ec[..., None].to(ye.dtype)
        out = _combine(r, ye, w_ec)
    else:
        e, cap = r.gates.shape[-1], r.cap
        sel = (r.topi[..., None] == torch.arange(e, device=x.device)).to(x.dtype)
        slot = r.pos.masked_fill(~r.keep, cap).long()
        cap_onehot = (slot[..., None] == torch.arange(cap, device=x.device)).to(x.dtype)
        disp = torch.einsum("btke,btkc->btec", sel, cap_onehot)
        xe = torch.einsum("btd,btec->becd", x, disp)
        ye = _experts(params, xe, cfg.act)
        w = (r.topw * r.keep).to(x.dtype)
        comb = torch.einsum("btke,btkc,btk->btec", sel, cap_onehot, w)
        out = torch.einsum("btec,becd->btd", comb, ye)
    if (b, t) != (b_in, t_in):
        out = out.reshape(b_in, t_in, d)
    return out.to(x.dtype), aux_loss(r)


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
