"""Port parity, B3's LSE form and B3-bwd at a query offset (a context-parallel
rank's query rows over the gathered keys), plain versions on the CPU against
the JAX package.

* A causal and a windowed attention of 4 query heads over 2 KV heads (G 2),
  HD 32, T 64, batch 2, split into M = 2 and 4 query shards: shard r holds
  the rows [r·T/M, (r+1)·T/M) at ``q_offset`` r·T/M over the keys [0,
  (r+1)·T/M). Per shard, `flash_attention_lse` and
  `flash_attention_backward` (and `FlashAttentionFn` through
  `models.attention.train_attention`) against ``jax.vjp`` of the reference's
  `flash_attention_xla` over the whole sequence, its output restricted to
  the shard's rows and its cotangent zero outside them, within `ATTN_TOL`
  (`tests/test_torch_train.py`'s tolerance: f32 on both sides, the same
  terms summed in other orders).
* The shards recombine: their outputs, LSE rows and dQ rows concatenated,
  and their dK / dV summed, equal the unsharded plain call's within
  `ATTN_TOL` (f32: dK and dV are sums over the query rows taken in another
  grouping).
* The offset is checked: keys that stop before a shard's last position are
  refused.

Run alone: ~7 s on this container's CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch.kernels.flash_prefill import ops as fp
from repro_torch.models.attention import fold_heads, train_attention

ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
B, T, H, KV, HD = 2, 64, 4, 2, 32
MASKS = {"causal": dict(causal=True, window=0), "window": dict(causal=True, window=20)}


def _inputs():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, T, H, HD), np.float32)
    k = rng.standard_normal((B, T, KV, HD), np.float32)
    v = rng.standard_normal((B, T, KV, HD), np.float32)
    do = rng.standard_normal((B, T, H, HD), np.float32)
    return q, k, v, do


@jax.jit(static_argnames=("causal", "window"))
def _jax_vjp(q, k, v, cot, causal, window):
    out, vjp = jax.vjp(lambda *x: jattention.flash_attention_xla(*x, causal=causal,
                                                                  window=window), q, k, v)
    return (out, *vjp(cot))


def _jax_shard(q, k, v, do, lo, hi, mask):
    """jax.vjp of the whole-sequence reference, the cotangent zero outside
    rows [lo, hi): (out rows, dq rows, dk, dv)."""
    cot = np.zeros_like(do)
    cot[:, lo:hi] = do[:, lo:hi]
    out, dq, dk, dv = (np.asarray(x) for x in _jax_vjp(
        *(jnp.asarray(x) for x in (q, k, v, cot)), **mask))
    return out[:, lo:hi], dq[:, lo:hi], dk, dv


def _fold(x):
    return fold_heads(torch.from_numpy(np.ascontiguousarray(x)))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_offset_shards_match_jax_and_recombine(m, mask_name):
    mask = MASKS[mask_name]
    q, k, v, do = _inputs()
    fq, fk, fv, fdo = (_fold(x) for x in (q, k, v, do))
    whole_out, whole_lse = fp.flash_attention_lse(fq, fk, fv, **mask)
    whole = fp.flash_attention_backward(fq, fk, fv, whole_out, fdo, whole_lse, **mask)
    n = T // m
    outs, lses, dqs = [], [], []
    dk_sum, dv_sum = torch.zeros_like(fk), torch.zeros_like(fv)
    for r in range(m):
        lo, hi = r * n, (r + 1) * n
        jout, jdq, jdk, jdv = _jax_shard(q, k, v, do, lo, hi, mask)
        sq, sdo = fq[:, lo:hi].contiguous(), fdo[:, lo:hi].contiguous()
        sk, sv = fk[:, :hi].contiguous(), fv[:, :hi].contiguous()
        out, lse = fp.flash_attention_lse(sq, sk, sv, q_offset=lo, **mask)
        dq, dk, dv = fp.flash_attention_backward(sq, sk, sv, out, sdo, lse, q_offset=lo, **mask)
        np.testing.assert_allclose(out.numpy(), _fold(jout).numpy(), err_msg=f"out {r}",
                                   **ATTN_TOL)
        np.testing.assert_allclose(dq.numpy(), _fold(jdq).numpy(), err_msg=f"dq {r}", **ATTN_TOL)
        for name, got, want in (("dk", dk, jdk), ("dv", dv, jdv)):
            np.testing.assert_allclose(got.numpy(), _fold(want[:, :hi]).numpy(),
                                       err_msg=f"{name} {r}", **ATTN_TOL)
            assert not _fold(want[:, hi:]).any(), "keys past the shard get no gradient"
        # the Function through the model's layout, at the same offset
        tq = torch.from_numpy(q[:, lo:hi].copy()).requires_grad_()
        tk, tv = (torch.from_numpy(x[:, :hi].copy()).requires_grad_() for x in (k, v))
        y = train_attention(tq, tk, tv, q_offset=lo, **mask)
        y.backward(torch.from_numpy(do[:, lo:hi].copy()))
        np.testing.assert_allclose(y.detach().numpy(), jout, **ATTN_TOL)
        for name, got, want in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk[:, :hi]),
                                ("dv", tv.grad, jdv[:, :hi])):
            np.testing.assert_allclose(got.numpy(), want, err_msg=f"Fn {name} {r}", **ATTN_TOL)
        outs.append(out)
        lses.append(lse)
        dqs.append(dq)
        dk_sum[:, :hi] += dk
        dv_sum[:, :hi] += dv
    for name, got, want in (("out", torch.cat(outs, 1), whole_out),
                            ("lse", torch.cat(lses, 1), whole_lse),
                            ("dq", torch.cat(dqs, 1), whole[0]), ("dk", dk_sum, whole[1]),
                            ("dv", dv_sum, whole[2])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name, **ATTN_TOL)


def test_offset_needs_keys_through_the_last_position():
    q, k, v, do = _inputs()
    fq, fk, fv = (_fold(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="need keys through"):
        fp.flash_attention_lse(fq[:, 32:], fk[:, :40], fv[:, :40], q_offset=32)
    out, lse = fp.flash_attention_lse(fq[:, 32:], fk, fv, q_offset=32)
    with pytest.raises(ValueError, match="need keys through"):
        fp.flash_attention_backward(fq[:, 32:], fk[:, :40], fv[:, :40], out, out, lse,
                                    q_offset=32)
