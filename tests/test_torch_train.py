"""Port parity, training: the differentiable attention and every family's
loss and gradient against the JAX package on the CPU, at float32 compute.

* (a) B3's gradient: `flash_attention_backward_plain` (the explicit formula
  from the forward's log-sum-exp) and `FlashAttentionFn`'s CPU backward
  (through `models.attention.train_attention`) against ``jax.vjp`` of the
  reference's `flash_attention_xla`: causal, windowed, unmasked, GQA G 2
  and Tq != S, within `ATTN_TOL`.
* (b) `ModelAPI.loss` (`lm_loss` / `encdec_loss`) and the gradient of every
  parameter against ``jax.value_and_grad`` of the reference's loss, on the
  reduced configs of the seven families at T 64 and batch 2 (the
  reference's `make_batch`), through `params_from_numpy`: the loss within
  `LOSS_TOL`, each gradient leaf within `GRAD_RTOL` of that leaf's largest
  magnitude (`_torch_bridge.check_loss_and_gradients`). gemma3's and
  recurrentgemma's windows are cut to 24 so that the window binds at T 64.
  qwen3-0.6b, gemma3-12b, granite-moe-3b-a800m, whisper-small and
  llava-next-mistral-7b here; mamba2-2.7b and recurrentgemma-2b in
  tests/test_torch_train_loop.py (the two files split the time).

Run alone: ~40 s on this container's CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import check_loss_and_gradients
from repro.models import attention as jattention
from repro_torch.kernels.flash_prefill import ops as fp
from repro_torch.models.attention import fold_heads, train_attention

# f32 on both sides; the gradients are sums of the same terms in other orders
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)


def attn_tol(hd: int) -> dict:
    """ATTN_TOL at HD 32; above it the absolute part grows as sqrt(HD / 32):
    where D = rowsum(dO∘O) and dP = dO·V cancel (a row that sees one key has
    dS = 0 exactly), their two f32 sums of HD products part by that much."""
    return dict(ATTN_TOL, atol=ATTN_TOL["atol"] * (hd / 32) ** 0.5)


# --------------------------------------------------------------------------
# (a) the attention gradient
# --------------------------------------------------------------------------

ATTN_CASES = {
    "causal": dict(h=2, kv=2, t=64, s=64, causal=True, window=0),
    "causal_gqa": dict(h=4, kv=2, t=64, s=64, causal=True, window=0),
    "window_gqa": dict(h=4, kv=2, t=64, s=64, causal=True, window=16),
    "unmasked_gqa": dict(h=4, kv=2, t=64, s=64, causal=False, window=0),
    "cross": dict(h=4, kv=2, t=24, s=40, causal=False, window=0),
    # the card test's edge shapes for B3-bwd's wgmma tiles (HD 128, T 129:
    # one row past two 64-row query tiles and one 128-key tile)
    "causal_hd128_t129": dict(h=4, kv=2, t=129, s=129, causal=True, window=0, hd=128),
    "window_hd128_t129": dict(h=4, kv=2, t=129, s=129, causal=True, window=65, hd=128),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_backward_matches_jax_vjp(case):
    c = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    b, hd = 2, c.get("hd", 32)
    q = rng.standard_normal((b, c["t"], c["h"], hd), np.float32)
    k = rng.standard_normal((b, c["s"], c["kv"], hd), np.float32)
    v = rng.standard_normal((b, c["s"], c["kv"], hd), np.float32)
    do = rng.standard_normal((b, c["t"], c["h"], hd), np.float32)
    mask = dict(causal=c["causal"], window=c["window"])
    tol = attn_tol(hd)

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_):
        out_, vjp = jax.vjp(lambda *x: jattention.flash_attention_xla(*x, **mask), q_, k_, v_)
        return out_, vjp(do_)
    jout, (jdq, jdk, jdv) = fwd_bwd(*(jnp.asarray(x) for x in (q, k, v, do)))
    jdq, jdk, jdv = (np.asarray(g) for g in (jdq, jdk, jdv))

    # the Function's CPU backward, through the model's layout
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = train_attention(tq, tk, tv, **mask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    out.backward(torch.from_numpy(do))
    for name, got, want in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk), ("dv", tv.grad, jdv)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **tol)

    # the plain backward called directly, from the plain forward's LSE
    fq, fk, fv, fdo = (fold_heads(torch.from_numpy(x)) for x in (q, k, v, do))
    fout, lse = fp.flash_attention_lse_plain(fq, fk, fv, **mask)
    dq, dk, dv = fp.flash_attention_backward_plain(fq, fk, fv, fout, fdo, lse, **mask)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), fold_heads(torch.from_numpy(want.copy())).numpy(),
                                   err_msg=name, **tol)


def test_lse_is_the_rows_logsumexp_and_forward_unchanged():
    """`flash_attention_lse_plain`'s output is `flash_attention_plain`'s bit
    for bit, and its LSE the rows' logsumexp of the masked scaled scores."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((n, 48, 32), generator=g) for n in (4, 2, 2))
    out, lse = fp.flash_attention_lse_plain(q, k, v, window=20)
    assert torch.equal(out, fp.flash_attention_plain(q, k, v, window=20))
    s = torch.einsum("btd,bsd->bts", q, k.repeat_interleave(2, 0)) / 32 ** 0.5
    i = torch.arange(48)
    keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 20)
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# (b) every family's loss and gradient (the other two families:
# tests/test_torch_train_loop.py, which splits the time)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b", "granite-moe-3b-a800m",
                                  "whisper-small", "llava-next-mistral-7b"])
def test_loss_and_gradients_match_reference(arch):
    check_loss_and_gradients(arch)
