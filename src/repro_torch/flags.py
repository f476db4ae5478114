"""Performance flags that change numbers on the port's path, with the
reference's names and defaults (`repro/flags.py`):

* ``group_sum_query`` — sum a GQA group's query features before the 3-bit
  quantization (one integer dot per kv head instead of G).
* ``bf16_collectives`` — run the relevance dequant chain with bf16 rounding
  pinned after every op (`core.quantization.dequant_score_chain`).
* ``ring_local_cache`` — a sliding-window ("L") layer keeps a ring of
  ``local_window`` rows instead of the full-context cache
  (`models.blocks.ring_size`); off, it keeps the full context and its
  decode masks to the trailing window.
* ``paged_fused_decode`` — the unsharded paged tick walks the page table
  inside its kernels (B1, B2); off, it runs the reference's unfused
  baseline: the feature stream gathered into logical order, the selected
  rows gathered one by one (`core.attention.salca_decode_attention_paged`).
* ``sharded_fused_decode`` — the block-sharded tick runs the fused island
  (B4, B5, B6); off, the reference's logical-gather island
  (`core.sp_decode.sp_salca_decode_paged`). Both baselines select the same
  tokens as the fused paths, bit for bit.
* ``moe_flat_dispatch`` — MoE routing flattens (B, T) into one token axis
  for decode-like shapes (B > 1, T <= 16) and sizes the expert capacity
  from the global token count, 4-aligned (`models.moe`).
* ``moe_gather_dispatch`` — MoE dispatch and combine by index gathers;
  off, by the one-hot einsums.

The reference's other flags steer paths the port does not have yet; they
join with those paths, and setting an unknown flag raises.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields


@dataclass
class PerfFlags:
    bf16_collectives: bool = True
    group_sum_query: bool = True
    ring_local_cache: bool = True
    paged_fused_decode: bool = True
    sharded_fused_decode: bool = True
    moe_flat_dispatch: bool = True
    moe_gather_dispatch: bool = True


PERF = PerfFlags()


def set_flags(**kw) -> None:
    names = {f.name for f in fields(PerfFlags)}
    for k, v in kw.items():
        if k not in names:
            raise AttributeError(f"unknown perf flag {k!r}")
        setattr(PERF, k, v)


@contextlib.contextmanager
def perf_flags(**kw):
    old = {k: getattr(PERF, k) for k in kw}
    try:
        set_flags(**kw)
        yield PERF
    finally:
        set_flags(**old)
