"""Performance flags that change numbers on the port's path, with the
reference's names and defaults (`repro/flags.py`):

* ``group_sum_query`` — sum a GQA group's query features before the 3-bit
  quantization (one integer dot per kv head instead of G).
* ``bf16_collectives`` — run the relevance dequant chain with bf16 rounding
  pinned after every op (`core.quantization.dequant_score_chain`).

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
