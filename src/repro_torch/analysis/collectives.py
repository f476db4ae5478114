"""Collective traffic of the port's sharded ticks, counted where it is issued.

Counterpart of the reference `analysis/hlo.py`, which parses the
collectives of a compiled XLA module. The port has no compiled module: its
collectives are the calls `distributed.sharding` makes (`all_reduce` for
pmin / pmax / psum, `all_gather_into_tensor` for the halo), and each one is
recorded here as it is issued (`record`), with its result bytes and an
*effective wire-bytes* estimate per rank from the reference's ring factors
over the group size g:

    all-reduce      2·(g−1)/g · bytes     (reduce-scatter + all-gather)
    all-gather      (g−1)/g · out_bytes
    reduce-scatter  (g−1)/g · in_bytes ≈ g·out · (g−1)/g
    all-to-all      (g−1)/g · bytes
    collective-permute  1 · bytes

A group of one moves nothing and is not recorded, as the reference skips a
single-participant group. `TRACE` is the process-wide record; `reset()`
empties it and `summary()` has the reference's keys.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

_WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),   # in_bytes = g × out_bytes
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


@dataclass
class CollectiveStats:
    count: int = 0
    result_bytes: int = 0
    wire_bytes: float = 0.0


@dataclass
class Collectives:
    per_op: dict = field(default_factory=lambda: defaultdict(CollectiveStats))

    def record(self, op: str, result_bytes: int, group_size: int) -> None:
        """One collective of kind ``op`` whose result holds ``result_bytes``
        bytes, over a group of ``group_size`` ranks."""
        if op != "collective-permute" and group_size <= 1:
            return
        g = 2 if op == "collective-permute" else group_size
        st = self.per_op[op]
        st.count += 1
        st.result_bytes += int(result_bytes)
        st.wire_bytes += _WIRE_FACTOR[op](g) * result_bytes

    def reset(self) -> None:
        self.per_op.clear()

    @property
    def total_wire_bytes(self) -> float:
        return sum(s.wire_bytes for s in self.per_op.values())

    @property
    def total_count(self) -> int:
        return sum(s.count for s in self.per_op.values())

    def summary(self) -> dict:
        return {op: {"count": s.count, "result_bytes": s.result_bytes,
                     "wire_bytes": round(s.wire_bytes)}
                for op, s in sorted(self.per_op.items())}


TRACE = Collectives()
