"""Deterministic, seeded fault injection for the serving runtime.

Port of the reference `runtime/faults.py` (the port keeps its own copy: it
imports nothing of the reference package). A serving system meets failures
that a test battery never wrote down: a host-tier block transfer fails, a
prefill chunk's step fails, one slot's logits come back NaN, the allocator
briefly reports an empty pool. The engine's contract is that each of these
degrades one request — a retry, a stall, a cold-pinned block, one
quarantined slot — and never crashes, leaks blocks, or poisons another
request's output. A ``FaultPlan`` makes those failures a reproducible
input: a seeded schedule of named injection sites passed to
``ServingEngine(faults=...)``.

Injection sites (the engine consults the plan by site name):

- ``"spill_transfer"`` — a host<->device block move (demote or promote)
  fails before any bytes land. The engine retries with capped exponential
  backoff; exhausted promote retries pin the block cold (unmapped and
  unselectable: attention gets sparser, the request goes on), exhausted
  demote retries pin it hot.
- ``"prefill_chunk"`` — one prefill chunk step fails before it runs.
  Nothing was charged, so the next scheduler pass retries it exactly.
- ``"decode_logits"`` — one slot's logits row turns non-finite this tick.
  The per-slot quarantine ends that request with ``stop_reason="error"``;
  the tick's other slots are unaffected.
- ``"alloc_exhausted"`` — the block allocator reports an empty pool for
  one call. Admission waits, a chunk stalls, decode growth stalls the slot
  for one tick: the paths a dry pool takes.

Determinism: every spec draws from its own numpy Generator seeded by
``(plan.seed, spec index)`` and advances one draw per matching opportunity,
never by wall time, so two engines given equal plans (this package's and
the reference's included) see the same fault schedule. A plan is stateful
(it counts opportunities and fires): build one plan per engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# the closed set of valid injection-site names
SITES = ("spill_transfer", "prefill_chunk", "decode_logits", "alloc_exhausted")


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule: fire at ``site`` with probability ``p`` per
    matching opportunity, skipping the first ``after`` opportunities, at
    most ``max_fires`` times. ``rids`` / ``direction`` narrow the rule to
    some requests (sites that carry a ``rid``) or to one spill direction
    (``"demote"`` / ``"promote"``)."""
    site: str
    p: float = 1.0
    after: int = 0
    max_fires: int | None = None
    rids: tuple[int, ...] | None = None
    direction: str | None = None        # spill_transfer only

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; valid sites: {SITES}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {self.p}")
        if self.direction is not None and self.direction not in ("demote", "promote"):
            raise ValueError(f"direction must be 'demote' or 'promote', got {self.direction!r}")

    def matches(self, site: str, ctx: dict) -> bool:
        if site != self.site:
            return False
        if self.rids is not None and ctx.get("rid") not in self.rids:
            return False
        if self.direction is not None and ctx.get("direction") != self.direction:
            return False
        return True


@dataclass
class FaultPlan:
    """A seeded, stateful schedule over a tuple of `FaultSpec` rules.
    ``fires(site, **ctx)`` is the engine's one entry point at an injection
    site: True when any matching spec fires (every matching spec advances
    its own opportunity count and generator, so the rules' schedules stay
    independent of one another)."""
    seed: int = 0
    specs: tuple[FaultSpec, ...] = ()

    _rngs: list = field(default_factory=list, repr=False)
    _opportunities: list = field(default_factory=list, repr=False)
    _fires: list = field(default_factory=list, repr=False)
    #: chronological (site, ctx) log of every injected fault
    fired_log: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        self.specs = tuple(self.specs)
        self._rngs = [np.random.default_rng((int(self.seed), i)) for i in range(len(self.specs))]
        self._opportunities = [0] * len(self.specs)
        self._fires = [0] * len(self.specs)

    def fires(self, site: str, **ctx) -> bool:
        """Consult the plan at one opportunity; depends only on the seed
        and the sequence of matching calls."""
        hit = False
        for i, spec in enumerate(self.specs):
            if not spec.matches(site, ctx):
                continue
            k = self._opportunities[i]
            self._opportunities[i] += 1
            # draw even for skipped or saturated opportunities, so a rule's
            # draws stay aligned with its opportunity index
            draw = self._rngs[i].random()
            if k < spec.after:
                continue
            if spec.max_fires is not None and self._fires[i] >= spec.max_fires:
                continue
            if draw < spec.p:
                self._fires[i] += 1
                hit = True
        if hit:
            self.fired_log.append((site, dict(ctx)))
        return hit

    @property
    def total_fired(self) -> int:
        return len(self.fired_log)

    def counts(self) -> dict[str, int]:
        """Injected faults by site."""
        out: dict[str, int] = {}
        for site, _ in self.fired_log:
            out[site] = out.get(site, 0) + 1
        return out
