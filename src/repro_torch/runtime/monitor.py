"""Step monitoring: straggler detection, NaN guards, heartbeats.

Port of the reference `runtime/monitor.py`. Slow hosts (failing memory,
thermal throttling, a flapping network) show up as step-time outliers long
before they fail outright. `StepMonitor` keeps an EWMA of step time and
flags steps slower than ``straggler_threshold ×`` the EWMA; repeated flags
raise the straggler alarm a launcher can act on. A heartbeat file, replaced
atomically after every step, lets an external watchdog detect hangs.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass, field

log = logging.getLogger("repro_torch.monitor")


@dataclass
class StepMonitor:
    ewma_alpha: float = 0.1
    straggler_threshold: float = 2.5     # × EWMA
    alarm_after: int = 3                 # consecutive flags
    heartbeat_path: str | None = None

    ewma: float | None = None
    slow_streak: int = 0
    total_steps: int = 0
    flagged_steps: int = 0
    history: list = field(default_factory=list)

    def record(self, step: int, seconds: float, loss: float | None = None) -> dict:
        self.total_steps += 1
        flagged = False
        if self.ewma is None:
            self.ewma = seconds
        else:
            if seconds > self.straggler_threshold * self.ewma:
                flagged = True
                self.flagged_steps += 1
                self.slow_streak += 1
                log.warning("straggler step %d: %.3fs vs EWMA %.3fs", step, seconds, self.ewma)
            else:
                self.slow_streak = 0
            self.ewma = (1 - self.ewma_alpha) * self.ewma + self.ewma_alpha * seconds
        alarm = self.slow_streak >= self.alarm_after
        rec = {"step": step, "seconds": seconds, "ewma": self.ewma, "flagged": flagged,
               "alarm": alarm, "loss": loss}
        self.history.append(rec)
        if self.heartbeat_path:
            tmp = self.heartbeat_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "time": time.time()}, f)
            os.replace(tmp, self.heartbeat_path)
        return rec


class NaNGuard:
    """Counts non-finite values; trips after ``patience`` in a row.

    Two front ends over one policy: ``check`` guards a scalar (a trainer's
    loss: trip → restore from a checkpoint), and ``check_slot`` guards a
    serving engine's per-slot logits rows (trip → quarantine that slot's
    request with ``stop_reason="error"`` while the tick's other slots keep
    decoding). Serving uses ``patience=1``: a non-finite logits row cannot
    give a token, so there is nothing to wait out."""

    def __init__(self, patience: int = 2):
        self.patience = patience
        self.streak = 0
        self.total = 0
        self.slot_streaks: dict[int, int] = {}

    def check(self, loss: float) -> bool:
        """True → the caller should restore from a checkpoint."""
        if not math.isfinite(loss):
            self.streak += 1
            self.total += 1
            log.error("non-finite loss (streak %d)", self.streak)
            return self.streak >= self.patience
        self.streak = 0
        return False

    def check_slot(self, slot: int, finite: bool) -> bool:
        """Record one per-slot observation; True → quarantine the slot."""
        if finite:
            self.slot_streaks.pop(slot, None)
            return False
        n = self.slot_streaks.get(slot, 0) + 1
        self.slot_streaks[slot] = n
        self.total += 1
        log.error("non-finite logits in slot %d (streak %d)", slot, n)
        return n >= self.patience

    def reset_slot(self, slot: int) -> None:
        """Forget a slot's streak (its occupant finished or was evicted)."""
        self.slot_streaks.pop(slot, None)
