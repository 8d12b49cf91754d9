"""Straggler mitigation: deadline-based step monitoring + backup-step logic
(a copy of ``repro/distributed/straggler.py``: pure Python).

On a 1000-node job the slowest worker sets the step time (synchronous SPMD),
so the driver needs to (a) *detect* persistent stragglers and (b) *act*:
re-schedule the rank's work onto a spare and evict it at the next
checkpoint boundary.  There is no real cluster in this container, so the
mechanism is implemented against an injectable time source and exercised by
fault-injection tests (``tests/test_torch_train_driver.py``); the policy layer is
exactly what the real controller would run.

Policy (per step):
  * track an EWMA of step wall time;
  * a step slower than ``threshold x EWMA`` is a straggle event;
  * ``patience`` consecutive events on the same rank -> mitigation
    (evict + re-shard via ``distributed.elastic``, or spawn a backup step —
    the driver chooses; we log the decision).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    rank: int
    duration: float
    ewma: float


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, patience: int = 3,
                 alpha: float = 0.2, time_fn: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.time_fn = time_fn
        self.ewma: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self._consecutive: dict = {}
        self._t0: Optional[float] = None

    def step_begin(self):
        self._t0 = self.time_fn()

    def step_end(self, step: int, rank_durations: Optional[dict] = None):
        """rank_durations: per-rank wall times (multi-host); None = single
        measured duration attributed to rank 0."""
        total = self.time_fn() - self._t0
        durations = rank_durations or {0: total}
        slowest = max(durations.values())
        if self.ewma is None:
            self.ewma = slowest
        flagged = []
        for rank, dur in durations.items():
            if dur > self.threshold * self.ewma:
                self._consecutive[rank] = self._consecutive.get(rank, 0) + 1
                self.events.append(StragglerEvent(step, rank, dur, self.ewma))
                if self._consecutive[rank] >= self.patience:
                    flagged.append(rank)
            else:
                self._consecutive[rank] = 0
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * slowest
        return flagged

    def reset_rank(self, rank: int):
        self._consecutive[rank] = 0
