"""Fault tolerance and straggler mitigation for long runs: the port of the
JAX package's ``runtime/fault_tolerance.py`` (pure Python, copied).

* `StragglerMonitor` — per-step wall-time EWMA + robust deviation; flags
  steps slower than `threshold` x the EWMA (on real fleets this feeds the
  reschedule/evict decision; here it drives tests and the supervisor's
  telemetry).  This is the runtime-level analogue of the paper's timeout
  counter T_interval: a worker that waits too long stops waiting and acts.
* `Supervisor` — wraps the train loop: periodic checkpoints, automatic
  restore-from-latest-valid on failure (including NaN loss) and a bounded
  restart budget (checkpoints are logical, see checkpoint/).
* `SimulatedFault` — deterministic fault injector (host process loss, NaN
  step, slow step) used by integration tests to prove the recovery paths.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


class SimulatedFault(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.5
    warmup: int = 3
    _ewma: float = 0.0
    _n: int = 0
    flagged: int = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self._n += 1
        if self._n <= self.warmup:
            self._ewma = dt if self._ewma == 0 else \
                (1 - self.alpha) * self._ewma + self.alpha * dt
            return False
        slow = dt > self.threshold * self._ewma
        if slow:
            self.flagged += 1
        else:  # stragglers don't poison the baseline
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return slow

    @property
    def baseline(self) -> float:
        return self._ewma


@dataclasses.dataclass
class Supervisor:
    """Restart policy around a step function.

    run() drives `n_steps` of `step_fn(state, step_idx) -> (state, loss)`,
    checkpointing every `ckpt_every` via `save_fn(state, step)` and recovering
    from failures via `restore_fn() -> (state, step)`.
    """
    save_fn: Callable
    restore_fn: Callable
    ckpt_every: int = 50
    max_restarts: int = 3
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)
    restarts: int = 0
    recovered_from: Optional[int] = None

    def run(self, state, step_fn: Callable, n_steps: int, *, start_step=0,
            fault_at: Optional[dict] = None):
        """fault_at: {step: kind} with kind in {"crash", "nan", "slow"} —
        injected for tests."""
        step = start_step
        while step < n_steps:
            try:
                t0 = time.monotonic()
                kind = (fault_at or {}).get(step)
                if kind == "crash":
                    fault_at.pop(step)
                    raise SimulatedFault(f"node failure at step {step}")
                if kind == "slow":
                    fault_at.pop(step)
                    time.sleep(max(0.05, 4 * self.monitor.baseline))
                state, loss = step_fn(state, step)
                if kind == "nan":
                    fault_at.pop(step)
                    loss = float("nan")
                if not np.isfinite(loss):
                    raise SimulatedFault(f"non-finite loss at step {step}")
                self.monitor.record(time.monotonic() - t0)
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    self.save_fn(state, step)
            except SimulatedFault:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                restored, rstep = self.restore_fn()
                if restored is None:   # no checkpoint yet: restart from init
                    step = start_step
                else:
                    state, step = restored, rstep
                    self.recovered_from = rstep
        return state, step
