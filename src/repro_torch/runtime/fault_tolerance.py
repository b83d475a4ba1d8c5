"""Deterministic fault injection for the serving engine (port of
``repro.runtime.fault_tolerance.FaultInjector``).

The training runner and the straggler detector of the reference module
belong to the training slice and are not here."""

from __future__ import annotations

import numpy as np


class FaultInjector:
    """Deterministic fault schedule for tests and soak runs.

    Three fault classes, each fired at most once per scheduled occurrence:

    * ``fail_at`` — raise mid-step; the serving engine rolls back to its
      pre-step snapshot and replays the step
      (``SchedulerStats.faults_recovered``);
    * ``exhaust_pool_at`` — the engine's admission sees zero pool headroom
      at these steps (a transient allocation failure: admission backs off
      and retries next step);
    * ``corrupt_swap`` — the n-th ``swap/*`` transfer (0-indexed ordinal
      over swap-outs and swap-ins) is corrupted in flight on its first
      attempt; the end-to-end parity word catches it and the transfer is
      retried once (``SchedulerStats.bursts_retried``).
    """

    @classmethod
    def seeded(cls, seed: int, horizon: int, p_fail: float = 0.01,
               p_exhaust: float = 0.02, n_corrupt: int = 1
               ) -> "FaultInjector":
        """A schedule drawn from one seed: each step in ``[1, horizon)``
        independently fails mid-step with ``p_fail`` and sees an exhausted
        pool with ``p_exhaust``; the first ``n_corrupt`` swap transfers are
        corrupted.  The draws are the reference's (``numpy``'s
        ``default_rng(seed)``), so a seed gives the reference's schedule.
        Step 0 is excluded: nothing is live yet."""
        rng = np.random.default_rng(seed)
        draws = rng.random((max(horizon, 1), 2))
        fail = tuple(s for s in range(1, horizon) if draws[s, 0] < p_fail)
        exhaust = tuple(s for s in range(1, horizon)
                        if draws[s, 1] < p_exhaust)
        return cls(fail_at=fail, exhaust_pool_at=exhaust,
                   corrupt_swap=tuple(range(n_corrupt)))

    def __init__(self, fail_at: tuple = (), exhaust_pool_at: tuple = (),
                 corrupt_swap: tuple = ()):
        self.fail_at = set(fail_at)
        self.fired = set()
        self.exhaust_pool_at = set(exhaust_pool_at)
        self.exhaust_fired = set()
        self.corrupt_swap_at = set(corrupt_swap)
        self._swap_ordinal = 0
        self.corrupted = 0

    def check(self, step: int) -> None:
        """The mid-step failure seam: raises once at each ``fail_at`` step."""
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")

    def pool_exhausted(self, step: int) -> bool:
        """Whether admission at ``step`` should see an exhausted pool."""
        if step in self.exhaust_pool_at and step not in self.exhaust_fired:
            self.exhaust_fired.add(step)
            return True
        return False

    def corrupt_swap_burst(self, attempt: int) -> bool:
        """Consulted once per swap-transfer attempt.  The transfer ordinal
        advances on the first attempt only, so a retry of a corrupted
        transfer sees a clean channel."""
        if attempt:
            return False
        k = self._swap_ordinal
        self._swap_ordinal += 1
        if k in self.corrupt_swap_at:
            self.corrupted += 1
            return True
        return False
