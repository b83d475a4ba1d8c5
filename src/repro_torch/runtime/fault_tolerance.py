"""Fault tolerance (port of ``repro.runtime.fault_tolerance``):
restart-on-failure training, straggler detection and deterministic fault
injection.

The :class:`TrainingRunner` wraps the training loop so that a step failure
(``RuntimeError`` or ``OSError``: device loss, an injected fault) restores
the latest checkpoint and continues from its step; the data pipeline is a
pure function of the step (``batch_at``), so recovery is exact.  The port's
train state changes in place, so the restore copies the checkpoint into
every live tensor of the state: nothing the failed step wrote survives.
The :class:`StragglerDetector` flags steps slower than ``threshold`` times
the EMA, and counts them.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class StragglerDetector:
    threshold: float = 2.0
    decay: float = 0.9
    ema: Optional[float] = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.threshold * self.ema
        if is_straggler:
            self.flagged += 1
            log.warning("straggler step: %.3fs vs EMA %.3fs", dt, self.ema)
        else:
            # stragglers do not poison the EMA
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return is_straggler


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


class TrainingRunner:
    """Checkpoint/restart training driver.

    ``step_fn(state, batch) -> (state, metrics)``; ``state`` is any tree
    the checkpoint module takes (a dict of the parameters and the
    :class:`repro_torch.optim.OptState`).  On failure the runner restores
    the latest checkpoint into ``state``'s tensors and replays from its
    step; with no checkpoint yet it restarts from ``start_step`` with the
    state as it is."""

    def __init__(self, step_fn: Callable, data, ckpt: CheckpointManager,
                 straggler: Optional[StragglerDetector] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 max_restarts: int = 10):
        self.step_fn = step_fn
        self.data = data
        self.ckpt = ckpt
        self.straggler = straggler or StragglerDetector()
        self.fault_injector = fault_injector
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state, start_step: int, num_steps: int,
            on_metrics: Optional[Callable] = None):
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                while step < end:
                    if self.fault_injector is not None:
                        self.fault_injector.check(step)
                    t0 = time.monotonic()
                    batch = self.data.batch_at(step)
                    state, metrics = self.step_fn(state, batch)
                    self.straggler.observe(time.monotonic() - t0)
                    step += 1
                    self.ckpt.maybe_save(step, state, {"data_step": step})
                    if on_metrics is not None:
                        on_metrics(step, metrics)
            except (RuntimeError, OSError) as e:      # node failure class
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring latest "
                            "checkpoint", step, e)
                last = latest_step(self.ckpt.directory)
                if last is None:
                    step = start_step
                    continue
                state, extra = restore_checkpoint(self.ckpt.directory, last,
                                                  state)
                step = extra.get("data_step", last)
        return state, step
