"""Supervised execution: restart-from-checkpoint on failure.

The JAX package's ``ft/supervisor.py`` on the port's checkpoint manager;
the restored state lands on ``device`` (host numpy leaves when None) where
the reference re-shards it.

``Supervisor.run(body)`` calls ``body(start_step, restored_state_or_None)``
and, on an exception or simulated node failure, restores the latest
checkpoint and re-invokes it — up to ``max_restarts``.  ``body`` returns the
final state when training completes.  This is the single-controller analog
of a multi-pod job manager: crash → restore → continue, never lose more
than one checkpoint interval.

Restart pacing: failures back off exponentially — the k-th restart of a
burst sleeps ``backoff_s · 2^(k-1)`` capped at ``backoff_max_s``, plus a
deterministic jitter drawn from a seeded RNG (``backoff_jitter`` fraction
of the delay; two supervisors with different seeds never thundering-herd
the same storage).  A body that ran *healthy* for at least
``healthy_reset_s`` seconds before failing resets the burst: the restart
budget exists to stop crash loops, not to kill a job whose faults are
days apart.
"""
from __future__ import annotations

import logging
import random
import time
from typing import Any, Callable

from ..ckpt.manager import CheckpointManager

log = logging.getLogger(__name__)


class RestartBudgetExceeded(RuntimeError):
    pass


class Supervisor:
    def __init__(
        self,
        ckpt: CheckpointManager,
        state_template: Any,
        max_restarts: int = 3,
        backoff_s: float = 0.0,
        device=None,
        *,
        backoff_max_s: float = 60.0,
        backoff_jitter: float = 0.1,
        healthy_reset_s: float | None = None,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.ckpt = ckpt
        self.template = state_template
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.healthy_reset_s = healthy_reset_s
        self.device = device
        self.restarts = 0
        self.failures: list[str] = []
        self.budget_resets = 0
        self.last_backoff_s = 0.0
        self._burst = 0                     # consecutive unhealthy failures
        self._rng = random.Random(seed)
        self._clock = clock
        self._sleep = sleep

    def _backoff_delay(self) -> float:
        """Capped exponential backoff with deterministic (seeded) jitter
        for the current burst position; 0 when backoff is disabled."""
        if not self.backoff_s:
            return 0.0
        delay = min(self.backoff_s * (2.0 ** (self._burst - 1)),
                    self.backoff_max_s)
        return delay * (1.0 + self.backoff_jitter * self._rng.random())

    def run(self, body: Callable[[int, Any | None], Any]) -> Any:
        while True:
            step = self.ckpt.latest_step()
            state = None
            if step is not None:
                state = self.ckpt.restore(
                    self.template, step, device=self.device
                )
            start = 0 if step is None else step + 1
            t_start = self._clock()
            try:
                return body(start, state)
            except (RestartBudgetExceeded, KeyboardInterrupt):
                raise
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                ran_healthy = (
                    self.healthy_reset_s is not None
                    and self._clock() - t_start >= self.healthy_reset_s
                )
                if ran_healthy and self._burst:
                    # A long healthy run forgives the earlier burst: the
                    # budget guards against crash *loops*, and this was
                    # not one.  The backoff curve restarts from its base.
                    self.restarts = 0
                    self._burst = 0
                    self.budget_resets += 1
                self.restarts += 1
                self._burst += 1
                self.failures.append(f"{type(e).__name__}: {e}")
                log.warning("supervised body failed (%s); restart %d/%d",
                            e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise RestartBudgetExceeded(
                        f"{self.restarts - 1} restarts exhausted; last: {e}"
                    ) from e
                self.last_backoff_s = self._backoff_delay()
                if self.last_backoff_s > 0:
                    self._sleep(self.last_backoff_s)
