"""Fault-tolerance runtime: step heartbeats, EWMA straggler detection,
failure injection for tests, and the restart policy driver.

Counterpart of ``repro.runtime.fault``, the same pure-Python code: the
monitor watches wall-clock per step and the injector raises at a chosen
step, which the serving control plane (``serving/control_plane.py``)
turns into re-queue + replay and a training driver into a restore from
its latest state.

Under SPMD (``launch.train.train`` on a mesh) every rank runs its own
injector and restart loop: a failure keyed by the step fires on every rank at
the same step, before the step's first collective, and every rank
restores.  The restore joins the first rank's checkpoint writer and meets
every rank at a barrier before any reads ``latest`` (JAX's launcher reads
it at once, racing an async write: ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class NodeFailure(RuntimeError):
    """Raised (or injected) when a worker is lost mid-step."""


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than mean + k * stddev."""

    alpha: float = 0.2
    k: float = 3.0
    warmup: int = 5
    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._mean = dt if self._n == 1 else (
                self._mean + (dt - self._mean) / self._n)
            return False
        dev = dt - self._mean
        # floor the stddev at 5% of the mean: sub-noise jitter never flags
        std = max(self._var ** 0.5, 0.05 * abs(self._mean), 1e-9)
        flagged = dev > self.k * std
        self._mean += self.alpha * dev
        self._var = (1 - self.alpha) * (self._var + self.alpha * dev * dev)
        if flagged:
            self.events.append((step, dt, self._mean))
        return flagged


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure injection for integration tests."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class Heartbeat:
    """Wall-clock watchdog: a step exceeding ``timeout`` marks the worker
    dead (at scale this triggers the coordinator's restart path)."""

    timeout: float = 600.0
    last: float = dataclasses.field(default_factory=time.monotonic)

    def beat(self):
        now = time.monotonic()
        dt = now - self.last
        self.last = now
        return dt

    def expired(self) -> bool:
        return (time.monotonic() - self.last) > self.timeout


def run_with_restarts(train_loop: Callable[[int], int], *,
                      max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, Exception], None]] = None,
                      restore: Optional[Callable[[], int]] = None,
                      initial_step: int = 0) -> int:
    """Drive ``train_loop(start_step) -> final_step`` with restart-on-failure.

    The first attempt enters at ``initial_step``.  After a ``NodeFailure``
    (and ``on_restart``), the driver calls ``restore()`` and re-enters
    ``train_loop`` at the step it returns — e.g. the latest checkpoint's
    step; the callback may also restore state it closes over.  Without a
    ``restore`` callback, restarts re-enter at ``initial_step`` — only
    correct for loops that rebuild all state from the start step.
    """
    restarts = 0
    start = initial_step
    while True:
        try:
            return train_loop(start)
        except NodeFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            start = restore() if restore is not None else initial_step
