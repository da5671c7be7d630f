"""Fault tolerance: failure injection, restart orchestration, straggler
detection.

On a real multi-pod deployment node failure surfaces as a collective
timeout/ICI error; the coordinator restarts the job (possibly with a
different device count) and training resumes from the newest checkpoint.
This module provides the single-process-testable core of that loop:

  * FailureInjector — deterministic or probabilistic simulated faults
  * run_with_restarts — the supervisor: catches faults, re-invokes the
    (checkpoint-restoring) training function, bounds restart count
  * Watchdog — heartbeat-based straggler/stall detector; in production the
    callback escalates to the coordinator, here it records events

A copy of the JAX package's ``runtime/fault.py`` (plain Python, no JAX),
apart from the random injector's seed (see ``maybe_fail``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


class SimulatedFailure(RuntimeError):
    """Stand-in for a node crash / ICI timeout."""


@dataclass
class FailureInjector:
    fail_at_steps: Sequence[int] = ()
    probability: float = 0.0
    seed: int = 0
    fired: List[int] = field(default_factory=list)

    def maybe_fail(self, step: int):
        import random
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.append(step)
            raise SimulatedFailure(f"injected failure at step {step}")
        if self.probability > 0:
            # a str seed: the reference's tuple seed raises TypeError on
            # Python >= 3.11, where random.Random takes no tuples
            rng = random.Random(f"{self.seed}:{step}")
            if rng.random() < self.probability:
                self.fired.append(step)
                raise SimulatedFailure(f"random failure at step {step}")


def run_with_restarts(run_fn: Callable[[int], "object"],
                      max_restarts: int = 3):
    """``run_fn(restart_idx)`` must restore from the latest checkpoint and
    continue. Returns (result, n_restarts)."""
    restarts = 0
    while True:
        try:
            return run_fn(restarts), restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise


class Watchdog:
    """Detects stalled/straggling steps via heartbeats.

    The training loop calls ``beat(step)``; if no heartbeat lands within
    ``timeout`` seconds the callback fires (production: pre-empt the
    straggler / re-dispatch its shard; here: recorded for tests)."""

    def __init__(self, timeout: float = 5.0,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll: float = 0.05):
        self.timeout = timeout
        self.poll = poll
        self.on_stall = on_stall
        self.stalls: List[float] = []
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self, step: int = -1):
        self._last = time.monotonic()

    def _run(self):
        while not self._stop.wait(self.poll):
            silent = time.monotonic() - self._last
            if silent > self.timeout:
                self.stalls.append(silent)
                if self.on_stall:
                    self.on_stall(silent)
                self._last = time.monotonic()  # rate-limit

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
