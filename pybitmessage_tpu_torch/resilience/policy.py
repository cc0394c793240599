"""The circuit breaker (copy of ``pybitmessage_tpu.resilience.policy``
``CircuitBreaker``, without its registry, metrics and flight-recorder
trail).

``threshold`` consecutive failures open it, a ``cooldown`` later
exactly ONE probe is let through (half-open); the probe's outcome
closes or re-opens it.  Thread-safe.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"


class CircuitBreaker:
    """Closed / open / half-open circuit breaker.

    - CLOSED: calls flow; ``threshold`` CONSECUTIVE failures open it.
    - OPEN: :meth:`allow` refuses everything until ``cooldown`` elapses.
    - HALF-OPEN: exactly one probe call is admitted; its success closes
      the breaker, its failure re-opens it for another full cooldown.
    """

    def __init__(self, name: str, *, threshold: int = 3,
                 cooldown: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.name = name
        self.threshold = threshold
        self.cooldown = cooldown
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.cooldown:
            self._state = HALF_OPEN
            self._probe_in_flight = False

    def allow(self) -> bool:
        """True when a call may proceed.  In half-open state only the
        first caller gets True (the probe) until its outcome lands."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            now = self.clock()
            if self._state == HALF_OPEN:
                # failed probe: back to a full cooldown
                self._opened_at = now
                self._probe_in_flight = False
                self._state = OPEN
                return
            self._failures += 1
            if self._failures >= self.threshold and self._state == CLOSED:
                self._opened_at = now
                self._state = OPEN
