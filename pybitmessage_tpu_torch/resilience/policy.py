"""Resilience primitives (copy of ``pybitmessage_tpu.resilience.policy``:
``Deadline``, ``RetryPolicy`` and ``CircuitBreaker`` with their registry
``BREAKERS``, metrics and flight-recorder trail, without
``Deadline.check`` / ``DeadlineExceeded``, which nothing raises).

- :class:`RetryPolicy` — exponential backoff with bounded jitter;
  deterministic when constructed with a seeded ``random.Random``;
- :class:`Deadline` — a monotonic-clock budget that propagates through
  ``contextvars`` (API request handling sets one; nested retries stop
  scheduling attempts that could not finish in time);
- :class:`CircuitBreaker` — ``threshold`` consecutive failures open
  it, a ``cooldown`` later exactly ONE probe is let through
  (half-open); the probe's outcome closes or re-opens it.  Thread-safe.

``resilience_errors_total{site}`` counts the handled errors the port's
loops swallow (the JAX package's sites of the ported modules).
"""

from __future__ import annotations

import contextvars
import logging
import random
import threading
import time
from typing import Callable

from ..observability import REGISTRY
from ..observability.flightrec import record as _flight

logger = logging.getLogger("pybitmessage_tpu_torch.resilience")

RETRIES = REGISTRY.counter(
    "resilience_retry_total",
    "Retry-policy attempt outcomes by call site",
    ("site", "outcome"))
ERRORS = REGISTRY.counter(
    "resilience_errors_total",
    "Handled (non-fatal) errors by site — every swallowed exception in "
    "pow/ and network/ counts here instead of vanishing",
    ("site",))
BREAKER_STATE = REGISTRY.gauge(
    "resilience_breaker_state",
    "Circuit breaker state: 0 closed, 1 half-open, 2 open",
    ("breaker",))
BREAKER_TRANSITIONS = REGISTRY.counter(
    "resilience_breaker_transitions_total",
    "Circuit breaker state transitions", ("breaker", "to"))
BREAKER_SHORT_CIRCUITS = REGISTRY.counter(
    "resilience_breaker_short_circuit_total",
    "Calls refused outright because the breaker was open", ("breaker",))
BREAKER_RECOVERY_SECONDS = REGISTRY.histogram(
    "resilience_breaker_recovery_seconds",
    "Time from a breaker opening to the half-open probe closing it "
    "again — the outage length the ladder actually experienced",
    ("breaker",))

#: registered breakers by name (the clientStatus snapshot and the
#: health block's open-breaker list)
BREAKERS: dict[str, "CircuitBreaker"] = {}


_DEADLINE: contextvars.ContextVar["Deadline | None"] = \
    contextvars.ContextVar("bmtpu_torch_deadline", default=None)


def current_deadline() -> "Deadline | None":
    """The innermost :class:`Deadline` active in this context."""
    return _DEADLINE.get()


class Deadline:
    """A propagating time budget on the monotonic clock.

    ``with Deadline(5.0): ...`` publishes itself through a contextvar;
    nested code calls :func:`current_deadline` and refuses to start
    work that cannot finish.  Nesting keeps the TIGHTER deadline.
    """

    __slots__ = ("expires_at", "_token")

    def __init__(self, seconds: float, *,
                 clock: Callable[[], float] = time.monotonic):
        self.expires_at = clock() + seconds
        self._token = None

    def remaining(self, *, clock: Callable[[], float] = time.monotonic
                  ) -> float:
        return self.expires_at - clock()

    @property
    def expired(self) -> bool:
        """The budget is gone (the reconciler's round and catch-up
        timeouts read this)."""
        return self.remaining() <= 0

    def __enter__(self) -> "Deadline":
        outer = _DEADLINE.get()
        if outer is not None and outer.expires_at < self.expires_at:
            self.expires_at = outer.expires_at
        self._token = _DEADLINE.set(self)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _DEADLINE.reset(self._token)
            self._token = None


class RetryPolicy:
    """Exponential backoff with bounded jitter.

    ``delay(attempt)`` for attempt 0, 1, 2… is
    ``base * multiplier**attempt`` clamped to ``max_delay``, scaled by
    a jitter factor uniform in ``[1-jitter, 1+jitter]``.

    :meth:`call` runs a function under the policy: up to ``attempts``
    tries, sleeping between failures, honoring an explicit or
    context-propagated :class:`Deadline`.
    """

    def __init__(self, *, attempts: int = 3, base_delay: float = 0.1,
                 max_delay: float = 30.0, multiplier: float = 2.0,
                 jitter: float = 0.5,
                 rng: random.Random | None = None):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = min(max(jitter, 0.0), 1.0)
        self._rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        raw = min(self.base_delay * self.multiplier ** attempt,
                  self.max_delay)
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(raw, 0.0)

    def _pre_sleep(self, site: str, attempt: int,
                   deadline: Deadline | None, exc: BaseException) -> float:
        """The sleep before the next attempt; raises the original error
        when the policy (or the deadline) is out of budget."""
        if attempt + 1 >= self.attempts:
            RETRIES.labels(site=site, outcome="gave_up").inc()
            raise exc
        pause = self.delay(attempt)
        if deadline is not None and deadline.remaining() < pause:
            RETRIES.labels(site=site, outcome="deadline").inc()
            raise exc
        RETRIES.labels(site=site, outcome="retried").inc()
        logger.debug("%s failed (attempt %d/%d), retrying in %.2fs: %r",
                     site, attempt + 1, self.attempts, pause, exc)
        return pause

    def call(self, fn: Callable, *, site: str,
             retry_on: tuple = (Exception,),
             deadline: Deadline | None = None,
             sleep: Callable[[float], None] = time.sleep):
        """Run ``fn()`` with retries; returns its value or raises the
        last error once attempts (or the deadline) are exhausted."""
        deadline = deadline or current_deadline()
        for attempt in range(self.attempts):
            try:
                return fn()
            except retry_on as exc:
                sleep(self._pre_sleep(site, attempt, deadline, exc))


CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Closed / open / half-open circuit breaker.

    - CLOSED: calls flow; ``threshold`` CONSECUTIVE failures open it.
    - OPEN: :meth:`allow` refuses everything until ``cooldown`` elapses.
    - HALF-OPEN: exactly one probe call is admitted; its success closes
      the breaker (recovery latency is recorded), its failure re-opens
      it for another full cooldown.

    ``label`` names the metric series; breakers sharing a label (the
    per-peer dial breakers, by hashed peer bucket) share its transition
    and short-circuit counters.  Only registered breakers
    (``register=True``, published in :data:`BREAKERS`) write the state
    gauge, which they own 1:1.
    """

    def __init__(self, name: str, *, threshold: int = 3,
                 cooldown: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 label: str | None = None, register: bool = True):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.name = name
        self.label = label or name
        self.threshold = threshold
        self.cooldown = cooldown
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._first_opened_at: float | None = None
        self._probe_in_flight = False
        self._registered = register
        if register:
            BREAKERS[name] = self
            BREAKER_STATE.labels(breaker=self.label).set(0)

    def _transition(self, to: str) -> None:
        # caller holds the lock
        if to == self._state:
            return
        frm = self._state
        self._state = to
        if self._registered:
            BREAKER_STATE.labels(breaker=self.label).set(_STATE_VALUE[to])
        BREAKER_TRANSITIONS.labels(breaker=self.label, to=to).inc()
        # breaker flips are what a post-mortem wants in the ring
        _flight("breaker", name=self.name, frm=frm, to=to)
        logger.info("breaker %s -> %s", self.name, to)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.cooldown:
            self._transition(HALF_OPEN)
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
            BREAKER_SHORT_CIRCUITS.labels(breaker=self.label).inc()
            return False

    def available(self) -> bool:
        """Like :meth:`allow` without consuming the half-open probe
        slot: a read-only health check."""
        with self._lock:
            self._maybe_half_open()
            return self._state != OPEN

    def record_success(self) -> None:
        with self._lock:
            if self._state in (HALF_OPEN, OPEN):
                if self._first_opened_at is not None:
                    BREAKER_RECOVERY_SECONDS.labels(
                        breaker=self.label).observe(
                        self.clock() - self._first_opened_at)
                    self._first_opened_at = None
                self._transition(CLOSED)
            self._failures = 0
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            now = self.clock()
            if self._state == HALF_OPEN:
                # failed probe: back to a full cooldown
                self._opened_at = now
                self._probe_in_flight = False
                self._transition(OPEN)
                return
            self._failures += 1
            if self._failures >= self.threshold and self._state == CLOSED:
                self._opened_at = now
                if self._first_opened_at is None:
                    self._first_opened_at = now
                self._transition(OPEN)

    def release_probe(self) -> None:
        """Give back a consumed half-open probe slot without recording
        an outcome: an interrupted attempt (shutdown) is not evidence
        of health."""
        with self._lock:
            self._probe_in_flight = False

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            self._first_opened_at = None
            self._transition(CLOSED)

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {
                "state": self._state,
                "consecutiveFailures": self._failures,
                "threshold": self.threshold,
                "cooldownSeconds": self.cooldown,
            }


def breaker_snapshot() -> dict:
    """State of every registered breaker (clientStatus block)."""
    return {name: br.snapshot() for name, br in sorted(BREAKERS.items())}
