"""Resilience primitives of the port: the circuit breaker the
connection pool keeps per dialed peer, the retry policy of the
database's writes and the API's per-request deadline."""

from .policy import (  # noqa: F401
    CircuitBreaker, Deadline, RetryPolicy, current_deadline,
)
