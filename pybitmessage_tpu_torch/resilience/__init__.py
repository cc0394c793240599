"""Resilience primitives of the port: the circuit breaker the
connection pool keeps per dialed peer."""

from .policy import CircuitBreaker  # noqa: F401
