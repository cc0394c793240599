"""Token-bucket rate limiting for send/receive (copy of
``pybitmessage_tpu.network.ratelimit``).

Reference: the global buckets in src/network/asyncore_pollchoose.py
(set_rates / can_receive / can_send / update_*, lines 109-130+), driven
by maxdownloadrate / maxuploadrate config (kB/s; 0 = unlimited).
Bytes, throttle events and throttled seconds go to the JAX buckets'
metric families, by direction.
"""

from __future__ import annotations

import asyncio
import time

from ..observability import REGISTRY

BYTES = REGISTRY.counter(
    "network_bytes_total", "Payload bytes through the global rate "
    "buckets", ("direction",))
THROTTLE_EVENTS = REGISTRY.counter(
    "network_throttle_events_total",
    "Times a transfer slept because its bucket went into debt",
    ("direction",))
THROTTLED_SECONDS = REGISTRY.counter(
    "network_throttled_seconds_total",
    "Cumulative sleep imposed by the rate buckets", ("direction",))


class TokenBucket:
    def __init__(self, rate_bytes_per_sec: int, direction: str = ""):
        self.rate = rate_bytes_per_sec
        self._tokens = float(rate_bytes_per_sec)
        self._last = time.monotonic()
        #: bytes accounted so far (clientStatus bytesReceived/bytesSent)
        self.total_bytes = 0
        #: metrics label ("rx"/"tx"); "" keeps ad-hoc buckets out of the
        #: exported series.  Children are bound once: consume() is hot
        self.direction = direction
        self._bytes = BYTES.labels(direction=direction) \
            if direction else None
        self._throttle_events = THROTTLE_EVENTS.labels(
            direction=direction) if direction else None
        self._throttled_seconds = THROTTLED_SECONDS.labels(
            direction=direction) if direction else None

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(
            self.rate, self._tokens + (now - self._last) * self.rate)
        self._last = now

    async def consume(self, n: int) -> None:
        """Account ``n`` bytes, sleeping while the bucket is in debt.

        Debt model: a single transfer larger than one second's budget
        (e.g. a 1.6 MB max-size message at 100 kB/s) drives the bucket
        negative and the caller sleeps off the debt, rather than
        spinning forever waiting for capacity that can never accrue.
        """
        self.total_bytes += n
        if self._bytes is not None:
            self._bytes.inc(n)
        if self.rate <= 0:
            return
        self._refill()
        self._tokens -= n
        if self._tokens < 0:
            debt = -self._tokens / self.rate
            if self._throttle_events is not None:
                self._throttle_events.inc()
                self._throttled_seconds.inc(debt)
            await asyncio.sleep(debt)
