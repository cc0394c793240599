"""Token-bucket rate limiting for send/receive (copy of
``pybitmessage_tpu.network.ratelimit``, without its metrics).

Reference: the global buckets in src/network/asyncore_pollchoose.py
(set_rates / can_receive / can_send / update_*, lines 109-130+), driven
by maxdownloadrate / maxuploadrate config (kB/s; 0 = unlimited).
"""

from __future__ import annotations

import asyncio
import time


class TokenBucket:
    def __init__(self, rate_bytes_per_sec: int):
        self.rate = rate_bytes_per_sec
        self._tokens = float(rate_bytes_per_sec)
        self._last = time.monotonic()
        #: bytes accounted so far (clientStatus bytesReceived/bytesSent)
        self.total_bytes = 0

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
        if self.rate <= 0:
            return
        self._refill()
        self._tokens -= n
        if self._tokens < 0:
            await asyncio.sleep(-self._tokens / self.rate)
