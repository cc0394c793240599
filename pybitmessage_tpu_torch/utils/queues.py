"""Byte-size-bounded and watermark-backpressured asyncio queues (copy of
``pybitmessage_tpu.utils.queues``).

Reference semantics (src/queues.py:14-38): the objectProcessorQueue
caps *unprocessed payload bytes* at 32 MB and blocks producers — a
flood of large objects stalls the network readers instead of ballooning
memory.  ``put`` awaits while the buffered byte total is at/over the
cap; ``get`` frees budget and wakes waiters.

:class:`WatermarkQueue` is the ingest-path variant: ``put_nowait``
never fails (a validated object is never dropped), but crossing the
HIGH watermark clears a resume event that read loops await before their
next packet, until the drain side works the queue back under the LOW
watermark.  Its depth and pauses go to ``ingest_queue_depth`` and
``ingest_pause_total``; each pause and resume is a flight-recorder
event.
"""

from __future__ import annotations

import asyncio

from ..observability import REGISTRY
from ..observability.flightrec import record as _flight

DEFAULT_MAX_BYTES = 32 * 1024 * 1024

INGEST_DEPTH = REGISTRY.gauge(
    "ingest_queue_depth",
    "Validated objects waiting between the network pool and the "
    "object processor")
INGEST_PAUSES = REGISTRY.counter(
    "ingest_pause_total",
    "Read-loop pauses: the ingest queue crossed its high watermark "
    "and connection reads stalled until the low watermark")

#: default high/low watermarks for the network object queue — sized in
#: objects (the byte cap lives one stage later in ByteBoundedQueue)
DEFAULT_HIGH_WATERMARK = 512
DEFAULT_LOW_WATERMARK = 128


class WatermarkQueue(asyncio.Queue):
    """Unbounded queue with high/low-watermark read backpressure.

    ``high=0`` disables pausing entirely (plain queue).  Producers that
    feed from socket read loops call :meth:`wait_resume` before reading
    more work; consumers just ``get``.
    """

    def __init__(self, high: int = DEFAULT_HIGH_WATERMARK,
                 low: int | None = None):
        super().__init__()
        if high and low is None:
            low = max(1, high // 4)
        self.high = high
        self.low = low or 0
        self.paused = False
        self._resume = asyncio.Event()
        self._resume.set()

    def _update(self) -> None:
        size = self.qsize()
        INGEST_DEPTH.set(size)
        if not self.high:
            return
        if not self.paused and size >= self.high:
            self.paused = True
            self._resume.clear()
            INGEST_PAUSES.inc()
            _flight("ingest_pause", depth=size, high=self.high)
        elif self.paused and size <= self.low:
            self.paused = False
            self._resume.set()
            _flight("ingest_resume", depth=size, low=self.low)

    def put_nowait(self, item) -> None:
        super().put_nowait(item)
        self._update()

    def get_nowait(self):
        item = super().get_nowait()
        self._update()
        return item

    async def wait_resume(self) -> None:
        """Block while the queue sits between its watermarks' pause
        window; returns immediately when flow is open."""
        if self.paused:
            await self._resume.wait()


class ByteBoundedQueue(asyncio.Queue):
    """FIFO of ``bytes`` items bounded by their summed length."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        super().__init__()
        self.max_bytes = max_bytes
        self.pending_bytes = 0
        self._space = asyncio.Event()
        self._space.set()

    # NOTE: asyncio.Queue.put()/get() delegate to put_nowait()/
    # get_nowait(), so byte accounting lives ONLY in the _nowait pair —
    # the async wrappers just add the space-wait.

    async def put(self, item: bytes) -> None:
        while self.pending_bytes >= self.max_bytes:
            self._space.clear()
            await self._space.wait()
        await super().put(item)          # delegates to our put_nowait

    def put_nowait(self, item: bytes) -> None:
        if self.pending_bytes >= self.max_bytes:
            raise asyncio.QueueFull
        self.pending_bytes += len(item)
        super().put_nowait(item)

    def get_nowait(self) -> bytes:
        item = super().get_nowait()      # also serves Queue.get()
        self.pending_bytes -= len(item)
        if self.pending_bytes < self.max_bytes:
            self._space.set()
        return item
