"""Pooled receive buffers for the zero-copy packet path (copy of
``pybitmessage_tpu.network.bufpool``).

:class:`BufferPool` hands out refcounted :class:`PooledBuffer` objects
backed by reusable ``bytearray`` slabs.  The connection fills one per
packet (``readinto``-style: each socket chunk lands at its final
offset), verifies the checksum and runs the whole duplicate-detection
path over **memoryviews** of that buffer.  Only an object that turns
out to be *new* pays one ``materialize()`` into a stable ``bytes``
payload shared by the store and the processor queue; duplicates are
dropped for the cost of the single fill copy.

Ownership contract: ``acquire()`` returns a buffer with refcount 1;
whoever needs it past the current call frame ``retain()``s it and
pairs that with ``release()``.  The last release returns the backing
``bytearray`` to the pool for the next packet.  Copies, parked buffers
and misses go to the JAX pool's metric families.
"""

from __future__ import annotations

import threading

from ..observability import REGISTRY

BYTES_COPIED = REGISTRY.counter(
    "ingest_bytes_copied_total",
    "Payload bytes copied on the receive path, by copy stage: 'fill' "
    "= socket chunk into the pooled buffer (paid once per packet), "
    "'materialize' = pooled view into a stable payload (paid only for "
    "accepted-new objects and non-object commands)", ("stage",))
# children bound once: these run per packet / per accepted object
COPIED_FILL = BYTES_COPIED.labels(stage="fill")
COPIED_MATERIALIZE = BYTES_COPIED.labels(stage="materialize")
POOL_BUFFERS = REGISTRY.gauge(
    "ingest_buffer_pool_buffers",
    "Reusable receive buffers currently parked in the pool")
POOL_MISSES = REGISTRY.counter(
    "ingest_buffer_pool_misses_total",
    "acquire() calls that had to allocate a fresh buffer (no parked "
    "buffer was large enough)")

#: buffers parked per pool; beyond this a released buffer is dropped
#: to the allocator instead (bounds idle memory after a burst)
POOL_CAP = 32
#: total bytes parked per pool — without this, one burst of
#: MAX_MESSAGE_SIZE objects would pin POOL_CAP maximum-size buffers
#: (~64 MiB) for the process lifetime
POOL_MAX_BYTES = 16 << 20
#: smallest backing allocation — avoids churning tiny buffers for the
#: common small-command case
MIN_BUFFER = 4096


def _round_up(n: int) -> int:
    """Next power of two >= n (and >= MIN_BUFFER) so buffers re-fit
    across the packet-size mix instead of fragmenting per exact size."""
    size = MIN_BUFFER
    while size < n:
        size <<= 1
    return size


class PooledBuffer:
    """A refcounted view window over a pool-owned ``bytearray``.

    ``view()`` exposes the filled region as a ``memoryview``; the
    buffer must not be released while any such view is still being
    read (retain before handing a view to other-task code, release
    when done).
    """

    __slots__ = ("_pool", "_data", "_length", "_refs")

    def __init__(self, pool: "BufferPool", data: bytearray, length: int):
        self._pool = pool
        self._data = data
        self._length = length
        self._refs = 1

    def write_at(self, offset: int, chunk: bytes) -> None:
        """Copy one socket chunk to its final offset (the one 'fill'
        copy, counted)."""
        self._data[offset:offset + len(chunk)] = chunk
        COPIED_FILL.inc(len(chunk))

    def view(self) -> memoryview:
        """The filled payload region, zero-copy."""
        return memoryview(self._data)[:self._length]

    def materialize(self) -> bytes:
        """One stable ``bytes`` copy of the payload.  Goes through a
        memoryview so it really is ONE copy — a bytearray slice would
        allocate an intermediate."""
        COPIED_MATERIALIZE.inc(self._length)
        return bytes(memoryview(self._data)[:self._length])

    def __len__(self) -> int:
        return self._length

    def retain(self) -> "PooledBuffer":
        self._refs += 1
        return self

    def release(self) -> None:
        self._refs -= 1
        if self._refs == 0 and self._data is not None:
            data, self._data = self._data, None
            self._pool._park(data)


class BufferPool:
    """Size-capped free list of reusable receive ``bytearray``s.

    Thread-safe (releases can arrive from verify-task callbacks).
    """

    def __init__(self, cap: int = POOL_CAP,
                 max_bytes: int = POOL_MAX_BYTES):
        self._lock = threading.Lock()
        self._free: list[bytearray] = []
        self._free_bytes = 0
        self._cap = cap
        self._max_bytes = max_bytes

    def acquire(self, length: int) -> PooledBuffer:
        """A buffer whose backing store holds >= ``length`` bytes —
        BEST fit, so a small command doesn't burn a parked
        payload-sized buffer and force the next object to miss."""
        with self._lock:
            best = -1
            for i, data in enumerate(self._free):
                if len(data) >= length and (
                        best < 0 or len(data) < len(self._free[best])):
                    best = i
            if best >= 0:
                data = self._free.pop(best)
                self._free_bytes -= len(data)
                POOL_BUFFERS.set(len(self._free))
                return PooledBuffer(self, data, length)
        POOL_MISSES.inc()
        return PooledBuffer(self, bytearray(_round_up(length)), length)

    def _park(self, data: bytearray) -> None:
        with self._lock:
            if len(self._free) >= self._cap:
                # full: keep the LARGEST buffers — evict the smallest
                # parked buffer when it's smaller than this one
                i = min(range(len(self._free)),
                        key=lambda j: len(self._free[j]))
                if len(self._free[i]) >= len(data):
                    return
                self._free_bytes -= len(self._free.pop(i))
            self._free.append(data)
            self._free_bytes += len(data)
            # byte budget: shed the smallest buffers so a burst of
            # near-MAX_MESSAGE_SIZE payloads can't pin its whole
            # working set in the free list forever
            while self._free_bytes > self._max_bytes and \
                    len(self._free) > 1:
                i = min(range(len(self._free)),
                        key=lambda j: len(self._free[j]))
                self._free_bytes -= len(self._free.pop(i))
            POOL_BUFFERS.set(len(self._free))

    def parked(self) -> int:
        with self._lock:
            return len(self._free)


#: process-wide pool shared by every connection — receive buffers are
#: interchangeable, and one pool keeps the idle-memory bound global
RECV_POOL = BufferPool()
