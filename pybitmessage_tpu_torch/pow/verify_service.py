"""Batched PoW verification of incoming objects (twin of
``pybitmessage_tpu.pow.verify_service``).

Every received object's PoW is checked before anything else is done
with it.  The checks funnel through one drain task: whatever
accumulated while the previous batch was in flight becomes the next
batch, so batching emerges from load with zero added latency.  A drain
of at least ``MIN_DEVICE_BATCH``
objects runs on the device as one batched double-SHA512
(``ops/pow_search.verify``, plain torch ops, as the reference leaves it
to XLA); smaller drains take two host SHA-512s per object, which beat a
device round trip.

A device failure is not re-run on the host: it reaches the callers of
that batch as their exception.  Paths, drains, batch sizes and
rejections go to the JAX verifier's metric families.
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor

from .. import resolve_device
from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..models.constants import (DEFAULT_EXTRA_BYTES,
                                DEFAULT_NONCE_TRIALS_PER_BYTE)
from ..models.pow_math import check_pow, pow_target
from ..ops.pow_search import verify
from ..utils.hashes import sha512

#: the smallest drain worth a device round trip
MIN_DEVICE_BATCH = 4

VERIFIED = REGISTRY.counter(
    "pow_verify_total",
    "Incoming-object PoW checks by execution path", ("path",))
VERIFY_BATCHES = REGISTRY.counter(
    "pow_verify_batches_total", "Device verification batches launched")
VERIFY_BATCH_SIZE = REGISTRY.histogram(
    "pow_verify_batch_size",
    "Objects per coalesced verification drain (host or device)",
    buckets=DEFAULT_SIZE_BUCKETS)
VERIFY_REJECTED = REGISTRY.counter(
    "pow_verify_rejected_total",
    "Incoming objects whose embedded PoW failed the target")
VERIFY_SHUTDOWN = REGISTRY.counter(
    "pow_verify_shutdown_unverified_total",
    "Checks still pending at verifier shutdown, settled as unverified "
    "(False) instead of leaking CancelledError into per-connection "
    "verification tasks")


class BatchVerifier:
    """Coalesces ``check(object_bytes)`` calls into device batches on
    ``device`` (``None``: the CUDA card, raising without one)."""

    def __init__(self, device=None, *, ntpb: int = 0, extra: int = 0,
                 clamp: bool = True):
        self.device = resolve_device(device)
        # 0 -> network defaults, so the device path (pow_target) and the
        # host path (check_pow, which substitutes defaults itself) agree
        self.ntpb = ntpb or DEFAULT_NONCE_TRIALS_PER_BYTE
        self.extra = extra or DEFAULT_EXTRA_BYTES
        self.clamp = clamp
        self.queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._exec: ThreadPoolExecutor | None = None
        #: how many objects went down each path
        self.host_checked = 0
        self.device_checked = 0
        self.device_batches = 0

    def start(self) -> asyncio.Task:
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="bmtpu-powverify")
        self._task = asyncio.create_task(self._run())
        return self._task

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._exec is not None:
            self._exec.shutdown(wait=False, cancel_futures=True)
            self._exec = None
        # still-queued checks settle as unverified (False), never as a
        # CancelledError in the per-connection tasks awaiting them
        while not self.queue.empty():
            _, fut = self.queue.get_nowait()
            if not fut.done():
                VERIFY_SHUTDOWN.inc()
                fut.set_result(False)

    async def check(self, object_bytes: bytes) -> bool:
        """True when the object's embedded PoW meets its target."""
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put((object_bytes, fut))
        return await fut

    # -- internals -----------------------------------------------------------

    def _target_for(self, object_bytes: bytes) -> int:
        expires = int.from_bytes(object_bytes[8:16], "big")
        ttl = max(expires - int(time.time()), 300)
        return pow_target(len(object_bytes), ttl, self.ntpb, self.extra,
                          clamp=self.clamp)

    def _host_check(self, object_bytes: bytes) -> bool:
        return check_pow(object_bytes, self.ntpb, self.extra,
                         clamp=self.clamp)

    async def _run(self) -> None:
        while True:
            batch = []
            try:
                batch.append(await self.queue.get())
                while not self.queue.empty():
                    batch.append(self.queue.get_nowait())
                VERIFY_BATCH_SIZE.observe(len(batch))
                if len(batch) >= MIN_DEVICE_BATCH:
                    try:
                        results = await self._device_verify(
                            [ob for ob, _ in batch])
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:
                        for _, fut in batch:
                            if not fut.done():
                                fut.set_exception(exc)
                        continue
                    self.device_checked += len(batch)
                    self.device_batches += 1
                    VERIFIED.labels(path="device").inc(len(batch))
                    VERIFY_BATCHES.inc()
                else:
                    results = [self._host_check(ob) for ob, _ in batch]
                    self.host_checked += len(batch)
                    VERIFIED.labels(path="host").inc(len(batch))
                VERIFY_REJECTED.inc(sum(1 for ok in results if not ok))
                for (_, fut), ok in zip(batch, results):
                    if not fut.done():
                        fut.set_result(bool(ok))
            except asyncio.CancelledError:
                # every popped member settles: a future left pending
                # would hang its caller forever
                for _, fut in batch:
                    if not fut.done():
                        VERIFY_SHUTDOWN.inc()
                        fut.set_result(False)
                raise

    async def _device_verify(self, objects: list[bytes]) -> list[bool]:
        items = [(int.from_bytes(ob[:8], "big"), sha512(ob[8:]),
                  self._target_for(ob)) for ob in objects]
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec, lambda: verify(items, device=self.device))
