"""Async PoW front-end that coalesces concurrent solves into one batch
(twin of ``pow/service.py``).

Requests are queued; a short coalescing window lets the rest of a send
sweep arrive, and the whole batch goes through
``PowDispatcher.solve_batch`` in an executor thread.  A dispatcher
failure requeues the batch with exponential backoff instead of dropping
it; only ``MAX_ATTEMPTS`` consecutive failures surface the error to the
callers.  A shutdown-driven interrupt cancels the batch's futures.

Queue depth, waits, batch sizes, completions and requeues go to the
JAX service's metric families; each request's pre-nonce initial hash
enters the lifecycle timeline (``pow_queued`` -> ``pow_solved``).  The
reference's PoW journal is not part of this port yet.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass

from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..observability.flightrec import record as _flight
from ..observability.lifecycle import LIFECYCLE
from ..ops.pow_search import PowInterrupted

logger = logging.getLogger("pybitmessage_tpu_torch.pow")

BATCH_SIZE = REGISTRY.histogram(
    "pow_batch_size",
    "Objects coalesced into one solve_batch launch (window occupancy)",
    buckets=DEFAULT_SIZE_BUCKETS)
QUEUE_WAIT = REGISTRY.histogram(
    "pow_queue_wait_seconds",
    "Time a solve request waited in the coalescing queue before its "
    "batch launched")
QUEUE_DEPTH = REGISTRY.gauge(
    "pow_queue_depth", "Solve requests currently queued or coalescing")
BATCHES = REGISTRY.counter(
    "pow_batches_total", "Coalesced solve_batch launches")
SOLVED = REGISTRY.counter(
    "pow_solved_total", "Solve requests completed through the service")
REQUEUED = REGISTRY.counter(
    "pow_requeue_total",
    "Solve requests put back on the queue after a dispatcher failure "
    "or interrupt — the no-object-loss path", ("reason",))

#: default coalescing window in seconds
DEFAULT_WINDOW = 0.05


class RetryPolicy:
    """Exponential backoff with bounded jitter: ``delay(attempt)`` is
    ``base_delay * 2**attempt`` clamped to ``MAX_DELAY``, scaled by a
    factor uniform in ``[1 - jitter, 1 + jitter]``."""

    MAX_DELAY = 5.0

    def __init__(self, *, base_delay: float = 0.2, jitter: float = 0.5):
        self.base_delay = base_delay
        self.jitter = min(max(jitter, 0.0), 1.0)
        self._rng = random.Random()

    def delay(self, attempt: int) -> float:
        raw = min(self.base_delay * 2.0 ** attempt, self.MAX_DELAY)
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(raw, 0.0)


@dataclass
class _Request:
    initial_hash: bytes
    target: int
    future: asyncio.Future
    enqueued: float
    start_nonce: int = 0
    attempts: int = 0


class PowService:
    """Owns a background task that drains solve requests in batches."""

    #: consecutive dispatcher failures after which a request gets the error
    MAX_ATTEMPTS = 3

    def __init__(self, dispatcher, *, shutdown: asyncio.Event | None = None,
                 window: float | None = None,
                 retry: RetryPolicy | None = None):
        self.dispatcher = dispatcher
        self.shutdown = shutdown or asyncio.Event()
        self.window = DEFAULT_WINDOW if window is None else window
        self.retry = retry or RetryPolicy()
        self.queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        #: coalesced solve_batch calls that returned results
        self.batches = 0
        #: requests completed
        self.solved = 0

    def start(self) -> asyncio.Task:
        self._task = asyncio.create_task(self._run())
        return self._task

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def solve(self, initial_hash: bytes, target: int):
        """Queue one solve; returns (nonce, trials) when its batch lands."""
        fut = asyncio.get_running_loop().create_future()
        # lifecycle: a locally-generated object enters the timeline by
        # its pre-nonce initial hash
        LIFECYCLE.record(initial_hash, "pow_queued")
        await self.queue.put(_Request(initial_hash, target, fut,
                                      time.monotonic()))
        QUEUE_DEPTH.set(self.queue.qsize())
        return await fut

    async def _run(self) -> None:
        while True:
            first = await self.queue.get()
            if self.window > 0:
                await asyncio.sleep(self.window)
            batch = [first]
            while not self.queue.empty():
                batch.append(self.queue.get_nowait())
            now = time.monotonic()
            for req in batch:
                QUEUE_WAIT.observe(now - req.enqueued)
            BATCH_SIZE.observe(len(batch))
            QUEUE_DEPTH.set(self.queue.qsize())
            items = [(r.initial_hash, r.target) for r in batch]
            starts = [r.start_nonce for r in batch]

            def progress(i, next_nonce, _batch=batch):
                # checkpoint: a requeued request resumes from here
                req = _batch[i]
                req.start_nonce = max(req.start_nonce, next_nonce)

            loop = asyncio.get_running_loop()
            try:
                results = await loop.run_in_executor(
                    None, lambda: self.dispatcher.solve_batch(
                        items, should_stop=self.shutdown.is_set,
                        start_nonces=starts, progress=progress))
            except asyncio.CancelledError:
                self._settle_interrupted(batch)
                raise
            except PowInterrupted:
                self._settle_interrupted(batch)
                continue
            except Exception as exc:
                await self._requeue_failed(batch, exc)
                continue
            self.batches += 1
            self.solved += len(batch)
            BATCHES.inc()
            SOLVED.inc(len(batch))
            if len(batch) > 1:
                logger.info("batched PoW: %d objects in one call (%s)",
                            len(batch), self.dispatcher.last_backend)
            for req, res in zip(batch, results):
                LIFECYCLE.record(req.initial_hash, "pow_solved")
                if not req.future.done():
                    req.future.set_result(res)

    @staticmethod
    def _settle_interrupted(batch: list[_Request]) -> None:
        REQUEUED.labels(reason="interrupt").inc(len(batch))
        _flight("pow_requeue", reason="interrupt", n=len(batch))
        for req in batch:
            if not req.future.done():
                req.future.cancel()

    async def _requeue_failed(self, batch: list[_Request],
                              exc: Exception) -> None:
        """Put every request of a failed batch back on the queue (with
        backoff) until it has failed ``MAX_ATTEMPTS`` times; exhausted
        requests get the error."""
        survivors = []
        for req in batch:
            req.attempts += 1
            if req.attempts >= self.MAX_ATTEMPTS:
                REQUEUED.labels(reason="exhausted").inc()
                logger.error("PoW solve failed after %d attempts; "
                             "surfacing the error to the caller",
                             req.attempts)
                if not req.future.done():
                    req.future.set_exception(exc)
            else:
                survivors.append(req)
        if not survivors:
            return
        REQUEUED.labels(reason="failure").inc(len(survivors))
        _flight("pow_requeue", reason="failure", n=len(survivors),
                error=repr(exc)[:120])
        attempt = min(r.attempts for r in survivors) - 1
        pause = self.retry.delay(attempt)
        logger.warning("dispatcher failed (%r); requeueing %d solve(s), "
                       "attempt %d/%d after %.2fs backoff", exc,
                       len(survivors), attempt + 2, self.MAX_ATTEMPTS, pause)
        try:
            await asyncio.sleep(pause)
        except asyncio.CancelledError:
            self._settle_interrupted(survivors)
            raise
        for req in survivors:
            self.queue.put_nowait(req)
        QUEUE_DEPTH.set(self.queue.qsize())
