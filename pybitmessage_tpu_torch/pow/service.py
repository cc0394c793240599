"""Async PoW front-end that coalesces concurrent solves into one batch
(twin of ``pow/service.py``).

Requests are queued; a short coalescing window lets the rest of a send
sweep arrive, and the whole batch goes through
``PowDispatcher.solve_batch`` in an executor thread.  A dispatcher
failure requeues the batch with exponential backoff instead of dropping
it; only ``max_attempts`` consecutive failures (the daemon's
``powmaxretries``) surface the error to the callers.  A shutdown-driven
interrupt cancels the batch's futures.

With a :class:`~pybitmessage_tpu_torch.resilience.journal.PowJournal`
attached, every request is journaled before it is queued, search
progress is checkpointed as slabs harvest (at most every
``CHECKPOINT_INTERVAL`` seconds a request), and completion deletes the
row: queued and in-flight objects survive a process crash, and a
resubmitted job resumes from its checkpointed nonce offset.  A failing
journal write is retried briefly and then skipped: the solve goes on
without durability rather than failing.

Queue depth, waits, batch sizes, completions and requeues go to the
JAX service's metric families; each request's pre-nonce initial hash
enters the lifecycle timeline (``pow_queued`` -> ``pow_solved``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..observability.flightrec import record as _flight
from ..observability.lifecycle import LIFECYCLE
from ..ops.pow_search import PowInterrupted
from ..resilience.policy import ERRORS, RetryPolicy

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


@dataclass
class _Request:
    initial_hash: bytes
    target: int
    future: asyncio.Future
    enqueued: float
    job_id: int | None = None
    start_nonce: int = 0
    attempts: int = 0
    #: monotonic time of the last journal checkpoint (write throttle)
    last_checkpoint: float = field(default=0.0)
    #: the object's wire trace id (``LIFECYCLE.trace_ctx_for``), named in
    #: the requeue flight events
    trace_id: bytes = b""


class PowService:
    """Owns a background task that drains solve requests in batches."""

    #: minimum seconds between journal checkpoint writes per request
    CHECKPOINT_INTERVAL = 0.2

    def __init__(self, dispatcher, *, shutdown: asyncio.Event | None = None,
                 window: float | None = None, journal=None,
                 max_attempts: int = 3, retry: RetryPolicy | None = None):
        self.dispatcher = dispatcher
        self.shutdown = shutdown or asyncio.Event()
        self.window = DEFAULT_WINDOW if window is None else window
        self.journal = journal
        #: dispatcher failures after which a request gets the error
        self.max_attempts = max(1, max_attempts)
        #: backoff between requeued batches (async sleeps in _run)
        self.retry = retry or RetryPolicy(attempts=self.max_attempts,
                                          base_delay=0.2, max_delay=5.0)
        #: journal writes run inline on the event loop: a budget of
        #: microseconds of sqlite work and at most ~60 ms of backoff,
        #: never the batch policy above
        self._journal_retry = RetryPolicy(attempts=3, base_delay=0.01,
                                          max_delay=0.05, jitter=0.0)
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

    # -- journal plumbing ----------------------------------------------------

    def _journal_call(self, fn, site: str):
        """One journal write, transient failures absorbed by a bounded
        retry; a persistently broken journal degrades to un-journaled
        operation instead of failing the solve."""
        if self.journal is None:
            return None
        try:
            return self._journal_retry.call(fn, site=site)
        except Exception:
            ERRORS.labels(site=site).inc()
            logger.exception("PoW journal write failed (%s); continuing "
                             "without journal durability", site)
            return None

    def _checkpoint(self, req: _Request, next_nonce: int) -> None:
        """Progress hook from the dispatcher (executor thread)."""
        req.start_nonce = max(req.start_nonce, next_nonce)
        if self.journal is None or req.job_id is None:
            return
        now = time.monotonic()
        if now - req.last_checkpoint < self.CHECKPOINT_INTERVAL:
            return
        req.last_checkpoint = now
        try:
            self.journal.checkpoint(req.job_id, next_nonce)
        except Exception:
            ERRORS.labels(site="pow.journal.checkpoint").inc()
            logger.debug("journal checkpoint failed for job %s",
                         req.job_id, exc_info=True)

    # -- API -----------------------------------------------------------------

    async def solve(self, initial_hash: bytes, target: int):
        """Queue one solve; returns (nonce, trials) when its batch lands."""
        fut = asyncio.get_running_loop().create_future()
        req = _Request(initial_hash, target, fut, time.monotonic())
        journaled = self._journal_call(
            lambda: self.journal.add(initial_hash, target),
            site="pow.journal.add")
        if journaled is not None:
            req.job_id, req.start_nonce = journaled
            if req.start_nonce:
                logger.info("resuming journaled PoW job %d from nonce "
                            "offset %d", req.job_id, req.start_nonce)
        # lifecycle: a locally-generated object enters the timeline by
        # its pre-nonce initial hash
        LIFECYCLE.record(initial_hash, "pow_queued")
        # the job joins (or opens) the object's wire trace, so a requeue
        # can be joined to it
        ctx = LIFECYCLE.trace_ctx_for(initial_hash)
        if ctx is not None:
            req.trace_id = ctx.trace_id
        await self.queue.put(req)
        QUEUE_DEPTH.set(self.queue.qsize())
        return await fut

    # -- drain loop ----------------------------------------------------------

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
            for req in batch:
                if req.job_id is not None:
                    self._journal_call(
                        lambda j=req.job_id: self.journal.mark_inflight(j),
                        site="pow.journal.inflight")

            def progress(i, next_nonce, _batch=batch):
                # checkpoint: a requeued or resubmitted request resumes
                # from here
                self._checkpoint(_batch[i], next_nonce)

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
                if req.job_id is not None:
                    self._journal_call(
                        lambda j=req.job_id: self.journal.complete(j),
                        site="pow.journal.complete")
                LIFECYCLE.record(req.initial_hash, "pow_solved")
                if not req.future.done():
                    req.future.set_result(res)

    @staticmethod
    def _trace_ids(batch: list[_Request]) -> list[str]:
        """8-hex prefixes of the first 8 requests' trace ids."""
        return [r.trace_id.hex()[:8] for r in batch[:8] if r.trace_id]

    def _settle_interrupted(self, batch: list[_Request]) -> None:
        """Shutdown-driven: the jobs stay journaled for the next process;
        the futures cancel so the callers unwind."""
        REQUEUED.labels(reason="interrupt").inc(len(batch))
        _flight("pow_requeue", reason="interrupt", n=len(batch),
                traces=self._trace_ids(batch))
        for req in batch:
            if req.job_id is not None:
                self._journal_call(
                    lambda j=req.job_id: self.journal.requeue(j),
                    site="pow.journal.requeue")
            if not req.future.done():
                req.future.cancel()

    async def _requeue_failed(self, batch: list[_Request],
                              exc: Exception) -> None:
        """Put every request of a failed batch back on the queue (with
        backoff) until it has failed ``max_attempts`` times; exhausted
        requests get the error but stay journaled for the next
        process."""
        survivors = []
        for req in batch:
            req.attempts += 1
            if req.job_id is not None:
                self._journal_call(
                    lambda j=req.job_id: self.journal.requeue(j),
                    site="pow.journal.requeue")
            if req.attempts >= self.max_attempts:
                REQUEUED.labels(reason="exhausted").inc()
                logger.error("PoW solve failed after %d attempts; "
                             "surfacing the error to the caller (job "
                             "stays journaled)", req.attempts)
                if not req.future.done():
                    req.future.set_exception(exc)
            else:
                survivors.append(req)
        if not survivors:
            return
        REQUEUED.labels(reason="failure").inc(len(survivors))
        _flight("pow_requeue", reason="failure", n=len(survivors),
                error=repr(exc)[:120], traces=self._trace_ids(survivors))
        attempt = min(r.attempts for r in survivors) - 1
        pause = self.retry.delay(attempt)
        logger.warning("dispatcher failed (%r); requeueing %d solve(s), "
                       "attempt %d/%d after %.2fs backoff", exc,
                       len(survivors), attempt + 2, self.max_attempts, pause)
        try:
            await asyncio.sleep(pause)
        except asyncio.CancelledError:
            self._settle_interrupted(survivors)
            raise
        for req in survivors:
            self.queue.put_nowait(req)
        QUEUE_DEPTH.set(self.queue.qsize())
