"""The PoW farm daemon: admission -> journal -> WDRR -> the card (copy
of ``pybitmessage_tpu.powfarm.server``).

Turns the node's :class:`~pybitmessage_tpu_torch.pow.dispatcher.
PowDispatcher` into a multi-tenant network service: edge nodes submit
jobs over the length-prefixed protocol (protocol.py), every *accepted*
job is journaled in the crash-safe store (journal.py) before it is
queued, the scheduler (scheduler.py) decides drain order and
admission, and coalesced batches go down through the dispatcher, so
many tenants' jobs share one launch of the card's search kernels (a
storm of tiny objects packs into the packed kernel) with the
dispatcher's stall deadline and resumable-checkpoint plumbing.

Failure contract (docs/resilience.md conventions):

- a dispatcher failure REQUEUES the batch at the front of its lanes
  with backoff; ``powmaxretries`` consecutive failures surface an
  ``error`` RESULT to the clients and the job *stays journaled*;
- a farm crash loses nothing: journaled jobs are re-adopted into the
  scheduler at restart WITH their tenant/lane (FarmJournal meta) and
  their checkpointed nonce offsets (each logged with its offset); a still-connected client that
  already requeued the same job locally — or re-submits it on
  reconnect — is DEDUPED by ``(initial_hash, target)`` and attached
  to the recovered job instead of double-enqueuing it
  (``farm_adopt_collisions_total`` counts the collisions);
- result delivery failures never lose work: the solved nonce stays in
  a bounded recent-results cache, so a client that reconnects and
  re-submits gets the answer without re-solving.

A submission's 32-byte trace field is the submitting node's wire trace
context: the job adopts its trace id, so queue wait and solve latency
stay attributable per tenant and per trace.

Chaos sites (resilience/chaos.py catalog): ``farm.accept`` fails a
submission accept (the client sees a retryable REJECT),
``farm.dispatch`` fails a batch launch (exercises the requeue path),
``farm.result`` drops a result frame send (exercises the
recent-cache / client-local-fallback path).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..observability.flightrec import record as _flight
from ..observability.lifecycle import LIFECYCLE
from ..observability.tracing import TraceContext
from ..ops.pow_search import PowInterrupted
from ..resilience.chaos import inject
from ..resilience.policy import ERRORS, RetryPolicy
from .protocol import (LANE_BULK, MSG_ACCEPT, MSG_PING, MSG_PONG,
                       MSG_REJECT, MSG_RESULT, MSG_SUBMIT, ST_ERROR, ST_EXPIRED, ST_OK,
                       AcceptMsg, ProtocolError, RejectMsg, ResultMsg,
                       SubmitMsg, mac_ok, pack_frame, read_frame)
from .scheduler import (REJECT_AUTH, FarmJob, FarmScheduler,
                        TenantConfig)

logger = logging.getLogger("pybitmessage_tpu_torch.powfarm")

JOBS = REGISTRY.counter(
    "farm_jobs_total",
    "Terminal farm job outcomes by lane: solved, error (ladder "
    "exhausted; job stays journaled), expired (deadline passed in "
    "queue)", ("lane", "outcome"))
BATCH_SIZE = REGISTRY.histogram(
    "farm_batch_size",
    "Jobs coalesced into one farm dispatch through the solver ladder",
    buckets=DEFAULT_SIZE_BUCKETS)
SOLVE_SECONDS = REGISTRY.histogram(
    "farm_solve_seconds",
    "Wall time of one coalesced farm batch through the dispatcher")
ADOPT_COLLISIONS = REGISTRY.counter(
    "farm_adopt_collisions_total",
    "Submissions deduped onto an already-journaled job by "
    "(initial_hash, target) — restart re-submissions and concurrent "
    "local requeues attach to the recovered job instead of "
    "double-enqueuing it")
CONNECTIONS = REGISTRY.gauge(
    "farm_connections", "Client connections currently open on the farm")
REQUEUES = REGISTRY.counter(
    "farm_requeue_total",
    "Farm batches put back on the queue after a dispatch failure — "
    "the no-job-loss path", ("reason",))
TENANT_CPU = REGISTRY.counter(
    "farm_tenant_cpu_seconds_total",
    "Solve wall time attributed per tenant: each coalesced batch's "
    "dispatcher seconds split by the tenant's job share of the batch "
    "(the farm half of the costStatus attribution plane; tenant ids "
    "are bounded by the scheduler's registration cap)", ("tenant",))


class FarmServer:
    """Multi-tenant PoW-as-a-service daemon on the node's event loop."""

    #: minimum seconds between journal checkpoint writes per job
    CHECKPOINT_INTERVAL = 0.2
    #: solved (initial_hash, target) -> (nonce, trials) kept for
    #: re-submitting clients whose result frame was lost
    RECENT_RESULTS = 1024

    def __init__(self, solver, *, journal=None, host: str = "127.0.0.1",
                 port: int = 0, scheduler: FarmScheduler | None = None,
                 auth_required: bool = False, batch_max: int = 32,
                 window: float = 0.01, max_attempts: int = 3,
                 retry: RetryPolicy | None = None):
        self.solver = solver
        self.journal = journal
        self.host = host
        self.port = port
        self.scheduler = scheduler or FarmScheduler()
        #: signed-submissions mode: only pre-registered tenants (with
        #: their HMAC secrets) are admitted; open mode auto-registers
        #: up to the scheduler's tenant cap
        self.auth_required = auth_required
        self.batch_max = max(1, batch_max)
        self.window = window
        self.max_attempts = max(1, max_attempts)
        self.retry = retry or RetryPolicy(attempts=self.max_attempts,
                                          base_delay=0.1, max_delay=2.0)
        #: journal writes are µs-scale sqlite on the loop (the
        #: PowService precedent) — tiny bounded retry, never the
        #: batch policy
        self._journal_retry = RetryPolicy(attempts=3, base_delay=0.01,
                                          max_delay=0.05, jitter=0.0)
        self._shutdown = asyncio.Event()
        self._wake = asyncio.Event()
        self._server: asyncio.AbstractServer | None = None
        self._drain_task: asyncio.Task | None = None
        self._conn_ids = itertools.count(1)
        #: dedicated NAMED dispatch thread (not the anonymous asyncio
        #: default executor), so a thread dump or a profile names the
        #: farm's solves.  One worker: the drain loop awaits each
        #: batch anyway.
        self._solve_exec = ThreadPoolExecutor(
            1, thread_name_prefix="bmtpu-farm-solve")
        self._writers: dict[int, asyncio.StreamWriter] = {}
        #: every queued-or-inflight job by (initial_hash, target) —
        #: THE dedupe map the restart-adoption fix rides on
        self._by_key: dict[tuple[bytes, int], FarmJob] = {}
        self._recent: OrderedDict = OrderedDict()
        self.listen_port: int | None = None

    # -- tenants -------------------------------------------------------------

    def register_tenant(self, name: str,
                        config: TenantConfig | None = None) -> None:
        self.scheduler.register(name, config)

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._adopt_journal()
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port)
        self.listen_port = self._server.sockets[0].getsockname()[1]
        self._drain_task = asyncio.create_task(self._drain())
        logger.info("PoW farm listening on %s:%d (batch<=%d, "
                    "auth=%s, %d tenant(s) registered)",
                    self.host, self.listen_port, self.batch_max,
                    self.auth_required, len(self.scheduler.tenants()))

    def _adopt_journal(self) -> None:
        """Re-enter crash survivors into the scheduler with their
        tenant/lane — recovered work competes under the same WDRR as
        fresh traffic instead of jumping (or losing) the queue."""
        if self.journal is None:
            return
        adopted = 0
        for pj, meta in self.journal.pending_meta():
            job = FarmJob(
                tenant=meta.get("tenant", "recovered"),
                lane=meta.get("lane", LANE_BULK),
                initial_hash=pj.initial_hash, target=pj.target,
                start_nonce=pj.start_nonce, job_id=pj.job_id)
            if job.key in self._by_key:
                continue
            self._by_key[job.key] = job
            self.scheduler.push(job)
            adopted += 1
            logger.info("farm journal: adopted job %d (tenant %s, lane "
                        "%s) from its checkpoint, nonce offset %d",
                        pj.job_id, job.tenant, job.lane, pj.start_nonce)
        if adopted:
            self._wake.set()
            _flight("farm_adopt", n=adopted)
            logger.info("farm journal: adopted %d job(s) surviving "
                        "restart into the scheduler", adopted)

    async def stop(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._drain_task is not None:
            self._drain_task.cancel()
            try:
                await self._drain_task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
        # the clients' connections close BEFORE the wait: since Python
        # 3.12 ``wait_closed`` waits for every connection, and a
        # connected client's handler would block it forever
        for writer in list(self._writers.values()):
            try:
                writer.close()
            except Exception as exc:
                logger.debug("farm writer close failed: %r", exc)
        self._writers.clear()
        if self._server is not None:
            await self._server.wait_closed()
        self._solve_exec.shutdown(wait=False)
        CONNECTIONS.set(0)

    # -- journal plumbing ----------------------------------------------------

    def _journal_call(self, fn, site: str):
        """One journal write with bounded absorption: a persistently
        broken journal degrades to un-journaled operation instead of
        failing the job (PowService contract)."""
        if self.journal is None:
            return None
        try:
            return self._journal_retry.call(fn, site=site)
        except Exception:
            ERRORS.labels(site=site).inc()
            logger.exception("farm journal write failed (%s); "
                             "continuing without durability", site)
            return None

    def _checkpoint(self, job: FarmJob, next_nonce: int) -> None:
        """Progress hook from the dispatcher (executor thread)."""
        job.start_nonce = max(job.start_nonce, next_nonce)
        if self.journal is None or job.job_id is None:
            return
        now = time.monotonic()
        if now - job.last_checkpoint < self.CHECKPOINT_INTERVAL:
            return
        job.last_checkpoint = now
        try:
            self.journal.checkpoint(job.job_id, next_nonce)
        except Exception:
            ERRORS.labels(site="pow.journal.checkpoint").inc()
            logger.debug("farm checkpoint failed for job %s",
                         job.job_id, exc_info=True)

    # -- connection handling -------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        conn_id = next(self._conn_ids)
        self._writers[conn_id] = writer
        CONNECTIONS.set(len(self._writers))
        try:
            while not self._shutdown.is_set():
                msg_type, payload = await read_frame(reader)
                if msg_type == MSG_PING:
                    writer.write(pack_frame(MSG_PONG, b""))
                    await writer.drain()
                elif msg_type == MSG_SUBMIT:
                    await self._on_submit(conn_id, payload, writer)
                else:
                    raise ProtocolError(
                        "unexpected farm frame type %d" % msg_type)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass                     # normal client departure
        except ProtocolError as exc:
            ERRORS.labels(site="farm.protocol").inc()
            logger.warning("farm protocol error from client: %s", exc)
        finally:
            self._writers.pop(conn_id, None)
            CONNECTIONS.set(len(self._writers))
            # the departed client's pending refs: jobs stay queued
            # (journaled) — their results land in the recent cache
            for job in self._by_key.values():
                job.refs = [r for r in job.refs if r[0] != conn_id]
            try:
                writer.close()
            except Exception as exc:
                logger.debug("farm writer close failed: %r", exc)

    async def _reply(self, writer, msg_type: int, payload: bytes) -> None:
        writer.write(pack_frame(msg_type, payload))
        await writer.drain()

    async def _on_submit(self, conn_id: int, payload: bytes,
                         writer) -> None:
        msg = SubmitMsg.decode(payload)     # ProtocolError -> _serve
        try:
            inject("farm.accept")
        except Exception as exc:
            # an injected accept fault is a retryable farm-side
            # refusal: the client backs off or solves locally
            ERRORS.labels(site="farm.accept").inc()
            logger.warning("farm accept fault for tenant %s: %r",
                           msg.tenant, exc)
            await self._reply(writer, MSG_REJECT, RejectMsg(
                msg.job_ref, "unavailable", 200).encode())
            return
        # signed submissions: pre-registered tenants verify by HMAC
        state = self.scheduler.tenant(msg.tenant)
        if self.auth_required and state is None:
            await self._reject(writer, msg, REJECT_AUTH, 0.0)
            return
        if state is not None and state.config.secret:
            if not msg.mac or not mac_ok(state.config.secret,
                                         msg._signed, msg.mac):
                await self._reject(writer, msg, REJECT_AUTH, 0.0)
                return
        key = (msg.initial_hash, msg.target)
        # already solved and the result frame was lost?  answer from
        # the recent cache without burning solver time
        hit = self._recent.get(key)
        if hit is not None:
            nonce, trials = hit
            await self._reply(writer, MSG_RESULT, ResultMsg(
                msg.job_ref, ST_OK, nonce, trials).encode())
            return
        # restart-adoption / concurrent-requeue dedupe:
        # the same (initial_hash, target) already queued or inflight
        # attaches this client instead of double-enqueuing the job
        job = self._by_key.get(key)
        if job is not None:
            ADOPT_COLLISIONS.inc()
            job.refs.append((conn_id, msg.job_ref))
            await self._reply(writer, MSG_ACCEPT, AcceptMsg(
                msg.job_ref, job.job_id or 0,
                self.scheduler.depth(),
                int(self.scheduler.projected_wait(job.lane) * 1e3)
            ).encode())
            return
        deadline_s = msg.deadline_ms / 1e3 if msg.deadline_ms else None
        verdict = self.scheduler.admit(msg.tenant, msg.lane, deadline_s)
        if not verdict.ok:
            await self._reject(writer, msg, verdict.reason,
                               verdict.retry_after)
            return
        journaled = self._journal_call(
            lambda: self.journal.add(
                msg.initial_hash, msg.target,
                meta={"tenant": msg.tenant, "lane": msg.lane}),
            site="pow.journal.add")
        job = FarmJob(
            tenant=msg.tenant, lane=msg.lane,
            initial_hash=msg.initial_hash, target=msg.target,
            start_nonce=msg.start_nonce,
            deadline=(time.monotonic() + deadline_s
                      if deadline_s else None),
            refs=[(conn_id, msg.job_ref)])
        if journaled is not None:
            job.job_id, journal_start = journaled
            job.start_nonce = max(job.start_nonce, journal_start)
        # the job joins the object's wire trace: queue wait and solve
        # latency stay attributable per tenant AND per trace
        if msg.trace:
            try:
                ctx = TraceContext.decode(msg.trace)
                LIFECYCLE.adopt(msg.initial_hash, ctx.trace_id,
                                ctx.parent_span)
                job.trace_id = ctx.trace_id
            except ValueError:
                logger.debug("undecodable trace ctx on farm submit")
        LIFECYCLE.record(msg.initial_hash, "pow_queued")
        self._by_key[key] = job
        self.scheduler.push(job)
        self._wake.set()
        await self._reply(writer, MSG_ACCEPT, AcceptMsg(
            msg.job_ref, job.job_id or 0, verdict.depth + 1,
            int(verdict.est_wait * 1e3)).encode())

    async def _reject(self, writer, msg: SubmitMsg, reason: str,
                      retry_after: float) -> None:
        await self._reply(writer, MSG_REJECT, RejectMsg(
            msg.job_ref, reason,
            int(max(retry_after, 0.0) * 1e3)).encode())

    # -- drain loop ----------------------------------------------------------

    async def _drain(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._shutdown.is_set():
            if self.scheduler.depth() == 0:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), 0.5)
                except asyncio.TimeoutError:
                    continue
            if self.window > 0:
                await asyncio.sleep(self.window)
            batch = self.scheduler.take(self.batch_max)
            if not batch:
                continue
            live = await self._settle_expired(batch)
            if not live:
                continue
            BATCH_SIZE.observe(len(live))
            for job in live:
                if job.job_id is not None:
                    self._journal_call(
                        lambda j=job.job_id:
                        self.journal.mark_inflight(j),
                        site="pow.journal.inflight")
            items = [(j.initial_hash, j.target) for j in live]
            starts = [j.start_nonce for j in live]

            def progress(i, next_nonce, _live=live):
                self._checkpoint(_live[i], next_nonce)

            t0 = time.monotonic()
            self.scheduler.inflight = len(live)
            try:
                inject("farm.dispatch")
                results = await loop.run_in_executor(
                    self._solve_exec,
                    lambda: self.solver.solve_batch(
                        items, should_stop=self._shutdown.is_set,
                        start_nonces=starts, progress=progress))
            except asyncio.CancelledError:
                self._settle_interrupted(live)
                raise
            except PowInterrupted:
                # shutdown-driven: jobs stay journaled for the next
                # process (restart adoption re-queues them)
                self._settle_interrupted(live)
                continue
            except Exception as exc:
                await self._requeue_failed(live, exc)
                continue
            finally:
                self.scheduler.inflight = 0
            dt = max(time.monotonic() - t0, 1e-9)
            SOLVE_SECONDS.observe(dt)
            self.scheduler.note_drained(len(live), dt)
            # cost attribution: the batch's solve seconds split by
            # each tenant's job share
            tenant_jobs: dict[str, int] = {}
            for job in live:
                tenant_jobs[job.tenant] = \
                    tenant_jobs.get(job.tenant, 0) + 1
            for tenant, n in tenant_jobs.items():
                TENANT_CPU.labels(tenant=tenant).inc(
                    dt * n / len(live))
            now = time.monotonic()
            for job, res in zip(live, results):
                nonce, trials = res
                if job.job_id is not None:
                    self._journal_call(
                        lambda j=job.job_id: self.journal.complete(j),
                        site="pow.journal.complete")
                self.scheduler.note_solved(job)
                JOBS.labels(lane=job.lane, outcome="solved").inc()
                LIFECYCLE.record(job.initial_hash, "pow_solved")
                self._remember(job.key, nonce, trials)
                self._by_key.pop(job.key, None)
                await self._send_result(job, ResultMsg(
                    0, ST_OK, nonce, trials,
                    queue_wait_ms=int((now - job.enqueued) * 1e3),
                    solve_ms=int(dt * 1e3)))

    def _remember(self, key, nonce: int, trials: int) -> None:
        self._recent[key] = (nonce, trials)
        self._recent.move_to_end(key)
        while len(self._recent) > self.RECENT_RESULTS:
            self._recent.popitem(last=False)

    async def _settle_expired(self, batch: list[FarmJob]
                              ) -> list[FarmJob]:
        """Jobs whose client deadline passed while queued: a terminal
        ``expired`` RESULT, journal row removed (the client gave up —
        re-solving it at restart would be wasted capacity)."""
        now = time.monotonic()
        live = []
        for job in batch:
            if job.deadline is not None and now > job.deadline:
                JOBS.labels(lane=job.lane, outcome="expired").inc()
                if job.job_id is not None:
                    self._journal_call(
                        lambda j=job.job_id: self.journal.complete(j),
                        site="pow.journal.complete")
                self._by_key.pop(job.key, None)
                await self._send_result(job, ResultMsg(
                    0, ST_EXPIRED,
                    queue_wait_ms=int((now - job.enqueued) * 1e3),
                    detail="deadline passed in queue"))
            else:
                live.append(job)
        return live

    def _settle_interrupted(self, batch: list[FarmJob]) -> None:
        REQUEUES.labels(reason="interrupt").inc(len(batch))
        _flight("farm_requeue", reason="interrupt", n=len(batch))
        for job in batch:
            if job.job_id is not None:
                self._journal_call(
                    lambda j=job.job_id: self.journal.requeue(j),
                    site="pow.journal.requeue")

    async def _requeue_failed(self, batch: list[FarmJob],
                              exc: Exception) -> None:
        """A dispatch failure must never lose an accepted job: the
        batch goes back at the FRONT of its lanes (drain position
        kept) with backoff; exhausted jobs surface an error RESULT to
        their clients but STAY journaled for the next process."""
        ERRORS.labels(site="farm.dispatch").inc()
        survivors = []
        for job in batch:
            job.attempts += 1
            if job.job_id is not None:
                self._journal_call(
                    lambda j=job.job_id: self.journal.requeue(j),
                    site="pow.journal.requeue")
            if job.attempts >= self.max_attempts:
                JOBS.labels(lane=job.lane, outcome="error").inc()
                self._by_key.pop(job.key, None)
                logger.error(
                    "farm job for tenant %s failed %d attempts; "
                    "surfacing the error (job stays journaled)",
                    job.tenant, job.attempts)
                await self._send_result(job, ResultMsg(
                    0, ST_ERROR, detail=repr(exc)[:150]))
            else:
                survivors.append(job)
        if not survivors:
            return
        REQUEUES.labels(reason="failure").inc(len(survivors))
        _flight("farm_requeue", reason="failure", n=len(survivors),
                error=repr(exc)[:120])
        pause = self.retry.delay(min(j.attempts for j in survivors) - 1)
        logger.warning(
            "farm dispatch failed (%r); requeueing %d job(s) after "
            "%.2fs backoff", exc, len(survivors), pause)
        try:
            await asyncio.sleep(pause)
        except asyncio.CancelledError:
            self._settle_interrupted(survivors)
            raise
        for job in reversed(survivors):
            self.scheduler.push(job, front=True)
        self._wake.set()

    async def _send_result(self, job: FarmJob, base: ResultMsg) -> None:
        """Deliver one terminal result to every attached client ref.
        A failed send is counted and dropped — the nonce stays in the
        recent cache, and the client's local-fallback requeue (or its
        re-submission on reconnect) recovers it without re-solving."""
        for conn_id, job_ref in job.refs:
            writer = self._writers.get(conn_id)
            if writer is None:
                continue
            try:
                inject("farm.result")
                base.job_ref = job_ref
                writer.write(pack_frame(MSG_RESULT, base.encode()))
                await writer.drain()
            except Exception as exc:
                ERRORS.labels(site="farm.result").inc()
                logger.warning(
                    "farm result send to client failed (%r); the "
                    "client's local fallback covers the job", exc)
        job.refs = []

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """clientStatus ``farm`` block (docs/pow_farm.md)."""
        return {
            "listen": ("%s:%s" % (self.host, self.listen_port)
                       if self.listen_port else None),
            "authRequired": self.auth_required,
            "connections": len(self._writers),
            "pendingJobs": len(self._by_key),
            "recentResults": len(self._recent),
            "adoptCollisions": int(ADOPT_COLLISIONS.value),
            "scheduler": self.scheduler.snapshot(),
        }
