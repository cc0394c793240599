"""Runtime health probes: loop lag, worker saturation, health block
(twin of ``pybitmessage_tpu.observability.health``).

:class:`LoopLagProbe` sleeps ``interval`` seconds on the event loop and
feeds how late it woke into the ``event_loop_lag_seconds`` histogram -
the single most diagnostic number for "the node feels stuck" (crypto or
SQL leaked onto the loop, a flood starved it, the process is swapping).

:class:`HealthMonitor` owns the probe plus a slow sampling tick that
refreshes saturation gauges (crypto-pool backlog, ingest-worker
occupancy) and serves the composite per-subsystem ``health`` block
``clientStatus`` exposes: each subsystem reports ``ok`` or ``degraded``
with the reading that tripped it.

A lag sample above ``culprit_threshold`` asks the sampling profiler
(``profiling.py``) which site held the loop during the late tick; the
site is counted into ``event_loop_slow_callback_total{site}``, dropped
as a flight-recorder breadcrumb and shown as the health block's
``lastSlowCallback``.  The block carries ``loop``, ``role``, ``pow``,
``ingest``, ``storage``, ``sync`` (with a reconciler: sessions with an
open breaker are degraded peers) and, with the light-client tier, ``clients`` (an edge's plane) and
``lightClient`` (a client's link), as the JAX block does for such a
node; ``role`` judges an edge's replica-set coverage and reports a
relay's edges, epoch and forwarded streams.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque

from .metrics import REGISTRY

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

LOOP_LAG = REGISTRY.histogram(
    "event_loop_lag_seconds",
    "How late the health sampler's sleep woke up — event-loop "
    "scheduling delay (always-on promotion of the bench probe)")
LOOP_LAG_MAX = REGISTRY.gauge(
    "event_loop_lag_max_seconds",
    "Worst loop lag observed since process start")
CRYPTO_SATURATION = REGISTRY.gauge(
    "crypto_pool_saturation",
    "Queued crypto-pool work items per worker thread (0 = idle)")
INGEST_SATURATION = REGISTRY.gauge(
    "ingest_worker_saturation",
    "Fraction of ingest pipeline workers mid-object (1.0 = all busy)")

#: default probe cadence, seconds - coarse enough to cost nothing,
#: fine enough that a multi-second stall is caught within one tick
DEFAULT_INTERVAL = 0.25

#: loop-lag threshold above which the loop subsystem reports degraded
#: (same budget the ingest bench asserts)
LAG_DEGRADED_SECONDS = 0.05


class LoopLagProbe:
    """Asyncio task measuring event-loop scheduling delay.

    ``await asyncio.sleep(interval)`` should resume ``interval``
    seconds later; any excess is time the loop spent running other
    callbacks (or blocked in C) - the lag.

    A lag sample above ``culprit_threshold`` is attributed: the probe
    asks the sampling profiler which site dominated the event-loop
    thread during the late window and counts it into
    ``event_loop_slow_callback_total{site}`` with a flight-recorder
    breadcrumb (without the sampler running the number stays bare).
    """

    #: samples kept for the live-state window (~1 min at the default
    #: cadence) - the health verdict must reflect the loop NOW, not a
    #: since-start histogram a day of healthy samples has diluted
    WINDOW = 240

    def __init__(self, interval: float = DEFAULT_INTERVAL, *,
                 histogram=LOOP_LAG,
                 culprit_threshold: float = LAG_DEGRADED_SECONDS):
        self.interval = interval
        self.histogram = histogram
        self.culprit_threshold = culprit_threshold
        self.max_lag = 0.0
        #: the most recently attributed spike, (site, lag, wall time);
        #: aged out of the health block after CULPRIT_TTL
        self.last_culprit: tuple[str, float, float] | None = None
        self.recent: deque = deque(maxlen=self.WINDOW)
        self._task: asyncio.Task | None = None

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            lag = max(loop.time() - t0 - self.interval, 0.0)
            self.recent.append(lag)
            if self.histogram is not None:
                self.histogram.observe(lag)
            if lag > self.max_lag:
                self.max_lag = lag
                LOOP_LAG_MAX.set(lag)
            if lag >= self.culprit_threshold:
                self._attribute(lag)

    #: seconds after which an attributed culprit stops being shown
    CULPRIT_TTL = 900.0

    def _attribute(self, lag: float) -> None:
        """Name the callback that held the loop (never raises)."""
        try:
            from .profiling import PROFILER, note_slow_callback
            site = PROFILER.loop_culprit(lag + self.interval)
            if site is not None:
                self.last_culprit = (site, lag, time.time())
                note_slow_callback(site, lag)
        except Exception:
            logger.debug("slow-callback attribution failed",
                         exc_info=True)

    def recent_culprit(self) -> tuple[str, float] | None:
        """(site, lag) of the last attributed spike, or None once it
        has aged past :data:`CULPRIT_TTL`."""
        if self.last_culprit is None:
            return None
        site, lag, t = self.last_culprit
        if time.time() - t > self.CULPRIT_TTL:
            return None
        return site, lag

    def recent_p99(self) -> float:
        """p99 over the recent window (0.0 with no samples yet)."""
        if not self.recent:
            return 0.0
        lags = sorted(self.recent)
        return lags[min(int(0.99 * len(lags)), len(lags) - 1)]

    def start(self) -> asyncio.Task:
        self._task = asyncio.create_task(self.run())
        return self._task

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


class HealthMonitor:
    """Always-on probes + the composite clientStatus health block."""

    def __init__(self, node=None, *, lag_interval: float = DEFAULT_INTERVAL,
                 sample_interval: float = 5.0):
        self.node = node
        self.probe = LoopLagProbe(lag_interval)
        self.sample_interval = sample_interval
        self._tasks: list[asyncio.Task] = []

    def start(self) -> None:
        self._tasks = [self.probe.start(),
                       asyncio.create_task(self._sample_loop())]

    async def stop(self) -> None:
        await self.probe.stop()
        for t in self._tasks[1:]:
            t.cancel()
        if self._tasks[1:]:
            await asyncio.gather(*self._tasks[1:], return_exceptions=True)
        self._tasks = []

    # -- sampling ------------------------------------------------------------

    async def _sample_loop(self) -> None:
        while True:
            await asyncio.sleep(self.sample_interval)
            try:
                self.sample()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.debug("health sample failed", exc_info=True)

    def sample(self) -> None:
        """Refresh the saturation gauges from live node state."""
        node = self.node
        if node is None:
            return
        proc = getattr(node, "processor", None)
        if proc is not None:
            workers = max(getattr(proc, "concurrency", 1), 1)
            INGEST_SATURATION.set(
                min(getattr(proc, "active", 0) / workers, 1.0))
            pool = getattr(proc, "crypto", None)
            if pool is not None:
                CRYPTO_SATURATION.set(_crypto_backlog_per_worker(pool))

    # -- the composite block -------------------------------------------------

    def health_block(self) -> dict:
        """Per-subsystem health for ``clientStatus``."""
        node = self.node
        out: dict = {}

        # windowed, not the since-start histogram: the verdict must
        # flip when the loop wedges NOW, not 15 minutes later
        lag_p99 = self.probe.recent_p99()
        culprit = self.probe.recent_culprit()
        out["loop"] = _verdict(
            lag_p99 <= LAG_DEGRADED_SECONDS,
            lagP99Ms=round(lag_p99 * 1e3, 2),
            lagMaxMs=round(self.probe.max_lag * 1e3, 2),
            # the profiler-attributed site of the most recent
            # above-threshold lag spike ("" until one crossed the
            # threshold with the sampler running, and again once the
            # attribution ages past the probe's TTL)
            lastSlowCallback=culprit[0] if culprit else "")

        if node is None:
            return out

        # role identity + IPC hand-off health
        runtime = getattr(node, "role_runtime", None)
        ipc_ok, ipc_detail = True, {}
        if runtime is not None:
            snap = runtime.snapshot()
            links = snap.get("links")
            if links is not None:      # edge: replica-set coverage
                # a down link is not degraded by itself: its replica
                # siblings absorb the traffic; the edge is degraded when
                # some stream has no member above the "down" rung left
                rsets = snap.get("replicaSets", {})
                uncovered = [s for s, members in rsets.items()
                             if not any(m["health"] > 0
                                        for m in members)]
                ipc_ok = not uncovered if rsets else \
                    all(lk["connected"] and not lk["breakerOpen"]
                        for lk in links)
                ipc_detail = {"links": len(links),
                              "outbox": sum(lk["outbox"] + lk["unacked"]
                                            for lk in links),
                              "uncoveredStreams": uncovered,
                              "shardEpochs": {lk["relay"]: lk["epoch"]
                                              for lk in links}}
            else:                      # relay: connected edge count
                ipc_detail = {"edges": len(snap.get("edges", ())),
                              "shardEpoch": snap.get("epoch", 0),
                              "forwardingStreams":
                                  sorted(snap.get("forwarding", ()))}
        out["role"] = _verdict(
            ipc_ok, name=getattr(node, "role", "all"),
            streams=list(getattr(getattr(node, "ctx", None),
                                 "streams", ())),
            **ipc_detail)

        # pow: queue depth + any open breaker
        from ..resilience.policy import BREAKERS
        open_breakers = [n for n, b in BREAKERS.items()
                         if not b.available()]
        depth = int(REGISTRY.sample("pow_queue_depth"))
        out["pow"] = _verdict(
            not open_breakers,
            queueDepth=depth, openBreakers=open_breakers)

        # ingest: queue depth vs watermark, worker saturation
        queue = getattr(getattr(node, "ctx", None), "object_queue", None)
        paused = bool(getattr(queue, "paused", False))
        out["ingest"] = _verdict(
            not paused,
            queueDepth=queue.qsize() if queue is not None else 0,
            paused=paused,
            workerSaturation=round(INGEST_SATURATION.value, 3),
            cryptoBacklog=round(CRYPTO_SATURATION.value, 2))

        # storage: write-behind backlog (direct stores report 0)
        wb = getattr(getattr(node, "processor", None), "_wb", None)
        pending = wb.pending_rows() if wb is not None else 0
        out["storage"] = _verdict(
            wb is None or pending < wb.max_rows, pendingRows=pending)

        # sync: sessions with an open breaker are degraded peers
        recon = getattr(node, "reconciler", None)
        if recon is not None:
            snap = recon.snapshot_state()
            out["sync"] = _verdict(
                snap["breakersOpen"] == 0, **snap)

        # light-client tier: a plane whose sessions keep overflowing is
        # deferring pushes into FETCH repair; a light client that cannot
        # hold its edge link is degraded
        plane = getattr(node, "client_plane", None)
        if plane is not None:
            snap = plane.snapshot()
            pushed = max(snap["pushed"], 1)
            out["clients"] = _verdict(
                snap["overflowed"] < pushed,
                sessions=snap["sessions"],
                subscriptions=snap["index"]["memberships"],
                epoch=snap["index"]["epoch"],
                overflowed=snap["overflowed"])
        light = getattr(node, "light_client", None)
        if light is not None:
            snap = light.snapshot()
            out["lightClient"] = _verdict(
                snap["connected"], **{k: snap[k] for k in
                                      ("edge", "connects", "epoch",
                                       "subscribedBuckets", "objects")})
        return out


def _verdict(ok: bool, **detail) -> dict:
    return {"status": "ok" if ok else "degraded", **detail}


def _crypto_backlog_per_worker(pool) -> float:
    """Queued work per crypto worker; inline pools (size=0) read 0."""
    size = max(getattr(pool, "size", 0), 0)
    ex = getattr(pool, "_exec", None)
    if not size or ex is None:
        return 0.0
    try:
        return ex._work_queue.qsize() / size
    except Exception:  # pragma: no cover - executor internals moved
        return 0.0
