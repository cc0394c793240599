"""Per-object lifecycle tracing keyed by inventory hash (twin of
``pybitmessage_tpu.observability.lifecycle``).

A Dapper-style event timeline follows each object end to end —
``received -> parsed -> decrypted -> verified -> stored`` plus the
relay-side stages ``announced`` / ``sync_pushed`` and the terminal
``delivered`` — recorded from one-line hooks in the network pool, the
object processor, the write-behind store, the PoW service and the sync
reconciler.  Locally-generated objects additionally carry
``pow_queued -> pow_solved``.

Two metric families fall out of the timelines:

- ``object_stage_seconds{from,to}`` — stage-to-stage latency
  histograms (the label pair is bounded by the stage vocabulary, far
  under the registry cardinality guard);
- ``object_propagation_seconds`` — first-appearance to delivery
  latency.  ``sync/mesh.py`` instantiates its own tracer with the
  simulated tick clock and reports p50/p90/p99 from it.

Retention is bounded: timelines live in an LRU keyed by hash
(``maxlen`` objects, oldest evicted) and each timeline holds at most
``MAX_EVENTS`` events — a hostile or looping stage can never grow
memory without bound.  ``record()`` never raises; it is called from
the ingest hot path, where telemetry failures must stay invisible.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque

from .metrics import REGISTRY

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

#: canonical stage vocabulary (free-form stages are accepted — the
#: registry guard bounds any abuse — but these are the documented ones)
STAGES = ("received", "parsed", "decrypted", "verified", "stored",
          "announced", "sync_pushed", "delivered",
          "pow_queued", "pow_solved")

STAGE_SECONDS = REGISTRY.histogram(
    "object_stage_seconds",
    "Stage-to-stage latency along one object's lifecycle timeline",
    ("from", "to"))
PROPAGATION_SECONDS = REGISTRY.histogram(
    "object_propagation_seconds",
    "First appearance (origin) to delivery at another node — the "
    "cross-node propagation latency the scenario lab reports")
TRACKED = REGISTRY.gauge(
    "lifecycle_tracked_objects",
    "Object timelines currently retained by the lifecycle tracer")
EVICTED = REGISTRY.counter(
    "lifecycle_evicted_total",
    "Timelines evicted by the LRU retention bound")


class LifecycleTracer:
    """Bounded per-object event timelines.

    ``clock`` is injectable (the simulated mesh runs on ticks); pass
    an explicit ``t`` per event to mix clocks.  ``enabled=False``
    turns every hook into one attribute read.
    """

    #: events kept per timeline — a stage recorded in a loop must not
    #: grow one object's history unboundedly
    MAX_EVENTS = 64

    def __init__(self, maxlen: int = 4096, *, clock=time.monotonic,
                 stage_histogram=STAGE_SECONDS,
                 propagation_histogram=PROPAGATION_SECONDS,
                 update_gauge: bool = True):
        self.enabled = True
        self.maxlen = max(1, maxlen)
        self.clock = clock
        self._stage_hist = stage_histogram
        self._prop_hist = propagation_histogram
        self._update_gauge = update_gauge
        self._lock = threading.Lock()
        #: hash -> list[(stage, t)] in arrival order (LRU by insertion)
        self._timelines: "OrderedDict[bytes, list]" = OrderedDict()
        #: hash -> wire-trace metadata {trace_id, span, parent_span} —
        #: populated lazily (only traced objects pay for it), evicted
        #: alongside the timeline
        self._trace_meta: dict[bytes, dict] = {}
        #: incremental per-stage event counts over retained timelines —
        #: snapshot() must be O(stages), not a full scan under the
        #: hot-path lock
        self._stage_counts: dict[str, int] = {}
        #: recent propagation deltas for local percentile reporting
        #: (bench) — the histogram keeps the exported view
        self._prop_deltas: deque = deque(maxlen=4096)

    # -- recording (hot path: must never raise) ------------------------------

    def record(self, h, stage: str, t: float | None = None) -> None:
        """Append one stage event to ``h``'s timeline and feed the
        stage-to-stage latency histogram."""
        if not self.enabled or h is None:
            return
        try:
            if t is None:
                t = self.clock()
            with self._lock:
                timeline = self._timelines.get(h)
                if timeline is None:
                    while len(self._timelines) >= self.maxlen:
                        old_h, old = self._timelines.popitem(last=False)
                        self._uncount(old)
                        self._trace_meta.pop(old_h, None)
                        EVICTED.inc()
                    timeline = self._timelines[h] = []
                prev = timeline[-1] if timeline else None
                appended = len(timeline) < self.MAX_EVENTS
                if appended:
                    timeline.append((stage, t))
                    self._stage_counts[stage] = \
                        self._stage_counts.get(stage, 0) + 1
                if self._update_gauge:
                    TRACKED.set(len(self._timelines))
            # latency only for events that actually entered the
            # timeline: past the cap, prev is a permanently stale
            # event and the delta would grow without bound
            if appended and prev is not None and \
                    self._stage_hist is not None:
                self._stage_hist.labels(
                    **{"from": prev[0], "to": stage}).observe(
                    max(t - prev[1], 0.0))
        except Exception:  # pragma: no cover — telemetry must not
            # kill the ingest path it observes
            logger.debug("lifecycle record failed", exc_info=True)

    def observe_propagation(self, h, t: float | None = None
                            ) -> float | None:
        """Delivery of ``h`` somewhere other than its origin: observe
        the latency since its FIRST recorded event.  Returns the delta
        (None when the origin event was never seen / already evicted).
        """
        if not self.enabled or h is None:
            return None
        try:
            if t is None:
                t = self.clock()
            with self._lock:
                timeline = self._timelines.get(h)
                if not timeline:
                    return None
                delta = max(t - timeline[0][1], 0.0)
            self._prop_deltas.append(delta)
            if self._prop_hist is not None:
                self._prop_hist.observe(delta)
            return delta
        except Exception:  # pragma: no cover
            return None

    # -- inspection ----------------------------------------------------------

    def timeline(self, h) -> list[dict]:
        """The recorded events of one object, oldest first."""
        with self._lock:
            events = list(self._timelines.get(h, ()))
        return [{"stage": s, "t": t} for s, t in events]

    def first_seen(self, h) -> float | None:
        with self._lock:
            timeline = self._timelines.get(h)
            return timeline[0][1] if timeline else None

    def tracked(self) -> int:
        with self._lock:
            return len(self._timelines)

    def discard(self, h) -> None:
        with self._lock:
            timeline = self._timelines.pop(h, None)
            self._trace_meta.pop(h, None)
            if timeline is not None:
                self._uncount(timeline)
                if self._update_gauge:
                    TRACKED.set(len(self._timelines))

    # -- wire trace stitching (distributed observability plane) --------------

    def adopt(self, h, trace_id: bytes, parent_span: int = 0) -> None:
        """Bind ``h`` to a trace that originated on ANOTHER node: the
        object arrived with a wire trace context, so this node's
        timeline joins the sender's trace instead of opening a new one.
        First writer wins — an object's origin trace is never
        overwritten by a later duplicate push.  Never raises."""
        if not self.enabled or h is None:
            return
        try:
            with self._lock:
                meta = self._trace_meta.get(h)
                if meta is None:
                    from .tracing import new_span_id
                    self._bound_trace_meta()
                    self._trace_meta[h] = {
                        "trace_id": bytes(trace_id),
                        "span": new_span_id(),
                        "parent_span": int(parent_span)}
        except Exception:  # pragma: no cover — telemetry never kills
            logger.debug("lifecycle adopt failed", exc_info=True)

    def trace_ctx_for(self, h):
        """The :class:`~.tracing.TraceContext` to attach when pushing
        ``h`` to a NODE_TRACE peer: the object's adopted trace id (a
        fresh one if this node is the origin) with THIS node's span as
        the receiver's parent.  Returns None only on internal failure
        (the push then simply goes untraced)."""
        if h is None:
            return None
        try:
            from .tracing import TraceContext, new_span_id, new_trace_id
            with self._lock:
                meta = self._trace_meta.get(h)
                if meta is None:
                    self._bound_trace_meta()
                    meta = self._trace_meta[h] = {
                        "trace_id": new_trace_id(),
                        "span": new_span_id(),
                        "parent_span": 0}
            return TraceContext(meta["trace_id"], meta["span"])
        except Exception:  # pragma: no cover
            logger.debug("lifecycle trace_ctx_for failed", exc_info=True)
            return None

    def _bound_trace_meta(self) -> None:
        # caller holds the lock.  Metadata normally dies with its
        # timeline's eviction, but trace_ctx_for can mint entries for
        # hashes that never grow one — cap those independently.
        while len(self._trace_meta) >= 2 * self.maxlen:
            self._trace_meta.pop(next(iter(self._trace_meta)))

    def trace_meta(self, h) -> dict | None:
        """The stitching metadata of one object (None when untraced)."""
        with self._lock:
            meta = self._trace_meta.get(h)
            return dict(meta) if meta is not None else None

    def _uncount(self, timeline) -> None:
        # caller holds the lock
        for stage, _ in timeline:
            n = self._stage_counts.get(stage, 0) - 1
            if n > 0:
                self._stage_counts[stage] = n
            else:
                self._stage_counts.pop(stage, None)

    def propagation_percentiles(self) -> dict | None:
        """p50/p90/p99 over the recent propagation-delta window (same
        clock units the tracer runs on) — bench/clientStatus helper."""
        deltas = sorted(self._prop_deltas)
        if not deltas:
            return None

        def q(p: float) -> float:
            return deltas[min(int(p * len(deltas)), len(deltas) - 1)]

        return {"count": len(deltas), "p50": q(0.50),
                "p90": q(0.90), "p99": q(0.99)}

    def snapshot(self) -> dict:
        """clientStatus-style summary: retention + per-stage counts.
        O(stages) — the counts are maintained incrementally so a
        monitoring poll never scans every timeline under the hot-path
        lock."""
        with self._lock:
            counts = dict(self._stage_counts)
            tracked = len(self._timelines)
        out = {"tracked": tracked, "stageEvents": counts}
        prop = self.propagation_percentiles()
        if prop is not None:
            out["propagation"] = prop
        return out


#: the process-wide tracer every node-side hook records into
LIFECYCLE = LifecycleTracer()
