"""Metrics federation: per-node snapshot push + fleet-wide aggregation
(copy of ``pybitmessage_tpu.observability.federation``).

Without this module every observability surface is process-local:
``REGISTRY`` describes one node, and a multi-process deployment (the
solver-farm service, the edge/relay role split, the simulated mesh's
nodes) is invisible as a fleet.  This module closes that gap with two
halves:

- :class:`FederationPublisher` — owned by each child process / peer /
  simulated node: periodically serializes its registry into a
  **versioned, delta-encoded** snapshot push (only series that changed
  since the last acknowledged push travel; the first push — and any
  push after the aggregator asks for a resync — is full) and hands it
  to a transport.  Transports are plain callables: the in-process
  aggregator's ``ingest`` (mesh lab, same-process roles), or
  :func:`http_transport` POSTing to a parent node's API port
  (``/federation/push``, same basic auth as RPC) for real
  multi-process topologies.

- :class:`Aggregator` — owned by the parent node: validates the push
  (version mismatches and over-capacity nodes are REJECTED and
  counted, never half-merged), stores the latest per-node series
  values, and merges them fleet-wide — counters and gauges sum,
  histograms merge **bucket-wise** (identical bucket bounds required;
  a mismatch rejects that series, not the push).  The merged view is
  served as ``GET /metrics/federated`` (Prometheus text) and the
  ``federatedStatus`` API command (per-node health verdicts from
  ``observability/health.py`` blocks carried on each push, last-push
  age, clock-skew estimates, staleness).

Per-tenant counters pushed from farm workers merge into one
billing/fairness view exactly like any other family.

Wire/JSON push format (``FEDERATION_VERSION`` 1)::

    {"v": 1, "node": "<id>", "seq": N, "t": <wall>, "full": bool,
     "skew": <remote-minus-local seconds | null>,
     "health": {<subsystem>: {"status": "ok"|"degraded", ...}},
     "metrics": {name: {"type": "counter"|"gauge"|"histogram",
                        "labels": [...],
                        "buckets": [...],          # histograms only
                        "series": [{"l": {...}, "v": x}            # c/g
                                   | {"l": {...}, "c": [...],
                                      "s": sum, "n": count}]}}}    # hist
"""

from __future__ import annotations

import json
import logging
import threading
import time

from .metrics import REGISTRY, Histogram, Registry, _fmt, _labels_suffix

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

#: bump on any incompatible change to the push format — the aggregator
#: refuses mismatched pushes outright (a half-understood snapshot
#: would corrupt the merged view silently)
FEDERATION_VERSION = 1

PUSHES = REGISTRY.counter(
    "federation_pushes_total",
    "Snapshot pushes leaving this process, by result",
    ("result",))
PUSH_BYTES = REGISTRY.counter(
    "federation_push_bytes_total",
    "Serialized snapshot bytes pushed (delta-encoded)")
INGESTED = REGISTRY.counter(
    "federation_ingested_total",
    "Snapshot pushes accepted by the local aggregator")
REJECTED = REGISTRY.counter(
    "federation_rejected_total",
    "Snapshot pushes/series refused by the aggregator, by reason "
    "(version/malformed/capacity/buckets)", ("reason",))
NODES = REGISTRY.gauge(
    "federation_nodes",
    "Nodes currently known to the local aggregator (incl. stale)")
MERGE_SECONDS = REGISTRY.histogram(
    "federation_merge_seconds",
    "Time to ingest one push into the per-node store")


# -- mergeable snapshots -----------------------------------------------------

def mergeable_snapshot(registry: Registry | None = None) -> dict:
    """The full registry in the push's ``metrics`` shape — unlike
    ``export.snapshot()`` (percentiles for humans), this carries raw
    bucket counts so histograms can merge bucket-wise downstream."""
    out: dict = {}
    for fam in (registry or REGISTRY).families():
        entry: dict = {"type": fam.kind,
                       "labels": list(fam.labelnames), "series": []}
        if isinstance(fam, Histogram):
            entry["buckets"] = list(fam._bounds)
        for values, child in fam.children():
            labels = dict(zip(fam.labelnames, values))
            if isinstance(fam, Histogram):
                counts, total_sum, total = child.snapshot()
                entry["series"].append(
                    {"l": labels, "c": counts, "s": total_sum,
                     "n": total})
            else:
                entry["series"].append({"l": labels, "v": child.value})
        out[fam.name] = entry
    return out


def _series_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def delta_snapshot(full: dict, prev: dict | None) -> dict:
    """Only the families/series of ``full`` that changed vs ``prev``
    (the last ACKNOWLEDGED full snapshot).  Values are absolute, so
    applying a delta is plain replacement — idempotent and safe to
    re-send."""
    if not prev:
        return full
    out: dict = {}
    for name, entry in full.items():
        prev_entry = prev.get(name)
        if prev_entry is None:
            out[name] = entry
            continue
        prev_series = {_series_key(s["l"]): s
                       for s in prev_entry["series"]}
        changed = [s for s in entry["series"]
                   if prev_series.get(_series_key(s["l"])) != s]
        if changed:
            out[name] = dict(entry, series=changed)
    return out


def _merged_percentile(bounds: list, counts: list, q: float) -> float:
    """histogram_quantile() over merged bucket counts (mirrors
    ``_HistogramChild.percentile``)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            return lo + (hi - lo) * (rank - prev_cum) / c
    return bounds[-1] if bounds else 0.0


# -- the publisher (child side) ----------------------------------------------

class FederationPublisher:
    """Periodic delta-encoded snapshot push from one process/node.

    ``transport`` is a callable (sync or async) taking the push dict
    and returning the aggregator's ack dict; ``health`` and ``skew``
    are optional callables sampled per push (the node wires its
    ``HealthMonitor.health_block`` and its wire-trace skew mean).
    ``push_once()`` is synchronous so the simulated mesh (and tests)
    can drive the REAL path without an event loop; ``run()`` wraps it
    in the periodic asyncio task a live node uses.
    """

    def __init__(self, node_id: str, registry: Registry | None = None,
                 *, transport=None, interval: float = 10.0,
                 health=None, skew=None, count_bytes: bool = True):
        self.node_id = node_id
        self.registry = registry or REGISTRY
        self.transport = transport
        self.interval = interval
        self.health = health
        self.skew = skew
        #: serialize-and-measure each push for federation_push_bytes —
        #: true wire accounting, but a pure-overhead json.dumps for
        #: IN-PROCESS transports (the mesh lab turns it off: there are
        #: no wire bytes to account for)
        self.count_bytes = count_bytes
        self.seq = 0
        #: last snapshot the aggregator acknowledged (delta base)
        self._acked: dict | None = None
        self._task = None

    def build_push(self) -> tuple[dict, dict]:
        """(push, full_snapshot) — the push is a delta against the last
        acknowledged snapshot (full on first push / after a resync)."""
        full = mergeable_snapshot(self.registry)
        is_full = self._acked is None
        metrics = full if is_full else delta_snapshot(full, self._acked)
        self.seq += 1
        push = {"v": FEDERATION_VERSION, "node": self.node_id,
                "seq": self.seq, "t": time.time(), "full": is_full,
                "skew": self._sample(self.skew),
                "health": self._sample(self.health) or {},
                "metrics": metrics}
        return push, full

    def _sample(self, fn):
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            logger.debug("federation sampler failed", exc_info=True)
            return None

    def push_once(self) -> dict | None:
        """Build and send one push through a SYNC transport; returns
        the ack (None on failure — the next push re-deltas or resyncs)."""
        if self.transport is None:
            return None
        push, full = self.build_push()
        try:
            if self.count_bytes:
                PUSH_BYTES.inc(len(json.dumps(push)))
            ack = self.transport(push)
        except Exception:
            PUSHES.labels(result="error").inc()
            logger.debug("federation push failed", exc_info=True)
            return None
        return self._settle(ack, full)

    async def push_once_async(self) -> dict | None:
        """`push_once` for async transports (the HTTP pusher)."""
        import inspect
        if self.transport is None:
            return None
        push, full = self.build_push()
        try:
            if self.count_bytes:
                PUSH_BYTES.inc(len(json.dumps(push)))
            ack = self.transport(push)
            if inspect.isawaitable(ack):
                ack = await ack
        except Exception:
            PUSHES.labels(result="error").inc()
            logger.debug("federation push failed", exc_info=True)
            return None
        return self._settle(ack, full)

    def _settle(self, ack, full: dict) -> dict | None:
        if not isinstance(ack, dict) or not ack.get("ok"):
            reason = (ack or {}).get("reason", "error") \
                if isinstance(ack, dict) else "error"
            # the reason string comes from the REMOTE aggregator — clamp
            # to the known ack vocabulary (Aggregator.ingest) so a
            # buggy/hostile peer cannot mint unbounded label values
            if reason not in ("version", "resync", "malformed",
                              "capacity", "buckets", "error"):
                reason = "other"
            PUSHES.labels(result=reason).inc()
            # resync: the aggregator lost (or never had) our state —
            # the next push must be full or its merged view would miss
            # every series that happens not to change again
            self._acked = None
            return ack if isinstance(ack, dict) else None
        PUSHES.labels(result="ok").inc()
        self._acked = full
        return ack

    def start(self):
        import asyncio
        self._task = asyncio.create_task(self.run())
        return self._task

    async def run(self) -> None:
        import asyncio
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self.push_once_async()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.debug("federation push loop error", exc_info=True)

    async def stop(self) -> None:
        import asyncio
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


def http_transport(host: str, port: int, *, username: str = "",
                   password: str = "", timeout: float = 10.0):
    """An async transport POSTing pushes to a parent node's API port
    (``POST /federation/push``, HTTP basic auth) — zero-dependency,
    plain asyncio streams like the rest of the stack."""
    import asyncio
    import base64

    auth = ""
    if username or password:
        auth = base64.b64encode(
            ("%s:%s" % (username, password)).encode()).decode()

    async def send(push: dict) -> dict:
        body = json.dumps(push).encode("utf-8")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
        try:
            head = ("POST /federation/push HTTP/1.1\r\n"
                    "Content-Type: application/json\r\n"
                    "Content-Length: %d\r\n" % len(body))
            if auth:
                head += "Authorization: Basic %s\r\n" % auth
            head += "Connection: close\r\n\r\n"
            writer.write(head.encode("latin-1") + body)
            await writer.drain()
            response = await asyncio.wait_for(reader.read(), timeout)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception as exc:
                logger.debug("federation transport close failed: %r",
                             exc)
        _, _, resp_body = response.partition(b"\r\n\r\n")
        return json.loads(resp_body or b"{}")

    return send


# -- the aggregator (parent side) --------------------------------------------

class Aggregator:
    """Fleet-wide merge of per-node snapshot pushes.

    Thread-safe (the API server ingests from asyncio while bench/tests
    read merged views).  Per node it keeps the latest absolute value of
    every series ever pushed; ``merged()`` folds them together —
    counters/gauges sum, histograms merge bucket-wise.
    """

    def __init__(self, *, expiry: float = 90.0, max_nodes: int = 4096,
                 evict_after: float | None = None, clock=time.time):
        #: seconds without a push before a node reports stale
        self.expiry = expiry
        self.max_nodes = max_nodes
        #: seconds without a push before a node is DROPPED from the
        #: store entirely (its gauges leave the merged view and its
        #: slot frees up).  Restarted children re-register under a
        #: fresh node id, so without eviction every restart would
        #: leave a ghost merging its last values forever and
        #: eventually exhaust ``max_nodes``.
        if evict_after is None:
            evict_after = expiry * 10 if expiry is not None else None
        self.evict_after = evict_after
        self.clock = clock
        self._lock = threading.Lock()
        #: node_id -> {"seq", "t", "skew", "health", "metrics":
        #:             {name: {"type","labels","buckets","series":
        #:                     {key: series-dict}}}}
        self._nodes: dict[str, dict] = {}

    # -- ingest --------------------------------------------------------------

    def ingest(self, push: dict) -> dict:
        """Validate + merge one push; returns the ack dict the
        publisher consumes.  Never raises on bad input — a malformed
        child must not take down the aggregator."""
        t0 = time.monotonic()
        try:
            return self._ingest(push)
        except Exception:
            REJECTED.labels(reason="malformed").inc()
            logger.debug("federation ingest failed", exc_info=True)
            return {"ok": False, "reason": "malformed"}
        finally:
            MERGE_SECONDS.observe(time.monotonic() - t0)

    def _ingest(self, push: dict) -> dict:
        if not isinstance(push, dict) or \
                push.get("v") != FEDERATION_VERSION:
            REJECTED.labels(reason="version").inc()
            return {"ok": False, "reason": "version",
                    "expected": FEDERATION_VERSION}
        node_id = str(push.get("node", ""))
        if not node_id:
            REJECTED.labels(reason="malformed").inc()
            return {"ok": False, "reason": "malformed"}
        seq = int(push.get("seq", 0))
        full = bool(push.get("full"))
        with self._lock:
            self._evict_dead()
            state = self._nodes.get(node_id)
            if state is None:
                if len(self._nodes) >= self.max_nodes:
                    REJECTED.labels(reason="capacity").inc()
                    return {"ok": False, "reason": "capacity"}
                if not full:
                    # a delta for a node we know nothing about: every
                    # unchanged series would be missing forever
                    REJECTED.labels(reason="resync").inc()
                    return {"ok": False, "reason": "resync"}
                state = self._nodes[node_id] = {"metrics": {}}
                NODES.set(len(self._nodes))
            elif not full and seq != state.get("seq", 0) + 1:
                # gap (lost push) — unchanged-series state is suspect
                REJECTED.labels(reason="resync").inc()
                return {"ok": False, "reason": "resync"}
            if full:
                state["metrics"] = {}
            # staleness is judged on the AGGREGATOR's clock — trusting
            # the child's self-reported wall time would let one broken
            # clock mark itself permanently stale (or forever fresh);
            # the child's stamp is kept for skew debugging
            state.update(seq=seq, t=self.clock(),
                         push_t=float(push.get("t") or 0.0),
                         skew=push.get("skew"),
                         health=push.get("health") or {})
            rejected_series = self._apply(state["metrics"],
                                          push.get("metrics") or {})
        INGESTED.inc()
        return {"ok": True, "seq": seq,
                "rejected_series": rejected_series}

    def _apply(self, store: dict, metrics: dict) -> int:
        """Replace stored series with the pushed absolute values;
        returns how many series were refused (bucket-bound mismatch
        against what this node previously declared)."""
        rejected = 0
        for name, entry in metrics.items():
            fam = store.get(name)
            if fam is None:
                fam = store[name] = {
                    "type": entry.get("type", "untyped"),
                    "labels": list(entry.get("labels", ())),
                    "buckets": list(entry.get("buckets", ())) or None,
                    "series": {}}
            elif fam["buckets"] is not None and entry.get("buckets") \
                    and list(entry["buckets"]) != fam["buckets"]:
                REJECTED.labels(reason="buckets").inc()
                rejected += len(entry.get("series", ()))
                continue
            for s in entry.get("series", ()):
                fam["series"][_series_key(s.get("l", {}))] = s
        return rejected

    def _evict_dead(self) -> None:
        # caller holds the lock
        if self.evict_after is None:
            return
        now = self.clock()
        dead = [nid for nid, st in self._nodes.items()
                if now - st.get("t", now) > self.evict_after]
        for nid in dead:
            del self._nodes[nid]
        if dead:
            NODES.set(len(self._nodes))

    def forget(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            NODES.set(len(self._nodes))

    # -- merged views --------------------------------------------------------

    def merged(self) -> dict:
        """Fleet-wide families: ``{name: {"type", "labels",
        "buckets", "series": [{"l", merged values...}]}}`` — counters
        and gauges summed across nodes, histogram buckets added
        element-wise.  Bucket-bound disagreement ACROSS nodes keeps
        the first-seen bounds and skips (and counts) the others."""
        with self._lock:
            self._evict_dead()
            nodes = {nid: st["metrics"] for nid, st in
                     self._nodes.items()}
            out: dict = {}
            for metrics in nodes.values():
                for name, fam in metrics.items():
                    agg = out.get(name)
                    if agg is None:
                        agg = out[name] = {
                            "type": fam["type"],
                            "labels": list(fam["labels"]),
                            "buckets": (list(fam["buckets"])
                                        if fam["buckets"] else None),
                            "series": {}}
                    elif agg["buckets"] is not None and fam["buckets"] \
                            and list(fam["buckets"]) != agg["buckets"]:
                        REJECTED.labels(reason="buckets").inc()
                        continue
                    for key, s in fam["series"].items():
                        cur = agg["series"].get(key)
                        if "c" in s:
                            if cur is None:
                                agg["series"][key] = {
                                    "l": dict(s["l"]),
                                    "c": list(s["c"]),
                                    "s": s["s"], "n": s["n"]}
                            else:
                                counts = cur["c"]
                                for i, c in enumerate(s["c"]):
                                    if i < len(counts):
                                        counts[i] += c
                                cur["s"] += s["s"]
                                cur["n"] += s["n"]
                        else:
                            if cur is None:
                                agg["series"][key] = {
                                    "l": dict(s["l"]), "v": s["v"]}
                            else:
                                cur["v"] += s["v"]
        for fam in out.values():
            fam["series"] = [fam["series"][k]
                             for k in sorted(fam["series"])]
        return out

    def merged_value(self, name: str, labels: dict | None = None) -> float:
        """One merged counter/gauge value (histograms: observation
        count); 0.0 when absent — delta-friendly like
        ``Registry.sample``."""
        fam = self.merged().get(name)
        if fam is None:
            return 0.0
        key = _series_key(labels or {})
        for s in fam["series"]:
            if _series_key(s["l"]) == key:
                return s["n"] if "c" in s else s["v"]
        return 0.0

    def merged_percentile(self, name: str, q: float,
                          labels: dict | None = None) -> float:
        """Estimated quantile of a merged histogram series."""
        fam = self.merged().get(name)
        if fam is None or not fam.get("buckets"):
            return 0.0
        key = _series_key(labels or {})
        for s in fam["series"]:
            if _series_key(s["l"]) == key and "c" in s:
                return _merged_percentile(fam["buckets"], s["c"], q)
        return 0.0

    def render(self) -> str:
        """The merged fleet view in Prometheus text exposition —
        what ``GET /metrics/federated`` serves."""
        lines: list[str] = []
        merged = self.merged()
        for name in sorted(merged):
            fam = merged[name]
            labelnames = tuple(fam["labels"])
            lines.append("# TYPE %s %s" % (name, fam["type"]))
            for s in fam["series"]:
                values = tuple(str(s["l"].get(ln, "")) for ln in labelnames)
                if "c" in s:
                    bounds = fam["buckets"] or []
                    cum = 0
                    for bound, c in zip(bounds, s["c"]):
                        cum += c
                        lines.append("%s_bucket%s %d" % (
                            name, _labels_suffix(
                                labelnames, values,
                                'le="%s"' % _fmt(bound)), cum))
                    lines.append("%s_bucket%s %d" % (
                        name, _labels_suffix(labelnames, values,
                                             'le="+Inf"'), s["n"]))
                    suffix = _labels_suffix(labelnames, values)
                    lines.append("%s_sum%s %s" % (name, suffix,
                                                  _fmt(s["s"])))
                    lines.append("%s_count%s %d" % (name, suffix,
                                                    s["n"]))
                else:
                    lines.append("%s%s %s" % (
                        name, _labels_suffix(labelnames, values),
                        _fmt(s["v"])))
        return "\n".join(lines) + "\n" if lines else ""

    # -- fleet status --------------------------------------------------------

    def status(self) -> dict:
        """The ``federatedStatus`` block: per-node last-push age, seq,
        skew, the pushed health verdicts and an overall ok/degraded/
        stale roll-up."""
        now = self.clock()
        with self._lock:
            nodes = {nid: dict(st) for nid, st in self._nodes.items()}
        out_nodes = {}
        degraded = stale = 0
        for nid, st in sorted(nodes.items()):
            age = max(now - st.get("t", 0.0), 0.0)
            health = st.get("health") or {}
            is_stale = self.expiry is not None and age > self.expiry
            is_degraded = any(
                isinstance(v, dict) and v.get("status") == "degraded"
                for v in health.values())
            verdict = ("stale" if is_stale
                       else "degraded" if is_degraded else "ok")
            stale += is_stale
            degraded += (not is_stale) and is_degraded
            out_nodes[nid] = {
                "verdict": verdict,
                "lastPushAgeSeconds": round(age, 3),
                "seq": st.get("seq", 0),
                "skewSeconds": st.get("skew"),
                "health": health,
                "families": len(st.get("metrics", {})),
            }
        return {"version": FEDERATION_VERSION,
                "nodes": out_nodes,
                "fleet": {"nodes": len(out_nodes),
                          "degraded": degraded, "stale": stale,
                          "ok": len(out_nodes) - degraded - stale}}
