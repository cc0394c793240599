"""Flight recorder: a fixed-size ring of structured events (twin of
``pybitmessage_tpu.observability.flightrec``).

The black box for post-mortems.  Subsystems append one small event per
*notable* transition - breaker state changes, PoW requeues, slab
stalls, ingest-watermark pause/resume, objects processed - and the ring
keeps the last ``maxlen`` of them.  The ``dumpFlightRecorder`` API
command dumps it on demand.

Appends are lock-free on CPython: one ``deque.append`` (atomic under
the GIL) plus a counter increment.  ``record()`` never raises.
A running sampling profiler sets ``profile_provider``, so every dump
also carries the stacks of its last ~10 s.
"""

from __future__ import annotations

import itertools
import json
import logging
import time
from collections import deque

from .metrics import REGISTRY

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

EVENTS = REGISTRY.counter(
    "flightrec_events_total",
    "Structured events appended to the flight-recorder ring",
    ("kind",))
DUMPS = REGISTRY.counter(
    "flightrec_dumps_total",
    "Flight-recorder dumps by trigger (stall/fatal/api)", ("trigger",))

#: default ring capacity (events, not bytes); overridable via the
#: ``flightrecsize`` setting
DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Ring buffer of ``{kind, t, seq, **fields}`` event dicts."""

    def __init__(self, maxlen: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=max(1, maxlen))
        #: itertools.count - __next__ is atomic under the GIL, unlike
        #: a += on an int attribute (record() runs on the event loop
        #: AND from dispatcher/watchdog threads)
        self._seq = itertools.count(1)
        self.enabled = True
        #: this process's identity in multi-node dumps (the node nonce
        #: hex; set by Node) - "" until wired
        self.node_id = ""
        #: optional callable returning this node's estimated clock
        #: offset vs its peers (remote-minus-local seconds), recorded in
        #: every dump; unset until the wire trace is ported
        self.skew_provider = None
        #: optional callable returning a rolling-window profile block
        #: (``profiling.py``; set while the sampler runs)
        self.profile_provider = None

    def resize(self, maxlen: int) -> None:
        """Re-cap the ring, keeping the newest events."""
        maxlen = max(1, maxlen)
        self._ring = deque(list(self._ring)[-maxlen:], maxlen=maxlen)

    # -- recording (hot path: must never raise) ------------------------------

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        try:
            event = {"kind": kind, "t": round(time.time(), 4),
                     "seq": next(self._seq)}
            event.update(fields)
            self._ring.append(event)
            EVENTS.labels(kind=kind).inc()
        except Exception:  # pragma: no cover - telemetry never kills
            logger.debug("flight recorder append failed", exc_info=True)

    # -- reading / dumping ---------------------------------------------------

    def events(self, n: int | None = None,
               kind: str | None = None) -> list[dict]:
        """Newest-last slice of the ring (optionally filtered)."""
        out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out[-n:] if n else out

    def clear(self) -> None:
        self._ring.clear()

    def skew(self) -> float:
        """This node's estimated clock offset (0.0 when unwired or the
        provider fails - a dump must never fail on telemetry)."""
        if self.skew_provider is None:
            return 0.0
        try:
            return float(self.skew_provider())
        except Exception:
            logger.debug("flightrec skew provider failed", exc_info=True)
            return 0.0

    def profile(self) -> dict | None:
        """The rolling-window profile block (None when unwired or the
        provider fails - a dump must never fail on telemetry)."""
        if self.profile_provider is None:
            return None
        try:
            block = self.profile_provider()
            return block if isinstance(block, dict) else None
        except Exception:
            logger.debug("flightrec profile provider failed",
                         exc_info=True)
            return None

    def dump_record(self, trigger: str) -> dict:
        """The full dump structure: node identity + the clock-skew
        estimate + the ring (+ the profiler's rolling window when
        wired)."""
        out = {"trigger": trigger, "node": self.node_id,
               "skew": round(self.skew(), 6), "events": self.events()}
        profile = self.profile()
        if profile is not None:
            out["profile"] = profile
        return out

    def dump(self, trigger: str, *, log: logging.Logger | None = None
             ) -> list[dict]:
        """Emit the whole ring as one structured log line and return
        the events.  ``trigger`` names why (stall/fatal/api) - every
        dump is counted so post-mortems know whether the black box
        fired at all."""
        record = self.dump_record(trigger)
        events = record["events"]
        DUMPS.labels(trigger=trigger).inc()
        try:
            (log or logger).warning(
                "flightrec_dump trigger=%s events=%d %s", trigger,
                len(events), json.dumps(record, default=repr))
        except Exception:  # pragma: no cover
            logger.exception("flight recorder dump failed")
        return events


#: the process-wide ring every subsystem hook appends to
FLIGHT_RECORDER = FlightRecorder()


def record(kind: str, **fields) -> None:
    """Module-level shorthand for ``FLIGHT_RECORDER.record``."""
    FLIGHT_RECORDER.record(kind, **fields)
