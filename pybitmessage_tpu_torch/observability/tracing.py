"""Structured span tracer with an optional ``torch.profiler`` bridge and the
wire trace context (twin of ``pybitmessage_tpu.observability.tracing``).

``trace("pow.solve", backend="cuda")`` works as a context manager or a
decorator.  Each span records a monotonic start, its duration, free-form
attributes, and its parent span (linked through a
``contextvars.ContextVar`` so nesting survives ``await`` boundaries and
executor hops started from instrumented code).  Finished spans land in a
fixed-size ring buffer for post-hoc inspection.

When the bridge is on (``enable_profiler_annotations(True)``), every span
also enters a ``torch.profiler.record_function`` range, so the spans
show as named host ranges in a trace captured by
``devicetelemetry.capture_device_trace`` beside the kernels they
launched.  The bridge is off by default: the hot path pays no
annotation cost unless a trace is being taken.

A span may be given ``histogram=<Histogram child or family>``: its
duration is observed on exit.

The wire trace context (``TraceContext``: 16-byte trace id, 8-byte
parent span, 8-byte send time in microseconds) crosses the wire on
object pushes, sync rounds and PoW job hops between peers that both
advertised NODE_TRACE, so lifecycle timelines stitch across nodes; a
``SkewEstimator`` per connection turns its send times into a bounded
clock-offset estimate.
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import logging
import os
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .metrics import REGISTRY

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

_current_span: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("pybitmessage_tpu_torch_current_span",
                           default=None)

_span_ids = itertools.count(1)

#: module switch for the torch.profiler.record_function bridge
_profiler_annotations_enabled = False


def enable_profiler_annotations(on: bool = True) -> None:
    """Toggle mirroring spans into torch.profiler.record_function."""
    global _profiler_annotations_enabled
    _profiler_annotations_enabled = bool(on)


def profiler_annotations_enabled() -> bool:
    return _profiler_annotations_enabled


@dataclass
class Span:
    name: str
    span_id: int
    parent_id: int | None
    start: float                      # time.monotonic()
    attrs: dict = field(default_factory=dict)
    duration: float | None = None     # filled on exit

    def as_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "start": self.start,
                "duration": self.duration, "attrs": dict(self.attrs)}


class Tracer:
    """Ring buffer of finished spans + the trace() factory."""

    def __init__(self, maxlen: int = 2048):
        self._lock = threading.Lock()
        self.spans: deque[Span] = deque(maxlen=maxlen)

    def record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def recent(self, n: int = 50, name: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self.spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out[-n:]

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


#: process-wide default tracer
TRACER = Tracer()


class trace:
    """Span context manager / decorator.

    >>> with trace("pow.solve", backend="cuda") as span:
    ...     ...
    >>> @trace("inventory.flush")
    ... def flush(): ...
    """

    __slots__ = ("name", "attrs", "histogram", "tracer", "span",
                 "_token", "_range", "_t0")

    def __init__(self, name: str, *, histogram=None, tracer: Tracer = None,
                 **attrs):
        self.name = name
        self.attrs = attrs
        self.histogram = histogram
        self.tracer = tracer or TRACER
        self.span = None
        self._token = None
        self._range = None
        self._t0 = 0.0

    def __enter__(self) -> Span:
        parent = _current_span.get()
        self.span = Span(
            name=self.name, span_id=next(_span_ids),
            parent_id=parent.span_id if parent is not None else None,
            start=time.monotonic(), attrs=self.attrs)
        self._token = _current_span.set(self.span)
        if _profiler_annotations_enabled:
            try:
                from torch.profiler import record_function
                self._range = record_function(self.name)
                self._range.__enter__()
            except Exception:
                self._range = None
        self._t0 = time.monotonic()
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration = time.monotonic() - self._t0
        if self._range is not None:
            try:
                self._range.__exit__(exc_type, exc, tb)
            except Exception:
                logger.debug("profiler range exit failed", exc_info=True)
            self._range = None
        _current_span.reset(self._token)
        self.span.duration = duration
        if exc_type is not None:
            self.span.attrs["error"] = exc_type.__name__
        self.tracer.record(self.span)
        if self.histogram is not None:
            self.histogram.observe(duration)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # fresh instance per call - `self` holds per-entry state
            with trace(self.name, histogram=self.histogram,
                       tracer=self.tracer, **self.attrs):
                return fn(*args, **kwargs)
        return wrapper


def current_span() -> Span | None:
    return _current_span.get()


def new_trace_id() -> bytes:
    return os.urandom(16)


def new_span_id() -> int:
    return int.from_bytes(os.urandom(8), "big") or 1


#: encoded size on the wire: trace_id(16) + parent_span(8) + sent_at(8)
TRACE_CTX_LEN = 32

TRACE_CTX_SENT = REGISTRY.counter(
    "trace_ctx_sent_total",
    "Wire trace contexts attached to outgoing packets, by command",
    ("command",))
TRACE_CTX_RECEIVED = REGISTRY.counter(
    "trace_ctx_received_total",
    "Wire trace contexts parsed from incoming packets, by command",
    ("command",))
TRACE_CTX_INVALID = REGISTRY.counter(
    "trace_ctx_invalid_total",
    "Trace trailers that failed to parse (dropped; the carrying packet "
    "is still processed)")
TRACE_CLOCK_SKEW = REGISTRY.gauge(
    "trace_clock_skew_seconds",
    "Most recent per-connection clock-offset estimate fed by incoming "
    "trace contexts (remote clock minus local, bounded)")


class TraceContext:
    """One hop's wire trace context (16B trace id + 8B parent span +
    8B send time)."""

    __slots__ = ("trace_id", "parent_span", "sent_at")

    def __init__(self, trace_id: bytes, parent_span: int,
                 sent_at: float | None = None):
        self.trace_id = bytes(trace_id[:16]).ljust(16, b"\x00")
        self.parent_span = parent_span & (2 ** 64 - 1)
        self.sent_at = time.time() if sent_at is None else float(sent_at)

    def encode(self) -> bytes:
        return self.trace_id + struct.pack(
            ">Qq", self.parent_span, int(self.sent_at * 1e6))

    @classmethod
    def decode(cls, data: bytes) -> "TraceContext":
        if len(data) < TRACE_CTX_LEN:
            raise ValueError("trace context too short")
        parent, micros = struct.unpack_from(">Qq", data, 16)
        return cls(data[:16], parent, micros / 1e6)

    def as_dict(self) -> dict:
        return {"traceId": self.trace_id.hex(),
                "parentSpan": self.parent_span,
                "sentAt": self.sent_at}

    def __repr__(self) -> str:  # debug/flightrec friendliness
        return "TraceContext(%s, parent=%x)" % (self.trace_id.hex()[:8],
                                                self.parent_span)


class SkewEstimator:
    """Bounded per-connection clock-offset estimator.

    Each incoming trace context carries the sender's wall-clock send
    time; ``observe()`` feeds ``remote_sent_at - local_recv_at`` into
    an EWMA (the one-way network delay biases the estimate negative by
    up to the path latency — acceptable for stage-latency stitching,
    where millisecond-scale bias is dwarfed by the second-scale skews
    the estimator exists to remove).  Samples beyond ``max_abs``
    seconds are clamped, so one insane peer clock cannot poison the
    estimate unboundedly, and the estimate itself is bounded by
    construction.  ``offset()`` is remote-minus-local: subtract it
    from a remote timestamp to express it on the local clock.
    """

    __slots__ = ("alpha", "max_abs", "samples", "_offset", "_dev")

    def __init__(self, *, alpha: float = 0.25, max_abs: float = 3600.0):
        self.alpha = alpha
        self.max_abs = max_abs
        self.samples = 0
        self._offset: float | None = None
        self._dev = 0.0

    def observe(self, remote_sent_at: float,
                local_recv_at: float | None = None) -> float:
        if local_recv_at is None:
            local_recv_at = time.time()
        sample = remote_sent_at - local_recv_at
        sample = max(-self.max_abs, min(self.max_abs, sample))
        if self._offset is None:
            self._offset = sample
        else:
            self._dev = (1 - self.alpha) * self._dev + \
                self.alpha * abs(sample - self._offset)
            self._offset = (1 - self.alpha) * self._offset + \
                self.alpha * sample
        self.samples += 1
        TRACE_CLOCK_SKEW.set(self._offset)
        return self._offset

    def offset(self) -> float:
        """Estimated remote-minus-local clock offset (0.0 unsampled)."""
        return self._offset if self._offset is not None else 0.0

    def deviation(self) -> float:
        return self._dev

    def normalize(self, remote_t: float) -> float:
        """A remote wall-clock timestamp expressed on the local clock."""
        return remote_t - self.offset()

    def snapshot(self) -> dict:
        return {"offsetSeconds": round(self.offset(), 6),
                "deviationSeconds": round(self._dev, 6),
                "samples": self.samples}
