"""Structured span tracer with an optional ``torch.profiler`` bridge (twin
of ``pybitmessage_tpu.observability.tracing``, less the wire trace's
``TraceContext`` and ``SkewEstimator``).

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
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

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
