"""Zero-dependency metrics registry: Counter / Gauge / Histogram (twin
of ``pybitmessage_tpu.observability.metrics``: the same names, help
strings, bucket bounds, cardinality guard and exposition format, so one
scrape config and one dashboard read both daemons).

Semantics follow the Prometheus data model:

- a metric *family* has a name, help text, type, and label names;
- ``labels(**kv)`` binds label values and returns a child holding the
  actual series; an unlabeled family is its own single child;
- ``render()`` emits the text exposition format (version 0.0.4) that
  ``GET /metrics`` serves.

Everything is guarded by one lock per family, so increments are safe
from any mix of threads (the PoW executor, the crypto drains) and
asyncio tasks; the write path is a dict lookup plus a float add.

Naming conventions (enforced by ``Registry.register``): snake_case,
counters end ``_total`` (or ``_seconds_total`` for accumulated time),
histograms end with a unit suffix (``_seconds``, ``_bytes``, ``_size``).
"""

from __future__ import annotations

import logging
import math
import re
import threading
from bisect import bisect_left
from typing import Iterable

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: log-spaced (x4) upper bounds from 1 µs to ~268 s — one ladder
#: covers device slab launches (~ms), solve latencies (~s on network
#: difficulty), and queue waits (µs..minutes)
DEFAULT_LATENCY_BUCKETS = tuple(1e-6 * 4.0 ** i for i in range(15))

#: powers of two for batch/queue occupancy histograms
DEFAULT_SIZE_BUCKETS = tuple(float(1 << i) for i in range(11))

#: refuse to materialize more label sets than this per family — a
#: mis-labeled hot path (e.g. a peer address used as a label) would
#: otherwise grow memory without bound.  Excess label sets are DROPPED
#: (recorded into a shared unrendered overflow child and counted in
#: ``observability_dropped_series_total``), never raised: telemetry
#: must not crash the hot path it observes.
MAX_LABEL_SETS = 512

#: default hashed peer-bucket count for :func:`peer_bucket` — at lab
#: scale (hundreds of peers) raw per-peer label values blow through
#: :data:`MAX_LABEL_SETS` and silently collapse into the overflow
#: child; hashing peers into a bounded bucket set keeps per-peer-group
#: visibility at fixed cardinality (``peerlabelbuckets`` setting)
DEFAULT_PEER_BUCKETS = 16

_peer_buckets = DEFAULT_PEER_BUCKETS


def set_peer_buckets(n: int) -> None:
    """Configure the hashed peer-bucket count (>=1)."""
    global _peer_buckets
    _peer_buckets = max(1, int(n))


def peer_buckets() -> int:
    return _peer_buckets


def peer_bucket(peer: str, buckets: int | None = None) -> str:
    """Stable hashed bucket label for a peer identity.

    ``"host:port" -> "b07"`` — deterministic across processes (CRC32,
    not the salted builtin ``hash``) so the same peer lands in the
    same bucket on every node, and bounded so per-peer series can
    never approach the cardinality guard."""
    import zlib
    n = buckets if buckets is not None else _peer_buckets
    return "b%02d" % (zlib.crc32(str(peer).encode("utf-8", "replace"))
                      % max(1, n))


def peer_bucket_label(site: str, peer: str,
                      buckets: int | None = None) -> str:
    """``site/bNN`` — the shared-label convention the per-peer breaker
    families use: per-bucket visibility, ``sites x buckets`` bounded
    cardinality."""
    return "%s/%s" % (site, peer_bucket(peer, buckets))


def _fmt(v: float) -> str:
    """Prometheus sample value / le formatting: integers stay integral
    ("5" not "5.0"), +Inf spelled the Prometheus way."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def escape_label_value(value: str) -> str:
    """Label-value escaping per the text exposition spec (0.0.4):
    backslash, newline and double-quote."""
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def escape_help(value: str) -> str:
    """HELP-line escaping per the exposition spec: ONLY backslash and
    newline — a double-quote in help text is emitted verbatim."""
    return value.replace("\\", r"\\").replace("\n", r"\n")


def _labels_suffix(names: tuple[str, ...], values: tuple[str, ...],
                   extra: str = "") -> str:
    parts = ['%s="%s"' % (n, escape_label_value(v))
             for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{%s}" % ",".join(parts) if parts else ""


class _Family:
    """Shared machinery: child management + label validation."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError("metric name %r is not snake_case" % name)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError("label name %r is not snake_case" % ln)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        #: shared sink for label sets beyond MAX_LABEL_SETS — a working
        #: child of the right type (so hot-path inc/observe never
        #: raises) that is NEVER rendered (fabricated label values
        #: would corrupt the exposition)
        self._overflow = None
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        """Child bound to the given label values (created on demand).

        Beyond :data:`MAX_LABEL_SETS` distinct label sets the guard
        DROPS the new series: the caller gets a shared unrendered
        overflow child and ``observability_dropped_series_total``
        counts the drop — the hot path never raises."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                "%s expects labels %r, got %r"
                % (self.name, self.labelnames, tuple(kv)))
        key = tuple(str(kv[n]) for n in self.labelnames)
        dropped = False
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_LABEL_SETS:
                    if self._overflow is None:
                        self._overflow = self._make_child()
                    child = self._overflow
                    dropped = True
                else:
                    child = self._children[key] = self._make_child()
        if dropped:
            # counted outside the family lock (the drop counter takes
            # its own); the counter never counts its own overflow
            _count_dropped_series(self)
        return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                "%s is labeled %r; call .labels() first"
                % (self.name, self.labelnames))
        return self._children[()]

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # -- rendering -----------------------------------------------------------

    def render(self) -> list[str]:
        lines = []
        if self.help:
            lines.append("# HELP %s %s" % (self.name,
                                           escape_help(self.help)))
        lines.append("# TYPE %s %s" % (self.name, self.kind))
        for values, child in self.children():
            lines.extend(self._render_child(values, child))
        return lines

    def _render_child(self, values, child) -> list[str]:
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Family):
    """Monotonically increasing count; name must end in ``_total``."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        if not name.endswith("_total"):
            raise ValueError("counter %r must end in _total" % name)
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def _render_child(self, values, child):
        return ["%s%s %s" % (self.name,
                             _labels_suffix(self.labelnames, values),
                             _fmt(child.value))]


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def _render_child(self, values, child):
        return ["%s%s %s" % (self.name,
                             _labels_suffix(self.labelnames, values),
                             _fmt(child.value))]


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        # one slot per finite bucket + the +Inf overflow slot
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        # Prometheus buckets are ``le`` (<=) — bisect_left lands a
        # value exactly on a bound in that bound's bucket
        i = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (0..1) by linear interpolation within
        the containing bucket — the standard histogram_quantile()
        estimate, good enough for bench snapshots."""
        counts, _, total = self.snapshot()
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = (self._bounds[i] if i < len(self._bounds)
                      else self._bounds[-1])
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self._bounds[-1]


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        self._bounds = bounds
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._bounds)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def percentile(self, q: float) -> float:
        return self._default_child().percentile(q)

    @property
    def count(self) -> int:
        return self._default_child()._count

    @property
    def sum(self) -> float:
        return self._default_child()._sum

    def _render_child(self, values, child):
        counts, total_sum, total = child.snapshot()
        lines, cum = [], 0
        for bound, c in zip(self._bounds, counts):
            cum += c
            lines.append("%s_bucket%s %d" % (
                self.name,
                _labels_suffix(self.labelnames, values,
                               'le="%s"' % _fmt(bound)),
                cum))
        lines.append("%s_bucket%s %d" % (
            self.name,
            _labels_suffix(self.labelnames, values, 'le="+Inf"'), total))
        suffix = _labels_suffix(self.labelnames, values)
        lines.append("%s_sum%s %s" % (self.name, suffix, _fmt(total_sum)))
        lines.append("%s_count%s %d" % (self.name, suffix, total))
        return lines


class Registry:
    """Named collection of metric families; renders /metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def register(self, family: _Family) -> _Family:
        with self._lock:
            existing = self._families.get(family.name)
            if existing is not None:
                # a silent mismatch would record into the first
                # definition's buckets/labels — fail loudly instead
                if type(existing) is not type(family):
                    raise ValueError(
                        "metric %s re-registered with a different type"
                        % family.name)
                if existing.labelnames != family.labelnames:
                    raise ValueError(
                        "metric %s re-registered with labels %r != %r"
                        % (family.name, family.labelnames,
                           existing.labelnames))
                if (isinstance(family, Histogram)
                        and existing._bounds != family._bounds):
                    raise ValueError(
                        "histogram %s re-registered with different "
                        "buckets" % family.name)
                return existing
            self._families[family.name] = family
            return family

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self.register(Counter(name, help, labelnames))

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self.register(Gauge(name, help, labelnames))

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help, labelnames, buckets))

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    def sample(self, name: str, labels: dict | None = None):
        """Current value of one series (test/snapshot helper).

        Counters/gauges return the float value; histograms return the
        observation count.  Missing series sample as 0 so tests can
        take before/after deltas without pre-touching the series.
        """
        fam = self.get(name)
        if fam is None:
            return 0.0
        try:
            key = (tuple(str((labels or {})[n]) for n in fam.labelnames)
                   if fam.labelnames else ())
        except KeyError:
            return 0.0
        with fam._lock:
            child = fam._children.get(key)
        if child is None:
            return 0.0
        if isinstance(child, _HistogramChild):
            return child.snapshot()[2]
        return child.value

    def render(self) -> str:
        """The full Prometheus text exposition (trailing newline)."""
        lines = []
        for fam in self.families():
            lines.extend(fam.render())
        return "\n".join(lines) + "\n" if lines else ""


#: the process-wide default registry every instrumented module uses
REGISTRY = Registry()

#: drops by the per-family cardinality guard — labeled by the family
#: that overflowed, so a runaway label (a peer address, an unbounded
#: lifecycle stage) is attributable from /metrics alone
DROPPED_SERIES = REGISTRY.counter(
    "observability_dropped_series_total",
    "Label sets dropped by the cardinality guard (recorded into a "
    "shared unrendered overflow series instead)", ("metric",))


def _count_dropped_series(family: _Family) -> None:
    """Count one guard drop; self-referential drops (the drop counter
    itself overflowing on family names) must not recurse."""
    if family is DROPPED_SERIES:
        return
    try:
        DROPPED_SERIES.labels(metric=family.name).inc()
    except Exception:  # pragma: no cover - never fail the hot path
        logger.debug("dropped-series counter update failed",
                     exc_info=True)
