"""Exporters: structured snapshots and the periodic log task (twin of
``pybitmessage_tpu.observability.export``).

- ``render_prometheus()`` - the text exposition behind ``GET /metrics``
  and the ``metrics`` API command;
- ``snapshot()`` - a JSON-friendly dict (histograms carry count/sum and
  interpolated p50/p90/p99);
- ``log_snapshot_task()`` - an asyncio task logging one structured
  snapshot line per interval, so a long-running daemon leaves a
  greppable telemetry trail even with no scraper attached.
"""

from __future__ import annotations

import asyncio
import json
import logging

from .metrics import (REGISTRY, Counter, Gauge,  # noqa: F401 - public
                      Histogram, Registry, escape_help,
                      escape_label_value)

logger = logging.getLogger("pybitmessage_tpu_torch.observability")


def render_prometheus(registry: Registry = None) -> str:
    return (registry or REGISTRY).render()


def snapshot(registry: Registry = None,
             include_buckets: bool = False) -> dict:
    """``{metric_name: {type, series: [{labels, ...values}]}}``.

    ``include_buckets=True`` adds raw bucket bounds/counts to each
    histogram series (the lossless shape a merger needs); the default
    is the compact human view."""
    out = {}
    for fam in (registry or REGISTRY).families():
        series = []
        for values, child in fam.children():
            labels = dict(zip(fam.labelnames, values))
            if isinstance(fam, Histogram):
                counts, total_sum, total = child.snapshot()
                entry = {
                    "labels": labels, "count": total,
                    "sum": round(total_sum, 9),
                    "p50": round(child.percentile(0.50), 9),
                    "p90": round(child.percentile(0.90), 9),
                    "p99": round(child.percentile(0.99), 9)}
                if include_buckets:
                    entry["buckets"] = list(fam._bounds)
                    entry["bucketCounts"] = counts
                series.append(entry)
            else:
                series.append({"labels": labels, "value": child.value})
        out[fam.name] = {"type": fam.kind, "series": series}
    return out


def _changed_since(snap: dict, prev: dict) -> dict:
    """Only metrics whose series changed - keeps the periodic log line
    proportional to activity, not to how much is instrumented."""
    return {name: data for name, data in snap.items()
            if prev.get(name) != data}


async def log_snapshot_task(interval: float = 60.0,
                            registry: Registry = None,
                            log: logging.Logger = None) -> None:
    """Periodically log changed metrics as one JSON line."""
    log = log or logger
    prev: dict = {}
    while True:
        await asyncio.sleep(interval)
        try:
            snap = snapshot(registry)
            delta = _changed_since(snap, prev)
            prev = snap
            if delta:
                log.info("metrics_snapshot %s",
                         json.dumps(delta, sort_keys=True))
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("metrics snapshot failed")
