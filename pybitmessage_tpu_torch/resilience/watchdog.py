"""Slab-stall watchdog: bound the wall time of a blocking launch (copy
of ``pybitmessage_tpu.resilience.watchdog``).

A wedged device launch or readback would otherwise pin the caller's
thread forever.  :class:`StallGuard` runs the blocking callable on a
daemon worker thread and gives up waiting after ``timeout`` seconds:
the call site gets :class:`SlabStallError`.  In this package the PoW
pipeline's harvest guard (``pow/pipeline.py`` ``_PipelineDriver``)
raises the same class and counts into the same family; the dispatcher
notes the stall and, once the requeued work completes, observes
:data:`STALL_RECOVERY_SECONDS`.

The abandoned thread cannot be killed (Python has no safe thread
cancellation), so it is left to finish in the background as a daemon
and its result is discarded: one leaked waiter against a wedged
pipeline.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from ..observability import REGISTRY
from ..observability.flightrec import FLIGHT_RECORDER

logger = logging.getLogger("pybitmessage_tpu_torch.resilience")

STALLS = REGISTRY.counter(
    "pow_stall_total",
    "Launches abandoned by the stall watchdog", ("site",))
STALL_RECOVERY_SECONDS = REGISTRY.histogram(
    "pow_stall_recovery_seconds",
    "Time from a stall being detected to the rescued solve completing "
    "on a fallback tier")


class SlabStallError(Exception):
    """The guarded launch exceeded its stall deadline."""


def note_stall(site: str, timeout: float) -> None:
    """Count one stall at ``site`` and dump the flight recorder while
    the pre-stall context (launches, breaker flips, chaos fires) is
    still in its ring."""
    STALLS.labels(site=site).inc()
    FLIGHT_RECORDER.record("stall", site=site, timeout=timeout)
    FLIGHT_RECORDER.dump("stall")


class StallGuard:
    """Run a blocking callable with a stall deadline.

    ``timeout <= 0`` disables the guard (the callable runs inline).
    One worker thread per ``run()``; the pipeline's per-harvest path
    keeps a reusable worker instead.  The guard only detects and counts
    the stall; the dispatcher observes the recovery.
    """

    def __init__(self, *, timeout: float, site: str = "pow.slab"):
        self.timeout = timeout
        self.site = site

    def run(self, fn: Callable):
        if self.timeout <= 0:
            return fn()
        done = threading.Event()
        box: dict = {}

        def worker():
            try:
                box["result"] = fn()
            except BaseException as exc:   # noqa: BLE001 (relayed below)
                box["error"] = exc
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True,
                             name="bmtpu-stall-%s" % self.site)
        t.start()
        if not done.wait(self.timeout):
            note_stall(self.site, self.timeout)
            logger.error("%s stalled: launch exceeded %.1fs; abandoning "
                         "it and falling back", self.site, self.timeout)
            raise SlabStallError(
                "%s exceeded %.1fs stall deadline" % (self.site,
                                                      self.timeout))
        if "error" in box:
            raise box["error"]
        return box["result"]
