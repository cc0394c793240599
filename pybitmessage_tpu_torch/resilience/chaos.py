"""Config/env-driven fault injection with named sites (copy of
``pybitmessage_tpu.resilience.chaos``: the registry whole, the same env
spec and per-site seeded draws).

Hot paths plant ``inject("<site>")`` markers; the registry decides,
deterministically under a seed, whether that call raises.  Disarmed (the
production default) an injection site is one dict lookup.

The sites this package plants (:data:`SITES`):

=====================  ==================================================
``pow.device_launch``  entering the dispatcher's card tier
``pow.readback``       pulling slab results to the host (the pipeline's
                       fetch and the single-sync readback)
``db.write``           a SQLite write (``storage/db.py`` and the PoW
                       journal)
``net.dial``           an outbound dial (``ConnectionPool.connect_to``)
``net.send``           a framed packet send (``BMConnection.send_packet``)
``api.dispatch``       an RPC command dispatch (the API server, JSON-RPC
                       and XML-RPC alike)
``storage.slab_io``    a slab drain or seal write
                       (``storage/slabstore.py``)
``farm.accept``        a farm job submission accept (``powfarm/server.py``)
``farm.dispatch``      a farm batch launch through the dispatcher
``farm.result``        a farm result frame send back to a client
``role.ipc``           an edge's frame send and a relay's ack and push
                       sends on the role IPC channel (``roles/``)
``role.handoff``       a relay's handoff control, drain and forward sends
``role.replica``       an edge's replica health probe
``role.client``        a light-client plane frame send, both the edge's
                       session writer and the client's (``roles/``)
``sync.sketch_decode`` sketch subtract/peel (reconciler gossip/catch-up,
                       ``sync/reconciler.py``)
``crypto.native``      a native-rung drain of the batch crypto engine
                       (``crypto/batch.py``; re-run on the pure tier)
``crypto.tpu``         a card-rung drain's launch (a failed drain,
                       settled conservatively, never re-run on the host)
=====================  ==================================================

That is the JAX catalog whole.  :func:`unplanted` names a spec's sites
outside it, so the daemon can refuse a spec that would arm nothing.

Arming, one of:

- env: ``BMTPU_CHAOS="pow.device_launch:0.5,db.write:1.0x3"`` (+
  ``BMTPU_CHAOS_SEED=1234``): ``site:probability`` entries, optional
  ``xN`` capping total fires;
- code: ``CHAOS.arm("net.send", probability=1.0, count=3)``.

Determinism: each site draws from its own ``random.Random`` seeded with
``(seed, site)``, so a given (seed, call sequence) fires the same calls
as the JAX registry's, whatever the other sites' traffic.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time

from ..observability import REGISTRY
from ..observability.flightrec import record as _flight

logger = logging.getLogger("pybitmessage_tpu_torch.resilience")

FAULTS = REGISTRY.counter(
    "chaos_injected_total",
    "Faults raised by the chaos registry", ("site",))

#: the injection sites planted in this package
SITES = ("pow.device_launch", "pow.readback", "db.write", "net.dial",
         "net.send", "api.dispatch", "storage.slab_io", "farm.accept",
         "farm.dispatch", "farm.result", "role.ipc", "role.handoff",
         "role.replica", "role.client", "sync.sketch_decode",
         "crypto.native", "crypto.tpu")


class ChaosError(RuntimeError):
    """The default injected fault (sites may configure another type)."""


#: realistic default exception per site family: network faults exercise
#: the same handlers a dead peer does
_DEFAULT_EXC: dict[str, type] = {
    "net.dial": OSError,
    "net.send": ConnectionError,
    "role.ipc": ConnectionError,
    "role.handoff": ConnectionError,
    "role.replica": ConnectionError,
    "role.client": ConnectionError,
}


class _Site:
    __slots__ = ("probability", "count", "exc", "delay", "fired", "rng")

    def __init__(self, probability: float, count: int | None,
                 exc: type, delay: float, rng: random.Random):
        self.probability = probability
        self.count = count          # None = unlimited
        self.exc = exc
        self.delay = delay          # sleep before raising (stall sim)
        self.fired = 0
        self.rng = rng


def parse_spec(spec: str) -> list[tuple[str, float, int | None]]:
    """``site:probability[xCount]`` comma list -> ``[(site, p, count)]``."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, _, rest = entry.partition(":")
        prob, count = rest or "1.0", None
        if "x" in prob:
            prob, _, n = prob.partition("x")
            count = int(n)
        out.append((site.strip(), float(prob or 1.0), count))
    return out


def unplanted(spec: str) -> list[str]:
    """The sites a spec names that this package does not plant."""
    return [site for site, _, _ in parse_spec(spec) if site not in SITES]


class ChaosRegistry:
    """Named injection sites, armed per test run or via env."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._sites: dict[str, _Site] = {}
        self._seed = seed

    # -- configuration -------------------------------------------------------

    def arm(self, site: str, probability: float = 1.0, *,
            count: int | None = None, exc: type | None = None,
            delay: float = 0.0) -> None:
        """Arm one site.  ``count`` caps total fires; ``delay`` sleeps
        before raising (a stalled launch for the watchdog)."""
        exc = exc or _DEFAULT_EXC.get(site, ChaosError)
        rng = random.Random("%d:%s" % (self._seed, site))
        with self._lock:
            self._sites[site] = _Site(probability, count, exc, delay, rng)
        logger.info("chaos armed: %s p=%.2f count=%s delay=%.2fs (%s)",
                    site, probability, count, delay, exc.__name__)

    def disarm(self, site: str | None = None) -> None:
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def seed(self, seed: int) -> None:
        """Set the seed for sites armed AFTER this call."""
        self._seed = seed

    def configure(self, spec: str, seed: int | None = None) -> None:
        """Arm every entry of a ``site:probability[xCount]`` comma list
        (the env format)."""
        if seed is not None:
            self.seed(seed)
        for site, prob, count in parse_spec(spec):
            self.arm(site, prob, count=count)

    def active(self) -> dict[str, dict]:
        """Armed sites and their fire counts (clientStatus block)."""
        with self._lock:
            return {name: {"probability": s.probability,
                           "count": s.count, "fired": s.fired,
                           "delay": s.delay}
                    for name, s in self._sites.items()}

    # -- the hot-path hook ---------------------------------------------------

    def inject(self, site: str) -> None:
        """Raise the configured fault when ``site`` is armed and its
        die roll fires; a no-op (one dict lookup) otherwise."""
        if not self._sites:        # disarmed fast path, no lock
            return
        with self._lock:
            s = self._sites.get(site)
            if s is None:
                return
            if s.count is not None and s.fired >= s.count:
                return
            if s.probability < 1.0 and s.rng.random() >= s.probability:
                return
            s.fired += 1
            exc, delay = s.exc, s.delay
        FAULTS.labels(site=site).inc()
        _flight("chaos", site=site, exc=exc.__name__)
        if delay > 0:
            time.sleep(delay)
        raise exc("chaos: injected fault at %s" % site)


#: the process-wide registry every planted site consults
CHAOS = ChaosRegistry(seed=int(os.environ.get("BMTPU_CHAOS_SEED", "0")))
if os.environ.get("BMTPU_CHAOS"):
    CHAOS.configure(os.environ["BMTPU_CHAOS"])


def inject(site: str) -> None:
    """Module-level shorthand for ``CHAOS.inject(site)``."""
    CHAOS.inject(site)
