"""Resilience of the port (twin of ``pybitmessage_tpu.resilience``):

- :mod:`.policy`: the retry policy (PowService's backoff, the journal's
  and the database's write retries), the per-request ``Deadline`` and
  the circuit breakers (the connection pool's per-peer dials, the farm
  rung of the PoW dispatcher);
- :mod:`.chaos`: the fault-injection registry and the sites this
  package plants;
- :mod:`.journal`: the crash-safe SQLite PoW job journal, so a solve
  interrupted by a crash resumes from its checkpointed nonce offset;
- :mod:`.watchdog`: slab-stall detection (``StallGuard``,
  ``SlabStallError``, ``pow_stall_total``): an overdue launch or
  readback is abandoned, counted, and its work requeued.
"""

from .chaos import CHAOS, ChaosError, ChaosRegistry, inject  # noqa: F401
from .journal import PowJob, PowJournal  # noqa: F401
from .policy import (  # noqa: F401
    BREAKERS, CircuitBreaker, Deadline, RetryPolicy, breaker_snapshot,
    current_deadline,
)
from .watchdog import SlabStallError, StallGuard  # noqa: F401
