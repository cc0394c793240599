"""PoW solver farm: multi-tenant PoW-as-a-service (twin of
``pybitmessage_tpu.powfarm``).

Many edge nodes delegate their proof-of-work to one shared solver farm
over a small length-prefixed protocol whose frames are the JAX
package's byte for byte, so either package's clients and servers meet.
Server side (:class:`FarmServer`, the daemon's ``powfarmlisten``):
signed job submissions, crash-safe journaling (:class:`FarmJournal`),
weighted deficit-round-robin fairness across tenants with two priority
lanes and queue-depth-aware admission (:class:`FarmScheduler`), and
coalesced batches through the node's ``PowDispatcher`` on the card.
Client side (:class:`FarmSolverTier`, ``powfarmconnect``): the top rung
of the dispatcher (farm -> cuda) with deadline propagation,
requeue-on-farm-failure back to the card and a host re-check of every
returned nonce.
"""

from .client import FarmClient, FarmError, FarmRejected, FarmSolverTier
from .journal import FarmJournal
from .protocol import LANE_BULK, LANE_INTERACTIVE, LANES
from .scheduler import Admission, FarmJob, FarmScheduler, TenantConfig
from .server import FarmServer

__all__ = [
    "FarmServer", "FarmScheduler", "FarmJournal", "FarmJob",
    "TenantConfig", "Admission",
    "FarmClient", "FarmSolverTier", "FarmError", "FarmRejected",
    "LANES", "LANE_INTERACTIVE", "LANE_BULK",
]
