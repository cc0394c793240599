"""Set-reconciliation sync (twin of ``pybitmessage_tpu.sync``).

Replaces most per-object inv flooding with periodic per-peer sketch
exchanges (Erlay, Naumenko et al. CCS 2019; Graphene, Ozisik et al.
SIGCOMM 2019):

- :mod:`.sketch` — an invertible Bloom lookup table (IBLT) over salted
  64-bit short IDs of inventory hashes, with ``encode`` / ``subtract``
  / ``decode`` (peeling) and capacity estimation, vectorized with numpy;
- :mod:`.digest` — bucketed inventory digests maintained incrementally
  by ``storage/inventory.py``, so the catch-up of a freshly connected
  peer never rescans the inventory table (the light-client plane
  buckets its own digest by routing key);
- :mod:`.reconciler` — the per-connection session state machine
  (init -> sketch -> diff -> push) with a circuit breaker that degrades
  failing peers back to classic inv flooding, and the low-fanout
  hybrid: new objects still flood to a sqrt(n) subset of peers, every
  other peer reconciles;
- :mod:`.mesh` — an in-process simulated peer mesh driving the real
  reconciler and codec stack.

Everything stays on the host and reports through
``observability.REGISTRY``; the reconciler plants the
``sync.sketch_decode`` chaos site.
"""

from .digest import DIGEST_BUCKETS, DIGEST_SALT, InventoryDigest, bucket_of
from .reconciler import Reconciler, SyncSession
from .sketch import (Sketch, SketchDecodeError, capacity_for, short_id,
                     short_id_map, short_ids)

__all__ = [
    "Sketch", "SketchDecodeError", "capacity_for",
    "short_id", "short_ids", "short_id_map",
    "InventoryDigest", "DIGEST_BUCKETS", "DIGEST_SALT", "bucket_of",
    "Reconciler", "SyncSession",
]
