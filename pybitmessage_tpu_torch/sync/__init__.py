"""Bucketed inventory digests (twin of part of ``pybitmessage_tpu.sync``).

Only what the light-client tier reads is here: ``digest.py``
(``InventoryDigest``, ``bucket_of``) and, from ``sketch.py``, the
64-bit ``short_id`` the digest folds.  The set reconciler (sketches,
``sketchreq``/``sketch``/``recondiff``) is not part of this package
yet.
"""

from .digest import DIGEST_BUCKETS, DIGEST_SALT, InventoryDigest, bucket_of
from .sketch import short_id

__all__ = ["DIGEST_BUCKETS", "DIGEST_SALT", "InventoryDigest", "bucket_of",
           "short_id"]
