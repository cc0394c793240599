"""Object inventory: RAM cache of new objects over the SQL table (copy of
``pybitmessage_tpu.storage.inventory``).

Same two-tier semantics as the reference (src/storage/sqlite.py:12-124):
``_pending`` holds objects received since the last flush; ``_known``
caches hash->stream existence so inv floods don't hit SQL per lookup.
``flush()`` bulk-inserts, ``clean()`` drops objects expired more than
3 hours ago.  Lookups, held objects and flushes go to the JAX
inventory's metric families.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Iterable

from ..models.constants import EXPIRES_GRACE
from ..observability import REGISTRY
from .db import Database

LOOKUPS = REGISTRY.counter(
    "inventory_lookups_total",
    "Inventory existence checks by outcome (hit = RAM/SQL knows the "
    "hash)", ("result",))
# bound once: __contains__ runs per inv-flood entry
LOOKUP_HIT = LOOKUPS.labels(result="hit")
LOOKUP_MISS = LOOKUPS.labels(result="miss")
ITEMS = REGISTRY.gauge(
    "inventory_items", "Objects held in the inventory (pending + SQL)")
FLUSHES = REGISTRY.counter(
    "inventory_flushes_total", "Pending->SQL bulk-insert flushes")


@dataclass(frozen=True)
class InventoryItem:
    type: int
    stream: int
    payload: bytes
    expires: int
    tag: bytes


class Inventory:
    """Dict-like object store keyed by 32-byte inventory hash."""

    def __init__(self, db: Database):
        self._db = db
        self._lock = threading.RLock()
        self._pending: dict[bytes, InventoryItem] = {}
        self._known: dict[bytes, int] = {}  # hash -> stream existence cache
        #: optional sync/digest.py InventoryDigest kept incrementally
        #: in step with add/clean — reconciliation rounds read it
        #: instead of rescanning the inventory table
        self._digest = None
        # process-wide gauge: the most recently constructed/cleaned
        # Inventory owns the reading (one live inventory per daemon)
        ITEMS.set(len(self))

    def attach_digest(self, digest) -> None:
        """Attach a bucketed digest (sync subsystem) and seed it with
        one scan — the only full scan it ever costs; every later
        ``add``/``clean`` maintains it incrementally."""
        with self._lock:
            now = int(time.time())
            seed = [(h, v.stream, v.expires)
                    for h, v in self._pending.items() if v.expires > now]
            seed += [(bytes(h), s, e) for h, s, e in self._db.query(
                "SELECT hash, streamnumber, expirestime FROM inventory"
                " WHERE expirestime>?", (now,))]
            digest.rebuild(seed)
            self._digest = digest

    def __contains__(self, hash_: bytes) -> bool:
        with self._lock:
            if hash_ in self._pending or hash_ in self._known:
                LOOKUP_HIT.inc()
                return True
            rows = self._db.query(
                "SELECT streamnumber FROM inventory WHERE hash=?", (hash_,))
            if not rows:
                LOOKUP_MISS.inc()
                return False
            self._known[hash_] = rows[0][0]
            LOOKUP_HIT.inc()
            return True

    def __getitem__(self, hash_: bytes) -> InventoryItem:
        with self._lock:
            if hash_ in self._pending:
                return self._pending[hash_]
            rows = self._db.query(
                "SELECT objecttype, streamnumber, payload, expirestime, tag"
                " FROM inventory WHERE hash=?", (hash_,))
            if not rows:
                raise KeyError(hash_.hex())
            t, s, p, e, tag = rows[0]
            return InventoryItem(t, s, bytes(p), e, bytes(tag))

    def __setitem__(self, hash_: bytes, item: InventoryItem) -> None:
        with self._lock:
            if hash_ not in self._pending and hash_ not in self._known:
                ITEMS.inc()
            self._pending[hash_] = item
            self._known[hash_] = item.stream
            if self._digest is not None:
                self._digest.add(hash_, item.stream, item.expires)

    def __len__(self) -> int:
        """SQL rows plus the pending objects no row holds yet, counted
        when asked (no count is kept up on the insert path)."""
        with self._lock:
            pending = list(self._pending)
            n = self._db.query("SELECT count(*) FROM inventory")[0][0]
            n += len(pending)
            for i in range(0, len(pending), 500):
                chunk = pending[i:i + 500]
                n -= self._db.query(
                    "SELECT count(*) FROM inventory WHERE hash IN (%s)"
                    % ",".join("?" * len(chunk)), chunk)[0][0]
            return n

    def add(self, hash_: bytes, type_: int, stream: int, payload: bytes,
            expires: int, tag: bytes = b"") -> None:
        self[hash_] = InventoryItem(type_, stream, payload, expires, tag)

    def by_type_and_tag(self, object_type: int,
                        tag: bytes | None = None) -> list[InventoryItem]:
        sql = ("SELECT objecttype, streamnumber, payload, expirestime, tag"
               " FROM inventory WHERE objecttype=?")
        params: list = [object_type]
        if tag is not None:
            sql += " AND tag=?"
            params.append(tag)
        with self._lock:
            out = [v for v in self._pending.values()
                   if v.type == object_type
                   and (tag is None or v.tag == tag)]
            out += [InventoryItem(t, s, bytes(p), e, bytes(g))
                    for t, s, p, e, g in self._db.query(sql, params)]
            return out

    def unexpired_hashes_by_stream(self, stream: int) -> list[bytes]:
        now = int(time.time())
        with self._lock:
            hashes = [h for h, v in self._pending.items()
                      if v.stream == stream and v.expires > now]
            hashes += [bytes(h) for h, in self._db.query(
                "SELECT hash FROM inventory WHERE streamnumber=?"
                " AND expirestime>?", (stream, now))]
            return hashes

    def flush(self) -> None:
        with self._lock:
            if not self._pending:
                FLUSHES.inc()
                return
            self._db.executemany(
                "INSERT INTO inventory VALUES (?, ?, ?, ?, ?, ?)",
                [(h, v.type, v.stream, v.payload, v.expires, v.tag)
                 for h, v in self._pending.items()])
            self._pending.clear()
            FLUSHES.inc()

    def clean(self) -> None:
        """Purge objects >3h expired; rebuild the existence cache."""
        with self._lock:
            self._db.execute(
                "DELETE FROM inventory WHERE expirestime<?",
                (int(time.time()) - EXPIRES_GRACE,))
            self._known.clear()
            for h, v in self._pending.items():
                self._known[h] = v.stream
            if self._digest is not None:
                # expired objects must leave the announce view NOW,
                # not after the 3 h purge grace
                self._digest.clean(int(time.time()))
            ITEMS.set(len(self))

    def hashes(self) -> Iterable[bytes]:
        with self._lock:
            out = list(self._pending.keys())
            out += [bytes(h) for h, in self._db.query(
                "SELECT hash FROM inventory")]
            return out
