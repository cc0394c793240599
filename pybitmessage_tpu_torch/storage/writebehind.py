"""Write-behind buffer over the message store — SQL off the hot loop (copy
of ``pybitmessage_tpu.storage.writebehind``).

The ingest fast path's store stage: inbox deliveries, pubkey inserts
and sent-ack status updates land in an in-memory buffer and are
drained as ONE SQLite transaction per flush
(:meth:`.db.Database.execute_batch`,
``executemany`` under the existing single-writer lock).  Under flood
traffic that replaces one autocommit fsync per object with one per
drain window.

Correctness rules:

- the sighash dedup that guards :meth:`deliver_inbox` consults the
  pending buffer AND the database, so a duplicate arriving before the
  first copy flushed is still dropped;
- :meth:`get_pubkey` is buffer-aware for the same reason;
- a failed drain (a locked database) keeps every row buffered —
  nothing is lost, the next drain retries; :meth:`flush` on shutdown
  drains what remains;
- everything else passes straight through to the wrapped
  :class:`.messages.MessageStore`.

Thread-safe: stage callbacks buffer from the event loop while the
drain runs in an executor thread.  Drain sizes, outcomes and the
buffered rows go to the JAX store's metric families; an inbox insert
marks the object's lifecycle ``stored``.
"""

from __future__ import annotations

import logging
import threading
import time

from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..observability.lifecycle import LIFECYCLE
from .messages import MessageStore

logger = logging.getLogger("pybitmessage_tpu_torch.storage")

FLUSH_SIZE = REGISTRY.histogram(
    "storage_write_behind_flush_size",
    "Buffered rows drained per write-behind flush (one transaction)",
    buckets=DEFAULT_SIZE_BUCKETS)
FLUSHES = REGISTRY.counter(
    "storage_write_behind_flushes_total",
    "Write-behind drain attempts by outcome", ("result",))
PENDING = REGISTRY.gauge(
    "storage_write_behind_pending",
    "Rows currently buffered awaiting the next drain")

_INSERT_INBOX = "INSERT INTO inbox VALUES (?,?,?,?,?,?,?,?,?,?)"
_INSERT_PUBKEY = "INSERT INTO pubkeys VALUES (?,?,?,?,?)"
_UPDATE_SENT = ("UPDATE sent SET status=?, lastactiontime=?, sleeptill=?"
                " WHERE ackdata=?")


class WriteBehindStore:
    """MessageStore facade buffering the ingest-path writes."""

    def __init__(self, store: MessageStore, max_rows: int = 512):
        self._store = store
        self._db = store._db
        #: a buffer larger than this triggers an immediate drain
        #: (the processor checks :meth:`should_flush` per object)
        self.max_rows = max_rows
        self._lock = threading.Lock()
        self._inbox: list[tuple] = []
        self._pubkeys: list[tuple] = []
        self._sent: list[tuple] = []
        self._pending_sighashes: set[bytes] = set()
        self._pending_pubkeys: dict[str, bytes] = {}

    # everything not intercepted passes through to the real store
    def __getattr__(self, name):
        return getattr(self._store, name)

    # -- buffered writes -----------------------------------------------------

    def deliver_inbox(self, *, msgid: bytes, toaddress: str,
                      fromaddress: str, subject: str, message: str,
                      encoding: int = 2, sighash: bytes = b"") -> bool:
        """Buffer an inbox insert; returns False on duplicate sighash
        (checked against the buffer AND the database)."""
        with self._lock:
            if sighash:
                if sighash in self._pending_sighashes:
                    return False
                dup = self._db.query(
                    "SELECT COUNT(*) FROM inbox WHERE sighash=?",
                    (sighash,))
                if dup[0][0]:
                    return False
                self._pending_sighashes.add(sighash)
            self._inbox.append(
                (msgid, toaddress, fromaddress, subject,
                 str(int(time.time())), message, "inbox", encoding,
                 False, sighash))
            self._update_gauge()
        # msgid is the inventory hash: "stored" marks acceptance into
        # the (buffered) store, not the fsync
        LIFECYCLE.record(msgid, "stored")
        return True

    def store_pubkey(self, address: str, version: int, payload: bytes,
                     used_personally: bool = False) -> None:
        with self._lock:
            self._pending_pubkeys[address] = payload
            self._pubkeys.append(
                (address, version, payload, int(time.time()),
                 "yes" if used_personally else "no"))
            self._update_gauge()

    def update_sent_status(self, ackdata: bytes, status: str,
                           sleeptill: int = 0) -> None:
        with self._lock:
            self._sent.append(
                (status, int(time.time()), sleeptill, ackdata))
            self._update_gauge()

    # -- buffer-aware reads --------------------------------------------------

    def get_pubkey(self, address: str) -> bytes | None:
        with self._lock:
            pending = self._pending_pubkeys.get(address)
        if pending is not None:
            return pending
        return self._store.get_pubkey(address)

    # -- draining ------------------------------------------------------------

    def pending_rows(self) -> int:
        with self._lock:
            return len(self._inbox) + len(self._pubkeys) + len(self._sent)

    def should_flush(self) -> bool:
        return self.pending_rows() >= self.max_rows

    def _update_gauge(self) -> None:
        # caller holds the lock
        PENDING.set(len(self._inbox) + len(self._pubkeys)
                    + len(self._sent))

    def flush(self) -> bool:
        """Drain the buffer in one transaction; False when the write
        failed (rows stay buffered for the next drain)."""
        with self._lock:
            inbox, pubkeys, sent = self._inbox, self._pubkeys, self._sent
            if not (inbox or pubkeys or sent):
                return True
            self._inbox, self._pubkeys, self._sent = [], [], []
        n = len(inbox) + len(pubkeys) + len(sent)
        try:
            self._db.execute_batch([
                (_INSERT_INBOX, inbox),
                (_INSERT_PUBKEY, pubkeys),
                (_UPDATE_SENT, sent),
            ])
        except Exception:
            # transaction rolled back whole — restore FIFO order ahead
            # of anything buffered while the drain ran
            with self._lock:
                self._inbox = inbox + self._inbox
                self._pubkeys = pubkeys + self._pubkeys
                self._sent = sent + self._sent
                self._update_gauge()
            FLUSHES.labels(result="failed").inc()
            logger.exception("write-behind drain failed; %d row(s) "
                             "kept buffered for the next drain", n)
            return False
        with self._lock:
            for row in inbox:
                self._pending_sighashes.discard(row[9])
            for row in pubkeys:
                # only clear the sentinel if no NEWER buffered write
                # superseded it while the drain ran
                if self._pending_pubkeys.get(row[0]) is row[2]:
                    del self._pending_pubkeys[row[0]]
            self._update_gauge()
        FLUSH_SIZE.observe(n)
        FLUSHES.labels(result="ok").inc()
        return True
