"""Crash-safe SQLite journal of PoW jobs with search checkpoints (copy
of ``pybitmessage_tpu.resilience.journal``: the same schema, so a
journal file written by either package is read by the other).

Every solve entering :class:`~pybitmessage_tpu_torch.pow.service.PowService`
is journaled before it is queued; the solver checkpoints the highest
nonce offset known to be fully searched (no hit below it) as slabs
harvest; completion deletes the row.  After a crash, surviving rows
are the exact set of objects whose PoW was pending, each carrying the
offset the resumed search should start from — an interrupted
network-difficulty solve does NOT restart from nonce 0.

Resume keying is ``(initial_hash, target)``: a re-submitted job with
the same payload bytes (in-process requeues, ack PoW, any retry that
does not rebuild the object shell) adopts the journaled checkpoint.
A retry that re-timestamps its payload gets a fresh initial hash and
honestly starts over — stale rows are purged by age on open.

The journal deliberately has its own connection (WAL, synchronous
NORMAL) instead of riding ``storage.db.Database``: a wedged message
store must not be able to deadlock PoW recovery, and the checkpoint
write cadence (~1 per slab harvest) stays off the store's lock.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import dataclass

from ..observability import REGISTRY
from .chaos import inject

JOURNAL_DEPTH = REGISTRY.gauge(
    "pow_journal_jobs", "PoW jobs currently journaled (queued or "
    "in flight)")
JOURNAL_RECOVERED = REGISTRY.counter(
    "pow_journal_recovered_total",
    "Jobs found pending in the journal at open (crash survivors)")
JOURNAL_CHECKPOINTS = REGISTRY.counter(
    "pow_journal_checkpoints_total",
    "Search-progress checkpoints written")
JOURNAL_RESUMES = REGISTRY.counter(
    "pow_journal_resume_total",
    "Solves that adopted a journaled nonce offset instead of 0")

QUEUED, INFLIGHT = "queued", "inflight"

#: rows older than this at open are abandoned work (their objects were
#: re-timestamped or given up on) — matches the default object TTL
MAX_AGE_SECONDS = 4 * 24 * 3600

_MASK64 = (1 << 64) - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS powjobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    initial_hash BLOB NOT NULL,
    target BLOB NOT NULL,              -- 8-byte big-endian u64
    start_nonce BLOB NOT NULL,         -- checkpoint, 8-byte big-endian
    status TEXT NOT NULL DEFAULT 'queued',
    attempts INTEGER NOT NULL DEFAULT 0,
    enqueued_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS powjobs_key
    ON powjobs (initial_hash, target);
"""


@dataclass
class PowJob:
    job_id: int
    initial_hash: bytes
    target: int
    start_nonce: int
    status: str
    attempts: int


def _u64(value: int) -> bytes:
    return (value & _MASK64).to_bytes(8, "big")


class PowJournal:
    """Thread-safe persistent PoW job journal (``:memory:`` for tests)."""

    def __init__(self, path: str = ":memory:", *,
                 max_age: float = MAX_AGE_SECONDS):
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(
            str(path), check_same_thread=False, isolation_level=None)
        with self._lock:
            cur = self._conn.cursor()
            if str(path) != ":memory:":
                cur.execute("PRAGMA journal_mode = WAL")
                cur.execute("PRAGMA synchronous = NORMAL")
            cur.executescript(_SCHEMA)
            # purge abandoned work, then adopt crash survivors
            cur.execute("DELETE FROM powjobs WHERE enqueued_at < ?",
                        (time.time() - max_age,))
            cur.execute(
                "UPDATE powjobs SET status=? WHERE status=?",
                (QUEUED, INFLIGHT))
            survivors = cur.execute(
                "SELECT COUNT(*) FROM powjobs").fetchone()[0]
        if survivors:
            JOURNAL_RECOVERED.inc(survivors)
        self._update_depth()

    def _update_depth(self) -> None:
        with self._lock:
            n = self._conn.execute(
                "SELECT COUNT(*) FROM powjobs").fetchone()[0]
        JOURNAL_DEPTH.set(n)

    # -- writes (all chaos-injectable at the db.write site) ------------------

    def add(self, initial_hash: bytes, target: int) -> tuple[int, int]:
        """Journal one job; returns ``(job_id, start_nonce)``.

        A pending row with the same ``(initial_hash, target)`` — an
        in-process requeue or a crash survivor — is adopted instead of
        duplicated, handing back its checkpointed offset.
        """
        inject("db.write")
        key = (initial_hash, _u64(target))
        with self._lock:
            row = self._conn.execute(
                "SELECT id, start_nonce FROM powjobs"
                " WHERE initial_hash=? AND target=?"
                " ORDER BY id LIMIT 1", key).fetchone()
            if row is not None:
                start = int.from_bytes(bytes(row[1]), "big")
                if start:
                    JOURNAL_RESUMES.inc()
                return int(row[0]), start
            now = time.time()
            cur = self._conn.execute(
                "INSERT INTO powjobs (initial_hash, target, start_nonce,"
                " status, enqueued_at, updated_at) VALUES (?,?,?,?,?,?)",
                (*key, _u64(0), QUEUED, now, now))
            job_id = cur.lastrowid
        self._update_depth()
        return job_id, 0

    def mark_inflight(self, job_id: int) -> None:
        inject("db.write")
        with self._lock:
            self._conn.execute(
                "UPDATE powjobs SET status=?, attempts=attempts+1,"
                " updated_at=? WHERE id=?",
                (INFLIGHT, time.time(), job_id))

    def checkpoint(self, job_id: int, next_nonce: int) -> None:
        """Record that every nonce below ``next_nonce`` was searched
        without a hit.  Monotonic: a stale (smaller) offset from an
        out-of-order harvest never rolls the checkpoint back."""
        inject("db.write")
        with self._lock:
            self._conn.execute(
                "UPDATE powjobs SET start_nonce=?, updated_at=?"
                " WHERE id=? AND start_nonce < ?",
                (_u64(next_nonce), time.time(), job_id,
                 _u64(next_nonce)))
        JOURNAL_CHECKPOINTS.inc()

    def requeue(self, job_id: int) -> None:
        inject("db.write")
        with self._lock:
            self._conn.execute(
                "UPDATE powjobs SET status=?, updated_at=? WHERE id=?",
                (QUEUED, time.time(), job_id))

    def complete(self, job_id: int) -> None:
        inject("db.write")
        with self._lock:
            self._conn.execute("DELETE FROM powjobs WHERE id=?",
                               (job_id,))
        self._update_depth()

    # -- reads ---------------------------------------------------------------

    def pending(self) -> list[PowJob]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, initial_hash, target, start_nonce, status,"
                " attempts FROM powjobs ORDER BY id").fetchall()
        return [PowJob(int(r[0]), bytes(r[1]),
                       int.from_bytes(bytes(r[2]), "big"),
                       int.from_bytes(bytes(r[3]), "big"), r[4],
                       int(r[5]))
                for r in rows]

    def get(self, job_id: int) -> PowJob | None:
        with self._lock:
            r = self._conn.execute(
                "SELECT id, initial_hash, target, start_nonce, status,"
                " attempts FROM powjobs WHERE id=?", (job_id,)).fetchone()
        if r is None:
            return None
        return PowJob(int(r[0]), bytes(r[1]),
                      int.from_bytes(bytes(r[2]), "big"),
                      int.from_bytes(bytes(r[3]), "big"), r[4], int(r[5]))

    def pending_count(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM powjobs").fetchone()[0]

    def close(self) -> None:
        with self._lock:
            self._conn.commit()
            self._conn.close()
