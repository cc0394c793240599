"""SQLite message store (copy of ``pybitmessage_tpu.storage.db``; each
write attempt is the ``db.write`` chaos site, absorbed by the bounded
retry as a locked database is).

Schema matches the reference's v11 (src/class_sqlThread.py:49-84) so the
data model carries over one-to-one: inbox, sent, subscriptions,
addressbook, blacklist, whitelist, pubkeys, inventory, settings,
objectprocessorqueue.

All access goes through one connection guarded by an RLock — the same
single-writer discipline the reference enforces with a dedicated SQL
thread + submit/return queues (src/helper_sql.py:24-35).
"""

from __future__ import annotations

import logging
import sqlite3
import threading
import time
from typing import Any, Iterable, Sequence

from ..resilience.chaos import ChaosError, inject
from ..resilience.policy import ERRORS, RetryPolicy

logger = logging.getLogger("pybitmessage_tpu_torch.db")

SCHEMA_VERSION = 12

#: the version ``_SCHEMA`` below creates; _SCHEMA is frozen here —
#: every later schema change goes into MIGRATIONS, which fresh and
#: existing databases BOTH run (so the two paths cannot diverge)
BASELINE_VERSION = 11

#: Ordered migration registry: target version -> SQL statements that
#: bring a (target-1) database to it.  The reference evolves its schema
#: through 11 in-place upgrade steps (class_sqlThread.py:94-460); this
#: framework starts AT the v11-equivalent baseline, so 11 is a recorded
#: no-op — the hook exists so the first post-ship schema change is a
#: dict entry + SCHEMA_VERSION bump, not a redesign.  The current
#: version lives in ``PRAGMA user_version`` (mirrored to the settings
#: table for reference-parity introspection).
MIGRATIONS: dict[int, tuple[str, ...]] = {
    BASELINE_VERSION: (),   # baseline: reference-v11-equivalent schema
    # v12: cover the two hot inventory scans.  At retention scale the
    # catch-up path (unexpired_hashes_by_stream: WHERE streamnumber=?
    # AND expirestime>?) and the TTL purge (clean: WHERE
    # expirestime<?) were full-table scans — the UNIQUE(hash) index
    # helps neither.
    12: (
        "CREATE INDEX IF NOT EXISTS idx_inventory_stream_expires"
        " ON inventory(streamnumber, expirestime)",
        "CREATE INDEX IF NOT EXISTS idx_inventory_expires"
        " ON inventory(expirestime)",
    ),
}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS inbox (
    msgid blob, toaddress text, fromaddress text, subject text,
    received text, message text, folder text, encodingtype int,
    read bool, sighash blob, UNIQUE(msgid) ON CONFLICT REPLACE);
CREATE TABLE IF NOT EXISTS sent (
    msgid blob, toaddress text, toripe blob, fromaddress text,
    subject text, message text, ackdata blob, senttime integer,
    lastactiontime integer, sleeptill integer, status text,
    retrynumber integer, folder text, encodingtype int, ttl int);
CREATE TABLE IF NOT EXISTS subscriptions (
    label text, address text, enabled bool);
CREATE TABLE IF NOT EXISTS addressbook (
    label text, address text, UNIQUE(address) ON CONFLICT IGNORE);
CREATE TABLE IF NOT EXISTS blacklist (label text, address text, enabled bool);
CREATE TABLE IF NOT EXISTS whitelist (label text, address text, enabled bool);
CREATE TABLE IF NOT EXISTS pubkeys (
    address text, addressversion int, transmitdata blob, time int,
    usedpersonally text, UNIQUE(address) ON CONFLICT REPLACE);
CREATE TABLE IF NOT EXISTS inventory (
    hash blob, objecttype int, streamnumber int, payload blob,
    expirestime integer, tag blob, UNIQUE(hash) ON CONFLICT REPLACE);
CREATE TABLE IF NOT EXISTS settings (
    key blob, value blob, UNIQUE(key) ON CONFLICT REPLACE);
CREATE TABLE IF NOT EXISTS objectprocessorqueue (
    objecttype int, data blob, UNIQUE(objecttype, data) ON CONFLICT REPLACE);
"""


class Database:
    """Thread-safe SQLite store.  ``path=':memory:'`` for tests."""

    def __init__(self, path: str = ":memory:"):
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None)
        self._conn.text_factory = str
        with self._lock:
            cur = self._conn.cursor()
            if path != ":memory:":
                cur.execute("PRAGMA journal_mode = WAL")
            cur.execute("PRAGMA secure_delete = true")
            fresh = not cur.execute(
                "SELECT 1 FROM sqlite_master WHERE type='table'"
                " AND name='sent'").fetchone()
            cur.executescript(_SCHEMA)
            if fresh:
                # _SCHEMA creates the frozen baseline; the migration
                # ladder below brings fresh installs to HEAD too, so a
                # MIGRATIONS entry is the single source of truth
                cur.execute("PRAGMA user_version = %d" % BASELINE_VERSION)
            self._migrate(cur)
            # only ever raise the stamp: a database touched by a NEWER
            # build must keep its higher version or that build would
            # re-run its migrations on an already-migrated schema
            current = cur.execute("PRAGMA user_version").fetchone()[0]
            stamp = max(current, SCHEMA_VERSION)
            cur.execute("PRAGMA user_version = %d" % stamp)
            cur.execute(
                "INSERT OR REPLACE INTO settings VALUES('version', ?)",
                (str(stamp),))
            cur.execute(
                "INSERT OR IGNORE INTO settings VALUES('lastvacuumtime', ?)",
                (int(time.time()),))

    def _migrate(self, cur) -> None:
        """Apply MIGRATIONS above the recorded version, in order
        (reference class_sqlThread.py:94-460 upgrade ladder)."""
        current = cur.execute("PRAGMA user_version").fetchone()[0]
        if current == 0:
            # pre-user_version database: adopt the settings-table
            # version stamp (always written since round 1)
            row = cur.execute(
                "SELECT value FROM settings WHERE key='version'").fetchone()
            current = int(row[0]) if row else SCHEMA_VERSION
        for target in sorted(MIGRATIONS):
            if target <= current:
                continue
            for statement in MIGRATIONS[target]:
                cur.execute(statement)
            cur.execute("PRAGMA user_version = %d" % target)
            current = target

    # -- generic access ------------------------------------------------------

    #: transient SQLite write failures retried with backoff before the
    #: error surfaces (reference helper_sql retries "database is
    #: locked" the same way); class-level so tests can tighten it
    WRITE_ATTEMPTS = 3

    def _write_retry(self, fn):
        """Run one write with bounded backoff on transient failures;
        each attempt is the ``db.write`` chaos site."""
        def attempt():
            inject("db.write")
            return fn()

        try:
            return RetryPolicy(attempts=self.WRITE_ATTEMPTS,
                               base_delay=0.02, max_delay=0.5).call(
                attempt, site="db.write",
                retry_on=(sqlite3.OperationalError, ChaosError))
        except (sqlite3.OperationalError, ChaosError):
            ERRORS.labels(site="db.write").inc()
            logger.exception("SQLite write failed after %d attempts",
                             self.WRITE_ATTEMPTS)
            raise

    def execute(self, sql: str, params: Sequence[Any] = ()) -> int:
        """Run one statement; returns rowcount."""
        def run():
            with self._lock:
                cur = self._conn.cursor()
                cur.execute(sql, params)
                return cur.rowcount
        if not sql.lstrip()[:6].upper().startswith("SELECT"):
            return self._write_retry(run)
        return run()

    def executemany(self, sql: str, rows: Iterable[Sequence[Any]]) -> None:
        rows = list(rows)

        def run():
            with self._lock:
                self._conn.cursor().executemany(sql, rows)
        self._write_retry(run)

    def execute_batch(
            self, ops: Sequence[tuple[str, Sequence[Sequence[Any]]]]
    ) -> None:
        """Run ``[(sql, rows), ...]`` as ONE transaction (executemany
        per statement) under the single-writer lock.

        The write-behind drain path: a whole coalescing window's worth
        of inbox/pubkey/sent-status rows lands in a single fsync
        instead of one autocommit transaction per row.  Goes through
        :meth:`_write_retry`; on failure the transaction rolls back
        atomically — callers keep their rows buffered and retry the
        next drain.
        """
        ops = [(sql, list(rows)) for sql, rows in ops if rows]
        if not ops:
            return

        def run():
            with self._lock:
                cur = self._conn.cursor()
                cur.execute("BEGIN")
                try:
                    for sql, rows in ops:
                        cur.executemany(sql, rows)
                except BaseException:
                    cur.execute("ROLLBACK")
                    raise
                cur.execute("COMMIT")
        self._write_retry(run)

    def query(self, sql: str, params: Sequence[Any] = ()) -> list[tuple]:
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(sql, params)
            return cur.fetchall()

    def vacuum(self) -> None:
        with self._lock:
            self._conn.execute("VACUUM")
            self.execute(
                "UPDATE settings SET value=? WHERE key='lastvacuumtime'",
                (int(time.time()),))

    def close(self) -> None:
        with self._lock:
            self._conn.commit()
            self._conn.close()

    # -- settings ------------------------------------------------------------

    def get_setting(self, key: str, default: str | None = None) -> str | None:
        rows = self.query("SELECT value FROM settings WHERE key=?", (key,))
        return rows[0][0] if rows else default

    def set_setting(self, key: str, value: str) -> None:
        self.execute("INSERT INTO settings VALUES(?, ?)", (key, value))
