"""Crash-safe farm job journal: the PoW journal plus scheduling meta
(copy of ``pybitmessage_tpu.powfarm.journal``; the same table and
column, so a farm journal written by either package is adopted by the
other).

The farm daemon journals every *accepted* job before it is queued —
the same crash-safety contract :class:`~pybitmessage_tpu_torch.pow.
service.PowService` gives local solves (resilience/journal.py), reused rather
than re-invented: keyed ``(initial_hash, target)`` with monotonic
nonce checkpoints and ``inflight -> queued`` adoption at open.

What the base journal cannot carry is *scheduling* state: which
tenant owns a job and which lane it rides.  Without it, a restarted
farm would re-run recovered work outside the fairness machinery (one
tenant's crash backlog could starve everyone else's fresh traffic).
:class:`FarmJournal` adds a ``meta`` JSON column (idempotent
``ALTER TABLE`` migration — a journal written by the base class stays
readable) and :meth:`pending_meta` hands recovered jobs back with
their tenant/lane so restart adoption re-enters WDRR correctly.
"""

from __future__ import annotations

import json
import sqlite3

from ..resilience.journal import MAX_AGE_SECONDS, PowJob, PowJournal


class FarmJournal(PowJournal):
    """Persistent farm job journal (``:memory:`` for tests)."""

    def __init__(self, path: str = ":memory:", *,
                 max_age: float = MAX_AGE_SECONDS):
        super().__init__(path, max_age=max_age)
        with self._lock:
            try:
                self._conn.execute(
                    "ALTER TABLE powjobs ADD COLUMN meta TEXT")
            except sqlite3.OperationalError:
                pass                 # column already exists

    def add(self, initial_hash: bytes, target: int,
            meta: dict | None = None) -> tuple[int, int]:
        """Journal one job with scheduling meta; returns
        ``(job_id, start_nonce)``.  Dedupe/adoption semantics are the
        base class's (one copy of the invariant, including the resume
        metric); the meta column is filled only where it is still
        NULL, so a re-submission never overwrites the adopted row's
        original tenant/lane."""
        job_id, start = super().add(initial_hash, target)
        if meta:
            with self._lock:
                self._conn.execute(
                    "UPDATE powjobs SET meta=? WHERE id=?"
                    " AND meta IS NULL",
                    (json.dumps(meta), job_id))
        return job_id, start

    def pending_meta(self) -> list[tuple]:
        """Pending jobs with their scheduling meta:
        ``[(PowJob, {"tenant": ..., "lane": ...} | {}), ...]``."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, initial_hash, target, start_nonce, status,"
                " attempts, meta FROM powjobs ORDER BY id").fetchall()
        out = []
        for r in rows:
            job = PowJob(int(r[0]), bytes(r[1]),
                         int.from_bytes(bytes(r[2]), "big"),
                         int.from_bytes(bytes(r[3]), "big"), r[4],
                         int(r[5]))
            meta = {}
            if r[6]:
                try:
                    meta = json.loads(r[6])
                except (ValueError, TypeError):
                    meta = {}
            out.append((job, meta))
        return out
