"""Typed accessors over the inbox/sent/pubkeys tables (copy of
``pybitmessage_tpu.storage.messages``).

The send-state machine lives in ``sent.status`` exactly as in the
reference (class_singleWorker.py): msgqueued -> doingpubkeypow ->
awaitingpubkey -> doingmsgpow -> msgsent -> ackreceived, with
``sleeptill``/``retrynumber`` driving resend backoff.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .db import Database

# sent.status values (reference class_singleWorker.py state machine)
MSGQUEUED = "msgqueued"
DOINGPUBKEYPOW = "doingpubkeypow"
AWAITINGPUBKEY = "awaitingpubkey"
DOINGMSGPOW = "doingmsgpow"
FORCEPOW = "forcepow"
MSGSENT = "msgsent"
MSGSENTNOACKEXPECTED = "msgsentnoackexpected"
ACKRECEIVED = "ackreceived"
BROADCASTQUEUED = "broadcastqueued"
DOINGBROADCASTPOW = "doingbroadcastpow"
BROADCASTSENT = "broadcastsent"


@dataclass
class SentMessage:
    msgid: bytes
    toaddress: str
    toripe: bytes
    fromaddress: str
    subject: str
    message: str
    ackdata: bytes
    senttime: int
    lastactiontime: int
    sleeptill: int
    status: str
    retrynumber: int
    folder: str
    encodingtype: int
    ttl: int


@dataclass
class InboxMessage:
    msgid: bytes
    toaddress: str
    fromaddress: str
    subject: str
    received: str
    message: str
    folder: str
    encodingtype: int
    read: bool
    sighash: bytes


class MessageStore:
    def __init__(self, db: Database):
        self._db = db

    # -- sent ----------------------------------------------------------------

    def queue_sent(self, *, msgid: bytes, toaddress: str, toripe: bytes,
                   fromaddress: str, subject: str, message: str,
                   ackdata: bytes, ttl: int, encoding: int = 2,
                   status: str = MSGQUEUED, folder: str = "sent") -> None:
        """Insert a message in the outgoing state machine
        (reference: helper_sent.insert)."""
        now = int(time.time())
        self._db.execute(
            "INSERT INTO sent VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (msgid, toaddress, toripe, fromaddress, subject, message,
             ackdata, now, now, 0, status, 0, folder, encoding, ttl))

    def sent_by_status(self, *statuses: str) -> list[SentMessage]:
        marks = ",".join("?" * len(statuses))
        rows = self._db.query(
            "SELECT msgid, toaddress, toripe, fromaddress, subject, message,"
            " ackdata, senttime, lastactiontime, sleeptill, status,"
            " retrynumber, folder, encodingtype, ttl FROM sent"
            f" WHERE status IN ({marks}) AND folder='sent'", statuses)
        return [self._sent_row(r) for r in rows]

    def sent_by_ackdata(self, ackdata: bytes) -> SentMessage | None:
        rows = self._db.query(
            "SELECT msgid, toaddress, toripe, fromaddress, subject, message,"
            " ackdata, senttime, lastactiontime, sleeptill, status,"
            " retrynumber, folder, encodingtype, ttl FROM sent"
            " WHERE ackdata=?", (ackdata,))
        return self._sent_row(rows[0]) if rows else None

    def update_sent_status(self, ackdata: bytes, status: str,
                           sleeptill: int = 0) -> None:
        self._db.execute(
            "UPDATE sent SET status=?, lastactiontime=?, sleeptill=?"
            " WHERE ackdata=?",
            (status, int(time.time()), sleeptill, ackdata))

    def bump_retry(self, ackdata: bytes, new_ttl: int, sleeptill: int) -> None:
        self._db.execute(
            "UPDATE sent SET retrynumber=retrynumber+1, ttl=?, sleeptill=?,"
            " lastactiontime=? WHERE ackdata=?",
            (new_ttl, sleeptill, int(time.time()), ackdata))

    def due_for_resend(self, now: int | None = None) -> list[SentMessage]:
        """msgsent/awaitingpubkey messages whose sleeptill has passed
        (reference: class_singleCleaner.py:92-106)."""
        now = now or int(time.time())
        rows = self._db.query(
            "SELECT msgid, toaddress, toripe, fromaddress, subject, message,"
            " ackdata, senttime, lastactiontime, sleeptill, status,"
            " retrynumber, folder, encodingtype, ttl FROM sent"
            " WHERE status IN ('msgsent','awaitingpubkey') AND sleeptill<?"
            " AND folder='sent'", (now,))
        return [self._sent_row(r) for r in rows]

    @staticmethod
    def _sent_row(r) -> SentMessage:
        return SentMessage(
            bytes(r[0]) if r[0] is not None else b"", r[1],
            bytes(r[2]) if r[2] is not None else b"", r[3], r[4], r[5],
            bytes(r[6]) if r[6] is not None else b"", r[7], r[8], r[9],
            r[10], r[11], r[12], r[13], r[14])

    def reset_interrupted_pow(self) -> None:
        """On startup, anything mid-PoW goes back to queued
        (reference: class_singleWorker.py:534-538, 720-724)."""
        self._db.execute(
            "UPDATE sent SET status='msgqueued'"
            " WHERE status IN ('doingpubkeypow','doingmsgpow')")
        self._db.execute(
            "UPDATE sent SET status='broadcastqueued'"
            " WHERE status='doingbroadcastpow'")

    # -- inbox ---------------------------------------------------------------

    def deliver_inbox(self, *, msgid: bytes, toaddress: str,
                      fromaddress: str, subject: str, message: str,
                      encoding: int = 2, sighash: bytes = b"") -> bool:
        """Insert into inbox; returns False on duplicate sighash
        (dedup, reference: class_objectProcessor.py:644-650)."""
        if sighash:
            dup = self._db.query(
                "SELECT COUNT(*) FROM inbox WHERE sighash=?", (sighash,))
            if dup[0][0]:
                return False
        self._db.execute(
            "INSERT INTO inbox VALUES (?,?,?,?,?,?,?,?,?,?)",
            (msgid, toaddress, fromaddress, subject,
             str(int(time.time())), message, "inbox", encoding, False,
             sighash))
        return True

    def inbox(self, include_trash: bool = False) -> list[InboxMessage]:
        where = "" if include_trash else " WHERE folder='inbox'"
        rows = self._db.query(
            "SELECT msgid, toaddress, fromaddress, subject, received,"
            " message, folder, encodingtype, read, sighash FROM inbox"
            + where)
        return [InboxMessage(bytes(r[0]), r[1], r[2], r[3], r[4], r[5],
                             r[6], r[7], bool(r[8]),
                             bytes(r[9]) if r[9] is not None else b"")
                for r in rows]

    def trash_inbox(self, msgid: bytes) -> None:
        self._db.execute(
            "UPDATE inbox SET folder='trash' WHERE msgid=?", (msgid,))

    def undelete_inbox(self, msgid: bytes) -> None:
        """Move a trashed message back (reference HandleUndeleteMessage)."""
        self._db.execute(
            "UPDATE inbox SET folder='inbox' WHERE msgid=?", (msgid,))

    def inbox_by_id(self, msgid: bytes) -> InboxMessage | None:
        rows = self._db.query(
            "SELECT msgid, toaddress, fromaddress, subject, received,"
            " message, folder, encodingtype, read, sighash FROM inbox"
            " WHERE msgid=?", (msgid,))
        if not rows:
            return None
        r = rows[0]
        return InboxMessage(bytes(r[0]), r[1], r[2], r[3], r[4], r[5],
                            r[6], r[7], bool(r[8]),
                            bytes(r[9]) if r[9] is not None else b"")

    def mark_read(self, msgid: bytes, read: bool = True) -> None:
        self._db.execute("UPDATE inbox SET read=? WHERE msgid=?",
                         (read, msgid))

    #: fields a search may be restricted to (reference
    #: helper_search.py:34-43); anything else searches all four
    SEARCH_FIELDS = ("toaddress", "fromaddress", "subject", "message")

    def search(self, folder: str, what: str, where: str | None = None,
               unread_only: bool = False):
        """LIKE-search messages (reference helper_search.search_sql).

        ``folder``: 'inbox', 'trash', 'sent', or 'new' (= unread
        inbox).  ``where`` restricts to one field from
        :data:`SEARCH_FIELDS`; any other value (or None) matches the
        concatenation of all four.  SQLite LIKE is case-insensitive
        for ASCII, matching the reference's behavior.
        """
        field = where if where in self.SEARCH_FIELDS else \
            "toaddress || fromaddress || subject || message"
        pat = "%" + what + "%" if what else "%"
        if folder == "sent":
            rows = self._db.query(
                "SELECT msgid, toaddress, toripe, fromaddress, subject,"
                " message, ackdata, senttime, lastactiontime, sleeptill,"
                " status, retrynumber, folder, encodingtype, ttl FROM sent"
                " WHERE folder='sent' AND " + field + " LIKE ?"
                " ORDER BY lastactiontime", (pat,))
            return [self._sent_row(r) for r in rows]
        if folder == "new":
            folder, unread_only = "inbox", True
        clauses = ["folder=?", field + " LIKE ?"]
        args: list = [folder, pat]
        if unread_only:
            clauses.append("read=0")
        rows = self._db.query(
            "SELECT msgid, toaddress, fromaddress, subject, received,"
            " message, folder, encodingtype, read, sighash FROM inbox"
            " WHERE " + " AND ".join(clauses), tuple(args))
        return [InboxMessage(bytes(r[0]), r[1], r[2], r[3], r[4], r[5],
                             r[6], r[7], bool(r[8]),
                             bytes(r[9]) if r[9] is not None else b"")
                for r in rows]

    def all_sent(self) -> list[SentMessage]:
        rows = self._db.query(
            "SELECT msgid, toaddress, toripe, fromaddress, subject, message,"
            " ackdata, senttime, lastactiontime, sleeptill, status,"
            " retrynumber, folder, encodingtype, ttl FROM sent"
            " WHERE folder='sent'")
        return [self._sent_row(r) for r in rows]

    def sent_by_id(self, msgid: bytes) -> SentMessage | None:
        rows = self._db.query(
            "SELECT msgid, toaddress, toripe, fromaddress, subject, message,"
            " ackdata, senttime, lastactiontime, sleeptill, status,"
            " retrynumber, folder, encodingtype, ttl FROM sent"
            " WHERE msgid=?", (msgid,))
        return self._sent_row(rows[0]) if rows else None

    def trash_sent(self, msgid: bytes) -> None:
        self._db.execute(
            "UPDATE sent SET folder='trash' WHERE msgid=?", (msgid,))

    def trash_sent_by_ackdata(self, ackdata: bytes) -> None:
        self._db.execute(
            "UPDATE sent SET folder='trash' WHERE ackdata=?", (ackdata,))

    # -- addressbook ---------------------------------------------------------

    def addressbook(self) -> list[tuple[str, str]]:
        return [(r[0], r[1]) for r in self._db.query(
            "SELECT label, address FROM addressbook")]

    def addressbook_add(self, address: str, label: str) -> bool:
        exists = self._db.query(
            "SELECT COUNT(*) FROM addressbook WHERE address=?", (address,))
        if exists[0][0]:
            return False
        self._db.execute("INSERT INTO addressbook VALUES (?,?)",
                         (label, address))
        return True

    def addressbook_delete(self, address: str) -> None:
        self._db.execute("DELETE FROM addressbook WHERE address=?",
                         (address,))

    # -- black/whitelist -----------------------------------------------------
    # Reference: the Qt frontend maintains ``blacklist``/``whitelist``
    # tables and a ``blackwhitelist`` mode setting; objectProcessor
    # drops inbound messages from blacklisted senders (or, in whitelist
    # mode, from anyone NOT whitelisted) before inbox insertion
    # (src/class_objectProcessor.py processmsg, bitmessageqt/blacklist.py).

    # Table names cannot be bound parameters; check against an explicit
    # allowlist (raises, unlike assert, even under ``python -O``).
    @staticmethod
    def _bw_table(which: str) -> str:
        if which not in ("blacklist", "whitelist"):
            raise ValueError(f"not a black/whitelist table: {which!r}")
        return which

    def listing(self, which: str) -> list[tuple[str, str, bool]]:
        """(label, address, enabled) rows of 'blacklist' or 'whitelist'."""
        table = self._bw_table(which)
        return [(r[0], r[1], bool(r[2])) for r in self._db.query(
            "SELECT label, address, enabled FROM %s" % table)]

    def listing_add(self, which: str, address: str, label: str,
                    enabled: bool = True) -> bool:
        table = self._bw_table(which)
        if self._db.query("SELECT COUNT(*) FROM %s WHERE address=?" % table,
                          (address,))[0][0]:
            return False
        self._db.execute("INSERT INTO %s VALUES (?,?,?)" % table,
                         (label, address, bool(enabled)))
        return True

    def listing_delete(self, which: str, address: str) -> None:
        self._db.execute(
            "DELETE FROM %s WHERE address=?" % self._bw_table(which),
            (address,))

    def listing_set_enabled(self, which: str, address: str,
                            enabled: bool) -> None:
        self._db.execute(
            "UPDATE %s SET enabled=? WHERE address=?" % self._bw_table(which),
            (int(enabled), address))

    def sender_allowed(self, from_address: str, mode: str) -> bool:
        """Apply the black/whitelist policy to an inbound sender.

        ``mode``: 'black' — allow unless on an enabled blacklist row;
        'white' — allow only when on an enabled whitelist row.
        """
        if mode == "white":
            return bool(self._db.query(
                "SELECT COUNT(*) FROM whitelist WHERE address=? AND enabled=1",
                (from_address,))[0][0])
        return not self._db.query(
            "SELECT COUNT(*) FROM blacklist WHERE address=? AND enabled=1",
            (from_address,))[0][0]

    # -- pubkeys -------------------------------------------------------------

    def store_pubkey(self, address: str, version: int, payload: bytes,
                     used_personally: bool = False) -> None:
        self._db.execute(
            "INSERT INTO pubkeys VALUES (?,?,?,?,?)",
            (address, version, payload, int(time.time()),
             "yes" if used_personally else "no"))

    def get_pubkey(self, address: str) -> bytes | None:
        rows = self._db.query(
            "SELECT transmitdata FROM pubkeys WHERE address=?", (address,))
        return bytes(rows[0][0]) if rows else None

    def purge_stale_pubkeys(self, max_age: int = 28 * 24 * 3600) -> int:
        return self._db.execute(
            "DELETE FROM pubkeys WHERE time<? AND usedpersonally='no'",
            (int(time.time()) - max_age,))

    # -- objectprocessorqueue persistence ------------------------------------
    # Unprocessed network objects survive a restart (reference
    # class_objectProcessor.py:47-60 replay, 111-127 shutdown flush).

    def persist_objectprocessor_queue(self, payloads: list[bytes]) -> None:
        for p in payloads:
            objtype = int.from_bytes(p[16:20], "big") if len(p) >= 20 else 0
            self._db.execute(
                "INSERT INTO objectprocessorqueue (objecttype, data) "
                "VALUES (?, ?)", (objtype, p))

    def pop_objectprocessor_queue(self) -> list[bytes]:
        rows = self._db.query("SELECT data FROM objectprocessorqueue")
        self._db.execute("DELETE FROM objectprocessorqueue")
        return [bytes(r[0]) for r in rows]
