"""Import a reference-PyBitmessage data directory into this framework
(copy of ``pybitmessage_tpu.migrate``).

The role of the reference's migration machinery (bitmessageqt/
migrationwizard.py + the settingsversion upgrade chains in
helper_startup.py / class_sqlThread.py), redesigned for the actual
switching problem a reference user has: their identities, contacts,
messages and peer table live in the reference's on-disk formats —

- ``keys.dat``     INI, one ``BM-…`` section per identity with WIF
  private keys and per-address options (class_addressGenerator.py:
  180-197, account.py:228-229),
- ``messages.dat`` SQLite schema v11: inbox, sent, addressbook,
  subscriptions, blacklist, whitelist (class_sqlThread.py:49-84),
- ``knownnodes.dat`` JSON ``[{stream, peer:{host,port}, info:{…}}]``
  (network/knownnodes.py:52-78)

— and all three import losslessly because this framework's stores are
field-compatible by design.  Each importer is idempotent (re-running
skips rows that already exist) and never overwrites an existing local
identity.

Usage:  python -m pybitmessage_tpu_torch.migrate ~/.config/PyBitmessage ~/.bm
"""

from __future__ import annotations

import argparse
import configparser
import json
import sqlite3
import sys
from pathlib import Path

from .crypto.keys import priv_to_pub, wif_decode
from .utils.addresses import decode_address
from .utils.hashes import address_ripe


def import_identities(keys_dat: Path, keystore) -> int:
    """Merge the reference keys.dat identities into our keystore.

    WIF keys, per-address PoW demands, chan/mailinglist/gateway flags
    all carry over; the RIPE is recomputed from the keys and checked
    against the section's address so a corrupt file cannot plant a
    mismatched identity.
    """
    from .workers.keystore import OwnIdentity

    cfg = configparser.ConfigParser(interpolation=None)
    cfg.optionxform = str
    cfg.read(keys_dat)
    imported = 0
    for section in cfg.sections():
        if not section.startswith("BM-") or section in keystore.identities:
            continue
        s = cfg[section]
        try:
            a = decode_address(section)
            sk = wif_decode(s["privsigningkey"])
            ek = wif_decode(s["privencryptionkey"])
            pub_sk, pub_ek = priv_to_pub(sk), priv_to_pub(ek)
            ripe = address_ripe(pub_sk, pub_ek)
        except Exception:
            continue                      # unreadable/foreign section
        if ripe != a.ripe:
            continue                      # keys don't match the address
        ident = OwnIdentity(
            s.get("label", section), section, a.version, a.stream, ripe,
            sk, ek, pub_sk, pub_ek,
            int(s.get("noncetrialsperbyte", 1000) or 1000),
            int(s.get("payloadlengthextrabytes", 1000) or 1000),
            s.get("chan", "false").lower() == "true",
            s.get("enabled", "true").lower() == "true",
            mailinglist=s.get("mailinglist", "false").lower() == "true",
            mailinglistname=s.get("mailinglistname", ""),
            gateway=s.get("gateway", ""))
        keystore._index(ident)
        imported += 1
    if imported:
        keystore.save()
    return imported


def _import_inbox_row(store, row) -> bool:
    if store.inbox_by_id(bytes(row[0] or b"")) is not None:
        return False
    store._db.execute(
        "INSERT INTO inbox VALUES (?,?,?,?,?,?,?,?,?,?)",
        (bytes(row[0] or b""), str(row[1] or ""), str(row[2] or ""),
         str(row[3] or ""), str(row[4] or ""), str(row[5] or ""),
         row[6] or "inbox", int(row[7] or 2), bool(row[8]),
         bytes(row[9] or b"")))
    return True


def _import_sent_row(store, row) -> bool:
    mid, ack = bytes(row[0] or b""), bytes(row[6] or b"")
    toaddr, fromaddr = str(row[1] or ""), str(row[3] or "")
    # dedup by msgid first (always present once sent), then
    # ackdata, then the row's natural identity — so re-running
    # never duplicates rows whose ids were still empty; the
    # natural-identity values are coalesced exactly like the
    # insert below so NULL columns still match on a re-run
    if mid:
        dup = store.sent_by_id(mid) is not None
    elif ack:
        dup = store.sent_by_ackdata(ack) is not None
    else:
        dup = store._db.query(
            "SELECT COUNT(*) FROM sent WHERE toaddress=? AND"
            " fromaddress=? AND senttime=? AND subject=?",
            (toaddr, fromaddr, int(row[7] or 0), str(row[4] or "")))[0][0]
    if dup:
        return False
    # terminal statuses import as-is; anything mid-flight
    # becomes msgqueued so OUR send state machine owns it
    status = row[10] if row[10] in (
        "msgsent", "msgsentnoackexpected", "ackreceived",
        "broadcastsent") else "msgqueued"
    store._db.execute(
        "INSERT INTO sent VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
        (mid, toaddr, bytes(row[2] or b""),
         fromaddr, str(row[4] or ""), str(row[5] or ""), ack,
         int(row[7] or 0), int(row[8] or 0), int(row[9] or 0),
         status, int(row[11] or 0), row[12] or "sent",
         int(row[13] or 2), int(row[14] or 0)))
    return True


def import_messages(messages_dat: Path, store) -> dict:
    """Copy inbox/sent history and the four contact tables from the
    reference messages.dat (schema v11 — column-compatible with ours).

    SQLite columns are dynamically typed and v11 declares no type
    constraints, so a malformed row (wrong type, missing field) is
    skipped and counted rather than aborting the migration mid-way —
    the same per-record tolerance as the keys.dat/knownnodes importers.
    """
    src = sqlite3.connect(f"file:{messages_dat}?mode=ro", uri=True)
    counts = dict.fromkeys(
        ("inbox", "sent", "addressbook", "subscriptions", "blacklist",
         "whitelist", "skipped"), 0)
    try:
        for row in src.execute(
                "SELECT msgid, toaddress, fromaddress, subject, received,"
                " message, folder, encodingtype, read, sighash FROM inbox"):
            try:
                counts["inbox"] += _import_inbox_row(store, row)
            except (TypeError, ValueError):
                counts["skipped"] += 1
        for row in src.execute(
                "SELECT msgid, toaddress, toripe, fromaddress, subject,"
                " message, ackdata, senttime, lastactiontime, sleeptill,"
                " status, retrynumber, folder, encodingtype, ttl"
                " FROM sent"):
            try:
                counts["sent"] += _import_sent_row(store, row)
            except (TypeError, ValueError):
                counts["skipped"] += 1
        for label, address in src.execute(
                "SELECT label, address FROM addressbook"):
            if store.addressbook_add(str(address), str(label)):
                counts["addressbook"] += 1
        for label, address, enabled in src.execute(
                "SELECT label, address, enabled FROM subscriptions"):
            exists = store._db.query(
                "SELECT COUNT(*) FROM subscriptions WHERE address=?",
                (address,))[0][0]
            if not exists:
                store._db.execute(
                    "INSERT INTO subscriptions VALUES (?,?,?)",
                    (str(label), address, bool(enabled)))
                counts["subscriptions"] += 1
        for table in ("blacklist", "whitelist"):
            for label, address, enabled in src.execute(
                    f"SELECT label, address, enabled FROM {table}"):
                if store.listing_add(table, str(address), str(label),
                                     enabled=bool(enabled)):
                    counts[table] += 1
    finally:
        src.close()
    return counts


def import_knownnodes(knownnodes_dat: Path, kn) -> int:
    """Merge the reference's JSON peer table, ratings included."""
    from .storage.knownnodes import Peer

    with open(knownnodes_dat) as f:
        nodes = json.load(f)
    imported = 0
    for node in nodes:
        try:
            stream = int(node.get("stream", 1))
            peer = Peer(str(node["peer"]["host"]),
                        int(node["peer"].get("port", 8444)))
            info = node.get("info", {})
            # import only peers we don't know — a local table's fresher
            # lastseen/rating must never be clobbered by the file's
            # stale ones, and a re-run imports nothing
            if kn.get(peer, stream) is not None:
                continue
            if kn.add(peer, stream,
                      lastseen=int(info.get("lastseen", 0)) or None,
                      is_self=bool(info.get("self"))):
                rec = kn.get(peer, stream)
                if rec is not None:
                    if "rating" in info:
                        rec["rating"] = float(info["rating"])
                    # carry the true lastseen through — kn.add stamps
                    # "now" for falsy values, which would make a
                    # never-seen peer (lastseen=0) look freshly seen
                    if "lastseen" in info:
                        rec["lastseen"] = int(info["lastseen"])
                imported += 1
        except (KeyError, TypeError, ValueError):
            continue
    if imported:
        kn.save()
    return imported


def migrate(ref_dir: str | Path, home: str | Path) -> dict:
    """Import everything found under a reference appdata directory
    into a (possibly fresh) framework home.  Returns a summary."""
    from .storage.db import Database
    from .storage.knownnodes import KnownNodes
    from .storage.messages import MessageStore
    from .workers.keystore import KeyStore

    ref_dir, home = Path(ref_dir), Path(home)
    home.mkdir(parents=True, exist_ok=True)
    summary: dict = {}
    if (ref_dir / "keys.dat").exists():
        ks = KeyStore(home / "keys.dat")
        summary["identities"] = import_identities(
            ref_dir / "keys.dat", ks)
    if (ref_dir / "messages.dat").exists():
        db = Database(home / "messages.dat")
        try:
            summary.update(import_messages(
                ref_dir / "messages.dat", MessageStore(db)))
        finally:
            db.close()
    if (ref_dir / "knownnodes.dat").exists():
        kn = KnownNodes(home / "knownnodes.dat")
        summary["knownnodes"] = import_knownnodes(
            ref_dir / "knownnodes.dat", kn)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pybitmessage_tpu_torch.migrate",
        description="import a reference PyBitmessage data directory")
    p.add_argument("ref_dir", help="reference appdata dir "
                   "(contains keys.dat/messages.dat/knownnodes.dat)")
    p.add_argument("home", help="this framework's data dir")
    args = p.parse_args(argv)
    summary = migrate(args.ref_dir, args.home)
    if not summary:
        print("nothing to import (no reference data files found)")
        return 1
    for key, count in summary.items():
        print(f"{key}: {count}" if key == "skipped"
              else f"{key}: {count} imported")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
