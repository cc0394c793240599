"""The port's housekeeping against the JAX package's, on the CPU.

The same seeded rows go into a port store and a JAX store, the same
function runs on each, and what is left must be equal: the resend sweep
(``SendWorker.resend_stale``), ``MessageStore.bump_retry``,
``Inventory.clean``, ``MessageStore.purge_stale_pubkeys``,
``KnownNodes.cleanup`` and one ``Cleaner.run_once`` with its deep clean
due.  Also the database's write retry (ROADMAP §3 fault 3.2): a write
whose first attempt meets ``sqlite3.OperationalError("database is
locked")`` is retried in both packages (the port before the repair
raised), and the retry policy's schedule and deadline against the JAX
package's.

The nodes here are built and never started: no PoW and no socket.
Nothing of JAX is imported at module level.
"""

import random
import sqlite3
import time

import pytest

from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.resilience import (Deadline, RetryPolicy,
                                               current_deadline)
from pybitmessage_tpu_torch.storage.db import Database
from pybitmessage_tpu_torch.storage.inventory import Inventory
from pybitmessage_tpu_torch.storage.knownnodes import KnownNodes, Peer
from pybitmessage_tpu_torch.storage.messages import MessageStore
from pybitmessage_tpu_torch.utils.addresses import encode_address
from pybitmessage_tpu_torch.workers import cleaner as port_cleaner


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import pybitmessage_tpu.core as core
    import pybitmessage_tpu.resilience.policy as policy
    import pybitmessage_tpu.storage.db as db
    import pybitmessage_tpu.storage.inventory as inventory
    import pybitmessage_tpu.storage.knownnodes as knownnodes
    import pybitmessage_tpu.storage.messages as messages
    import pybitmessage_tpu.workers.cleaner as cleaner
    return {"core": core, "policy": policy, "db": db,
            "inventory": inventory, "knownnodes": knownnodes,
            "messages": messages, "cleaner": cleaner}


def both_nodes():
    """A port node and a JAX node, built, not started."""
    j = _jax()
    port = Node(device="cpu", listen=False, test_mode=True,
                crypto_batch=False)
    jax_node = j["core"].Node(
        listen=False, solver=lambda *a, **k: None, test_mode=True,
        dandelion_enabled=False, tls_enabled=False, sync_enabled=False,
        wiretrace_enabled=False, federation_enabled=False)
    return port, jax_node


def _address(rng) -> str:
    return encode_address(4, 1, b"\x00" + rng.randbytes(19))


def seed_sent(stores, rng, now):
    """The same sent rows in each store: every status the sweep reads or
    skips, sleeptill due and not, TTLs up to the 28-day cap."""
    rows = []
    for status in ("msgsent", "awaitingpubkey", "ackreceived",
                   "msgqueued", "msgsentnoackexpected"):
        for due in (True, False):
            for ttl in (600, 4 * 24 * 3600, 20 * 24 * 3600):
                rows.append(dict(
                    msgid=rng.randbytes(16), toaddress=_address(rng),
                    toripe=rng.randbytes(20), fromaddress=_address(rng),
                    subject="s%d" % len(rows), message="b", ackdata=(
                        b"\x00\x00\x00\x02\x01\x01" + rng.randbytes(32)),
                    ttl=ttl, status=status,
                    sleeptill=now - 5 if due else now + 3600))
    rows.append(dict(rows[0], msgid=rng.randbytes(16),
                     toaddress="BM-not-an-address",
                     ackdata=rng.randbytes(38), status="awaitingpubkey",
                     sleeptill=now - 5))
    for store in stores:
        for r in rows:
            store.queue_sent(**{k: v for k, v in r.items()
                                if k != "sleeptill"})
            store.update_sent_status(r["ackdata"], r["status"],
                                     sleeptill=r["sleeptill"])
    return rows


def sent_state(store):
    return sorted((m.ackdata, m.status, m.ttl, m.retrynumber, m.sleeptill)
                  for m in store.all_sent())


# ---------------------------------------------------------------------------
# the resend sweep
# ---------------------------------------------------------------------------


async def test_resend_stale_requeues_due_rows_with_doubled_ttl():
    port, jax_node = both_nodes()
    rng = random.Random(7)
    seed_sent([port.store, jax_node.store], rng, int(time.time()))
    for node in (port, jax_node):
        node.sender._rebuild_watchlists()
    assert port.sender.watched_acks == jax_node.sender.watched_acks
    assert port.sender.needed_pubkeys == jax_node.sender.needed_pubkeys
    due = [m.ackdata for m in port.store.due_for_resend()]
    assert sorted(due) == sorted(
        m.ackdata for m in jax_node.store.due_for_resend())
    assert due
    before = {m.ackdata: m.ttl for m in port.store.all_sent()}
    await port.sender.resend_stale()
    await jax_node.sender.resend_stale()
    assert sent_state(port.store) == sent_state(jax_node.store)
    for m in port.store.all_sent():
        if m.ackdata in due and m.toaddress.startswith("BM-2"):
            assert m.status == "msgqueued"
            assert m.ttl == min(before[m.ackdata] * 2, 28 * 24 * 3600)
            assert m.retrynumber == 1
    assert port.sender.queue.qsize() == jax_node.sender.queue.qsize()
    assert port.sender.watched_acks == jax_node.sender.watched_acks
    assert port.sender.needed_pubkeys == jax_node.sender.needed_pubkeys
    for node in (port, jax_node):
        node.db.close()


@pytest.mark.parametrize("retries", [1, 3])
def test_bump_retry_backs_off_as_the_reference(retries):
    port, jax_node = both_nodes()
    rng = random.Random(retries)
    now = int(time.time())
    rows = seed_sent([port.store, jax_node.store], rng, now)
    ttl = 3600
    for n in range(retries):
        ttl *= 2
        for store in (port.store, jax_node.store):
            for r in rows[::3]:
                store.bump_retry(r["ackdata"], ttl, now + ttl + n)
    assert sent_state(port.store) == sent_state(jax_node.store)
    assert {m.retrynumber for m in port.store.all_sent()} == {0, retries}
    for node in (port, jax_node):
        node.db.close()


# ---------------------------------------------------------------------------
# inventory, pubkeys and known nodes
# ---------------------------------------------------------------------------


def seed_inventory(inventories, rng, now):
    """Objects expired past the 3 h grace, inside it, and alive; some
    flushed to SQL, some pending."""
    grace = 3 * 3600
    for i, expires in enumerate([now - grace - 600, now - grace + 600,
                                 now - 60, now + 3600] * 6):
        h = rng.randbytes(32)
        payload = rng.randbytes(40)
        for inv in inventories:
            inv.add(h, i % 4, 1, payload, expires, rng.randbytes(0))
        if i == 11:
            for inv in inventories:
                inv.flush()


def inventory_state(inv):
    return sorted((h, inv[h].expires) for h in inv.hashes())


@pytest.mark.parametrize("flush_first", [False, True])
def test_inventory_clean_leaves_the_same_rows(flush_first):
    j = _jax()
    port_db, jax_db = Database(), j["db"].Database()
    port_inv = Inventory(port_db)
    jax_inv = j["inventory"].Inventory(jax_db)
    seed_inventory([port_inv, jax_inv], random.Random(3), int(time.time()))
    if flush_first:
        port_inv.flush()
        jax_inv.flush()
    assert len(port_inv) == len(jax_inv) == 24
    port_inv.clean()
    jax_inv.clean()
    assert inventory_state(port_inv) == inventory_state(jax_inv)
    assert len(port_inv) == len(jax_inv)
    assert len(port_inv) == (18 if flush_first else 21)


def test_purge_stale_pubkeys_drops_the_same_rows():
    j = _jax()
    stores = [MessageStore(Database()),
              j["messages"].MessageStore(j["db"].Database())]
    rng = random.Random(5)
    now = int(time.time())
    for age in (0, 27, 28, 29, 100):
        for used in (False, True):
            address = _address(rng)
            for store in stores:
                store.store_pubkey(address, 4, b"pk", used_personally=used)
                store._db.execute(
                    "UPDATE pubkeys SET time=? WHERE address=?",
                    (now - age * 24 * 3600 - 60, address))
    purged = [store.purge_stale_pubkeys() for store in stores]
    assert purged[0] == purged[1] == 3
    rows = [sorted(store._db.query(
        "SELECT address, time, usedpersonally FROM pubkeys"))
        for store in stores]
    assert rows[0] == rows[1]


def test_knownnodes_cleanup_drops_the_same_peers():
    j = _jax()
    tables = [KnownNodes(), j["knownnodes"].KnownNodes()]
    peer_classes = [Peer, j["knownnodes"].Peer]
    rng = random.Random(9)
    now = time.time()
    ages = [0, 2 * 3600, 4 * 3600, 27 * 24 * 3600, 29 * 24 * 3600]
    for i in range(40):
        age = ages[i % len(ages)]
        rating = rng.choice([-1.0, -0.5, -0.4, 0.0, 0.7])
        stream = 1 + i % 2
        for table, peer_cls in zip(tables, peer_classes):
            peer = peer_cls("10.0.%d.%d" % (i // 250, i % 250), 8444)
            table.add(peer, stream, lastseen=int(now - age))
            table._streams[stream][peer]["rating"] = rating
    dropped = [table.cleanup(now) for table in tables]
    assert dropped[0] == dropped[1] > 0
    for stream in (1, 2):
        assert [(p.host, p.port) for p in sorted(tables[0].peers(stream))] \
            == [(p.host, p.port) for p in sorted(tables[1].peers(stream))]


# ---------------------------------------------------------------------------
# the cleaner
# ---------------------------------------------------------------------------


def node_state(node):
    return (inventory_state(node.inventory),
            sorted(node.db.query("SELECT address FROM pubkeys")),
            sorted((p.host, p.port) for p in node.knownnodes.peers(1)),
            sent_state(node.store))


async def test_cleaner_run_once_with_the_deep_clean_due():
    j = _jax()
    assert port_cleaner.DEEP_CLEAN_INTERVAL == \
        j["cleaner"].DEEP_CLEAN_INTERVAL
    assert port_cleaner.FLUSH_INTERVAL == j["cleaner"].FLUSH_INTERVAL
    port, jax_node = both_nodes()
    rng = random.Random(11)
    now = int(time.time())
    seed_inventory([port.inventory, jax_node.inventory], rng, now)
    seed_sent([port.store, jax_node.store], rng, now)
    for node, peer_cls in ((port, Peer), (jax_node, j["knownnodes"].Peer)):
        node.knownnodes.add(peer_cls("10.1.1.1", 8444),
                            lastseen=now - 29 * 24 * 3600)
        node.knownnodes.add(peer_cls("10.1.1.2", 8444), lastseen=now)
        node.store.store_pubkey("BM-old", 4, b"pk")
        node.db.execute("UPDATE pubkeys SET time=?",
                        (now - 30 * 24 * 3600,))
        node.store.store_pubkey("BM-new", 4, b"pk")
        # nothing dialled: a pending download older than the request
        # timeout is what the tracker's expiry drops
        node.ctx.global_tracker.missing[b"\x01" * 32] = now - 7200
    # the first cycle runs the deep clean (none ran before)
    await port.cleaner.run_once()
    await jax_node.cleaner.run_once()
    assert node_state(port) == node_state(jax_node)
    assert len(port.inventory) == 18
    assert port.ctx.global_tracker.missing == {}
    assert [a for a, in port.db.query("SELECT address FROM pubkeys")] == \
        ["BM-new"]
    # a second cycle only flushes: the deep clean is not due
    for node in (port, jax_node):
        node.inventory.add(b"\x02" * 32, 2, 1, b"x", now - 4 * 3600)
    await port.cleaner.run_once()
    await jax_node.cleaner.run_once()
    assert node_state(port) == node_state(jax_node)
    assert len(port.inventory) == 19
    # and once DEEP_CLEAN_INTERVAL has passed, it runs again
    for node in (port, jax_node):
        node.cleaner._last_deep_clean -= port_cleaner.DEEP_CLEAN_INTERVAL
    await port.cleaner.run_once()
    await jax_node.cleaner.run_once()
    assert node_state(port) == node_state(jax_node)
    assert len(port.inventory) == 18
    for node in (port, jax_node):
        node.db.close()


# ---------------------------------------------------------------------------
# fault 3.2: the database's write retry
# ---------------------------------------------------------------------------


class _LockedOnce:
    """A connection whose next ``failures`` write statements raise
    ``OperationalError("database is locked")`` before they run."""

    def __init__(self, conn, failures: int = 1):
        self._conn = conn
        self.failures = failures

    def cursor(self):
        outer = self

        class Cursor:
            def __init__(self, cur):
                self._cur = cur

            def _maybe_fail(self, sql):
                if outer.failures and not sql.lstrip().upper().startswith(
                        ("SELECT", "BEGIN", "COMMIT", "ROLLBACK")):
                    outer.failures -= 1
                    raise sqlite3.OperationalError("database is locked")

            def execute(self, sql, params=()):
                self._maybe_fail(sql)
                return self._cur.execute(sql, params)

            def executemany(self, sql, rows):
                self._maybe_fail(sql)
                return self._cur.executemany(sql, rows)

            def __getattr__(self, name):
                return getattr(self._cur, name)
        return Cursor(self._conn.cursor())

    def __getattr__(self, name):
        return getattr(self._conn, name)


def _databases():
    j = _jax()
    return [Database(), j["db"].Database()]


WRITES = {
    "execute": lambda db: db.execute(
        "INSERT INTO settings VALUES(?, ?)", ("k", "v")),
    "executemany": lambda db: db.executemany(
        "INSERT INTO settings VALUES(?, ?)", [("k", "v")]),
    "execute_batch": lambda db: db.execute_batch(
        [("INSERT INTO settings VALUES(?, ?)", [("k", "v")])]),
}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_a_locked_write_is_retried_as_the_reference_retries(write):
    for db in _databases():
        db._conn = _LockedOnce(db._conn)
        WRITES[write](db)
        assert db._conn.failures == 0
        assert db.get_setting("k") == "v", type(db).__module__


def test_a_write_locked_past_the_attempts_raises_in_both():
    for db in _databases():
        db._conn = _LockedOnce(db._conn, failures=db.WRITE_ATTEMPTS)
        with pytest.raises(sqlite3.OperationalError):
            db.set_setting("k", "v")
        assert db.get_setting("k") is None


# ---------------------------------------------------------------------------
# the retry policy and the deadline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retry_policy_schedule_matches_the_reference(seed):
    policy = _jax()["policy"]
    kw = dict(attempts=5, base_delay=0.02, max_delay=0.5)
    ours = RetryPolicy(rng=random.Random(seed), **kw)
    theirs = policy.RetryPolicy(rng=random.Random(seed), **kw)
    assert [ours.delay(a) for a in range(kw["attempts"] - 1)] == \
        [theirs.delay(a) for a in range(kw["attempts"] - 1)]
    slept = []
    calls = iter([sqlite3.OperationalError("x")] * 2 + ["done"])

    def flaky():
        r = next(calls)
        if isinstance(r, Exception):
            raise r
        return r
    assert ours.call(flaky, site="t", sleep=slept.append) == "done"
    assert len(slept) == 2


def test_deadline_nesting_keeps_the_tighter_budget():
    policy = _jax()["policy"]
    for D, current in ((Deadline, current_deadline),
                       (policy.Deadline, policy.current_deadline)):
        assert current() is None
        with D(0.5) as outer:
            with D(30.0) as inner:
                assert current() is inner
                assert inner.expires_at == outer.expires_at
            assert current() is outer
        assert current() is None
        assert D(-1.0).remaining() < 0
    # a retry stops when the deadline cannot cover the next pause
    pause_calls = []
    with Deadline(0.001):
        with pytest.raises(sqlite3.OperationalError):
            RetryPolicy(attempts=5, base_delay=1.0).call(
                lambda: (_ for _ in ()).throw(
                    sqlite3.OperationalError("x")),
                site="t", sleep=pause_calls.append)
    assert pause_calls == []

