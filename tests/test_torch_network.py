"""The port's socket protocol against the JAX package's, on the CPU.

Codecs: the same seeded inputs give byte-equal frames from both
packages, each package decodes the other's, and both refuse the same
malformed inputs; the trackers, dandelion, the known-nodes table, the
random-order download dict and the circuit breaker make the same
choices under the same seed.  Over loopback TCP, port to port: the
handshake, big-inv sync, inv gossip, the closes (bad PoW, connection
to self, verack before version), addr gossip, the dial loop and its
breaker, a three-node line that relays without echoing, and a
download asked for again when its connection closes before it is
served or its getdata fails to send.  Port
against JAX, both dial directions: handshake, sync both ways, a bad-PoW
close on either side, and a getpubkey -> pubkey -> msg -> ack flow
between a port ``Node`` and a JAX ``Node`` with their set-reconciliation
sync and wire trace on and off; with both on, a digest catch-up of 200
objects each way and a ``tobject`` adopted into the other package's
lifecycle.  The malformed varint in an
object header closes the connection in both packages.

Every socket test runs under its own ``asyncio.wait_for`` limit, binds
only 127.0.0.1 on port 0 and closes its pools in a ``finally``.  PoW is
solved at the test difficulty (10/10) by hashlib.  Nothing of JAX is
imported at module level: the card runs the ``cuda`` test with
``--noconftest`` and has no JAX.
"""

import asyncio
import contextlib
import json
import random
import struct
import time

import numpy as np
import pytest
import torch

from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.models import packet
from pybitmessage_tpu_torch.models.pow_math import pow_initial_hash, pow_target
from pybitmessage_tpu_torch.network import connection as port_conn
from pybitmessage_tpu_torch.network import dandelion, messages, tracker
from pybitmessage_tpu_torch.network.bufpool import BufferPool
from pybitmessage_tpu_torch.network.pool import ConnectionPool, NodeContext
from pybitmessage_tpu_torch.pow.dispatcher import python_solve
from pybitmessage_tpu_torch.pow.verify_service import BatchVerifier
from pybitmessage_tpu_torch.resilience import CircuitBreaker
from pybitmessage_tpu_torch.storage.db import Database
from pybitmessage_tpu_torch.storage.inventory import Inventory
from pybitmessage_tpu_torch.storage.knownnodes import KnownNodes, Peer
from pybitmessage_tpu_torch.storage.messages import ACKRECEIVED
from pybitmessage_tpu_torch.utils.hashes import inventory_hash
from pybitmessage_tpu_torch.utils.randomtracking import RandomTrackingDict
from pybitmessage_tpu_torch.utils.varint import VarintError, encode_varint

#: test-mode difficulty of every object here
TEST_NTPB = 10
#: the limit of each socket test
LIMIT = 30.0
#: the limit of a getpubkey -> pubkey -> msg -> ack flow between a port
#: and a JAX node: four hops of announce jitter and two PoW searches on
#: the CPU take 9-22 s on an idle machine
FLOW_LIMIT = 60.0
LOOPBACK = "127.0.0.1"


def ref(module: str):
    """A module of the JAX package (imported on first use)."""
    import importlib
    return importlib.import_module("pybitmessage_tpu." + module)


def limited_to(seconds: float):
    """Run an async test body under ``asyncio.wait_for(seconds)``."""
    import functools

    def wrap(fn):
        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            await asyncio.wait_for(fn(*args, **kwargs), seconds)
        return wrapper
    return wrap


limited = limited_to(LIMIT)


def solved(body: bytes, ttl: int = 600, object_type: int = 2,
           version: int = 1, stream: int = 1) -> bytes:
    """An object payload with a valid PoW at the test difficulty."""
    sans_nonce = struct.pack(">QI", int(time.time()) + ttl, object_type) \
        + encode_varint(version) + encode_varint(stream) + body
    target = pow_target(len(sans_nonce) + 8, ttl, TEST_NTPB, TEST_NTPB,
                        clamp=False)
    nonce, _ = python_solve(pow_initial_hash(sans_nonce), target)
    return struct.pack(">Q", nonce) + sans_nonce


def bad_pow(body: bytes = b"no pow done") -> bytes:
    """An object whose nonce misses even the test difficulty."""
    for nonce in range(1000):
        sans_nonce = struct.pack(">QI", int(time.time()) + 600, 2) \
            + b"\x01\x01" + body
        obj = struct.pack(">Q", nonce) + sans_nonce
        from pybitmessage_tpu_torch.models.pow_math import check_pow
        if not check_pow(obj, TEST_NTPB, TEST_NTPB, clamp=False):
            return obj
    raise AssertionError("no failing nonce")


def hold(ctx, payload: bytes) -> bytes:
    """Put an object into a context's inventory; its hash."""
    h = inventory_hash(payload)
    ctx.inventory.add(h, 2, 1, payload, int.from_bytes(payload[8:16], "big"))
    return h


def port_pool(**kw):
    """A port pool over an in-memory inventory, its PoW checked by a
    CPU ``BatchVerifier`` at 10/10; the dial loop dials nothing
    (``max_outbound=0``) unless asked, so each test's topology is the
    one it draws."""
    verifier = BatchVerifier("cpu", ntpb=TEST_NTPB, extra=TEST_NTPB,
                             clamp=False)
    ctx = NodeContext(inventory=Inventory(Database(":memory:")),
                      pow_verifier=verifier, knownnodes=KnownNodes(),
                      dandelion=dandelion.Dandelion(enabled=False), port=0,
                      allow_private_peers=True, announce_buckets=1)
    return ConnectionPool(ctx, listen_host=LOOPBACK,
                          max_outbound=kw.pop("max_outbound", 0), **kw)


def jax_pool():
    """A JAX pool as its own tests build one, its PoW checked inline at
    the trivial difficulty (``TrivialPow.apply`` of ``tests/conftest.py``)."""
    pool_mod, storage = ref("network.pool"), ref("storage")
    ctx = pool_mod.NodeContext(
        inventory=storage.Inventory(storage.Database(":memory:")),
        knownnodes=storage.KnownNodes(),
        dandelion=ref("network.dandelion").Dandelion(enabled=False),
        port=0, allow_private_peers=True, announce_buckets=1)
    ctx.pow_ntpb = ctx.pow_extra = TEST_NTPB
    return pool_mod.ConnectionPool(ctx, listen_host=LOOPBACK,
                                   max_outbound=0)


def is_port_pool(pool) -> bool:
    return isinstance(pool, ConnectionPool)


@contextlib.asynccontextmanager
async def running(*pools, listen=None):
    """Start each pool (listening unless ``listen`` says otherwise) and
    its verifier; stop them all however the body ends."""
    listen = listen or [True] * len(pools)
    started = []
    try:
        for pool, lis in zip(pools, listen):
            verifier = pool.ctx.pow_verifier
            if is_port_pool(pool):
                verifier.start()
            await pool.start(listen=lis)
            started.append(pool)
        yield pools
    finally:
        for pool in reversed(started):
            await pool.stop()
            if is_port_pool(pool):
                await pool.ctx.pow_verifier.stop()


def closes(pool) -> list:
    """The close reasons of a port pool's connections, as they close."""
    reasons = []
    closed = pool.connection_closed

    def record(conn):
        reasons.append(conn.close_reason)
        closed(conn)
    pool.connection_closed = record
    return reasons


async def until(pred, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        await asyncio.sleep(0.02)


async def dial(src, dst):
    """``src`` dials ``dst`` on loopback; both ends established."""
    peer_cls = Peer if is_port_pool(src) else ref("storage").Peer
    conn = await src.connect_to(peer_cls(LOOPBACK, dst.listen_port))
    assert conn is not None
    await until(lambda: conn.fully_established and dst.established(),
                "the handshake")
    return conn


# ---------------------------------------------------------------------------
# codecs: byte-equal both ways
# ---------------------------------------------------------------------------


def _hosts(rng):
    v4 = ".".join(str(int(b)) for b in rng.integers(1, 255, size=4))
    v6 = ":".join("%x" % int(w) for w in rng.integers(1, 0xFFFF, size=8))
    import base64
    onion = base64.b32encode(rng.bytes(10)).decode().lower() + ".onion"
    return [v4, v6, onion, "127.0.0.1", "::1"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packet_frames_are_byte_equal(seed):
    theirs = ref("models.packet")
    rng = np.random.default_rng(seed)
    for command in ("version", "verack", "inv", "getdata", "object",
                    "addr", "error", "ping", "dinv", "portcheck"):
        payload = rng.bytes(int(rng.integers(0, 300)))
        frame = packet.pack_packet(command, payload)
        assert frame == theirs.pack_packet(command, payload)
        for unpack in (packet.unpack_header, theirs.unpack_header):
            cmd, length, checksum = unpack(frame[:packet.HEADER_LEN])
            assert (cmd, length) == (command, len(payload))
            assert packet.verify_payload(payload, checksum)
            assert theirs.verify_payload(payload, checksum)
        assert not packet.verify_payload(payload + b"x", checksum)


@pytest.mark.parametrize("case", ["short", "magic", "oversize",
                                  "long_command"])
def test_packet_refusals_agree(case):
    theirs = ref("models.packet")
    frame = packet.pack_packet("inv", b"\x00")
    if case == "long_command":
        for pack, err in ((packet.pack_packet, packet.PacketError),
                          (theirs.pack_packet, theirs.PacketError)):
            with pytest.raises(err):
                pack("thirteenchars", b"")
        return
    bad = {"short": frame[:23],
           "magic": b"\x00" + frame[1:24],
           "oversize": frame[:16] + struct.pack(">L", 1600101)
           + frame[20:24]}[case]
    with pytest.raises(packet.PacketError):
        packet.unpack_header(bad)
    with pytest.raises(theirs.PacketError):
        theirs.unpack_header(bad)


@pytest.mark.parametrize("seed", [3, 4])
def test_version_payload_is_byte_equal(seed):
    theirs = ref("network.messages")
    rng = np.random.default_rng(seed)
    for host in _hosts(rng)[:2] + ["not a host"]:
        kw = dict(protocol_version=3, services=int(rng.integers(0, 64)),
                  timestamp=1_700_000_000 + int(rng.integers(1 << 20)),
                  remote_host=host,
                  remote_port=int(rng.integers(1, 65536)),
                  my_port=int(rng.integers(1, 65536)), nonce=rng.bytes(8),
                  user_agent="/ua:%d/" % int(rng.integers(1000)),
                  streams=tuple(sorted({1, int(rng.integers(1, 300))})))
        mine = messages.VersionPayload(**kw).encode()
        assert mine == theirs.VersionPayload(**kw).encode()
        a = messages.VersionPayload.decode(mine)
        b = theirs.VersionPayload.decode(mine)
        assert a.__dict__ == b.__dict__
        assert (a.timestamp, a.my_port, a.nonce, a.streams) == \
            (kw["timestamp"], kw["my_port"], kw["nonce"], kw["streams"])


@pytest.mark.parametrize("case", ["short", "user_agent", "streams",
                                  "varint"])
def test_version_refusals_agree(case):
    theirs = ref("network.messages")
    good = messages.VersionPayload(timestamp=1_700_000_000,
                                   nonce=b"n" * 8).encode()
    bad = {"short": good[:82],
           "user_agent": good[:80] + encode_varint(5001) + b"u" * 5001,
           "streams": good[:80] + b"\x00" + encode_varint(160001),
           "varint": good[:80] + b"\xfd\x00\x01" + b"\x00" * 4}[case]
    err_port = VarintError if case == "varint" else messages.MessageError
    err_ref = ref("utils.varint").VarintError if case == "varint" \
        else theirs.MessageError
    with pytest.raises(err_port):
        messages.VersionPayload.decode(bad)
    with pytest.raises(err_ref):
        theirs.VersionPayload.decode(bad)


@pytest.mark.parametrize("seed", [5, 6])
def test_addr_is_byte_equal(seed):
    theirs = ref("network.messages")
    rng = np.random.default_rng(seed)
    entries = [(int(rng.integers(1 << 31)), int(rng.integers(1, 4)),
                int(rng.integers(0, 16)), host, int(rng.integers(1, 65536)))
               for host in _hosts(rng) * 3]
    mine = messages.encode_addr([messages.AddrEntry(*e) for e in entries])
    assert mine == theirs.encode_addr(
        [theirs.AddrEntry(*e) for e in entries])
    for dec in (messages.decode_addr, theirs.decode_addr):
        assert [(e.time, e.stream, e.services, e.host, e.port)
                for e in dec(mine)] == entries


@pytest.mark.parametrize("case", ["count", "truncated"])
def test_addr_refusals_agree(case):
    theirs = ref("network.messages")
    bad = encode_varint(1001) if case == "count" else \
        encode_varint(2) + b"\x00" * 75
    with pytest.raises(messages.MessageError):
        messages.decode_addr(bad)
    with pytest.raises(theirs.MessageError):
        theirs.decode_addr(bad)


@pytest.mark.parametrize("count", [0, 1, 7, 50000, 50001])
def test_inv_is_byte_equal(count):
    theirs = ref("network.messages")
    rng = np.random.default_rng(count)
    blob = rng.bytes(32 * count)
    hashes = [blob[32 * i:32 * (i + 1)] for i in range(count)]
    mine = messages.encode_inv(hashes)
    assert mine == theirs.encode_inv(hashes)
    want = hashes[:50000]
    assert messages.decode_inv(mine) == theirs.decode_inv(mine) == want


@pytest.mark.parametrize("case", ["one_past", "truncated", "empty"])
def test_inv_refusals_agree(case):
    theirs = ref("network.messages")
    bad = {"one_past": encode_varint(50001),
           "truncated": encode_varint(2) + b"\x00" * 63,
           "empty": b""}[case]
    if case == "empty":     # an empty payload is an empty inv in both
        assert messages.decode_inv(bad) == theirs.decode_inv(bad) == []
        return
    with pytest.raises(messages.MessageError):
        messages.decode_inv(bad)
    with pytest.raises(theirs.MessageError):
        theirs.decode_inv(bad)


@pytest.mark.parametrize("seed", [7, 8])
def test_error_is_byte_equal(seed):
    theirs = ref("network.messages")
    rng = np.random.default_rng(seed)
    args = (int(rng.integers(0, 3)), int(rng.integers(0, 1 << 20)),
            rng.bytes(32), "why é %d" % int(rng.integers(100)))
    mine = messages.encode_error(*args)
    assert mine == theirs.encode_error(*args)
    assert messages.decode_error(mine) == theirs.decode_error(mine) == args


@pytest.mark.parametrize("seed", [9, 10])
def test_hosts_and_groups_agree(seed):
    theirs = ref("network.messages")
    rng = np.random.default_rng(seed)
    hosts = _hosts(rng) + ["10.1.2.3", "192.168.0.1", "8.8.8.8",
                           "fe80::1", "bootstrap8444.bitmessage.org"]
    for host in hosts:
        assert messages.network_group(host) == theirs.network_group(host)
        assert messages.is_private_host(host) == theirs.is_private_host(host)
        if host.endswith(".org"):
            continue
        raw = messages.encode_host(host)
        assert raw == theirs.encode_host(host)
        assert messages.decode_host(raw) == theirs.decode_host(raw)
    v3 = "a" * 56 + ".onion"
    with pytest.raises(messages.MessageError):
        messages.encode_host(v3)
    with pytest.raises(theirs.MessageError):
        theirs.encode_host(v3)


def test_constants_agree():
    theirs = ref("models.constants")
    from pybitmessage_tpu_torch.models import constants
    for name in ("MAGIC", "PROTOCOL_VERSION", "NODE_NETWORK", "NODE_SSL",
                 "NODE_DANDELION", "ADDRESS_ALIVE", "MAX_ADDR_COUNT",
                 "MAX_MESSAGE_SIZE", "MAX_INV_COUNT", "MAX_OBJECT_COUNT",
                 "MAX_TIME_OFFSET", "ONION_PREFIX"):
        assert getattr(constants, name) == getattr(theirs, name), name
    assert port_conn.VERIFY_WINDOW == \
        ref("network.connection").VERIFY_WINDOW


# ---------------------------------------------------------------------------
# the same choices under the same seed
# ---------------------------------------------------------------------------


def _hashes(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


@pytest.mark.parametrize("buckets", [1, 3, 10])
def test_connection_trackers_choose_alike(buckets):
    theirs = ref("network.tracker")
    hashes = _hashes(40, buckets)
    got = []
    for mod in (tracker, theirs):
        random.seed(buckets)
        t = mod.ConnectionTracker(buckets=buckets)
        for h in hashes:
            t.we_should_announce(h)
            t.peer_announced(h[::-1])
        t.peer_announced(hashes[0])
        rounds = [t.take_announcements() for _ in range(buckets)]
        batches = [t.request_batch(7), t.request_batch(7)]
        t.object_received(batches[0][0])
        batches.append(t.request_batch(100))
        got.append((rounds, batches, t.pending_announcements()))
    assert got[0] == got[1]


def test_global_trackers_agree():
    theirs = ref("network.tracker")
    hashes = _hashes(6, 11)
    for mod in (tracker, theirs):
        g = mod.GlobalTracker()
        g.mark_requested(hashes[:4])
        g.received(hashes[1])
        g.missing[hashes[2]] -= mod.REQUEST_TIMEOUT + 1
        assert g.expire() == 1
        assert [g.was_requested(h) for h in hashes] == \
            [True, False, False, True, False, False]


@pytest.mark.parametrize("seed", [12, 13])
def test_random_tracking_dicts_choose_alike(seed):
    theirs = ref("utils.randomtracking")
    keys = _hashes(30, seed)
    got = []
    for mod in (RandomTrackingDict, theirs.RandomTrackingDict):
        random.seed(seed)
        d = mod()
        for k in keys:
            d[k] = True
        first = d.random_keys(4)
        del d[first[0]]
        got.append((first, d.random_keys(20), d.random_keys(3), len(d)))
    assert got[0] == got[1]


@pytest.mark.parametrize("seed", [14, 15])
def test_dandelion_chooses_alike(seed, monkeypatch):
    theirs = ref("network.dandelion")
    hashes = _hashes(12, seed)

    class Conn:
        def __init__(self, i):
            self.i, self.services = i, 8 if i % 3 else 1

    got = []
    for mod in (dandelion, theirs):
        random.seed(seed)
        now = [1000.0]
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
        conns = [Conn(i) for i in range(5)]
        d = mod.Dandelion()
        for c in conns[:3]:
            d.maybe_add_stem(c)
        for k, h in enumerate(hashes):
            d.add_hash(h, stream=1, source=conns[k % 5] if k % 4 else None)
        children = [getattr(d.child_for(h), "i", None) for h in hashes]
        d.remove_connection(conns[0])
        now[0] += 15
        fluffed = d.expire_fluffed()
        now[0] += mod.REASSIGN_INTERVAL + 1
        d.maybe_reassign(conns)
        stems = [c.i for c in d._stems]
        got.append((children, [hashes.index(h) for h, _ in fluffed],
                    stems, [d.in_stem_phase(h) for h in hashes]))
    assert got[0] == got[1]


def test_known_nodes_agree_and_share_their_file(tmp_path):
    theirs = ref("storage.knownnodes")
    peers = [("203.0.113.%d" % i, 8444 + i) for i in range(12)]
    tables = []
    for mod, name in ((theirs, "jax.json"), (
            __import__("pybitmessage_tpu_torch.storage.knownnodes",
                       fromlist=["x"]), "port.json")):
        kn = mod.KnownNodes(tmp_path / name)
        for k, (host, port) in enumerate(peers):
            kn.add(mod.Peer(host, port), 1 + k % 2, lastseen=1_700_000_000 + k)
        for _ in range(3):
            kn.increase_rating(mod.Peer(*peers[0]))
        kn.decrease_rating(mod.Peer(*peers[2]))
        rng = random.Random(16)
        choices = [kn.choose(1 + k % 2, rng=rng) for k in range(20)]
        kn.save()
        tables.append(([(c.host, c.port) for c in choices],
                       json.loads((tmp_path / name).read_text())))
    assert tables[0] == tables[1]
    # each opens the other's file
    mine = KnownNodes(tmp_path / "jax.json")
    other = theirs.KnownNodes(tmp_path / "port.json")
    for stream in (1, 2):
        assert sorted((p.host, p.port, tuple(sorted(mine.get(p, stream)
                                                    .items())))
                      for p in mine.peers(stream)) == \
            sorted((p.host, p.port, tuple(sorted(other.get(p, stream)
                                                 .items())))
                   for p in other.peers(stream))


def test_circuit_breakers_step_alike():
    theirs = ref("resilience.policy")
    got = []
    for cls, kw in ((CircuitBreaker, {}), (theirs.CircuitBreaker,
                                          {"register": False})):
        now = [0.0]
        br = cls("t", threshold=2, cooldown=5.0, clock=lambda: now[0], **kw)
        trace = []
        for step in ("fail", "ok", "fail", "fail", "allow", "wait",
                     "allow", "allow", "fail", "wait", "allow", "ok",
                     "allow"):
            if step == "fail":
                br.record_failure()
            elif step == "ok":
                br.record_success()
            elif step == "wait":
                now[0] += 5.0
            else:
                trace.append(br.allow())
            trace.append(br.state)
        got.append(trace)
    assert got[0] == got[1]


def test_buffer_pools_park_alike():
    theirs = ref("network.bufpool")
    got = []
    for cls in (BufferPool, theirs.BufferPool):
        pool = cls(cap=3, max_bytes=40000)
        sizes = []
        for n in (10, 5000, 9000, 100, 20000, 3000, 7000):
            buf = pool.acquire(n)
            buf.write_at(0, b"x" * n)
            assert buf.materialize() == b"x" * n
            sizes.append(len(buf._data))
            buf.retain()
            buf.release()
            buf.release()
        got.append((sizes, pool.parked()))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# raw sockets
# ---------------------------------------------------------------------------


async def read_frame(reader) -> tuple:
    header = await reader.readexactly(packet.HEADER_LEN)
    command, length, _ = packet.unpack_header(header)
    return command, await reader.readexactly(length)


async def raw_peer(port: int, nonce: bytes = b"rawpeer!"):
    """A hand-driven peer dialing ``port``: version out, the listener's
    version in, verack out, the listener's verack in.  The listener
    holds the connection established after this."""
    reader, writer = await asyncio.open_connection(LOOPBACK, port)
    writer.write(packet.pack_packet("version", messages.VersionPayload(
        remote_host=LOOPBACK, remote_port=port, my_port=1,
        nonce=nonce).encode()))
    await writer.drain()
    command, _ = await read_frame(reader)
    assert command == "version"
    writer.write(packet.pack_packet("verack"))
    await writer.drain()
    while (await read_frame(reader))[0] != "verack":
        pass
    return reader, writer


async def closed_by_peer(reader, timeout: float = 10.0) -> bool:
    """True when the other end closes within ``timeout``; False when it
    stays open."""
    try:
        while True:
            data = await asyncio.wait_for(reader.read(65536), timeout)
            if not data:
                return True
    except asyncio.TimeoutError:
        return False
    except ConnectionError:
        return True


def varint_case(case: str) -> bytes:
    """The object payloads of the varint fault: nonce, expires and type,
    then a truncated 3-byte varint (``FD 00``, 22 bytes) or a
    non-minimal one (``FD 00 01``)."""
    head = struct.pack(">QQI", 0, int(time.time()) + 600, 2)
    return head + {"truncated": b"\xfd\x00",
                   "non_minimal": b"\xfd\x00\x01"}[case]


# ---------------------------------------------------------------------------
# port to port over loopback TCP
# ---------------------------------------------------------------------------


@limited
async def test_handshake():
    a, b = port_pool(), port_pool()
    async with running(a, b, listen=[True, False]):
        conn = await dial(b, a)
        theirs, = a.established()
        assert conn.outbound and not theirs.outbound
        for c, ctx in ((conn, a.ctx), (theirs, b.ctx)):
            assert c.services == ctx.services == 1 | 8
            assert c.streams == (1,)
            assert c.user_agent == messages.USER_AGENT
            assert c.verack_sent and c.verack_received
        # B's listening port (0: not listening) is what A records
        assert theirs.port == 0
        assert Peer(LOOPBACK, a.listen_port) in b.ctx.knownnodes.peers()


@limited
async def test_big_inv_then_inv_gossip():
    a, b = port_pool(), port_pool()
    before = solved(b"held before the nodes meet")
    h1 = hold(a.ctx, before)
    async with running(a, b, listen=[True, False]):
        await dial(b, a)
        await until(lambda: h1 in b.ctx.inventory, "the big-inv sync")
        assert b.ctx.inventory[h1].payload == before
        fresh = solved(b"fresh object")
        h2 = hold(a.ctx, fresh)
        a.announce_object(h2, local=True)
        await until(lambda: h2 in b.ctx.inventory, "the inv gossip")
        assert b.ctx.object_queue.qsize() == 2
        assert b.objects_received == 2 and b.objects_relayed == 0
        assert b.ctx.pow_verifier.host_checked == 2
        assert a.connections()[0].objects_sent == 2


async def _withheld_request(a, b, h):
    """B dials A; A withholds its objects (its getdata service paused)
    until B has asked for ``h``.  B's connection and A's end of it."""
    conn = await dial(b, a)
    theirs, = a.established()
    theirs.skip_until = float("inf")
    await until(lambda: h in theirs.pending_upload, "B's getdata")
    return conn, theirs


@limited
async def test_a_request_lost_with_its_connection_is_asked_again():
    """B asks A for an object over a connection that closes before A
    serves it; over the next connection B asks again and gets it (a
    request stays pinned to its connection, not for REQUEST_TIMEOUT)."""
    a, b = port_pool(), port_pool()
    payload = solved(b"asked for on a connection that dies")
    h = hold(a.ctx, payload)
    async with running(a, b, listen=[True, False]):
        conn, _ = await _withheld_request(a, b, h)
        assert b.ctx.global_tracker.was_requested(h)
        await conn.close("test")
        await until(lambda: not a.connections() and not b.connections(),
                    "both ends to close")
        assert not b.ctx.global_tracker.was_requested(h)
        await dial(b, a)
        await until(lambda: h in b.ctx.inventory, "the second request")
        assert b.ctx.inventory[h].payload == payload
        assert b.ctx.global_tracker.pending_count() == 0


@limited
async def test_a_getdata_that_fails_to_send_is_sent_again(monkeypatch):
    """B's first getdata for A's object fails to send (the connection
    stays up): the next download round asks again at once, not after
    the download dict's 60 s pending window."""
    send, fails = port_conn.BMConnection.send_packet, []

    async def flaky(conn, command, payload=b""):
        if command == "getdata" and not fails:
            fails.append(payload)
            raise ConnectionError("getdata lost")
        await send(conn, command, payload)
    monkeypatch.setattr(port_conn.BMConnection, "send_packet", flaky)
    a, b = port_pool(), port_pool()
    payload = solved(b"its first getdata never left")
    h = hold(a.ctx, payload)
    async with running(a, b, listen=[True, False]):
        await dial(b, a)
        await until(lambda: h in b.ctx.inventory, "the getdata sent again")
        assert len(fails) == 1 and b.ctx.inventory[h].payload == payload


def test_global_tracker_releases_a_closed_connections_requests():
    hashes = _hashes(5, 16)
    one, two = object(), object()
    g = tracker.GlobalTracker()
    g.mark_requested(hashes[:2], via=one)
    g.mark_requested(hashes[2:4], via=two)
    g.mark_requested(hashes[4:])
    g.received(hashes[2])
    assert g.release(one) == 2 and g.release(one) == 0
    assert [g.was_requested(h) for h in hashes] == \
        [False, False, False, True, True]
    g.forget(hashes[3:])
    assert g.release(two) == 0 and g.pending_count() == 0
    t = tracker.ConnectionTracker(buckets=1)
    for h in hashes:
        t.peer_announced(h)
    first = t.request_batch(2)
    assert not set(first) & set(t.request_batch(10))
    t.request_failed(first)
    assert sorted(t.request_batch(10)) == sorted(first)


@limited
async def test_bad_pow_drops_the_peer():
    a, b = port_pool(), port_pool()
    async with running(a, b, listen=[True, False]):
        conn = await dial(b, a)
        bogus = bad_pow()
        await conn.send_packet("object", bogus)
        await until(lambda: not a.established(), "A to drop B")
        assert inventory_hash(bogus) not in a.ctx.inventory
        await until(lambda: not b.connections(), "B to see the close")


@limited
async def test_connection_to_self_is_refused():
    a = port_pool()
    reasons = closes(a)
    async with running(a):
        twin = ConnectionPool(a.ctx, listen_host=LOOPBACK)
        conn = await twin.connect_to(Peer(LOOPBACK, a.listen_port))
        assert conn is not None
        await until(lambda: reasons and conn.close_reason is not None,
                    "the close")
        assert "connection to self" in reasons[0]
        assert not conn.fully_established and not a.connections()
        await twin.stop()


@limited
async def test_verack_before_version_closes():
    a = port_pool()
    async with running(a):
        reader, writer = await asyncio.open_connection(LOOPBACK,
                                                       a.listen_port)
        writer.write(packet.pack_packet("verack"))
        await writer.drain()
        data = b""
        while True:
            more = await asyncio.wait_for(reader.read(4096), 5)
            if not more:
                break
            data += more
        assert b"verack" not in data and b"addr" not in data
        assert not a.connections()
        writer.close()


@limited
async def test_addr_gossip_fills_the_known_nodes():
    a, b = port_pool(), port_pool()
    a.ctx.knownnodes.add(Peer("203.0.113.7", 8444))
    a.ctx.knownnodes.add(Peer("10.0.0.9", 8444))
    async with running(a, b, listen=[True, False]):
        await dial(b, a)
        await until(lambda: Peer("203.0.113.7", 8444)
                    in b.ctx.knownnodes.peers(), "the addr sample")
        assert Peer("10.0.0.9", 8444) in b.ctx.knownnodes.peers()
    c, d = port_pool(), port_pool()
    c.ctx.allow_private_peers = d.ctx.allow_private_peers = False
    c.ctx.knownnodes.add(Peer("93.184.216.34", 8444))
    c.ctx.knownnodes.add(Peer("10.0.0.10", 8444))
    async with running(c, d, listen=[True, False]):
        await dial(d, c)
        await until(lambda: Peer("93.184.216.34", 8444)
                    in d.ctx.knownnodes.peers(), "the addr sample")
        assert Peer("10.0.0.10", 8444) not in d.ctx.knownnodes.peers()


@limited
async def test_dial_loop_and_its_breaker():
    a, b = port_pool(), port_pool(max_outbound=8)
    async with running(a, b, listen=[True, False]):
        b.ctx.knownnodes.add(Peer(LOOPBACK, a.listen_port))
        await until(lambda: b.established() and a.established(),
                    "the dial loop's connection", timeout=10)
        # a dead port: three failed dials open its breaker
        import socket
        with socket.socket() as s:
            s.bind((LOOPBACK, 0))
            dead = Peer(LOOPBACK, s.getsockname()[1])
        for _ in range(3):
            assert await b.connect_to(dead) is None
        assert b._dial_breaker(dead).state == "open"
        assert await b.connect_to(dead) is None


@limited
async def test_three_node_line_relays_without_echo():
    """A - R - B: A's object reaches B through R, and R never
    announces it back to A."""
    a, r, b = port_pool(), port_pool(), port_pool()
    sent_to_a = []
    async with running(r, a, b, listen=[True, False, False]):
        await dial(a, r)
        a_conn, = r.inbound             # R's end of A's connection
        await dial(b, r)
        original = a_conn.announce

        async def spy(hashes, stem=False):
            sent_to_a.extend(hashes)
            await original(hashes, stem=stem)
        a_conn.announce = spy
        obj = solved(b"over the line")
        h = hold(a.ctx, obj)
        a.announce_object(h, local=True)
        await until(lambda: h in b.ctx.inventory, "B to hold A's object")
        assert h in r.ctx.inventory and r.objects_relayed == 1
        await asyncio.sleep(1.2)        # one more inv tick on R
        assert h not in sent_to_a
        assert not b.connections()[0].tracker.objects_new_to_me


# ---------------------------------------------------------------------------
# the varint fault: the connection closes in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["truncated", "non_minimal", "too_short"])
@pytest.mark.parametrize("side", ["port", "jax"])
@limited
async def test_malformed_object_header_closes_where_the_reference_does(
        side, case):
    """A malformed varint in an object header closes the connection in
    the port, as in the JAX package; an ``ObjectError`` (a 21-byte
    object) drops only the object, and the peer still answers a
    ping."""
    pool = port_pool() if side == "port" else jax_pool()
    reasons = closes(pool) if side == "port" else None
    async with running(pool):
        reader, writer = await raw_peer(pool.listen_port)
        await until(lambda: pool.established(), "the raw handshake")
        payload = varint_case(case) if case != "too_short" else \
            struct.pack(">QQI", 0, int(time.time()) + 600, 2) + b"\x01"
        assert len(payload) == {"truncated": 22, "non_minimal": 23,
                                "too_short": 21}[case]
        writer.write(packet.pack_packet("object", payload))
        writer.write(packet.pack_packet("ping"))
        await writer.drain()
        if case == "too_short":
            while (await read_frame(reader))[0] != "pong":
                pass
            assert pool.established()
        else:
            assert await closed_by_peer(reader)
            await until(lambda: not pool.connections(), "the close")
            if reasons is not None:
                assert reasons == ["VarintError(%r)" % {
                    "truncated": "truncated 3-byte varint",
                    "non_minimal": "non-minimal varint encoding"}[case]]
        writer.close()


def test_accept_object_reports_the_varint_case():
    ctx = NodeContext(inventory=Inventory(Database(":memory:")),
                      pow_verifier=None)

    async def outcomes():
        return [await port_conn.accept_object(ctx, None, varint_case(c))
                for c in ("truncated", "non_minimal")]
    assert asyncio.run(outcomes()) == ["varint", "varint"]


# ---------------------------------------------------------------------------
# port against JAX over loopback TCP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dialer", ["port", "jax"])
@limited
async def test_cross_package_handshake_and_sync(dialer):
    port, jax = port_pool(), jax_pool()
    mine, theirs = solved(b"the port's object"), solved(b"the JAX object")
    h_mine, h_theirs = hold(port.ctx, mine), hold(jax.ctx, theirs)
    src, dst = (port, jax) if dialer == "port" else (jax, port)
    async with running(dst, src, listen=[True, False]):
        await dial(src, dst)
        conn_p, = port.established()
        conn_j, = jax.established()
        assert conn_p.user_agent == conn_j.user_agent
        assert conn_p.services == jax.ctx.services
        assert conn_j.services == port.ctx.services
        await until(lambda: h_mine in jax.ctx.inventory
                    and h_theirs in port.ctx.inventory, "the big-inv sync")
        assert jax.ctx.inventory[h_mine].payload == mine
        assert port.ctx.inventory[h_theirs].payload == theirs
        fresh_p, fresh_j = solved(b"fresh port"), solved(b"fresh JAX")
        hp, hj = hold(port.ctx, fresh_p), hold(jax.ctx, fresh_j)
        port.announce_object(hp, local=True)
        jax.announce_object(hj, local=True)
        await until(lambda: hp in jax.ctx.inventory
                    and hj in port.ctx.inventory, "the inv gossip")
        assert port.objects_received == 2
        assert jax.ctx.object_queue.qsize() == 2


@pytest.mark.parametrize("receiver", ["port", "jax"])
@limited
async def test_cross_package_bad_pow_closes(receiver):
    port, jax = port_pool(), jax_pool()
    dst, src = (port, jax) if receiver == "port" else (jax, port)
    async with running(dst, src, listen=[True, False]):
        conn = await dial(src, dst)
        bogus = bad_pow()
        await conn.send_packet("object", bogus)
        await until(lambda: not dst.connections(), "the receiver's close")
        await until(lambda: not src.connections(), "the sender to see it")
        assert inventory_hash(bogus) not in dst.ctx.inventory


def jax_node(**kw):
    """A JAX ``Node`` as ``tests/test_torch_node.py`` builds one, but
    listening, with sync and the wire trace at their defaults."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    core, dispatcher = ref("core"), ref("pow.dispatcher")

    def solver(ih, target, should_stop=None):
        return dispatcher.python_solve(ih, target, should_stop=should_stop)
    return core.Node(None, listen=True, solver=solver, test_mode=True,
                     dandelion_enabled=False, tls_enabled=False,
                     federation_enabled=False, allow_private_peers=True,
                     **kw)


def port_node(**kw) -> Node:
    kw.setdefault("crypto_batch", False)
    return Node(device="cpu", test_mode=True, allow_private_peers=True,
                **kw)


def identity(node, label, passphrase=None):
    """An identity demanding the test-mode difficulty of its senders."""
    ident = node.create_identity(label, deterministic=passphrase)
    ident.nonce_trials_per_byte = ident.extra_bytes = TEST_NTPB
    node.keystore.save()
    return ident


@pytest.mark.parametrize("plane", ["on", "off"])
@pytest.mark.parametrize("sender", ["port", "jax"])
@limited_to(FLOW_LIMIT)
async def test_cross_package_message_flow(sender, plane):
    """getpubkey -> pubkey -> msg -> ack between a port Node and a JAX
    Node over TCP.  With the port's sync and wire trace on (its
    defaults) both ends negotiate them; with them off, the JAX node's
    stay off against the port peer."""
    on = plane == "on"
    port = port_node(sync_enabled=on, wiretrace_enabled=on)
    jax = jax_node()
    assert jax.ctx.services & 16 and jax.ctx.services & 32
    assert bool(port.ctx.services & 16) == bool(port.ctx.services & 32) \
        == on
    a, b = (port, jax) if sender == "port" else (jax, port)
    await port.start()
    await jax.start()
    try:
        conn = await port.pool.connect_to(
            Peer(LOOPBACK, jax.pool.listen_port))
        await until(lambda: conn.fully_established and
                    jax.pool.established(), "the handshake")
        theirs, = jax.pool.established()
        assert theirs.trace_negotiated == conn.trace_negotiated == on
        assert jax.pool.reconciler.negotiated(theirs) == on
        assert (port.pool.reconciler is not None
                and port.pool.reconciler.negotiated(conn)) == on
        alice = identity(a, "alice")
        bob = identity(b, "bob", b"torch net 3")
        ack = await a.send_message(bob.address, alice.address,
                                   "over tcp", "across the packages",
                                   ttl=300)
        await until(lambda: a.message_status(ack) == ACKRECEIVED,
                    "the ack", timeout=FLOW_LIMIT)
        row, = b.store.inbox()
        assert (row.subject, row.message, row.fromaddress,
                row.toaddress) == ("over tcp", "across the packages",
                                   alice.address, bob.address)
    finally:
        await port.stop()
        await jax.stop()


def _catchup_sides(seed: int, common: int, each: int):
    """``common`` junk objects both sides hold (never transferred, so
    unsolved) and ``each`` solved objects only one side holds, per
    side."""
    rng = np.random.default_rng(seed)
    now = int(time.time())
    shared = [(bytes(h), b"shared" + bytes(h)) for h in
              rng.integers(0, 256, (common, 32), dtype=np.uint8)]
    only = [[solved(b"%s only %d" % (side, i), ttl=900)
             for i in range(each)] for side in (b"port", b"jax")]
    return now, shared, only


@limited_to(FLOW_LIMIT)
async def test_cross_package_digest_catchup_of_200_each_way():
    """A port Node and a JAX Node with sync and the wire trace on meet
    over loopback: 200 objects only the port node holds and 200 only
    the JAX node holds cross in one digest catch-up (or its big-inv
    rung), over a common base of 1,000 neither sends, and each pushed
    object joins the sender's trace.  The responder sizes its sketch
    from the digests' bucket deltas (a lower bound, times 2.5), which
    at 200 each way over 64 buckets leaves it near the peeling
    threshold: a decode may fail and fall to the big inv, in both
    packages alike, so either rung must converge."""
    port, jax = port_node(), jax_node()
    now, shared, (port_only, jax_only) = _catchup_sides(12, 1000, 200)
    for node in (port, jax):
        for h, payload in shared:
            node.ctx.inventory.add(h, 2, 1, payload, now + 900)
    hp = [hold(port.ctx, p) for p in port_only]
    hj = [hold(jax.ctx, p) for p in jax_only]
    await port.start()
    await jax.start()
    try:
        sent0 = port_sample("trace_ctx_received_total",
                            {"command": "tobject"})
        outcomes = ("catchup_ok", "catchup_failed")
        before = [port_sample("sync_rounds_total", {"outcome": o})
                  for o in outcomes]
        conn = await port.pool.connect_to(
            Peer(LOOPBACK, jax.pool.listen_port))
        await until(lambda: conn.fully_established and
                    jax.pool.established(), "the handshake")
        theirs, = jax.pool.established()
        assert port.pool.reconciler.negotiated(conn)
        assert jax.pool.reconciler.negotiated(theirs)
        assert conn.trace_negotiated and theirs.trace_negotiated
        await until(lambda: all(h in jax.ctx.inventory for h in hp)
                    and all(h in port.ctx.inventory for h in hj),
                    "the catch-up", timeout=FLOW_LIMIT - 5)
        for h, payload in zip(hj, jax_only):
            assert port.ctx.inventory[h].payload == payload
        for h, payload in zip(hp, port_only):
            assert jax.ctx.inventory[h].payload == payload
        assert len(port.ctx.inventory) == len(jax.ctx.inventory) == 1400
        # the port end dialed, so it opened the one catch-up
        assert sum(port_sample("sync_rounds_total", {"outcome": o}) - b
                   for o, b in zip(outcomes, before)) == 1
        assert port_sample("trace_ctx_received_total",
                           {"command": "tobject"}) - sent0 >= 200
        from pybitmessage_tpu.observability import LIFECYCLE as JAX_LC
        from pybitmessage_tpu_torch.observability import LIFECYCLE
        for h in hj[:20]:
            assert LIFECYCLE.trace_meta(h)["trace_id"] == \
                JAX_LC.trace_meta(h)["trace_id"]
        for h in hp[:20]:
            assert JAX_LC.trace_meta(h)["trace_id"] == \
                LIFECYCLE.trace_meta(h)["trace_id"]
    finally:
        await port.stop()
        await jax.stop()


def port_sample(name: str, labels: dict) -> float:
    from pybitmessage_tpu_torch.observability import REGISTRY
    return REGISTRY.sample(name, labels)


@pytest.mark.parametrize("sender", ["port", "jax"])
@limited
async def test_cross_package_tobject_is_adopted(sender):
    """An object pushed between the packages over a NODE_TRACE link
    crosses as ``tobject``; the receiver's lifecycle adopts the
    sender's trace id with the sender's span as its parent, and its
    connection samples the sender's clock."""
    from pybitmessage_tpu.observability import LIFECYCLE as JAX_LC
    from pybitmessage_tpu_torch.observability import LIFECYCLE
    port, jax = port_node(), jax_node()
    src, dst = (port, jax) if sender == "port" else (jax, port)
    src_lc, dst_lc = (LIFECYCLE, JAX_LC) if sender == "port" \
        else (JAX_LC, LIFECYCLE)
    payload = solved(b"a traced object from " + sender.encode())
    h = hold(src.ctx, payload)
    await port.start()
    await jax.start()
    try:
        conn = await port.pool.connect_to(
            Peer(LOOPBACK, jax.pool.listen_port))
        await until(lambda: conn.fully_established and
                    jax.pool.established(), "the handshake")
        await until(lambda: h in dst.ctx.inventory, "the push")
        mine, theirs = src_lc.trace_meta(h), dst_lc.trace_meta(h)
        assert theirs["trace_id"] == mine["trace_id"]
        assert theirs["parent_span"] == mine["span"]
        link, = dst.pool.established()
        assert link.skew.samples >= 1 and abs(link.skew.offset()) < 5.0
    finally:
        await port.stop()
        await jax.stop()


@limited
async def test_two_port_nodes_over_tcp(tmp_path):
    """Two port Nodes meet over TCP and run the message flow; A keeps
    the peers it learned in ``knownnodes.json`` across a restart."""
    a, b = port_node(data_dir=tmp_path / "a"), port_node()
    await a.start()
    await b.start()
    try:
        conn = await b.pool.connect_to(Peer(LOOPBACK, a.pool.listen_port))
        await until(lambda: conn.fully_established, "the handshake")
        alice, bob = identity(a, "alice"), identity(b, "bob")
        ack = await a.send_message(bob.address, alice.address, "hello",
                                   "over loopback", ttl=300)
        await until(lambda: a.message_status(ack) == ACKRECEIVED,
                    "the ack", timeout=LIMIT)
        assert [(r.subject, r.message) for r in b.store.inbox()] == \
            [("hello", "over loopback")]
    finally:
        await b.stop()
        await a.stop()
    known = {(p, a.knownnodes.get(p)["rating"]) for p in a.knownnodes.peers()}
    assert known and {p.host for p, _ in known} == {LOOPBACK}
    again = port_node(data_dir=tmp_path / "a")
    try:
        assert {(p, again.knownnodes.get(p)["rating"])
                for p in again.knownnodes.peers()} == known
    finally:
        again.db.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
async def test_known_nodes_open_in_the_other_package(writer, tmp_path):
    theirs = ref("storage.knownnodes")
    peers = [("203.0.113.%d" % i, 8000 + i, 1 + i % 2) for i in range(6)]
    if writer == "jax":
        kn = theirs.KnownNodes(tmp_path / "knownnodes.json")
        for host, port, stream in peers:
            kn.add(theirs.Peer(host, port), stream, lastseen=1_700_000_000)
        kn.increase_rating(theirs.Peer(*peers[0][:2]))
        kn.save()
        node = port_node(data_dir=tmp_path)
        try:
            got = node.knownnodes
            assert sorted((p.host, p.port, s) for s in (1, 2)
                          for p in got.peers(s)) == sorted(peers)
            assert got.get(Peer(*peers[0][:2]))["rating"] == \
                pytest.approx(0.1)
        finally:
            node.db.close()
    else:
        node = port_node(data_dir=tmp_path)
        for host, port, stream in peers:
            node.knownnodes.add(Peer(host, port), stream,
                                lastseen=1_700_000_000)
        node.knownnodes.increase_rating(Peer(*peers[0][:2]))
        await node.stop()       # never started: stop saves the table
        kn = theirs.KnownNodes(tmp_path / "knownnodes.json")
        assert sorted((p.host, p.port, s) for s in (1, 2)
                      for p in kn.peers(s)) == sorted(peers)
        assert kn.get(theirs.Peer(*peers[0][:2]))["rating"] == \
            pytest.approx(0.1)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_two_nodes_over_tcp_on_the_card(cuda_device):
    """Two port nodes with every device service on the card meet over
    loopback TCP and run getpubkey -> pubkey -> msg -> ack.  Their
    crypto engines send every drain to the card (``cryptotpubatchmin``
    1): by default drains under 64 run on the native rung."""
    from pybitmessage_tpu_torch.ops import secp256k1_cuda, sha512_cuda

    async def flow():
        a = Node(device=cuda_device, test_mode=True)
        b = Node(device=cuda_device, test_mode=True)
        for node in (a, b):
            node.crypto.batch.gpu_batch_min = 1
        await a.start()
        await b.start()
        try:
            conn = await b.pool.connect_to(Peer(LOOPBACK,
                                                a.pool.listen_port))
            await until(lambda: conn.fully_established, "the handshake")
            alice, bob = identity(a, "alice"), identity(b, "bob")
            ack = await a.send_message(bob.address, alice.address, "card",
                                       "over tcp on the card", ttl=300)
            await until(lambda: a.message_status(ack) == ACKRECEIVED,
                        "the ack", timeout=120)
            assert [(r.subject, r.message) for r in b.store.inbox()] == \
                [("card", "over tcp on the card")]
            assert b.crypto.batch.failed_drains == 0
        finally:
            await a.stop()
            await b.stop()

    sha512_cuda.reset_launches()
    secp256k1_cuda.reset_launches()
    asyncio.run(asyncio.wait_for(flow(), 180))
    assert sum(sha512_cuda.LAUNCHES.values()) > 0
    assert secp256k1_cuda.LAUNCHES["secp_verify"] > 0
    assert secp256k1_cuda.LAUNCHES["secp_ecdh"] > 0
