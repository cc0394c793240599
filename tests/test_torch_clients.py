"""The port's light-client tier against the JAX package's, on the CPU.

Held against ``pybitmessage_tpu.roles.subscription``,
``pybitmessage_tpu.roles.client`` and ``pybitmessage_tpu.sync``:

- every plane frame is byte-equal, and each package reads the other's;
  junk headers and truncated payloads are rejected alike;
- ``bucket_of``, ``short_id``, ``routing_key`` and ``buckets_for_tags``
  over 10,000 seeded hashes, and ``InventoryDigest`` summaries over one
  seeded add / discard / clean / resize sequence;
- ``SubscriptionIndex`` decisions over one seeded sequence of replace,
  unsubscribe, drop and rebucket;
- over loopback TCP, a port ``LightClient`` against a JAX plane and a
  JAX ``LightClient`` against a port plane: pushes, a bucket-count
  reassignment, DIGEST_DELTA + FETCH repair with pushes suppressed, and
  ``role.client`` chaos, each converging with no subscribed object
  lost;
- a nonce delegated through the port's plane (to a port ``FarmServer``
  and, without a farm, to the edge's own ``PowDispatcher``) equals
  ``python_solve``'s;
- the port client's trial decrypt (its ``BatchCryptoEngine`` on the CPU,
  the kernels' plain torch versions) against the JAX client's;
- the metric families of both modules, and ``Node`` hooks: a plane fed
  by the sender's publishes, ``role="client"`` without a plane refused.

Everything compared is exact (bytes, integers, sets); no tolerance.
Nothing of JAX is imported at module level; every socket wait runs under
its own timeout.
"""

import asyncio
import hashlib
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch.observability import REGISTRY as PORT_REGISTRY
from pybitmessage_tpu_torch.resilience import CHAOS as PORT_CHAOS
from pybitmessage_tpu_torch.roles import client as port_client
from pybitmessage_tpu_torch.roles import ipc as port_ipc
from pybitmessage_tpu_torch.roles import subscription as port_wire
from pybitmessage_tpu_torch.sync import digest as port_digest
from pybitmessage_tpu_torch.sync import sketch as port_sketch

#: seconds for one convergence wait
CONVERGE_TIMEOUT = 20.0
#: a target that takes a few thousand trials
TARGET = 1 << 53


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.roles import client, ipc, subscription
    from pybitmessage_tpu.sync import digest, sketch
    return SimpleNamespace(wire=subscription, client=client, ipc=ipc,
                           digest=digest, sketch=sketch)


def _hashes(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [bytes(row) for row in rng.integers(0, 256, (n, 32),
                                               dtype=np.uint8)]


def _record(rng, i: int, tag: bytes = b"", stream: int = 1):
    """(h, type, stream, expires, tag, payload) for ``on_record``."""
    payload = bytes(rng.integers(0, 256, 40, dtype=np.uint8)) + \
        i.to_bytes(4, "big")
    return (hashlib.sha512(payload).digest()[:32], 42, stream,
            int(time.time()) + 900, tag, payload)


class _StubNode:
    """What a ``ClientPlane`` reads off a node: the payload cache (FETCH
    service), the farm tier (delegation) and the solver (delegation
    without a farm)."""

    def __init__(self):
        self.inventory: dict = {}
        self.farm_client = None
        self.solver = None

    def store(self, rec) -> None:
        h, type_, stream, expires, tag, payload = rec
        self.inventory[h] = SimpleNamespace(
            type=type_, stream=stream, expires=expires, tag=tag,
            payload=payload)


async def _until(predicate, what: str, timeout: float = CONVERGE_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "timed out: %s" % what
        await asyncio.sleep(0.02)


# ---------------------------------------------------------------------------
# the frames
# ---------------------------------------------------------------------------


def _frames(rng):
    """(name, encode args) for every message of the plane."""
    tag = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    h = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    entries = [(1, (3, 9, 63)), (2, ()), (7, tuple(range(0, 64, 5)))]
    return [
        ("subscribe", ("client-7", "tenant-x", 64, entries)),
        ("sub_ack", (2 ** 40 + 3, 256, 17)),
        ("unsubscribe", (entries,)),
        ("digest_delta", (99, 64, 1, [(0, 3, 2 ** 64 - 1), (63, 0, 5)])),
        ("object_ack", (2 ** 63 + 11,)),
        ("fetch", (2, (1, 2, 40))),
        ("pow_delegate", (12, hashlib.sha512(h).digest(), 2 ** 60, 1500)),
        ("pow_result", (12, 1, 2 ** 50 + 1, 77, "farm says no")),
        ("object_push", (5, (h, 3, 1, 1_700_000_000, tag, b"x" * 90))),
    ]


@pytest.mark.parametrize("index", range(9))
def test_every_frame_is_byte_equal_and_read_both_ways(index):
    jx = _jax()
    name, args = _frames(np.random.default_rng([11, index]))[index]
    encoded = []
    for wire, ipc in ((jx.wire, jx.ipc), (port_wire, port_ipc)):
        call_args = args
        if name == "object_push":
            seq, record = args
            call_args = (seq, ipc.encode_record(*record))
        encoded.append(getattr(wire, "encode_" + name)(*call_args))
    assert encoded[0] == encoded[1]
    decoded = [getattr(w, "decode_" + name)(encoded[1 - i])
               for i, w in enumerate((jx.wire, port_wire))]
    assert decoded[0] == decoded[1]
    msg_type = getattr(port_wire, "MSG_" + name.upper())
    assert getattr(jx.wire, "MSG_" + name.upper()) == msg_type
    frames = [w.pack_frame(msg_type, encoded[0])
              for w in (jx.wire, port_wire)]
    assert frames[0] == frames[1]
    assert port_wire.parse_header(frames[0][:8]) == \
        jx.wire.parse_header(frames[0][:8]) == (msg_type, len(encoded[0]))
    # every truncation is refused by both, or read alike by both
    for cut in range(len(encoded[0])):
        outcomes = []
        for w in (jx.wire, port_wire):
            try:
                outcomes.append(("ok", getattr(w, "decode_" + name)(
                    encoded[0][:cut])))
            except w.ClientProtocolError:
                outcomes.append(("refused", None))
        assert outcomes[0] == outcomes[1], cut


def test_junk_headers_and_oversized_fields_are_refused_alike():
    jx = _jax()
    bad = [b"\xc1\x08\x01\x01\x00\x00\x00\x00",        # magic
           b"\xc1\x07\x02\x01\x00\x00\x00\x00",        # version
           b"\xc1\x07\x01\x01\x00\x10\x00\x01"]        # > MAX_FRAME
    for header in bad:
        for w in (jx.wire, port_wire):
            with pytest.raises(w.ClientProtocolError):
                w.parse_header(header)
    for w in (jx.wire, port_wire):
        with pytest.raises(w.ClientProtocolError):
            w.encode_subscribe("c" * 65, "", 64, [])
        with pytest.raises(w.ClientProtocolError):
            w.pack_frame(w.MSG_PING, b"\0" * (w.MAX_FRAME + 1))
    for msg_type in (port_wire.MSG_PING, port_wire.MSG_PONG):
        assert port_wire.pack_frame(msg_type, b"") == \
            jx.wire.pack_frame(msg_type, b"")
    assert port_wire.MAX_FRAME == jx.wire.MAX_FRAME
    assert port_wire.FRAME_NAMES == jx.wire.FRAME_NAMES
    assert (port_wire.POW_OK, port_wire.POW_ERROR, port_wire.POW_REJECTED) \
        == (jx.wire.POW_OK, jx.wire.POW_ERROR, jx.wire.POW_REJECTED)


# ---------------------------------------------------------------------------
# buckets, short IDs, the digest
# ---------------------------------------------------------------------------


def test_bucket_of_short_id_and_routing_keys_over_10000_hashes():
    jx = _jax()
    hashes = _hashes(21, 10_000)
    rng = np.random.default_rng(22)
    counts = rng.integers(1, 4097, len(hashes))
    salts = rng.integers(0, 2 ** 63, len(hashes), dtype=np.int64)
    for h, count, salt in zip(hashes, counts, salts):
        count, salt = int(count), int(salt)
        assert port_digest.bucket_of(h, count) == \
            jx.digest.bucket_of(h, count)
        assert port_sketch.short_id(h, salt) == \
            jx.sketch.short_id(h, salt)
        assert port_sketch.short_id(h, port_digest.DIGEST_SALT) == \
            jx.sketch.short_id(h, jx.digest.DIGEST_SALT)
    assert port_digest.DIGEST_BUCKETS == jx.digest.DIGEST_BUCKETS
    assert port_digest.DIGEST_SALT == jx.digest.DIGEST_SALT
    tags = hashes[:40]
    for count in (1, 64, 1000):
        assert port_client.buckets_for_tags(tags, count) == \
            jx.client.buckets_for_tags(tags, count)
    for tag, h in ((hashes[0], hashes[1]), (b"", hashes[2])):
        assert port_wire.routing_key(tag, h) == \
            jx.wire.routing_key(tag, h)


def test_digest_summaries_equal_over_one_seeded_sequence():
    jx = _jax()
    rng = np.random.default_rng(23)
    hashes = _hashes(24, 600)
    digests = [jx.digest.InventoryDigest(buckets=64),
               port_digest.InventoryDigest(buckets=64)]
    now = 1_000_000
    for step, h in enumerate(hashes):
        stream = int(rng.integers(1, 4))
        expires = now + int(rng.integers(-50, 500))
        key = hashes[int(rng.integers(0, len(hashes)))] \
            if rng.random() < 0.5 else None
        for d in digests:
            d.add(h, stream, expires, key=key)
        if rng.random() < 0.2:
            gone = hashes[int(rng.integers(0, step + 1))]
            for d in digests:
                d.discard(gone)
        if step in (200, 400):
            count = int(rng.integers(8, 300))
            for d in digests:
                d.resize(count)
        if step == 500:
            assert digests[0].clean(now + 100) == \
                digests[1].clean(now + 100)
    for stream in (1, 2, 3, 9):
        assert digests[1].summaries(stream) == digests[0].summaries(stream)
        buckets = set(range(0, digests[0].buckets, 3))
        assert set(digests[1].hashes_in_buckets(stream, buckets)) == \
            set(digests[0].hashes_in_buckets(stream, buckets))
    assert len(digests[1]) == len(digests[0])
    restricted = [m.InventoryDigest(streams={2})
                  for m in (jx.digest, port_digest)]
    for d in restricted:
        for h in hashes[:50]:
            d.add(h, 1 + hashes.index(h) % 3, now)
    assert restricted[1].summaries(2) == restricted[0].summaries(2)
    assert len(restricted[1]) == len(restricted[0])


# ---------------------------------------------------------------------------
# the inverted index
# ---------------------------------------------------------------------------


def test_subscription_index_decisions_over_one_seeded_sequence():
    jx = _jax()
    rng = np.random.default_rng(25)
    indexes = [jx.wire.SubscriptionIndex(64, max_clients=40,
                                         max_buckets_per_client=12),
               port_wire.SubscriptionIndex(64, max_clients=40,
                                           max_buckets_per_client=12)]
    clients = ["c%02d" % i for i in range(50)]
    for step in range(1500):
        op = rng.random()
        cid = clients[int(rng.integers(0, len(clients)))]
        if op < 0.5:
            entries = [(int(rng.integers(1, 4)),
                        tuple(int(b) for b in rng.integers(
                            -3, indexes[0].buckets + 5,
                            int(rng.integers(0, 20)))))
                       for _ in range(int(rng.integers(0, 3)))]
            results = [ix.replace(cid, entries) for ix in indexes]
        elif op < 0.75:
            entries = [(int(rng.integers(1, 4)),
                        tuple(int(b) for b in rng.integers(
                            0, indexes[0].buckets,
                            int(rng.integers(0, 4)))))]
            results = [ix.unsubscribe(cid, entries) for ix in indexes]
        elif op < 0.97:
            results = [ix.drop(cid) for ix in indexes]
        else:
            count = int(rng.integers(1, 200))
            results = [ix.rebucket(count) for ix in indexes]
        assert results[0] == results[1], step
        assert indexes[1].snapshot() == indexes[0].snapshot(), step
        assert len(indexes[1]) == len(indexes[0])
        stream = int(rng.integers(1, 4))
        bucket = int(rng.integers(0, indexes[0].buckets))
        assert set(indexes[1].clients_for(stream, bucket)) == \
            set(indexes[0].clients_for(stream, bucket))
        probe = [int(b) for b in rng.integers(0, indexes[0].buckets, 6)]
        got = [{c: sorted(bs) for c, bs in
                ix.subscribers_of(stream, probe).items()}
               for ix in indexes]
        assert got[1] == got[0]
        assert indexes[1].buckets_of(cid) == indexes[0].buckets_of(cid)
    for ix in indexes:
        with pytest.raises(ValueError):
            ix.rebucket(0)


class _NoWalk(dict):
    """A client map that refuses to be walked whole."""

    def values(self):
        raise AssertionError("walked every client's set")


def test_a_replace_costs_its_own_buckets_not_every_clients():
    """The JAX index recounts every client's set on each change
    (``_export``, ``__len__``), so filling it with N clients is
    O(N^2); the port keeps the count as it changes.  A port index whose
    client map refuses a walk still serves replace, unsubscribe, drop,
    rebucket, ``len`` and ``snapshot``; the JAX index walks it."""
    jx = _jax()
    port_ix = port_wire.SubscriptionIndex(64)
    port_ix._subs = _NoWalk()
    reference = jx.wire.SubscriptionIndex(64)
    for ix in (port_ix, reference):
        for i in range(200):
            ix.replace("sim-%d" % i, [(1, (i % 64, (i * 7) % 64))])
        ix.unsubscribe("sim-3", [(1, (3,))])
        ix.drop("sim-4")
    assert len(port_ix) == port_ix.snapshot()["memberships"] == \
        len(reference) == 390
    port_ix.rebucket(32)
    assert len(port_ix) == 0
    jax_ix = jx.wire.SubscriptionIndex(64)
    jax_ix._subs = _NoWalk()
    with pytest.raises(AssertionError, match="walked"):
        jax_ix.replace("sim-0", [(1, (0,))])


# ---------------------------------------------------------------------------
# over loopback: each package's client against the other's plane
# ---------------------------------------------------------------------------


async def _converge(wire_mod, client_mod, seed: int, chaos=None):
    """A ``wire_mod`` plane, a ``client_mod`` client: pushes, a live
    rebucket, pushes suppressed (repair only) and, with ``chaos``, every
    frame send of a window failing.  Returns the records lost."""
    rng = np.random.default_rng(seed)
    plane = wire_mod.ClientPlane(_StubNode(), "127.0.0.1:0", buckets=64)
    plane.delta_interval = 0.02
    await plane.start()
    tag = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    other = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    cli = client_mod.LightClient("127.0.0.1:%d" % plane.listen_port,
                                 client_id="x-%d" % seed, tags=[tag],
                                 buckets=32)
    await cli.start()
    records = []

    def offer(n, tag_=tag):
        for _ in range(n):
            rec = _record(rng, len(records), tag=tag_)
            records.append(rec)
            plane.node.store(rec)
            plane.on_record(*rec)
    def held():
        return all(r[0] in cli.objects for r in records if r[4] == tag)

    def subscribed():
        return plane.index.snapshot()["memberships"] == 1
    try:
        await _until(lambda: cli.synced.is_set() and subscribed(),
                     "synced")
        assert cli.bucket_count == 64          # the edge's count wins
        offer(10)
        offer(3, tag_=other)                   # another client's bucket
        await _until(held, "pushed")
        plane.rebucket(256)
        await _until(lambda: cli.bucket_count == 256 and subscribed(),
                     "rebucketed")
        plane.outbox_high = 0                  # pushes deferred: repair
        offer(10)
        await _until(held, "repaired")
        assert cli.fetch_repairs > 0
        assert plane.snapshot()["overflowed"] >= 10
        if chaos is not None:
            chaos.arm("role.client", probability=1.0, count=20)
            try:
                offer(10)
                await asyncio.sleep(0.3)
            finally:
                chaos.disarm("role.client")
        wanted = [r[0] for r in records if r[4] == tag]
        await _until(lambda: all(h in cli.objects for h in wanted),
                     "every subscribed object")
        assert not any(r[0] in cli.objects for r in records
                       if r[4] == other)
        return [h for h in wanted if h not in cli.objects]
    finally:
        await cli.stop()
        await plane.stop()


@pytest.mark.parametrize("direction", ["port client, JAX plane",
                                       "JAX client, port plane"])
async def test_each_packages_client_converges_on_the_others_plane(direction):
    jx = _jax()
    if direction.startswith("port"):
        lost = await _converge(jx.wire, port_client, 31)
    else:
        lost = await _converge(port_wire, jx.client, 32)
    assert lost == []


async def test_role_client_chaos_loses_nothing():
    """The port's ``role.client`` site fails every frame send for a
    window on both sides; the link drops, the client reconnects,
    re-subscribes and fetches, and ends holding every object."""
    before = PORT_REGISTRY.sample("chaos_injected_total",
                                  {"site": "role.client"})
    lost = await _converge(port_wire, port_client, 33, chaos=PORT_CHAOS)
    assert lost == []
    assert PORT_REGISTRY.sample("chaos_injected_total",
                                {"site": "role.client"}) > before


# ---------------------------------------------------------------------------
# delegated PoW
# ---------------------------------------------------------------------------


async def test_a_delegated_nonce_is_python_solves():
    """Through the port's plane: to a port ``FarmServer`` over the
    port's ``PowDispatcher`` (one FarmClient per client tenant), and
    with no farm to the edge's own dispatcher.  Each nonce equals the
    JAX ``python_solve``'s: the lowest valid nonce >= 0."""
    _jax()
    from pybitmessage_tpu.pow.dispatcher import python_solve
    from pybitmessage_tpu_torch.observability.profiling import \
        farm_tenant_costs
    from pybitmessage_tpu_torch.pow.dispatcher import PowDispatcher
    from pybitmessage_tpu_torch.powfarm import FarmClient, FarmServer
    solver = PowDispatcher("cpu")
    server = FarmServer(solver, window=0.0)
    await server.start()
    plane = port_wire.ClientPlane(_StubNode(), "127.0.0.1:0")
    await plane.start()
    clients = []
    try:
        hashes = [hashlib.sha512(b"delegated %d" % i).digest()
                  for i in range(3)]
        expected = [python_solve(ih, TARGET)[0] for ih in hashes]
        plane.node.farm_client = SimpleNamespace(client=FarmClient(
            "127.0.0.1", server.listen_port, tenant="edge"))
        for tenant in ("alice", "bob"):
            cli = port_client.LightClient(
                "127.0.0.1:%d" % plane.listen_port, client_id=tenant,
                tenant="tenant-" + tenant, extra_buckets=(0,))
            await cli.start()
            clients.append(cli)
        for cli in clients:
            await _until(lambda: cli.synced.is_set(), "synced")
        got = [(await clients[i % 2].delegate_pow(ih, TARGET,
                                                  timeout=30))[0]
               for i, ih in enumerate(hashes[:2])]
        assert got == expected[:2]
        costs = farm_tenant_costs()
        assert "tenant-alice" in costs and "tenant-bob" in costs
        snap = plane.snapshot()["farmDelegation"]
        assert snap["ok"] == 2 and snap["tenants"] == 2
        # no farm: the edge's own dispatcher
        plane.node.farm_client = None
        for farm in plane._farms.values():
            farm.close()
        plane._farms.clear()
        plane.node.solver = solver
        nonce, _ = await clients[0].delegate_pow(hashes[2], TARGET,
                                                 timeout=30)
        assert nonce == expected[2]
        # an impossible job answers an error, not a hang
        plane.node.solver = lambda ih, target: (0, 1)
        with pytest.raises(RuntimeError, match="host verification"):
            await clients[1].delegate_pow(hashes[2], 1, timeout=30)
        assert plane.snapshot()["farmDelegation"]["errors"] == 1
    finally:
        for cli in clients:
            await cli.stop()
        await plane.stop()
        await server.stop()


# ---------------------------------------------------------------------------
# the client's trial decrypt
# ---------------------------------------------------------------------------


def _broadcast_payload(ident, plaintext: bytes, encrypt, priv_to_pub,
                       double_hash, encode_varint) -> bytes:
    """A v5 broadcast object: nonce, expires, type 3, version 5, stream,
    the tag, then the body encrypted to the address-derived key."""
    dh = double_hash(ident.version, ident.stream, ident.ripe)
    shell = (b"\x00" * 8 + struct.pack(">Q", int(time.time()) + 900)
             + b"\x00\x00\x00\x03" + encode_varint(5)
             + encode_varint(ident.stream) + dh[32:])
    return shell + encrypt(plaintext, priv_to_pub(dh[:32]))


async def test_client_trial_decrypt_is_the_jax_clients():
    """One broadcast to a subscription, one msg to an identity, one msg
    to nobody and one broadcast under an unknown tag, through each
    package's ``LightClient._trial_decrypt``: the JAX client on its pure
    rung, the port client on its ``BatchCryptoEngine("cpu")``."""
    jx = _jax()
    from pybitmessage_tpu.crypto import encrypt, priv_to_pub
    from pybitmessage_tpu.crypto.batch import BatchCryptoEngine as JaxEngine
    from pybitmessage_tpu.models.payloads import (
        double_hash_of_address_data, encode_varint)
    from pybitmessage_tpu.workers.keystore import KeyStore as JaxKeyStore
    from pybitmessage_tpu_torch.crypto.batch import BatchCryptoEngine
    from pybitmessage_tpu_torch.workers.keystore import KeyStore
    passphrase = b"light client decrypt parity"
    keystores = [JaxKeyStore(), KeyStore()]
    idents = [ks.create_deterministic(passphrase) for ks in keystores]
    assert idents[0].address == idents[1].address
    caster = JaxKeyStore().create_deterministic(b"a broadcaster")
    subs = [ks.subscribe(caster.address, "watched") for ks in keystores]
    bcast = _broadcast_payload(caster, b"broadcast body", encrypt,
                               priv_to_pub, double_hash_of_address_data,
                               encode_varint)
    shell = b"\x00" * 8 + struct.pack(">Q", int(time.time()) + 900) + \
        b"\x00\x00\x00\x02" + encode_varint(1) + encode_varint(1)
    msg = shell + encrypt(b"msg body", priv_to_pub(
        idents[0].priv_encryption))
    stray = shell + encrypt(b"to nobody", priv_to_pub(b"\x07" * 32))
    unknown = bcast[:22] + b"\x11" * 32 + bcast[54:]
    objects = [(3, bcast), (2, msg), (2, stray), (3, unknown)]
    engines = [JaxEngine(use_native=False, use_tpu=False),
               BatchCryptoEngine("cpu")]
    clients = [mod.LightClient("127.0.0.1:1", client_id="dec",
                               crypto=engine, identities=[ident],
                               subscriptions=[sub])
               for mod, engine, ident, sub in zip(
                   (jx.client, port_client), engines, idents, subs)]
    results = []
    for cli, engine in zip(clients, engines):
        engine.start()
        try:
            await asyncio.wait_for(asyncio.gather(*(
                cli._trial_decrypt(hashlib.sha512(p).digest()[:32], t, p)
                for t, p in objects)), 60)
        finally:
            await engine.stop()
        results.append(sorted((h, handle.address, plain)
                              for h, handle, plain in cli.decrypted))
    assert results[1] == results[0]
    assert sorted(plain for _, _, plain in results[1]) == \
        [b"broadcast body", b"msg body"]


async def test_a_client_whose_engine_is_not_running_raises():
    from pybitmessage_tpu_torch.crypto.batch import BatchCryptoEngine
    cli = port_client.LightClient("127.0.0.1:1", client_id="idle",
                                  crypto=BatchCryptoEngine("cpu"))
    with pytest.raises(RuntimeError, match="not running"):
        await cli._trial_decrypt(b"\0" * 32, 2, b"\0" * 60)


# ---------------------------------------------------------------------------
# metric families and the node's hooks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", ["roles.subscription", "roles.client"])
def test_metric_families_are_the_jax_ones(module):
    import importlib
    _jax()

    def families(mod):
        out = {}
        for name, value in vars(mod).items():
            if hasattr(value, "kind") and hasattr(value, "labelnames") \
                    and name.isupper():
                out[value.name] = (value.kind, value.help,
                                   value.labelnames,
                                   getattr(value, "_bounds", None))
        return out
    jax_mod = importlib.import_module("pybitmessage_tpu." + module)
    port_mod = importlib.import_module("pybitmessage_tpu_torch." + module)
    assert families(port_mod) == families(jax_mod)
    assert families(port_mod)


async def test_a_node_plane_serves_the_senders_broadcast():
    """A port ``Node(client_listen=...)``: a ``LightClient`` subscribed
    to the node's own address receives the node's broadcast, pushed
    from the sender's publish hook, and decrypts nothing (no engine)."""
    from pybitmessage_tpu_torch.core import Node
    node = Node(device="cpu", crypto_batch=False, test_mode=True,
                listen=False, client_listen="127.0.0.1:0",
                client_buckets=32)
    await node.start()
    cli = None
    try:
        ident = node.create_identity("caster")
        sub = node.keystore.subscribe(ident.address, "self")
        cli = port_client.LightClient(
            "127.0.0.1:%d" % node.client_plane.listen_port,
            client_id="watcher", subscriptions=[sub], tags=[sub.tag],
            buckets=32)
        await cli.start()
        await _until(lambda: cli.synced.is_set(), "synced")
        assert cli.accepted_buckets == 1
        await node.send_broadcast(ident.address, "s", "b", ttl=600)
        await _until(lambda: cli.pushes >= 1, "the broadcast pushed", 60)
        [(type_, stream, _, tag, _)] = list(cli.objects.values())
        assert (type_, stream, tag) == (3, 1, sub.tag)
        status = node.client_plane.snapshot()
        assert status["sessions"] == 1 and status["pushed"] >= 1
        assert status["index"]["buckets"] == 32
    finally:
        if cli is not None:
            await cli.stop()
        await node.stop()


def test_the_client_role_needs_an_edge():
    from pybitmessage_tpu_torch.core import Node
    with pytest.raises(ValueError, match="clientconnect"):
        Node(device="cpu", crypto_batch=False, role="client")
