"""The port's node against the JAX package's, on the CPU.

Module parity (addresses, varints, base58, object headers, message
encodings, msg / pubkey v4 / broadcast v5 payloads, the deterministic
grind), wire objects across the packages in both directions (one
package's SendWorker publishes, the other's acceptance and
ObjectProcessor deliver, and the inbox rows equal those of a node of
the publishing package fed the same objects), the rejections both
packages make, the port node's whole paths through a bridge
(loopback, getpubkey -> pubkey -> msg -> ack, a broadcast), stop and
start, and a ``data_dir`` written by one package opened by the other.

The port's nodes run on the CPU (``device="cpu"``: the kernels' plain
torch versions).  Most take ``crypto_batch=False`` (host crypto): the
plain torch ECDH ladder takes seconds a call on the CPU.  The broadcast
test runs the batch engine.  The JAX nodes solve with
``pow.dispatcher.python_solve``.  Identities demand the test-mode
difficulty (10/10) of senders, so no PoW takes more than milliseconds
in hashlib.  Nothing of JAX is imported at module level: the card runs
the ``cuda`` test with ``--noconftest`` and has no JAX.
"""

import asyncio
import hashlib
import random
import sqlite3
import struct
import time

import numpy as np
import pytest
import torch

from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.crypto import ecies, keys, signing
from pybitmessage_tpu_torch.models import msgcoding, payloads
from pybitmessage_tpu_torch.models.objects import ObjectHeader
from pybitmessage_tpu_torch.models.pow_math import (check_pow,
                                                    pow_initial_hash,
                                                    pow_target)
from pybitmessage_tpu_torch.network.connection import accept_object
from pybitmessage_tpu_torch.pow.dispatcher import python_solve
from pybitmessage_tpu_torch.storage.messages import ACKRECEIVED
from pybitmessage_tpu_torch.utils import addresses, base58, varint

#: test-mode difficulty, demanded by every identity here
TEST_NTPB = 10
#: deterministic identities: both packages grind the same keys from them
#: (first hits at nonces 4 and 6: a grind of a few keys)
BOB = b"torch node 91"
ALICE = b"torch node 26"
DEADLINE = 30.0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _jax():
    """The JAX package's modules the tests use (imported on first use)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import pybitmessage_tpu.core as core
    from pybitmessage_tpu.network.connection import BMConnection
    from pybitmessage_tpu.pow import dispatcher
    return core, BMConnection, dispatcher


def port_node(data_dir=None, **kw) -> Node:
    kw.setdefault("crypto_batch", False)
    return Node(data_dir, device="cpu", test_mode=True, **kw)


def jax_node(data_dir=None):
    core, _, dispatcher = _jax()

    def solver(ih, target, should_stop=None):
        return dispatcher.python_solve(ih, target, should_stop=should_stop)
    return core.Node(data_dir, listen=False, solver=solver, test_mode=True,
                     dandelion_enabled=False, tls_enabled=False,
                     sync_enabled=False, wiretrace_enabled=False,
                     federation_enabled=False)


def is_port(node) -> bool:
    return isinstance(node, Node)


def identity(node, label: str, passphrase: bytes | None = None):
    """An identity demanding the test-mode difficulty of its senders."""
    ident = node.create_identity(label, deterministic=passphrase)
    ident.nonce_trials_per_byte = ident.extra_bytes = TEST_NTPB
    node.keystore.save()
    return ident


async def accept(node, payload: bytes) -> None:
    """Hand one received object to a node's object checks: the port's
    acceptance function, or a JAX connection's ``_handle_object``."""
    if is_port(node):
        await accept_object(node.ctx, node.pool, payload)
        return
    _, BMConnection, _ = _jax()
    conn = BMConnection(node.pool, None, None, outbound=False,
                        host="bridge", port=0)
    await conn._handle_object(payload)
    while conn._verify_tasks:
        await asyncio.gather(*list(conn._verify_tasks),
                             return_exceptions=True)


class Bridge:
    """The network between the test's nodes: what a node publishes
    (its SendWorker's ``on_publish`` for a JAX node, its pool's
    announcements for a port node) goes to the linked nodes' object
    checks, and is kept in ``sent``."""

    def __init__(self):
        self.sent: dict = {}
        self._tasks: set = set()

    def link(self, src, *dsts) -> None:
        self.sent[src] = []

        def deliver(payload):
            self.sent[src].append(payload)
            for dst in dsts:
                task = asyncio.get_running_loop().create_task(
                    accept(dst, payload))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
        if is_port(src):
            src.pool.on_announce = \
                lambda h, stream, local: deliver(src.inventory[h].payload)
        else:
            src.sender.on_publish = \
                lambda h, t, s, e, tag, payload: deliver(payload)
            src.pool.on_announce = lambda h, stream, local: (
                None if local else deliver(src.inventory[h].payload))

    async def settle(self) -> None:
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)


async def until(pred, what: str, timeout: float = DEADLINE) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        await asyncio.sleep(0.01)


async def idle(node) -> None:
    """Wait until a node has processed everything it accepted and its
    rows are written."""
    await until(lambda: node.ctx.object_queue.empty()
                and not node.processor.pending(), "an idle processor")
    wb = node.processor._wb
    if wb is not None:
        wb.flush()


def rows(node) -> list:
    """Inbox rows as comparable tuples, sorted."""
    return sorted((r.msgid, r.toaddress, r.fromaddress, r.subject,
                   r.message, r.encodingtype, r.sighash)
                  for r in node.store.inbox())


def solve_object(sans_nonce: bytes, ttl: int = 300) -> bytes:
    """A full object at the test-mode difficulty, solved by hashlib."""
    target = pow_target(len(sans_nonce) + 8, ttl, TEST_NTPB, TEST_NTPB,
                        clamp=False)
    nonce, _ = python_solve(pow_initial_hash(sans_nonce), target)
    return struct.pack(">Q", nonce) + sans_nonce


def msg_object(sender, to_pub_enc: bytes, to_ripe: bytes, subject: str,
               body: str, *, expires: int | None = None, stream: int = 1,
               corrupt_signature: bool = False) -> bytes:
    """A msg object from ``sender`` (an OwnIdentity), encrypted to
    ``to_pub_enc``, without an ack."""
    expires = expires or int(time.time()) + 300
    plain = payloads.MsgPlaintext(
        sender.version, sender.stream, payloads.get_bitfield(True),
        sender.pub_signing_key, sender.pub_encryption_key,
        TEST_NTPB, TEST_NTPB, to_ripe, 2,
        msgcoding.encode_message(subject, body), b"")
    shell = payloads.object_shell(expires, 2, 1, stream)
    plain.signature = signing.sign(shell + plain.encode_unsigned(),
                                   sender.priv_signing)
    if corrupt_signature:
        sig = bytearray(plain.signature)
        sig[-1] ^= 0x01
        plain.signature = bytes(sig)
    return solve_object(shell + ecies.encrypt(plain.encode(), to_pub_enc))


def pubkey_object(ident) -> bytes:
    """``ident``'s v4 pubkey object, living an hour."""
    data = payloads.PubkeyData(
        4, ident.stream, payloads.get_bitfield(True), ident.pub_signing_key,
        ident.pub_encryption_key, TEST_NTPB, TEST_NTPB)
    return solve_object(payloads.assemble_pubkey(
        int(time.time()) + 3600, data, ident.ripe,
        sign_fn=lambda d: signing.sign(d, ident.priv_signing)), ttl=3600)


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [0, 1, 0xFC, 0xFD, 0xFFFF, 0x10000,
                                   0xFFFFFFFF, 1 << 32, (1 << 64) - 1])
def test_varint_round_trips_both_ways(value):
    from pybitmessage_tpu.utils import varint as ref
    assert varint.encode_varint(value) == ref.encode_varint(value)
    assert varint.decode_varint(ref.encode_varint(value)) == \
        ref.decode_varint(varint.encode_varint(value))


def test_varint_rejects_what_the_reference_rejects():
    from pybitmessage_tpu.utils import varint as ref
    for bad in (b"\xfd\x00\x10", b"\xfe\x00\x00\xff\xff", b"\xff\x00",
                b"\xfd\x01"):
        with pytest.raises(ref.VarintError):
            ref.decode_varint(bad)
        with pytest.raises(varint.VarintError):
            varint.decode_varint(bad)


def test_base58_round_trips_both_ways():
    from pybitmessage_tpu.utils import base58 as ref
    rng = random.Random(5)
    for n in (0, 1, 5, 21, 37):
        data = b"\x00" * (n % 3) + rng.randbytes(n)
        assert base58.b58encode(data) == ref.b58encode(data)
        assert base58.b58decode(ref.b58encode(data)) == data
        assert ref.b58decode(base58.b58encode(data)) == data


@pytest.mark.parametrize("version,stream,zeros", [
    (4, 1, 1), (4, 1, 3), (3, 1, 1), (3, 2, 2), (4, 17, 0)])
def test_addresses_round_trip_both_ways(version, stream, zeros):
    from pybitmessage_tpu.utils import addresses as ref
    rng = random.Random(version * 100 + stream + zeros)
    ripe = b"\x00" * zeros + rng.randbytes(20 - zeros)
    if version == 4 or zeros <= 2:
        text = addresses.encode_address(version, stream, ripe)
        assert text == ref.encode_address(version, stream, ripe)
        mine, theirs = addresses.decode_address(text), \
            ref.decode_address(text)
        assert (mine.version, mine.stream, mine.ripe) == \
            (theirs.version, theirs.stream, theirs.ripe) == \
            (version, stream, ripe)
    text = addresses.encode_address(4, stream, b"\x01" + ripe[1:])
    bad = text[:-1] + ("2" if text[-1] != "2" else "3")
    with pytest.raises(ref.AddressError) as e_ref:
        ref.decode_address(bad)
    with pytest.raises(addresses.AddressError) as e_port:
        addresses.decode_address(bad)
    assert e_ref.value.status == e_port.value.status


def test_object_header_parse_agrees():
    from pybitmessage_tpu.models import objects as ref
    rng = np.random.default_rng(8)
    for object_type, version, stream in ((0, 4, 1), (1, 4, 1), (2, 1, 1),
                                         (3, 5, 1), (2, 1, 300)):
        body = rng.bytes(int(rng.integers(40, 400)))
        data = ref.serialize_object(int(time.time()) + 600, object_type,
                                    version, stream, body,
                                    nonce=int(rng.integers(1 << 62)))
        mine, theirs = ObjectHeader.parse(data), ref.ObjectHeader.parse(data)
        assert (mine.nonce, mine.expires, mine.object_type, mine.version,
                mine.stream, mine.header_length) == \
            (theirs.nonce, theirs.expires, theirs.object_type,
             theirs.version, theirs.stream, theirs.header_length)
        from pybitmessage_tpu_torch.models.objects import extract_tag
        assert extract_tag(mine, data) == ref.extract_tag(theirs, data)


@pytest.mark.parametrize("encoding", [1, 2, 3])
def test_msgcoding_decodes_the_other_package(encoding):
    from pybitmessage_tpu.models import msgcoding as ref
    subject, body = "subject é", "line one\nline two ✓" * 5
    for enc, dec in ((msgcoding, ref), (ref, msgcoding)):
        got = dec.decode_message(enc.encode_message(subject, body, encoding),
                                 encoding)
        assert (got.subject, got.body) == \
            (subject if encoding != 1 else "", body)


@pytest.fixture(scope="module")
def ref_crypto():
    from pybitmessage_tpu import crypto
    return crypto


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_msg_plaintext_decodes_in_the_other_package(direction, ref_crypto):
    from pybitmessage_tpu.models import payloads as ref
    make, read = (payloads, ref) if direction == "port_to_jax" \
        else (ref, payloads)
    rng = random.Random(11)
    sk, ek = rng.randbytes(32), rng.randbytes(32)
    plain = make.MsgPlaintext(
        4, 1, make.get_bitfield(True), keys.priv_to_pub(sk),
        keys.priv_to_pub(ek), 1000, 1000, rng.randbytes(20), 2,
        b"Subject:s\nBody:b", b"ack packet bytes")
    shell = make.object_shell(int(time.time()) + 300, 2, 1, 1)
    plain.signature = signing.sign(shell + plain.encode_unsigned(), sk)
    payload = shell + ecies.encrypt(plain.encode(), keys.priv_to_pub(ek))
    decrypt = ref_crypto.decrypt if direction == "port_to_jax" \
        else ecies.decrypt
    got = read.MsgPlaintext.decode(decrypt(payload[len(shell):], ek))
    assert (got.dest_ripe, got.message, got.ack_data, got.signature,
            got.pub_signing_key) == (plain.dest_ripe, plain.message,
                                     plain.ack_data, plain.signature,
                                     plain.pub_signing_key)
    signed = read.msg_signed_data(b"\x00" * 8 + payload, 1, 1,
                                  got.encode_unsigned())
    assert ref_crypto.verify(signed, got.signature, got.pub_signing_key)
    assert signing.verify(signed, got.signature, got.pub_signing_key)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pubkey_v4_decodes_in_the_other_package(direction, ref_crypto):
    from pybitmessage_tpu.models import payloads as ref
    from pybitmessage_tpu.utils.hashes import address_ripe
    make, read = (payloads, ref) if direction == "port_to_jax" \
        else (ref, payloads)
    sign = signing.sign if direction == "port_to_jax" else ref_crypto.sign
    decrypt = ref_crypto.decrypt if direction == "port_to_jax" \
        else ecies.decrypt
    rng = random.Random(12)
    sk, ek = rng.randbytes(32), rng.randbytes(32)
    pub_sk, pub_ek = keys.priv_to_pub(sk), keys.priv_to_pub(ek)
    ripe = address_ripe(pub_sk, pub_ek)
    data = make.PubkeyData(4, 1, make.get_bitfield(True), pub_sk, pub_ek,
                           TEST_NTPB, TEST_NTPB)
    obj = make.assemble_pubkey(int(time.time()) + 600, data, ripe,
                               sign_fn=lambda d: sign(d, sk))
    dh = read.double_hash_of_address_data(4, 1, ripe)
    header = ObjectHeader.parse(b"\x00" * 8 + obj)
    tag_end = header.header_length - 8 + 32
    assert obj[tag_end - 32:tag_end] == dh[32:]
    inner = decrypt(obj[tag_end:], dh[:32])
    got = read.parse_pubkey_inner(inner, 4, 1)
    assert (got.pub_signing_key, got.pub_encryption_key,
            got.nonce_trials_per_byte, got.extra_bytes) == \
        (pub_sk, pub_ek, TEST_NTPB, TEST_NTPB)
    signed = obj[:tag_end] + inner[:len(inner) - 1 - len(got.signature)]
    assert ref_crypto.verify(signed, got.signature, pub_sk)
    assert signing.verify(signed, got.signature, pub_sk)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_broadcast_v5_decodes_in_the_other_package(direction, ref_crypto):
    from pybitmessage_tpu.models import payloads as ref
    make, read = (payloads, ref) if direction == "port_to_jax" \
        else (ref, payloads)
    decrypt = ref_crypto.decrypt if direction == "port_to_jax" \
        else ecies.decrypt
    rng = random.Random(13)
    sk, ek, ripe = rng.randbytes(32), rng.randbytes(32), rng.randbytes(20)
    dh = make.double_hash_of_address_data(4, 1, ripe)
    shell = make.object_shell(int(time.time()) + 600, 3, 5, 1) + dh[32:]
    plain = make.BroadcastPlaintext(
        4, 1, make.get_bitfield(True), keys.priv_to_pub(sk),
        keys.priv_to_pub(ek), 1000, 1000, 2, b"Subject:x\nBody:y")
    plain.signature = signing.sign(
        make.broadcast_signed_data(shell, plain.encode_unsigned()), sk)
    blob = ecies.encrypt(plain.encode(), keys.priv_to_pub(dh[:32]))
    got = read.BroadcastPlaintext.decode(decrypt(blob, dh[:32]))
    assert (got.message, got.signature, got.pub_encryption_key) == \
        (plain.message, plain.signature, plain.pub_encryption_key)
    assert read.broadcast_v4_key(3, 1, ripe) == \
        make.broadcast_v4_key(3, 1, ripe)


@pytest.mark.parametrize("passphrase,batch", [
    (b"alpha", 8), (b"bravo pass", 8), (BOB, 1), (BOB, 64)])
def test_deterministic_grind_matches_jax(passphrase, batch):
    """Batches of ``batch`` tries find the reference's first hit, within
    the first batch or many batches later."""
    from pybitmessage_tpu.crypto import keys as ref
    want = ref.grind_deterministic_keys(passphrase)
    assert keys.grind_deterministic_keys(
        passphrase, derive=keys.host_priv_to_pub_many, batch=batch) == want


def test_deterministic_grind_through_priv_to_pub_many_matches_jax():
    """The card's derivation route (``priv_to_pub_many``: kernel 5's
    plain version here) grinds the reference's keys."""
    from pybitmessage_tpu.crypto import keys as ref
    passphrase = b"torch grind 96"      # its first hit is at nonce 8
    want = ref.grind_deterministic_keys(passphrase)
    assert want[3] == 8
    got = keys.grind_deterministic_keys(
        passphrase, batch=8,
        derive=lambda ks: keys.priv_to_pub_many(ks, device="cpu"))
    assert got == want


@pytest.mark.parametrize("blocks", [1, 2, 95])
def test_aes_cbc_matches_jax_both_ways(blocks):
    """The port's table-driven inverse cipher against the JAX package's
    pure-Python AES (a 95-block payload is a 1 KB message's size)."""
    from pybitmessage_tpu.crypto import fallback as ref
    from pybitmessage_tpu_torch.crypto import fallback
    rng = random.Random(blocks)
    key, iv, data = rng.randbytes(32), rng.randbytes(16), \
        rng.randbytes(16 * blocks)
    sealed = ref.aes256_cbc(True, key, iv, data)
    assert fallback.aes256_cbc(True, key, iv, data) == sealed
    assert fallback.aes256_cbc(False, key, iv, sealed) == data
    assert ref.aes256_cbc(False, key, iv, sealed) == data


def test_wif_round_trips_both_ways(ref_crypto):
    rng = random.Random(14)
    for k in [rng.randbytes(32) for _ in range(4)]:
        assert keys.wif_decode(ref_crypto.wif_encode(k)) == k
        assert ref_crypto.wif_decode(keys.wif_encode(k)) == k
    with pytest.raises(ValueError):        # before any device work
        keys.priv_to_pub_many([b"\x00" * 32], device="cpu")


# ---------------------------------------------------------------------------
# wire objects across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
async def test_cross_package_delivery(direction):
    """A of one package sends a msg (with its embedded ack) and a
    broadcast to bob; bob's node of the other package and a twin of
    A's package, both holding bob's deterministic keys, are fed the same
    objects and hold the same inbox rows; the other package's ack goes
    back to A."""
    make_a, make_b = (jax_node, port_node) if direction == "jax_to_port" \
        else (port_node, jax_node)
    a, b, twin = make_a(), make_b(), make_a()
    bridge = Bridge()
    bridge.link(a, b, twin)
    bridge.link(b, a)
    for node in (a, b, twin):
        await node.start()
    try:
        alice = identity(a, "alice")
        bob = identity(b, "bob", BOB)
        assert identity(twin, "bob", BOB).address == bob.address
        for node in (b, twin):
            node.keystore.subscribe(alice.address, "alice")
        # A holds bob's pubkey: the only ack-less step skipped here
        inner = b.keystore.get(bob.address)
        body = (payloads.get_bitfield(True) + inner.pub_signing_key[1:]
                + inner.pub_encryption_key[1:]
                + varint.encode_varint(TEST_NTPB) * 2 + b"\x00")
        a.store.store_pubkey(bob.address, 4, body, True)
        ack = await a.send_message(bob.address, alice.address,
                                   "cross subject", "cross body", ttl=600)
        await a.send_broadcast(alice.address, "cross bcast", "news",
                               ttl=3600)
        for node in (b, twin):
            await until(lambda: len(node.store.inbox()) == 2,
                        "delivery to bob's %s node"
                        % ("port" if is_port(node) else "JAX"))
        await until(lambda: a.message_status(ack) == ACKRECEIVED,
                    "the ack back to A")
        await bridge.settle()
        await idle(b)
        await idle(twin)
        assert rows(b) == rows(twin)
        got = {r[1]: r for r in rows(b)}
        assert got[bob.address][2:6] == (alice.address, "cross subject",
                                        "cross body", 2)
        assert got["[Broadcast]"][2:6] == (alice.address, "cross bcast",
                                          "news", 2)
        assert {ObjectHeader.parse(p).object_type for p in bridge.sent[a]} \
            == {2, 3}
    finally:
        for node in (a, b, twin):
            await node.stop()


REJECTIONS = ["flipped_nonce", "corrupted_signature", "expired",
              "foreign_stream", "for_nobody"]


@pytest.mark.parametrize("case", REJECTIONS)
async def test_rejections_agree(case):
    """Both packages drop the object, and neither delivers it; a good
    object sent after it is delivered by both."""
    port, ref = port_node(), jax_node()
    await port.start()
    await ref.start()
    try:
        bob = identity(port, "bob", BOB)
        identity(ref, "bob", BOB)
        alice = identity(port, "alice", ALICE)
        to_pub, to_ripe = bob.pub_encryption_key, bob.ripe
        kw = {}
        if case == "corrupted_signature":
            kw["corrupt_signature"] = True
        elif case == "expired":
            kw["expires"] = int(time.time()) - 3700
        elif case == "foreign_stream":
            kw["stream"] = 2
        elif case == "for_nobody":
            to_pub = keys.priv_to_pub(random.Random(9).randbytes(32))
        bad = msg_object(alice, to_pub, to_ripe, "bad", case, **kw)
        if case == "flipped_nonce":
            for bit in range(64):
                flipped = bytearray(bad)
                flipped[7 - bit // 8] ^= 1 << (bit % 8)
                if not check_pow(bytes(flipped), TEST_NTPB, TEST_NTPB,
                                 clamp=False):
                    bad = bytes(flipped)
                    break
        outcome = await accept_object(port.ctx, port.pool, bad)
        await accept(ref, bad)
        want = {"flipped_nonce": "pow", "expired": "invalid",
                "foreign_stream": "stream"}.get(case, "accepted")
        assert outcome == want
        held = hashlib.sha512(hashlib.sha512(bad).digest()).digest()[:32]
        assert (held in port.inventory) == (held in ref.inventory) == \
            (want == "accepted")
        good = msg_object(alice, bob.pub_encryption_key, bob.ripe, "good",
                          "after " + case)
        assert await accept_object(port.ctx, port.pool, good) == "accepted"
        await accept(ref, good)
        for node in (port, ref):
            await until(lambda: len(node.store.inbox()) == 1,
                        "the good object")
            await idle(node)
            assert [r.subject for r in node.store.inbox()] == ["good"]
    finally:
        await port.stop()
        await ref.stop()


# ---------------------------------------------------------------------------
# the port node's whole paths, through the bridge
# ---------------------------------------------------------------------------


async def test_loopback_self_send():
    node = port_node()
    await node.start()
    try:
        me = identity(node, "me")
        ack = await node.send_message(me.address, me.address,
                                      "self subject", "self body", ttl=300)
        await until(lambda: node.message_status(ack) == ACKRECEIVED,
                    "the loopback delivery")
        inbox = node.store.inbox()
        assert [(r.subject, r.message, r.fromaddress, r.toaddress)
                for r in inbox] == [("self subject", "self body",
                                     me.address, me.address)]
        assert len(node.inventory.unexpired_hashes_by_stream(1)) == 1
        assert node.solver.last_backend.startswith("torch")
    finally:
        await node.stop()


async def test_two_node_getpubkey_pubkey_msg_ack():
    """A knows only B's address: getpubkey -> pubkey -> msg -> ack."""
    a, b = port_node(), port_node()
    bridge = Bridge()
    bridge.link(a, b)
    bridge.link(b, a)
    await a.start()
    await b.start()
    try:
        alice, bob = identity(a, "alice", ALICE), identity(b, "bob", BOB)
        ack = await a.send_message(bob.address, alice.address, "hello bob",
                                   "message body here", ttl=300)
        await until(lambda: a.message_status(ack) == ACKRECEIVED,
                    "the ack", timeout=60)
        await idle(b)
        row, = b.store.inbox()
        assert (row.subject, row.message, row.fromaddress, row.toaddress,
                row.encodingtype) == ("hello bob", "message body here",
                                      alice.address, bob.address, 2)
        kinds = [ObjectHeader.parse(p).object_type
                 for p in bridge.sent[a] + bridge.sent[b]]
        assert sorted(kinds) == [0, 1, 2, 2]    # getpubkey, pubkey, msg, ack
        assert b.pow_verifier.host_checked + b.pow_verifier.device_checked \
            == 2
        assert a.crypto.host_decrypts and b.crypto.host_verifies
    finally:
        await a.stop()
        await b.stop()


async def test_broadcast_to_a_subscriber_through_the_engine():
    """B's trial decrypt and signature check run in the batch engine
    (kernels 5 and 4 in their plain versions here; ``gpu_batch_min``
    1 puts these one-item drains on the card rung)."""
    a, b = port_node(), port_node(crypto_batch=True)
    b.crypto.batch.gpu_batch_min = 1
    bridge = Bridge()
    bridge.link(a, b)
    await a.start()
    await b.start()
    try:
        alice = identity(a, "alice")
        b.keystore.subscribe(alice.address, "alice")
        await a.send_broadcast(alice.address, "bcast subj", "news!")
        await until(lambda: len(b.store.inbox()) == 1, "the broadcast", 60)
        row, = b.store.inbox()
        assert (row.subject, row.message, row.fromaddress, row.toaddress) \
            == ("bcast subj", "news!", alice.address, "[Broadcast]")
        engine = b.crypto.batch
        assert engine.drains == 1 and engine.gpu_items == 2
        assert engine.failed_drains == 0
        assert b.crypto.host_verifies == b.crypto.host_decrypts == 0
        assert engine.backend.calls == {"verify": 1, "ecdh": 1}
    finally:
        await a.stop()
        await b.stop()


async def test_stop_and_start_keep_the_queue_and_the_sent_state(tmp_path):
    """A message awaiting its pubkey and an object the processor has
    not processed both survive a restart on the same ``data_dir``."""
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    b = port_node(b_dir)
    bob = identity(b, "bob", BOB)
    me = identity(b, "me")
    pending = msg_object(me, bob.pub_encryption_key, bob.ripe, "queued",
                         "never processed before the restart")
    b.processor.queue.put_nowait(pending)
    await b.stop()                  # never started: the queue persists
    with sqlite3.connect(b_dir / "messages.dat") as db:
        assert db.execute("SELECT count(*) FROM objectprocessorqueue"
                          ).fetchone() == (1,)

    a = port_node(a_dir)
    await a.start()
    alice = identity(a, "alice")
    ack = await a.send_message(bob.address, alice.address, "later",
                               "sent after the restart", ttl=300)
    await until(lambda: a.message_status(ack) == "awaitingpubkey",
                "the getpubkey")
    await a.stop()

    a, b = port_node(a_dir), port_node(b_dir)
    bridge = Bridge()
    bridge.link(a, b)
    bridge.link(b, a)
    assert a.message_status(ack) == "awaitingpubkey"
    await a.start()
    await b.start()
    try:
        await until(lambda: len(b.store.inbox()) == 1, "the restored object")
        assert b.store.inbox()[0].subject == "queued"
        assert list(a.sender.needed_pubkeys.values()) == [bob.address]
        # bob's pubkey reaches A now; A then sends
        assert await accept_object(a.ctx, a.pool, pubkey_object(bob)) == \
            "accepted"
        await until(lambda: a.message_status(ack) == ACKRECEIVED,
                    "the message after the restart", timeout=60)
    finally:
        await a.stop()
        await b.stop()


@pytest.mark.parametrize("mode", ["black", "white"])
async def test_black_and_white_lists(mode):
    """A blacklisted sender's message, or in whitelist mode an unlisted
    sender's, is dropped; a listed one's is delivered in whitelist
    mode."""
    node = port_node()
    await node.start()
    try:
        bob = identity(node, "bob", BOB)
        alice = identity(node, "alice", ALICE)
        node.processor.list_mode = mode
        if mode == "black":
            node.store.listing_add("blacklist", alice.address, "no")
        first = msg_object(alice, bob.pub_encryption_key, bob.ripe, "one",
                           "dropped")
        assert await accept_object(node.ctx, node.pool, first) == \
            "accepted"
        await idle(node)
        assert node.store.inbox() == []
        if mode == "white":
            node.store.listing_add("whitelist", alice.address, "yes")
            second = msg_object(alice, bob.pub_encryption_key, bob.ripe,
                                "two", "kept")
            await accept_object(node.ctx, node.pool, second)
            await until(lambda: node.store.inbox(), "the listed sender")
            assert [r.subject for r in node.store.inbox()] == ["two"]
    finally:
        await node.stop()


# ---------------------------------------------------------------------------
# state carried across packages
# ---------------------------------------------------------------------------


async def _fill(node, bob_address):
    """Identities, a subscription, a pubkey, inbox and sent rows and
    inventory objects, through the node's own API."""
    me = identity(node, "me", ALICE)
    node.keystore.subscribe(bob_address, "bob's feed")
    await node.start()
    ack = await node.send_message(me.address, me.address, "kept",
                                  "kept body", ttl=300)
    await until(lambda: node.message_status(ack) == ACKRECEIVED, "loopback")
    await node.send_message(bob_address, me.address, "to bob", "waits",
                            ttl=300)
    await until(lambda: node.store.sent_by_status("awaitingpubkey"),
                "the getpubkey")
    node.store.store_pubkey("BM-fake", 4, b"\x00" * 140, False)
    await node.stop()


def _state(node) -> dict:
    return {
        "identities": sorted((i.address, i.label, i.priv_signing,
                              i.priv_encryption, i.ripe,
                              i.nonce_trials_per_byte)
                             for i in node.keystore.identities.values()),
        "subscriptions": sorted((s.address, s.label)
                                for s in node.keystore.subscriptions.values()),
        "pubkey": node.store.get_pubkey("BM-fake"),
        "inbox": rows(node),
        "sent": sorted((m.toaddress, m.subject, m.status, m.ackdata)
                       for m in node.store.all_sent()),
        "inventory": sorted(node.inventory.hashes()),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
async def test_data_dir_opens_in_the_other_package(writer, tmp_path):
    make_w, make_r = (jax_node, port_node) if writer == "jax" \
        else (port_node, jax_node)
    bob_address = addresses.encode_address(4, 1, b"\x00" + b"\x42" * 19)
    w = make_w(tmp_path)
    await _fill(w, bob_address)
    w = make_w(tmp_path)
    want = _state(w)
    w.db.close()
    r = make_r(tmp_path)
    try:
        assert _state(r) == want
        assert len(want["inventory"]) == 2 and len(want["inbox"]) == 1
        assert sorted(s[2] for s in want["sent"]) == ["ackreceived",
                                                      "awaitingpubkey"]
    finally:
        r.db.close()


def test_create_identity_is_the_same_in_both_packages():
    port, ref = port_node(), jax_node()
    try:
        mine = port.create_identity("x", deterministic=BOB)
        theirs = ref.create_identity("x", deterministic=BOB)
        assert (mine.address, mine.priv_signing, mine.priv_encryption,
                mine.ripe, mine.pub_signing_key, mine.pub_encryption_key) \
            == (theirs.address, theirs.priv_signing, theirs.priv_encryption,
                theirs.ripe, theirs.pub_signing_key,
                theirs.pub_encryption_key)
    finally:
        port.db.close()
        ref.db.close()


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------


def test_node_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Node()
    node = Node(device="cpu")
    assert node.solver.device.type == "cpu"
    assert node.crypto.batch.backend.device.type == "cpu"
    assert node.pow_verifier.device.type == "cpu"
    node.db.close()


def test_attached_engine_that_is_not_running_is_an_error():
    node = Node(device="cpu", test_mode=True)

    async def check():
        with pytest.raises(RuntimeError):
            await node.crypto.verify(b"data", b"sig", b"\x04" * 65)
    try:
        asyncio.run(check())
    finally:
        node.db.close()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_two_node_flow_on_the_card(cuda_device):
    """The two-node flow with every device service on the card: the
    nonce searches, the verifier, the engine's verify and ECDH drains
    (``cryptotpubatchmin`` 1: by default drains under 64 run on the
    native rung) and the identity grind."""
    from pybitmessage_tpu_torch.ops import secp256k1_cuda, sha512_cuda

    async def flow():
        a = Node(device=cuda_device, test_mode=True)
        b = Node(device=cuda_device, test_mode=True)
        for node in (a, b):
            node.crypto.batch.gpu_batch_min = 1
        bridge = Bridge()
        bridge.link(a, b)
        bridge.link(b, a)
        await a.start()
        await b.start()
        try:
            alice, bob = identity(a, "alice"), identity(b, "bob", BOB)
            ack = await a.send_message(bob.address, alice.address, "card",
                                       "on the card", ttl=300)
            await until(lambda: a.message_status(ack) == ACKRECEIVED,
                        "the ack", timeout=120)
            await idle(b)
            assert [(r.subject, r.message) for r in b.store.inbox()] == \
                [("card", "on the card")]
            assert b.crypto.batch.failed_drains == 0
        finally:
            await a.stop()
            await b.stop()

    sha512_cuda.reset_launches()
    secp256k1_cuda.reset_launches()
    asyncio.run(flow())
    assert sum(sha512_cuda.LAUNCHES.values()) > 0
    assert secp256k1_cuda.LAUNCHES["secp_verify"] > 0
    assert secp256k1_cuda.LAUNCHES["secp_ecdh"] > 0
