"""Send pipeline: the sent-message state machine + PoW dispatch (copy of
``pybitmessage_tpu.workers.sender``).

Reference: class_singleWorker.py — sendMsg (717-1373), sendBroadcast
(532-715), sendOutOrStoreMyV4Pubkey (417-530), sendOnionPeerObj
(494-530), requestPubKey (1375-1493).  States: msgqueued -> (doingpubkeypow -> awaitingpubkey)
-> doingmsgpow -> msgsent -> ackreceived.

Every PoW goes through the port's ``PowService`` (the nonce-search
kernels on the card); signing and encryption run on the host.  A v4
pubkey found in the inventory is decrypted and its signature checked
through the node's ``CryptoPool``, i.e. the batch engine on the card.
Each PoW wait runs in a ``worker.pow`` span feeding
``worker_pow_wait_seconds``; each published object counts into
``worker_objects_published_total``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import struct
import time

from ..crypto.ecies import encrypt
from ..crypto.keys import priv_to_pub
from ..crypto.signing import sign
from ..models import msgcoding
from ..models.constants import (
    DEFAULT_EXTRA_BYTES, DEFAULT_NONCE_TRIALS_PER_BYTE, OBJECT_BROADCAST,
    OBJECT_GETPUBKEY, OBJECT_MSG, OBJECT_ONIONPEER, OBJECT_PUBKEY,
    RIDICULOUS_DIFFICULTY,
)
from ..models.objects import ObjectHeader
from ..models.packet import pack_packet
from ..models.payloads import (
    BroadcastPlaintext, MsgPlaintext, PayloadError, PubkeyData,
    ack_ttl_bucket, assemble_getpubkey, assemble_pubkey,
    bitfield_does_ack, broadcast_signed_data, broadcast_v4_key,
    double_hash_of_address_data, gen_ack_payload, get_bitfield,
    object_shell, parse_pubkey_inner,
)
from ..models.pow_math import pow_target
from ..network.messages import encode_host
from ..observability import REGISTRY, trace
from ..storage.messages import (
    ACKRECEIVED, AWAITINGPUBKEY, BROADCASTSENT, DOINGMSGPOW,
    DOINGPUBKEYPOW, MSGQUEUED, MSGSENT, MSGSENTNOACKEXPECTED, MessageStore,
)
from ..utils.addresses import decode_address
from ..utils.hashes import address_ripe, inventory_hash, sha512
from ..utils.varint import decode_varint, encode_varint
from .cryptopool import CryptoPool
from .keystore import KeyStore

logger = logging.getLogger("pybitmessage_tpu_torch.worker")

#: re-request a pubkey after this long (class_singleWorker.py getpubkey)
GETPUBKEY_RETRY = 2.5 * 24 * 3600

POW_WAIT_SECONDS = REGISTRY.histogram(
    "worker_pow_wait_seconds",
    "End-to-end PoW wait in the send pipeline: coalescing queue + "
    "solve + host verify")
OBJECTS_PUBLISHED = REGISTRY.counter(
    "worker_objects_published_total",
    "Locally generated objects entered into the inventory",
    ("type",))
_TYPE_NAMES = {OBJECT_GETPUBKEY: "getpubkey", OBJECT_MSG: "msg",
               OBJECT_PUBKEY: "pubkey", OBJECT_BROADCAST: "broadcast",
               OBJECT_ONIONPEER: "onionpeer"}


def _jitter_ttl(ttl: int) -> int:
    return max(300, int(ttl + random.randrange(-300, 300)))


class SendWorker:
    """Consumes send commands; drives the sent table state machine."""

    def __init__(self, *, keystore: KeyStore, store: MessageStore,
                 inventory, pool, pow_service, crypto: CryptoPool,
                 shutdown: asyncio.Event | None = None,
                 min_ntpb: int = DEFAULT_NONCE_TRIALS_PER_BYTE,
                 min_extra: int = DEFAULT_EXTRA_BYTES,
                 ui_signal=None):
        #: ``ui_signal(command, data)``: the node's UI event bus
        self.ui_signal = ui_signal or (lambda cmd, data=(): None)
        #: ``(h, type, stream, expires, tag, payload)`` hook for every
        #: locally published object
        self.on_publish = None
        self.keystore = keystore
        self.store = store
        self.inventory = inventory
        self.pool = pool
        #: the coalescing PoW front-end: concurrently pending sends
        #: become one batched launch
        self.pow_service = pow_service
        #: the ingest path's crypto route (the batch engine on the card)
        self.crypto = crypto
        self.min_ntpb = min_ntpb    # network-minimum PoW (test mode: /100)
        self.min_extra = min_extra
        self.shutdown = shutdown or asyncio.Event()
        self.queue: asyncio.Queue = asyncio.Queue()
        #: ackdata payloads we watch for (state.ackdataForWhichImWatching)
        self.watched_acks: set[bytes] = set()
        #: tag -> address for pubkeys we await (state.neededPubkeys analog)
        self.needed_pubkeys: dict[bytes, str] = {}
        #: ceilings on a recipient's demanded PoW (reference
        #: maxacceptablenoncetrialsperbyte / ...extrabytes; 0 = unlimited)
        self.max_acceptable_ntpb = \
            RIDICULOUS_DIFFICULTY * DEFAULT_NONCE_TRIALS_PER_BYTE
        self.max_acceptable_extra = \
            RIDICULOUS_DIFFICULTY * DEFAULT_EXTRA_BYTES
        #: (host, port) of our own onion endpoint; when set, start()
        #: publishes it as an ONIONPEER object (sendOnionPeerObj role)
        self.onion_peer: tuple[str, int] | None = None
        self._task: asyncio.Task | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> asyncio.Task:
        self.store.reset_interrupted_pow()
        self._rebuild_watchlists()
        # initial sweep: anything re-queued by reset_interrupted_pow (or
        # left queued at last shutdown) gets processed without waiting
        # for a new command
        self.queue.put_nowait(("sendmessage",))
        self.queue.put_nowait(("sendbroadcast",))
        # announce our onion endpoint, if configured (the reference
        # enqueues 'sendOnionPeerObj' at worker startup the same way,
        # class_singleWorker.py:142-143)
        if self.onion_peer:
            self.queue.put_nowait(("sendonionpeer",))
        self._task = asyncio.create_task(self._run())
        return self._task

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def _rebuild_watchlists(self) -> None:
        """Recover state from the sent table (class_singleWorker.py:72-117)."""
        for m in self.store.sent_by_status(MSGSENT, DOINGMSGPOW):
            self.watched_acks.add(m.ackdata)
        for m in self.store.sent_by_status(AWAITINGPUBKEY):
            try:
                a = decode_address(m.toaddress)
            except ValueError:
                logger.warning("sent row awaiting pubkey has "
                               "undecodable address %r", m.toaddress)
                continue
            tag = double_hash_of_address_data(a.version, a.stream, a.ripe)[32:]
            self.needed_pubkeys[tag] = m.toaddress

    async def _run(self) -> None:
        while not self.shutdown.is_set():
            cmd = await self.queue.get()
            try:
                await self._dispatch(cmd)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("send worker command failed: %r", cmd[:1])

    async def _dispatch(self, cmd: tuple) -> None:
        kind = cmd[0]
        if kind == "sendmessage":
            await self.process_queued_messages()
        elif kind == "sendbroadcast":
            await self.process_queued_broadcasts()
        elif kind == "sendpubkey":
            await self.send_my_pubkey(cmd[1])
        elif kind == "sendonionpeer":
            await self.send_onion_peer(*cmd[1:])
        else:
            logger.warning("unknown worker command %r", kind)

    # -- PoW helper ----------------------------------------------------------

    async def _run_crypto(self, fn, *args):
        """Run a host scalar multiplication (sign/encrypt) off the loop."""
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    async def _do_pow(self, payload_sans_nonce: bytes, ttl: int,
                      ntpb: int = 0, extra: int = 0) -> bytes:
        """Solve and prepend the nonce (class_singleWorker._doPOWDefaults)."""
        target = pow_target(len(payload_sans_nonce) + 8, ttl,
                            ntpb or self.min_ntpb, extra or self.min_extra,
                            clamp=False)
        initial = sha512(payload_sans_nonce)
        t0 = time.monotonic()
        with trace("worker.pow", bytes=len(payload_sans_nonce) + 8,
                   histogram=POW_WAIT_SECONDS):
            nonce, trials = await self.pow_service.solve(initial, target)
        dt = max(time.monotonic() - t0, 1e-9)
        logger.debug("PoW done: %d trials in %.2fs (%.0f H/s)",
                     trials, dt, trials / dt)
        return struct.pack(">Q", nonce) + payload_sans_nonce

    def _publish(self, payload: bytes, object_type: int, stream: int,
                 tag: bytes = b"") -> bytes:
        h = inventory_hash(payload)
        expires = int.from_bytes(payload[8:16], "big")
        OBJECTS_PUBLISHED.labels(
            type=_TYPE_NAMES.get(object_type, str(object_type))).inc()
        self.inventory.add(h, object_type, stream, payload, expires, tag)
        if self.pool is not None:
            self.pool.announce_object(h, stream, local=True)
        if self.on_publish is not None:
            self.on_publish(h, object_type, stream, expires, tag, payload)
        return h

    # -- msg sending ---------------------------------------------------------

    async def process_queued_messages(self) -> None:
        msgs = [m for m in self.store.sent_by_status(MSGQUEUED, "forcepow")
                if not self.shutdown.is_set()]
        if not msgs:
            return
        # concurrent sends: each PoW request lands in the PowService
        # coalescing window, so a sweep becomes one batched launch
        results = await asyncio.gather(
            *(self._send_one_msg(m) for m in msgs), return_exceptions=True)
        for m, r in zip(msgs, results):
            if isinstance(r, BaseException) and \
                    not isinstance(r, asyncio.CancelledError):
                logger.error("send failed for %s: %r", m.toaddress, r)

    async def _send_one_msg(self, m) -> None:
        to = decode_address(m.toaddress)
        sender = self.keystore.get(m.fromaddress)
        if sender is None:
            logger.error("own address %s missing from keystore",
                         m.fromaddress)
            self.store.update_sent_status(m.ackdata, "badkey")
            return

        if self.keystore.owns(m.toaddress):
            recipient = self.keystore.get(m.toaddress)
            pub_enc = recipient.pub_encryption_key
            their_ntpb = self.min_ntpb
            their_extra = self.min_extra
            their_bitfield_acks = False  # no ack to self/chan
        else:
            pubkey = await self._lookup_pubkey(to, m.toaddress)
            if pubkey is None:
                await self._request_pubkey(to, m.toaddress, m.ackdata)
                return
            their_ntpb = max(pubkey.nonce_trials_per_byte, self.min_ntpb)
            their_extra = max(pubkey.extra_bytes, self.min_extra)
            # refuse recipients demanding more work than the user is
            # willing to do — 'forcepow' overrides, 0 means unlimited
            # (class_singleWorker.py:1060-1091)
            if m.status != "forcepow" and (
                    (self.max_acceptable_ntpb
                     and their_ntpb > self.max_acceptable_ntpb)
                    or (self.max_acceptable_extra
                        and their_extra > self.max_acceptable_extra)):
                self.store.update_sent_status(m.ackdata, "toodifficult")
                self.ui_signal("updateSentItemStatusByAckdata",
                               (m.ackdata, "toodifficult"))
                return
            pub_enc = pubkey.pub_encryption_key
            their_bitfield_acks = bitfield_does_ack(pubkey.bitfield)

        self.store.update_sent_status(m.ackdata, DOINGMSGPOW)
        ttl = _jitter_ttl(m.ttl or 4 * 24 * 3600)
        expires = int(time.time()) + ttl

        # optional pre-PoW'd ack packet embedded in the plaintext
        ack_packet = b""
        if not self.keystore.owns(m.toaddress) and their_bitfield_acks:
            ack_packet = await self._make_full_ack(m.ackdata, to.stream, ttl)

        body = msgcoding.encode_message(m.subject, m.message,
                                        m.encodingtype or 2)
        plain = MsgPlaintext(
            sender_version=sender.version, sender_stream=sender.stream,
            bitfield=get_bitfield(True),
            pub_signing_key=sender.pub_signing_key,
            pub_encryption_key=sender.pub_encryption_key,
            nonce_trials_per_byte=sender.nonce_trials_per_byte,
            extra_bytes=sender.extra_bytes,
            dest_ripe=to.ripe, encoding=m.encodingtype or 2,
            message=body, ack_data=ack_packet)
        unsigned = plain.encode_unsigned()
        # msg object shell: expires + type(2) + msgver(1) + stream; the
        # signature covers shell-sans-nonce + plaintext through ackdata
        # (class_singleWorker.py:1224-1228)
        shell = object_shell(expires, OBJECT_MSG, 1, to.stream)
        plain.signature = await self._run_crypto(
            sign, shell + unsigned, sender.priv_signing)

        encrypted = await self._run_crypto(
            encrypt, plain.encode(), pub_enc)
        payload = shell + encrypted
        payload = await self._do_pow(payload, ttl, their_ntpb, their_extra)
        h = self._publish(payload, OBJECT_MSG, to.stream)
        logger.debug("msg sent, inventory hash %s", h.hex())

        if self.keystore.owns(m.toaddress):
            # loopback: deliver straight to our inbox
            # (class_singleWorker.py:1350-1373)
            self.store.deliver_inbox(
                msgid=h, toaddress=m.toaddress, fromaddress=m.fromaddress,
                subject=m.subject, message=m.message,
                encoding=m.encodingtype or 2,
                sighash=sha512(plain.signature))
            self.store.update_sent_status(m.ackdata, ACKRECEIVED)
            self.ui_signal("displayNewInboxMessage",
                           (h, m.toaddress, m.fromaddress, m.subject,
                            m.message))
        elif ack_packet:
            self.watched_acks.add(m.ackdata)
            self.store.update_sent_status(
                m.ackdata, MSGSENT,
                sleeptill=int(time.time() + 1.1 * ttl))
        else:
            self.store.update_sent_status(m.ackdata, MSGSENTNOACKEXPECTED)

    async def _make_full_ack(self, ackdata: bytes, stream: int,
                             ttl: int) -> bytes:
        """Pre-PoW'd ack the recipient floods back verbatim
        (generateFullAckMessage, class_singleWorker.py:1495-1519)."""
        ack_ttl = _jitter_ttl(ack_ttl_bucket(ttl))
        expires = int(time.time()) + ack_ttl
        payload = struct.pack(">Q", expires) + ackdata
        payload = await self._do_pow(payload, ack_ttl)
        return pack_packet("object", payload)

    # -- pubkey lookup / request ---------------------------------------------

    async def _lookup_pubkey(self, to, toaddress: str) -> PubkeyData | None:
        raw = self.store.get_pubkey(toaddress)
        if raw is not None:
            return parse_pubkey_inner(raw, to.version, to.stream)
        if to.version >= 4:
            # tagged pubkey objects in the inventory that we can decrypt
            # (protocol.py:401-529 decryptAndCheckPubkeyPayload)
            tag = double_hash_of_address_data(
                to.version, to.stream, to.ripe)[32:]
            for item in self.inventory.by_type_and_tag(OBJECT_PUBKEY, tag):
                data = await self.decrypt_pubkey_object(item.payload, to)
                if data is not None:
                    self.store.store_pubkey(
                        toaddress, to.version, pubkey_inner_bytes(data),
                        used_personally=True)
                    return data
        return None

    async def decrypt_pubkey_object(self, payload: bytes,
                                    to) -> PubkeyData | None:
        """Decrypt and check a v4 pubkey object for address ``to``: one
        trial decrypt against the address-derived key and one signature
        check, both through the crypto pool; None when anything fails."""
        try:
            hdr = ObjectHeader.parse(payload)
        except ValueError:
            return None
        if hdr.version != to.version:
            return None
        dh = double_hash_of_address_data(to.version, to.stream, to.ripe)
        blob = payload[hdr.header_length + 32:]
        matches = await self.crypto.try_decrypt_many(blob, [(dh[:32], to)])
        if not matches:
            return None
        inner = matches[0][0]
        try:
            data = parse_pubkey_inner(inner, to.version, to.stream)
            # the signature covers payload-through-tag + inner-through-
            # the difficulty varints
            i = 4 + 64 + 64
            _, n = decode_varint(inner, i)
            i += n
            _, n = decode_varint(inner, i)
            i += n
        except (PayloadError, ValueError):
            return None
        signed = payload[8:hdr.header_length + 32] + inner[:i]
        if not await self.crypto.verify(signed, data.signature,
                                        data.pub_signing_key):
            return None
        if address_ripe(data.pub_signing_key,
                        data.pub_encryption_key) != to.ripe:
            return None
        return data

    async def _request_pubkey(self, to, toaddress: str,
                              ackdata: bytes) -> None:
        tag = double_hash_of_address_data(to.version, to.stream, to.ripe)[32:]
        if tag in self.needed_pubkeys:
            # already requested: park until the normal retry horizon
            self.store.update_sent_status(
                ackdata, AWAITINGPUBKEY,
                sleeptill=int(time.time() + GETPUBKEY_RETRY))
            return
        self.needed_pubkeys[tag] = toaddress
        ttl = _jitter_ttl(int(GETPUBKEY_RETRY / 2.5))
        expires = int(time.time()) + ttl
        payload = assemble_getpubkey(expires, to.version, to.stream, to.ripe)
        # visible while the getpubkey PoW runs; a crash here is
        # re-queued by reset_interrupted_pow at next startup
        self.store.update_sent_status(ackdata, DOINGPUBKEYPOW)
        payload = await self._do_pow(payload, ttl)
        self._publish(payload, OBJECT_GETPUBKEY, to.stream)
        self.store.update_sent_status(
            ackdata, AWAITINGPUBKEY,
            sleeptill=int(time.time() + GETPUBKEY_RETRY))
        logger.debug("requested pubkey for %s", toaddress)

    # -- own pubkey publication ----------------------------------------------

    async def send_my_pubkey(self, address: str) -> None:
        ident = self.keystore.get(address)
        if ident is None:
            return
        ttl = _jitter_ttl(28 * 24 * 3600)
        expires = int(time.time()) + ttl
        data = PubkeyData(
            ident.version, ident.stream, get_bitfield(True),
            ident.pub_signing_key, ident.pub_encryption_key,
            ident.nonce_trials_per_byte, ident.extra_bytes)
        payload = await self._run_crypto(
            lambda: assemble_pubkey(
                expires, data, ident.ripe,
                sign_fn=lambda d: sign(d, ident.priv_signing)))
        payload = await self._do_pow(payload, ttl)
        tag = ident.tag if ident.version >= 4 else b""
        self._publish(payload, OBJECT_PUBKEY, ident.stream, tag)
        self.keystore.touch_pubkey_sent(address)
        logger.debug("published pubkey for %s", address)

    def queue_broadcast(self, fromaddress: str, subject: str,
                        message: str, *, ttl: int = 4 * 24 * 3600,
                        encoding: int = 2, stream: int = 1,
                        toaddress: str = "[Broadcast]") -> bytes:
        """Enqueue a broadcast row (status 'broadcastqueued', as
        helper_sent.insert does) and nudge the worker."""
        ack = gen_ack_payload(stream, 0)
        self.store.queue_sent(
            msgid=os.urandom(16), toaddress=toaddress, toripe=b"",
            fromaddress=fromaddress, subject=subject, message=message,
            ackdata=ack, ttl=ttl, encoding=encoding,
            status="broadcastqueued")
        self.queue.put_nowait(("sendbroadcast",))
        return ack

    # -- onionpeer announcement ----------------------------------------------

    async def send_onion_peer(self, peer: tuple[str, int] | None = None,
                              stream: int = 1) -> None:
        """Flood an ONIONPEER object naming an onion endpoint, ours by
        default (reference sendOnionPeerObj,
        class_singleWorker.py:494-530).  Body: varint port + 16-byte
        encoded host; dedup by tag so an unexpired copy isn't redone."""
        peer = peer or self.onion_peer
        if not peer:
            return
        host, port = peer
        try:
            body = encode_varint(port) + encode_host(host)
        except Exception:
            # expected for v3 onions (56 chars > the 16-byte addr
            # field): the service still serves inbound Tor dials, it
            # just can't be flooded
            logger.debug("onion endpoint %r not wire-encodable; "
                         "skipping ONIONPEER announcement", host)
            return
        tag = inventory_hash(body)
        if any(item.expires > time.time() for item in
               self.inventory.by_type_and_tag(OBJECT_ONIONPEER, tag)):
            return          # an unexpired announcement is circulating
        ttl = _jitter_ttl(7 * 24 * 3600)
        expires = int(time.time()) + ttl
        # object version 2 for v2 onions (22-char hostname), else 3
        # (the reference's wire choice)
        version = 2 if len(host) == 22 else 3
        payload = object_shell(expires, OBJECT_ONIONPEER, version,
                               stream) + body
        payload = await self._do_pow(payload, ttl)
        self._publish(payload, OBJECT_ONIONPEER, stream, tag)
        logger.info("published onionpeer object for %s:%d", host, port)

    # -- broadcast sending ---------------------------------------------------

    async def process_queued_broadcasts(self) -> None:
        msgs = [m for m in self.store.sent_by_status("broadcastqueued")
                if not self.shutdown.is_set()]
        if not msgs:
            return
        results = await asyncio.gather(
            *(self._send_one_broadcast(m) for m in msgs),
            return_exceptions=True)
        for m, r in zip(msgs, results):
            if isinstance(r, BaseException) and \
                    not isinstance(r, asyncio.CancelledError):
                logger.error("broadcast failed for %s: %r", m.fromaddress, r)

    async def _send_one_broadcast(self, m) -> None:
        sender = self.keystore.get(m.fromaddress)
        if sender is None:
            self.store.update_sent_status(m.ackdata, "badkey")
            return
        ttl = _jitter_ttl(min(max(m.ttl or 4 * 24 * 3600, 3600),
                              28 * 24 * 3600))
        expires = int(time.time()) + ttl
        obj_version = 4 if sender.version <= 3 else 5
        shell = (struct.pack(">Q", expires)
                 + struct.pack(">I", OBJECT_BROADCAST)
                 + encode_varint(obj_version)
                 + encode_varint(sender.stream))
        dh = double_hash_of_address_data(
            sender.version, sender.stream, sender.ripe)
        tag = b""
        if sender.version >= 4:
            tag = dh[32:]
            shell += tag

        body = msgcoding.encode_message(m.subject, m.message,
                                        m.encodingtype or 2)
        plain = BroadcastPlaintext(
            sender.version, sender.stream, get_bitfield(True),
            sender.pub_signing_key, sender.pub_encryption_key,
            sender.nonce_trials_per_byte, sender.extra_bytes,
            m.encodingtype or 2, body)
        unsigned = plain.encode_unsigned()
        plain.signature = await self._run_crypto(
            sign, broadcast_signed_data(shell, unsigned),
            sender.priv_signing)
        if sender.version <= 3:
            key = broadcast_v4_key(sender.version, sender.stream, sender.ripe)
        else:
            key = dh[:32]
        payload = shell + await self._run_crypto(
            lambda: encrypt(plain.encode(), priv_to_pub(key)))
        payload = await self._do_pow(payload, ttl)
        h = self._publish(payload, OBJECT_BROADCAST, sender.stream, tag)
        self.store.update_sent_status(m.ackdata, BROADCASTSENT)
        logger.debug("broadcast sent, hash %s", h.hex())

    # -- resend (cleaner hook) ----------------------------------------------

    async def resend_stale(self) -> None:
        """Re-queue messages whose sleeptill passed, doubling TTL
        (class_singleCleaner.py:92-106, singleWorker.py:900-904)."""
        for m in self.store.due_for_resend():
            new_ttl = min(m.ttl * 2, 28 * 24 * 3600)
            self.store.bump_retry(m.ackdata, new_ttl, 0)
            if m.status == AWAITINGPUBKEY:
                try:
                    to = decode_address(m.toaddress)
                except ValueError:
                    logger.warning("resend row has undecodable "
                                   "address %r", m.toaddress)
                    continue
                tag = double_hash_of_address_data(
                    to.version, to.stream, to.ripe)[32:]
                self.needed_pubkeys.pop(tag, None)
            else:
                self.watched_acks.discard(m.ackdata)
            self.store.update_sent_status(m.ackdata, MSGQUEUED)
            await self.queue.put(("sendmessage",))


def pubkey_inner_bytes(data: PubkeyData) -> bytes:
    """Serialize the pubkey body the way the pubkeys table stores it."""
    out = data.bitfield + data.pub_signing_key[1:] + \
        data.pub_encryption_key[1:]
    if data.address_version >= 3:
        out += encode_varint(data.nonce_trials_per_byte)
        out += encode_varint(data.extra_bytes)
        out += encode_varint(len(data.signature)) + data.signature
    return out
