"""Incoming-object processor: ack matching, pubkey/msg/broadcast/onionpeer
pipelines (copy of ``pybitmessage_tpu.workers.processor``).

Reference: class_objectProcessor.py — checkackdata (129-154),
processonion (156-174), processgetpubkey (176-268), processpubkey
(270-433), processmsg (435-747) with randomized key order,
anti-surreptitious-forwarding and the mailing-list rebroadcast
(688-721), processbroadcast (749-973).  Mail an email-gateway identity
receives from its operator's relay is rewritten to its real sender and
subject at delivery, and a registration denial raises
``emailGatewayRegistrationDenied`` (bitmessageqt/account.py:316-345).

``concurrency`` worker tasks pull from the queue in parallel; every
trial decrypt and signature check goes through the
:class:`~.cryptopool.CryptoPool`, whose batch engine coalesces them
into drains, one kernel launch each on the card (a pool without an
engine runs them on host threads); the store stage buffers rows into a
write-behind drain.  The queue survives stop and start: what is left
unprocessed, in flight included, is persisted and replayed.

Each object runs in a ``processor.object`` span (``worker_process_seconds``),
its stages feed ``ingest_stage_seconds`` and its lifecycle timeline
gains ``parsed``, ``decrypted``, ``verified`` and ``delivered``.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time

from ..crypto.screen import NegativeScreen
from ..gateways.email_account import (
    ALL_OK, REGISTRATION_DENIED, EmailGatewayAccount, spec_for_identity,
)
from ..models import msgcoding
from ..models.constants import (
    DEFAULT_EXTRA_BYTES, DEFAULT_NONCE_TRIALS_PER_BYTE, OBJECT_BROADCAST,
    OBJECT_GETPUBKEY, OBJECT_MSG, OBJECT_ONIONPEER, OBJECT_PUBKEY,
)
from ..models.objects import ObjectHeader
from ..models.payloads import (
    BroadcastPlaintext, MsgPlaintext, PayloadError,
    bitfield_does_ack, broadcast_signed_data, msg_signed_data,
    parse_pubkey_inner,
)
from ..models.pow_math import check_pow, pow_target, pow_value
from ..network.messages import decode_host, is_private_host
from ..observability import REGISTRY, trace
from ..observability.lifecycle import LIFECYCLE
from ..resilience.policy import ERRORS
from ..storage.knownnodes import Peer
from ..storage.messages import ACKRECEIVED, MessageStore
from ..storage.writebehind import WriteBehindStore
from ..utils.addresses import decode_address, encode_address
from ..utils.hashes import address_ripe, inventory_hash, sha512
from ..utils.queues import ByteBoundedQueue
from ..utils.varint import decode_varint
from .cryptopool import CryptoPool
from .keystore import KeyStore
from .sender import SendWorker, pubkey_inner_bytes

logger = logging.getLogger("pybitmessage_tpu_torch.processor")

#: don't resend our pubkey more often than this (objectProcessor.py:176-268)
PUBKEY_RESEND_INTERVAL = 28 * 24 * 3600

#: concurrent objects in flight through the processor (the
#: ``ingestworkers`` setting)
DEFAULT_CONCURRENCY = 8
#: write-behind drain cadence, seconds
FLUSH_INTERVAL = 0.05

OBJECTS_PROCESSED = REGISTRY.counter(
    "worker_objects_processed_total",
    "Objects through the processor pipeline by type", ("type",))
PROCESS_SECONDS = REGISTRY.histogram(
    "worker_process_seconds",
    "Per-object processing latency (decrypt, verify, store)")
STAGE_SECONDS = REGISTRY.histogram(
    "ingest_stage_seconds",
    "Per-stage ingest latency (parse, decrypt, sig_verify, store, "
    "flush)", ("stage",))


class _Stage:
    """Times one ingest stage into ``ingest_stage_seconds`` (a full
    tracer span per stage would pay label and ring costs four times an
    object)."""

    __slots__ = ("_child", "_t0")

    def __init__(self, stage: str):
        self._child = STAGE_SECONDS.labels(stage=stage)

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.monotonic() - self._t0)
        return False


class ObjectProcessor:
    """Consumes validated objects from the network object queue.

    ``crypto`` is the decrypt/sig-verify route: a :class:`CryptoPool`
    with the batch engine attached, or without one (host threads).  The
    processor puts a negative screen in front of its trial decryption
    and buffers its store stage (write-behind).
    """

    def __init__(self, *, keystore: KeyStore, store: MessageStore,
                 inventory, sender: SendWorker, crypto: CryptoPool,
                 pool=None, shutdown: asyncio.Event | None = None,
                 min_ntpb: int = DEFAULT_NONCE_TRIALS_PER_BYTE,
                 min_extra: int = DEFAULT_EXTRA_BYTES,
                 ui_signal=None, knownnodes=None):
        self.keystore = keystore
        #: where onionpeer objects' peers are recorded (None: ignored)
        self.knownnodes = knownnodes
        #: ``ui_signal(command, data)``: the node's UI event bus
        self.ui_signal = ui_signal or (lambda cmd, data=(): None)
        #: worker tasks start() spawns; the daemon sets it from
        #: ``ingestworkers`` before the node starts
        self.concurrency = DEFAULT_CONCURRENCY
        self.crypto = crypto
        # the screen's proofs are void once the keyring changes
        crypto.screen = NegativeScreen()
        keystore.add_change_listener(crypto.screen.bump)
        if crypto.batch is not None:
            crypto.batch.screen = crypto.screen
        #: write-behind: ingest-path rows coalesce into one transaction
        #: per drain (storage/writebehind.py)
        self._wb = WriteBehindStore(store)
        self.store = self._wb
        self.inventory = inventory
        self.sender = sender
        self.pool = pool
        self.shutdown = shutdown or asyncio.Event()
        self.min_ntpb = min_ntpb
        self.min_extra = min_extra
        #: black/whitelist policy: 'black' (default) drops enabled
        #: blacklist rows, 'white' accepts only enabled whitelist rows
        self.list_mode = "black"
        # 32 MB backpressure on unprocessed payload bytes (reference
        # queues.py:14-38) — floods stall readers, not memory
        self.queue: asyncio.Queue = ByteBoundedQueue()
        self._tasks: list[asyncio.Task] = []
        self._running = False
        #: objects currently inside :meth:`process`
        self.active = 0
        #: payload each worker task is processing — stop() persists
        #: these with the queue (replay is idempotent: sighash dedup,
        #: pubkey REPLACE, ack updates)
        self._inflight: dict[asyncio.Task, bytes] = {}
        self.messages_processed = 0
        self.broadcasts_processed = 0
        self.pubkeys_processed = 0

    def start(self) -> None:
        # replay objects persisted at last shutdown (reference
        # class_objectProcessor.py:47-60)
        restored = self.store.pop_objectprocessor_queue()
        for payload in restored:
            self.queue.put_nowait(payload)
        if restored:
            logger.info("restored %d unprocessed objects", len(restored))
        self._running = True
        if self.crypto.batch is not None and not self.crypto.batch.running:
            self.crypto.batch.start()
        self._tasks = [asyncio.create_task(self._run())
                       for _ in range(self.concurrency)]
        self._tasks.append(asyncio.create_task(self._flush_loop()))

    async def stop(self) -> None:
        self._running = False
        # snapshot in-flight payloads BEFORE cancelling: each worker's
        # finally pops its entry as the cancellation unwinds
        leftover = list(self._inflight.values())
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        self._inflight.clear()
        while True:
            try:
                leftover.append(self.queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        if leftover:
            self.store.persist_objectprocessor_queue(leftover)
            logger.info("persisted %d unprocessed objects", len(leftover))
        # rows accepted before shutdown land even when no flush tick
        # got to them
        if self._wb.pending_rows():
            self._wb.flush()
        if self.crypto.batch is not None:
            await self.crypto.batch.stop()
        self.crypto.close()

    def pending(self) -> int:
        """Objects queued or in flight."""
        return self.queue.qsize() + self.active

    async def _flush_loop(self) -> None:
        """Write-behind drain cadence: one transaction per interval
        when rows are buffered."""
        while not self.shutdown.is_set():
            await asyncio.sleep(FLUSH_INTERVAL)
            if self._wb.pending_rows():
                await self._flush_store()

    async def _flush_store(self) -> None:
        with _Stage("flush"):
            await self.crypto.run(self._wb.flush)

    async def _run(self) -> None:
        while not self.shutdown.is_set():
            payload = await self.queue.get()
            self.active += 1
            self._inflight[asyncio.current_task()] = payload
            try:
                await self.process(payload)
            except asyncio.CancelledError:
                raise
            except Exception:
                ERRORS.labels(site="ingest.process").inc()
                logger.exception("object processing failed")
            finally:
                self.active -= 1
                self._inflight.pop(asyncio.current_task(), None)

    async def process(self, payload: bytes) -> None:
        try:
            with _Stage("parse"):
                header = ObjectHeader.parse(payload)
        except ValueError:
            OBJECTS_PROCESSED.labels(type="unparseable").inc()
            return
        # one inventory hash per object: it keys the lifecycle timeline
        # and the delivery paths
        h = inventory_hash(payload)
        LIFECYCLE.record(h, "parsed")
        kind = "other"
        try:
            with trace("processor.object",
                       histogram=PROCESS_SECONDS) as span:
                if header.object_type == OBJECT_GETPUBKEY:
                    kind = "getpubkey"
                    await self._process_getpubkey(header, payload)
                elif header.object_type == OBJECT_PUBKEY:
                    kind = "pubkey"
                    await self._process_pubkey(header, payload)
                elif header.object_type == OBJECT_MSG:
                    kind = "msg"
                    await self._process_msg(header, payload, h)
                elif header.object_type == OBJECT_BROADCAST:
                    kind = "broadcast"
                    await self._process_broadcast(header, payload, h)
                elif header.object_type == OBJECT_ONIONPEER:
                    kind = "onionpeer"
                    self._process_onionpeer(header, payload)
                span.attrs["type"] = kind
        finally:
            # failed objects count too: a raising handler must not
            # leave worker_process_seconds ahead of the counter
            OBJECTS_PROCESSED.labels(type=kind).inc()
            if self._wb.should_flush() or not self._running:
                # a storm must not grow the buffer unbounded between
                # ticks; direct (un-started) calls stay write-through
                await self._flush_store()

    # -- onionpeer -----------------------------------------------------------

    def _process_onionpeer(self, header: ObjectHeader,
                           payload: bytes) -> None:
        """Type 0x746f72 ("tor"): varint port + 16-byte host — record
        the peer in knownnodes (class_objectProcessor.py:156-174
        processonion)."""
        if self.knownnodes is None:
            return
        body = payload[header.header_length:]
        try:
            port, n = decode_varint(body, 0)
            host = decode_host(body[n:n + 16])
        except Exception:
            logger.debug("undecodable onionpeer object")
            return
        if not (1 <= port <= 65535):
            return
        # accept onions always; public IPs only (the reference routes
        # the host through checkIPAddress, which drops private ranges)
        if not host.endswith(".onion") and is_private_host(host):
            return
        peer = Peer(host, port)
        own = getattr(self.sender, "onion_peer", None)
        is_self = own is not None \
            and (own[0].lower(), own[1]) == (host, port)
        if self.knownnodes.add(peer, header.stream, is_self=is_self):
            logger.info("onionpeer recorded: %s:%d (stream %d)",
                        host, port, header.stream)

    # -- acks ----------------------------------------------------------------

    def _check_ackdata(self, payload: bytes) -> bool:
        """Match objects against our ack watchlist: bytes from offset 16
        (type+version+stream+body) equal a watched ackdata
        (objectProcessor.py:129-154)."""
        if len(payload) < 32:
            return False
        ack = payload[16:]
        if ack in self.sender.watched_acks:
            self.sender.watched_acks.discard(ack)
            self.store.update_sent_status(ack, ACKRECEIVED)
            self.ui_signal("updateSentItemStatusByAckdata",
                           (ack, ACKRECEIVED))
            logger.debug("ack received for one of our messages")
            return True
        return False

    # -- getpubkey -----------------------------------------------------------

    async def _process_getpubkey(self, header: ObjectHeader,
                                 payload: bytes) -> None:
        i = header.header_length
        ident = None
        if header.version <= 3:
            ident = self.keystore.by_ripe.get(payload[i:i + 20])
        elif header.version == 4:
            ident = self.keystore.by_tag.get(payload[i:i + 32])
        if ident is None or ident.chan or header.version != ident.version:
            return
        if time.time() - ident.last_pubkey_send_time < \
                PUBKEY_RESEND_INTERVAL:
            logger.debug("pubkey for %s sent recently; not resending",
                         ident.address)
            return
        logger.debug("peer requested our pubkey for %s", ident.address)
        await self.sender.queue.put(("sendpubkey", ident.address))

    # -- pubkey --------------------------------------------------------------

    async def _process_pubkey(self, header: ObjectHeader,
                              payload: bytes) -> None:
        self.pubkeys_processed += 1
        i = header.header_length
        if header.version in (2, 3):
            data = parse_pubkey_inner(payload[i:], header.version,
                                      header.stream)
            if header.version == 3:
                # sig covers payload[8:] through the difficulty varints
                # (objectProcessor.py:362-371)
                end = _difficulty_end(payload, i + 4 + 128)
                with _Stage("sig_verify"):
                    ok = await self.crypto.verify(
                        payload[8:end], data.signature,
                        data.pub_signing_key)
                if not ok:
                    logger.debug("v3 pubkey bad signature")
                    return
            ripe = address_ripe(data.pub_signing_key,
                                data.pub_encryption_key)
            address = encode_address(header.version, header.stream, ripe)
            await self._store_pubkey(address, header.version, payload[i:])
        elif header.version == 4:
            tag = payload[i:i + 32]
            # can only decrypt if we're awaiting this tag
            toaddress = self.sender.needed_pubkeys.get(tag)
            if toaddress is None:
                return
            with _Stage("decrypt"):
                data = await self.sender.decrypt_pubkey_object(
                    payload, decode_address(toaddress))
            if data is None:
                logger.debug("v4 pubkey failed decrypt/verify")
                return
            await self._store_pubkey(toaddress, 4, pubkey_inner_bytes(data),
                                     used_personally=True)
            self.sender.needed_pubkeys.pop(tag, None)

    async def _store_pubkey(self, address: str, version: int, inner: bytes,
                            used_personally: bool = False) -> None:
        with _Stage("store"):
            self.store.store_pubkey(address, version, inner,
                                    used_personally)
        logger.debug("stored pubkey for %s", address)
        # the send pipeline reads through the UNBUFFERED store: drain
        # now so the key (and the status flips below) are visible
        # before the sender wakes
        await self._flush_store()
        # unblock any sends waiting on it (possibleNewPubkey analog)
        waiting = await self.crypto.run(
            self.store.sent_by_status, "awaitingpubkey")
        if any(m.toaddress == address for m in waiting):
            for m in waiting:
                if m.toaddress == address:
                    self.store.update_sent_status(m.ackdata, "msgqueued")
            await self._flush_store()
            self.sender.queue.put_nowait(("sendmessage",))

    # -- msg -----------------------------------------------------------------

    async def _process_msg(self, header: ObjectHeader,
                           payload: bytes, h: bytes) -> None:
        self.messages_processed += 1
        if self._check_ackdata(payload):
            return
        encrypted = payload[header.header_length:]

        # trial-decrypt against all our keys in RANDOMIZED order
        # (objectProcessor.py:459-477).  Candidates stay lazy: a
        # screened re-arrival must not pay the list build + shuffle
        def _candidates():
            idents = list(self.keystore.identities.values())
            random.shuffle(idents)
            for ident in idents:
                yield ident.priv_encryption, ident

        with _Stage("decrypt"):
            matches = await self.crypto.try_decrypt_many(
                encrypted, _candidates(), tag=h)
        if not matches:
            return
        decrypted, match = matches[0]
        LIFECYCLE.record(h, "decrypted")
        try:
            plain = MsgPlaintext.decode(decrypted)
        except PayloadError as exc:
            logger.debug("undecodable msg bound for us: %s", exc)
            return
        # anti-surreptitious-forwarding: embedded ripe must be OURS
        # (objectProcessor.py:531-540)
        if plain.dest_ripe != match.ripe:
            logger.warning("surreptitious forwarding attempt blocked")
            return
        signed = msg_signed_data(payload, header.version, header.stream,
                                 decrypted[:plain.signed_span])
        with _Stage("sig_verify"):
            ok = await self.crypto.verify(signed, plain.signature,
                                          plain.pub_signing_key)
        if not ok:
            logger.debug("msg signature invalid")
            return
        LIFECYCLE.record(h, "verified")
        # demanded-difficulty recheck (objectProcessor.py:615-629)
        if not match.chan:
            req_ntpb = max(match.nonce_trials_per_byte, self.min_ntpb)
            req_extra = max(match.extra_bytes, self.min_extra)
            ttl = max(header.expires - int(time.time()), 300)
            demanded = pow_target(len(payload), ttl, req_ntpb, req_extra,
                                  clamp=False)
            if await self.crypto.run(pow_value, payload) > demanded:
                logger.info("msg PoW below our demanded difficulty")
                return

        from_address = encode_address(
            plain.sender_version, plain.sender_stream,
            address_ripe(plain.pub_signing_key, plain.pub_encryption_key))
        # black/whitelist policy, before any inbox insert (chans too)
        allowed = await self.crypto.run(
            self.store.sender_allowed, from_address, self.list_mode)
        if not allowed:
            logger.info("message from %s dropped by %slist policy",
                        from_address, self.list_mode)
            return
        body = msgcoding.decode_message(plain.message, plain.encoding)
        subject = body.subject
        display_from = from_address
        # email-gateway accounts: mail arriving via the operator's
        # relay is rewritten to its real sender/subject, and a denial
        # from the registration address is surfaced to every frontend
        # (the reference rewrites at display time, account.py:316-345;
        # doing it at delivery covers API consumers too)
        gw_spec = spec_for_identity(match)
        feedback = ALL_OK
        if gw_spec is not None:
            acct = EmailGatewayAccount(match.address, gw_spec)
            display_from, subject, feedback = acct.parse_incoming(
                from_address, subject)
        with _Stage("store"):
            delivered = await self.crypto.run(
                lambda: self.store.deliver_inbox(
                    msgid=h, toaddress=match.address,
                    fromaddress=display_from, subject=subject,
                    message=body.body, encoding=plain.encoding,
                    sighash=sha512(plain.signature)))
        if not delivered:
            logger.debug("duplicate message dropped (sighash)")
            return
        LIFECYCLE.record(h, "delivered")
        # denial surfaced only for the first (non-duplicate) delivery:
        # a gateway retry must not re-notify every frontend
        if feedback == REGISTRATION_DENIED:
            logger.warning("email gateway DENIED registration of %s",
                           match.address)
            self.ui_signal("emailGatewayRegistrationDenied",
                           (match.address, gw_spec.name))
        logger.debug("message delivered: %s -> %s", display_from,
                     match.address)
        self.ui_signal("displayNewInboxMessage",
                       (h, match.address, display_from, subject,
                        body.body))
        # mailing-list identities re-send what they receive as a
        # broadcast to their subscribers (objectProcessor.py:688-721)
        if match.mailinglist and plain.encoding != 0:
            self._rebroadcast_to_list(match, from_address,
                                      body.subject, body.body)
        # flood the sender's pre-made ack (objectProcessor.py:723-731);
        # never for chans
        if not match.chan and plain.ack_data \
                and bitfield_does_ack(plain.bitfield):
            await self._emit_ack(plain.ack_data)

    @staticmethod
    def _mailing_list_subject(subject: str, name: str) -> str:
        """'[listname] subject', stripping a leading Re: and avoiding a
        duplicate prefix (objectProcessor addMailingListNameToSubject)."""
        subject = subject.strip()
        if subject[:3].lower() == "re:":
            subject = subject[3:].strip()
        if "[" + name + "]" in subject:
            return subject
        return "[" + name + "] " + subject

    def _rebroadcast_to_list(self, ident, from_address: str,
                             subject: str, body: str) -> None:
        """Queue the received message as a broadcast FROM the list
        identity, prefixed with the list name and stamped with the
        ostensible sender (objectProcessor.py:688-721)."""
        subject = self._mailing_list_subject(
            subject, ident.mailinglistname or ident.label)
        message = (time.strftime("%a, %Y-%m-%d %H:%M:%S UTC", time.gmtime())
                   + "   Message ostensibly from " + from_address
                   + ":\n\n" + body)
        ack = self.sender.queue_broadcast(
            ident.address, subject, message, stream=ident.stream,
            toaddress="[Broadcast subscribers]")
        self.ui_signal("displayNewSentMessage",
                       ("[Broadcast subscribers]", "[Broadcast subscribers]",
                        ident.address, subject, message, ack))
        logger.info("mailing list %s rebroadcasting message from %s",
                    ident.address, from_address)

    async def _emit_ack(self, ack_packet: bytes) -> None:
        """The embedded ack is a full wire packet; strip the 24-byte
        header and flood the object (bmproto.py:684-710)."""
        if len(ack_packet) < 24 + 22:
            return
        obj = ack_packet[24:]
        try:
            hdr = ObjectHeader.parse(obj)
            hdr.check_expiry()
        except ValueError:
            return
        if not check_pow(obj, self.min_ntpb, self.min_extra, clamp=False):
            return
        h = inventory_hash(obj)
        if h in self.inventory:
            return
        self.inventory.add(h, hdr.object_type, hdr.stream, obj, hdr.expires)
        if self.pool is not None:
            self.pool.announce_object(h, hdr.stream, local=False)
        logger.debug("flooded sender's ack object")

    # -- broadcast -----------------------------------------------------------

    async def _process_broadcast(self, header: ObjectHeader,
                                 payload: bytes, h: bytes) -> None:
        self.broadcasts_processed += 1
        i = header.header_length
        if header.version == 5:
            tag = payload[i:i + 32]
            i += 32
            subs = [s for s in self.keystore.active_subscriptions()
                    if s.tag == tag]
        elif header.version == 4:
            subs = [s for s in self.keystore.active_subscriptions()
                    if s.version <= 3]
        else:
            return
        with _Stage("decrypt"):
            matches = await self.crypto.try_decrypt_many(
                payload[i:], [(s.broadcast_key, s) for s in subs], tag=h)
        if matches:
            LIFECYCLE.record(h, "decrypted")
        for decrypted, sub in matches:
            try:
                plain = BroadcastPlaintext.decode(decrypted)
            except PayloadError:
                continue
            if address_ripe(plain.pub_signing_key,
                            plain.pub_encryption_key) != sub.ripe:
                logger.warning("broadcast key/ripe mismatch")
                continue
            signed = broadcast_signed_data(
                payload[8:header.header_length
                        + (32 if header.version == 5 else 0)],
                decrypted[:plain.signed_span])
            with _Stage("sig_verify"):
                ok = await self.crypto.verify(signed, plain.signature,
                                              plain.pub_signing_key)
            if not ok:
                logger.debug("broadcast signature invalid")
                continue
            LIFECYCLE.record(h, "verified")
            body = msgcoding.decode_message(plain.message, plain.encoding)
            with _Stage("store"):
                delivered = await self.crypto.run(
                    lambda: self.store.deliver_inbox(
                        msgid=h, toaddress="[Broadcast]",
                        fromaddress=sub.address, subject=body.subject,
                        message=body.body, encoding=plain.encoding,
                        sighash=sha512(plain.signature)))
            if delivered:
                LIFECYCLE.record(h, "delivered")
            logger.debug("broadcast delivered from %s", sub.address)
            self.ui_signal("displayNewInboxMessage",
                           (h, "[Broadcast]", sub.address, body.subject,
                            body.body))
            return


def _difficulty_end(payload: bytes, offset: int) -> int:
    """End offset of the two difficulty varints of a v3 pubkey."""
    _, n = decode_varint(payload, offset)
    _, m = decode_varint(payload, offset + n)
    return offset + n + m
