"""The edge role: sockets, framing and the PoW check, hand-off to relays
(copy of ``pybitmessage_tpu.roles.edge``, without the light-client
plane).

An edge process owns listener sockets (``SO_REUSEPORT``-shared with its
sibling edges), the framing path, the PoW check of every received
object through the node's ``BatchVerifier`` on the card and a bounded
dedupe/serve cache (:class:`EdgeCache`), and forwards every accepted
object over the role IPC channel to the relay owning the object's
stream.  Identity keys, decryption and storage authority live on the
relays.

Zero loss across the hand-off: accepted objects enter a RAM outbox and
leave only on a frame-level ``OBJECTS_ACK``; a failed or chaos-injected
send (the ``role.ipc`` site), a relay crash or a reconnect re-queues the
un-acked frames at the front of the outbox, and the relay's hash dedupe
makes redelivery idempotent.  The outbox high watermark back-pressures
the pump, which back-pressures the watermarked object queue, which
pauses connection reads.

Relays declaring the same stream form that stream's replica set
(:mod:`.replica`): every accepted record fans to all members, a PING
prober (the ``role.replica`` site) and an ack-lag watch rank each member
on the health ladder, and a member that goes down has its banked
records shifted to its healthy siblings.  Shard maps are versioned: each
``HELLO_ACK``/``SHARD_UPDATE`` carries the relay's monotonic epoch,
stale maps are ignored, and a map change re-routes any now-misrouted
banked records.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import OrderedDict, deque

from ..observability import REGISTRY
from ..observability.metrics import peer_bucket_label
from ..resilience import CircuitBreaker, inject
from ..resilience.policy import ERRORS
from . import ipc
from .replica import (ACK_LAG_DEGRADED, FAILOVERS, HEALTH_DEGRADED,
                      HEALTH_DOWN, HEALTH_OK, RTT_DEGRADED,
                      build_replica_sets)
from .streams import shard_owner

logger = logging.getLogger("pybitmessage_tpu_torch.roles")

HANDOFFS = REGISTRY.counter(
    "role_edge_handoff_total",
    "Objects handed edge->relay over role IPC, by outcome",
    ("result",))
OUTBOX_DEPTH = REGISTRY.gauge(
    "role_edge_outbox_depth",
    "Objects queued or un-acked on the edge->relay IPC hop")
RECONNECTS = REGISTRY.counter(
    "role_edge_reconnect_total",
    "Edge->relay IPC reconnect attempts")
RESENDS = REGISTRY.counter(
    "role_edge_resend_total",
    "Objects re-queued after a failed/un-acked IPC frame — retried, "
    "never lost")
FETCHES = REGISTRY.counter(
    "role_edge_fetch_total",
    "Relay payload fetches for getdata service, by outcome",
    ("result",))
STALE_MAPS = REGISTRY.counter(
    "role_edge_stale_map_total",
    "HELLO_ACK/SHARD_UPDATE frames ignored for carrying an older "
    "shard-map epoch than the link already holds")

#: outbox high watermark (queued + un-acked objects) pausing the pump
OUTBOX_HIGH = 4096
#: max records coalesced into one OBJECTS frame
BATCH_MAX = 256
#: reconnect backoff bounds, seconds
RECONNECT_MIN = 0.2
RECONNECT_MAX = 5.0
#: replica health prober cadence, seconds (PING RTT + gauge refresh)
PING_INTERVAL = 2.0


class EdgeCache:
    """The edge's inventory shim: a bounded LRU payload cache plus a
    hash-only *known* set (fed by relay INV deltas).

    Satisfies the slice of the inventory contract the network layer
    uses — duplicate detection, getdata service, big-inv — without
    storage authority.  Eviction only sheds payload bytes; hash
    knowledge survives (bounded) so dedupe keeps working.
    """

    def __init__(self, max_bytes: int = 64 << 20,
                 max_known: int = 1 << 20):
        self.max_bytes = max_bytes
        self.max_known = max_known
        self._lock = threading.RLock()
        #: hash -> InventoryItem-shaped record (payload resident)
        self._items: OrderedDict[bytes, "object"] = OrderedDict()
        #: hash -> (stream, expires) — known, payload not resident
        self._known: OrderedDict[bytes, tuple[int, int]] = OrderedDict()
        self._bytes = 0

    def add(self, hash_: bytes, type_: int, stream: int, payload: bytes,
            expires: int, tag: bytes = b"") -> None:
        from ..storage.inventory import InventoryItem
        with self._lock:
            if hash_ in self._items:
                return
            self._known.pop(hash_, None)
            self._items[hash_] = InventoryItem(
                type_, stream, bytes(payload), expires, bytes(tag))
            self._bytes += len(payload)
            while self._bytes > self.max_bytes and len(self._items) > 1:
                h, item = self._items.popitem(last=False)
                self._bytes -= len(item.payload)
                self._note_known(h, item.stream, item.expires)

    def note_known(self, hash_: bytes, stream: int, expires: int) -> None:
        """Fold a relay INV delta entry: the object exists fleet-side."""
        with self._lock:
            if hash_ in self._items:
                return
            self._note_known(hash_, stream, expires)

    def _note_known(self, hash_: bytes, stream: int, expires: int) -> None:
        self._known[hash_] = (stream, expires)
        self._known.move_to_end(hash_)
        while len(self._known) > self.max_known:
            self._known.popitem(last=False)

    def is_known_uncached(self, hash_: bytes) -> bool:
        with self._lock:
            return hash_ in self._known

    def known_stream(self, hash_: bytes) -> int | None:
        with self._lock:
            entry = self._known.get(hash_)
            return entry[0] if entry else None

    # -- inventory contract slice -------------------------------------------

    def __contains__(self, hash_: bytes) -> bool:
        with self._lock:
            return hash_ in self._items or hash_ in self._known

    def __getitem__(self, hash_: bytes):
        with self._lock:
            return self._items[hash_]

    def __len__(self) -> int:
        with self._lock:
            return len(self._items) + len(self._known)

    def unexpired_hashes_by_stream(self, stream: int) -> list[bytes]:
        now = time.time()
        with self._lock:
            out = [h for h, i in self._items.items()
                   if i.stream == stream and i.expires > now]
            out.extend(h for h, (s, e) in self._known.items()
                       if s == stream and e > now)
            return out

    def by_type_and_tag(self, object_type: int, tag: bytes) -> list:
        with self._lock:
            return [i for i in self._items.values()
                    if i.type == object_type and i.tag == tag]

    def flush(self) -> None:
        """RAM-only: nothing to persist."""

    def clean(self, now: float | None = None) -> int:
        now = time.time() if now is None else now
        with self._lock:
            stale = [h for h, i in self._items.items() if i.expires <= now]
            for h in stale:
                self._bytes -= len(self._items.pop(h).payload)
            known_stale = [h for h, (_, e) in self._known.items()
                           if e <= now]
            for h in known_stale:
                del self._known[h]
            return len(stale) + len(known_stale)


class EdgeLink:
    """One persistent IPC connection edge -> relay, with an acked
    outbox, breaker supervision and automatic reconnect."""

    def __init__(self, runtime: "EdgeRuntime", host: str, port: int):
        self.runtime = runtime
        self.host = host
        self.port = port
        self.addr = "%s:%d" % (host, port)
        #: relay identity learned from HELLO_ACK
        self.relay_id = ""
        self.relay_streams: tuple[int, ...] = ()
        #: relay shard-map epoch (HELLO_ACK / SHARD_UPDATE; monotonic
        #: per relay — older maps are ignored as stale)
        self.epoch = 0
        self.connected = False
        #: PING round-trip EWMA, seconds (None until the first PONG)
        self.rtt: float | None = None
        self._ping_sent_at = 0.0
        #: encoded record blobs awaiting a frame slot
        self.outbox: deque[bytes] = deque()
        #: seq -> list of encoded records awaiting OBJECTS_ACK
        self.unacked: "OrderedDict[int, list[bytes]]" = OrderedDict()
        #: seq -> send time, feeding the ack-lag health rung
        self._unacked_at: dict[int, float] = {}
        #: control frames (FETCH/PING) jump the object queue
        self.control: deque[bytes] = deque()
        self.seq = 0
        self.acked_objects = 0
        self.rejected_objects = 0
        self.duplicate_objects = 0
        self.breaker = CircuitBreaker(
            "role.ipc:%s" % self.addr, threshold=3, cooldown=2.0,
            label=peer_bucket_label("role.ipc", self.addr))
        #: reconnect backoff bounds (tests/bench tune these down)
        self.reconnect_min = RECONNECT_MIN
        self.reconnect_max = RECONNECT_MAX
        self._writer: asyncio.StreamWriter | None = None
        self._wakeup = asyncio.Event()
        self._drained = asyncio.Event()
        self._drained.set()
        self._task: asyncio.Task | None = None
        self._stopping = False

    # -- public surface ------------------------------------------------------

    def depth(self) -> int:
        return len(self.outbox) + sum(len(v) for v in self.unacked.values())

    def enqueue(self, record: bytes) -> None:
        self.outbox.append(record)
        self._drained.clear()
        self._wakeup.set()

    def send_control(self, frame: bytes) -> None:
        self.control.append(frame)
        self._wakeup.set()

    # -- health ladder (roles/replica.py) ------------------------------------

    def health(self) -> int:
        """2 ok / 1 degraded / 0 down — breaker state + PING RTT +
        ack lag, worst rung wins."""
        if not self.connected or not self.breaker.available():
            return HEALTH_DOWN
        if self.ack_lag() > ACK_LAG_DEGRADED or \
                (self.rtt is not None and self.rtt > RTT_DEGRADED):
            return HEALTH_DEGRADED
        return HEALTH_OK

    def ack_lag(self) -> float:
        """Age of the oldest un-acked OBJECTS frame, seconds."""
        if not self._unacked_at:
            return 0.0
        return max(0.0,
                   time.monotonic() - min(self._unacked_at.values()))

    def ping(self) -> None:
        """Queue one liveness probe (the prober loop's RTT sample)."""
        self._ping_sent_at = time.monotonic()
        self.send_control(ipc.pack_frame(ipc.MSG_PING, b""))

    def _note_pong(self) -> None:
        if not self._ping_sent_at:
            return
        sample = time.monotonic() - self._ping_sent_at
        self.rtt = sample if self.rtt is None else \
            0.7 * self.rtt + 0.3 * sample

    def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def stop(self, flush_timeout: float = 5.0) -> None:
        """Flush the outbox (bounded), then close."""
        try:
            await asyncio.wait_for(self._drained.wait(), flush_timeout)
        except asyncio.TimeoutError:
            logger.warning("edge link %s: %d objects still un-acked at "
                           "shutdown", self.addr, self.depth())
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self._close_writer()

    # -- connection lifecycle ------------------------------------------------

    async def _run(self) -> None:
        backoff = self.reconnect_min
        while not self._stopping:
            try:
                RECONNECTS.inc()
                reader, writer = await asyncio.open_connection(
                    self.host, self.port)
                self._writer = writer
                await self._handshake(reader, writer)
                self.connected = True
                backoff = self.reconnect_min
                self._requeue_unacked()
                # either loop dying means the link is down: a chaos/
                # send fault in the sender must not leave the receiver
                # waiting forever on a healthy socket
                sender = asyncio.create_task(self._send_loop(writer))
                receiver = asyncio.create_task(self._recv_loop(reader))
                try:
                    await asyncio.wait(
                        {sender, receiver},
                        return_when=asyncio.FIRST_COMPLETED)
                finally:
                    # cancel + retrieve BOTH (also on outer cancel) so
                    # no exception is ever left unretrieved
                    for task in (sender, receiver):
                        task.cancel()
                    results = await asyncio.gather(
                        sender, receiver, return_exceptions=True)
                for res in results:
                    if isinstance(res, BaseException) and not \
                            isinstance(res, asyncio.CancelledError):
                        raise res   # into the handlers below
            except asyncio.CancelledError:
                raise
            except (OSError, ConnectionError, asyncio.IncompleteReadError,
                    ipc.IPCError) as exc:
                ERRORS.labels(site="role.ipc").inc()
                logger.debug("edge link %s down: %r", self.addr, exc)
            except Exception:
                ERRORS.labels(site="role.ipc").inc()
                logger.exception("edge link %s failed", self.addr)
            self.connected = False
            await self._close_writer()
            self._requeue_unacked()
            if self._stopping:
                return
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.reconnect_max)

    async def _handshake(self, reader, writer) -> None:
        node = self.runtime.node
        writer.write(ipc.pack_frame(ipc.MSG_HELLO, ipc.encode_hello(
            "edge", node.node_id, tuple(node.ctx.streams))))
        await writer.drain()
        msg_type, payload = await asyncio.wait_for(
            ipc.read_frame(reader), 10.0)
        if msg_type != ipc.MSG_HELLO_ACK:
            raise ipc.IPCError("expected HELLO_ACK, got %d" % msg_type)
        role, self.relay_id, streams, epoch = ipc.decode_hello(payload)
        if epoch < self.epoch:
            # a delayed ack from an older relay incarnation: keep the
            # newer map (the stale-epoch rule)
            STALE_MAPS.inc()
            logger.debug("edge link %s: stale HELLO_ACK epoch %d < %d "
                         "ignored", self.addr, epoch, self.epoch)
        else:
            self.epoch = epoch
            self.apply_shard_map(streams)
        logger.info("edge link %s: relay %s owns streams %s (epoch %d)",
                    self.addr, self.relay_id[:8],
                    self.relay_streams or "(all)", self.epoch)

    def apply_shard_map(self, streams: tuple[int, ...]) -> None:
        """Adopt a (newer) shard map and let the runtime rebuild the
        replica sets + re-route any now-misrouted banked records."""
        self.relay_streams = tuple(streams)
        self.runtime.on_shard_change(self)

    async def _close_writer(self) -> None:
        writer, self._writer = self._writer, None
        if writer is None:
            return
        try:
            writer.close()
            await asyncio.wait_for(writer.wait_closed(), 2.0)
        except Exception as exc:
            # a dead relay's transport refusing to close cleanly is
            # routine; count it, never swallow silently
            ERRORS.labels(site="role.ipc").inc()
            logger.debug("edge link %s close failed: %r", self.addr, exc)

    def _requeue_unacked(self) -> None:
        """Un-acked frames are re-routed through the runtime (oldest
        first) — redelivery is idempotent relay-side, and routing
        again (rather than pinning to this link) means a relay that
        reconnected owning a DIFFERENT shard doesn't reject records a
        sibling link now owns.  With this link down, the runtime
        shifts them to healthy replica-set siblings (failover).  The
        queued-but-unsent outbox goes through the same routing so a
        dead member strands nothing."""
        self._unacked_at.clear()
        pending = list(self.outbox)
        self.outbox.clear()
        requeued = 0
        for seq in list(self.unacked):
            records = self.unacked.pop(seq)
            self.runtime.reroute(records, fallback=self)
            requeued += len(records)
        if requeued:
            RESENDS.inc(requeued)
        if pending:
            self.runtime.reroute(pending, fallback=self)
        self._wakeup.set()

    # -- send / receive ------------------------------------------------------

    async def _send_loop(self, writer: asyncio.StreamWriter) -> None:
        while True:
            if not self.control and not self.outbox:
                self._wakeup.clear()
                if not self.unacked:
                    self._drained.set()
                self.runtime.note_outbox()
                await self._wakeup.wait()
            while self.control:
                # peek-send-pop: a failed send leaves the frame at the
                # head so it survives the reconnect (a popped-then-lost
                # FETCH would strand its getdata waiters)
                frame = self.control[0]
                inject("role.ipc")
                writer.write(frame)
                await writer.drain()
                self.control.popleft()
            if not self.outbox:
                continue
            batch = []
            while self.outbox and len(batch) < BATCH_MAX:
                batch.append(self.outbox.popleft())
            self.seq += 1
            seq = self.seq
            self.unacked[seq] = batch
            self._unacked_at[seq] = time.monotonic()
            try:
                inject("role.ipc")
                if not self.breaker.allow():
                    raise ConnectionError("role.ipc breaker open for %s"
                                          % self.addr)
                writer.write(ipc.pack_frame(
                    ipc.MSG_OBJECTS, ipc.encode_objects(seq, batch)))
                await writer.drain()
                self.breaker.record_success()
            except (OSError, ConnectionError) as exc:
                # the frame may be partially written: drop the
                # connection (the recv loop's reader dies with it) and
                # let reconnect re-deliver the un-acked records
                self.breaker.record_failure()
                ERRORS.labels(site="role.ipc").inc()
                logger.debug("edge link %s send failed: %r",
                             self.addr, exc)
                raise
            finally:
                self.runtime.note_outbox()

    async def _recv_loop(self, reader: asyncio.StreamReader) -> None:
        while True:
            msg_type, payload = await ipc.read_frame(reader)
            if msg_type == ipc.MSG_OBJECTS_ACK:
                seq, accepted, duplicate, rejected = \
                    ipc.decode_objects_ack(payload)
                records = self.unacked.pop(seq, None)
                self._unacked_at.pop(seq, None)
                if records is not None:
                    self.acked_objects += accepted
                    self.duplicate_objects += duplicate
                    self.rejected_objects += rejected
                    HANDOFFS.labels(result="acked").inc(accepted)
                    if duplicate:
                        HANDOFFS.labels(result="duplicate").inc(duplicate)
                    if rejected:
                        HANDOFFS.labels(result="rejected").inc(rejected)
                if not self.unacked and not self.outbox:
                    self._drained.set()
                self.runtime.note_outbox()
            elif msg_type == ipc.MSG_INV:
                self.runtime.on_inv(ipc.decode_inv(payload), self)
            elif msg_type == ipc.MSG_OBJECT_PUSH:
                record, _ = ipc.decode_record(payload)
                self.runtime.on_push(record, self)
            elif msg_type == ipc.MSG_PING:
                self.send_control(ipc.pack_frame(ipc.MSG_PONG, b""))
            elif msg_type == ipc.MSG_PONG:
                self._note_pong()
            elif msg_type == ipc.MSG_SHARD_UPDATE:
                epoch, streams = ipc.decode_shard_update(payload)
                if epoch <= self.epoch:
                    STALE_MAPS.inc()
                    logger.debug("edge link %s: stale SHARD_UPDATE "
                                 "epoch %d <= %d ignored", self.addr,
                                 epoch, self.epoch)
                else:
                    logger.info("edge link %s: shard map -> %s "
                                "(epoch %d)", self.addr,
                                streams or "(all)", epoch)
                    self.epoch = epoch
                    self.apply_shard_map(streams)
            else:
                logger.debug("edge link %s: unexpected frame type %d",
                             self.addr, msg_type)


class EdgeRuntime:
    """Wires an edge Node to its relay links: the object-queue pump
    hands accepted objects to their stream's relay; INV deltas and
    OBJECT_PUSHes flow back for dedupe, announce and getdata service."""

    def __init__(self, node, connect: str):
        self.node = node
        self.links: list[EdgeLink] = []
        for entry in str(connect or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            host, _, port = entry.rpartition(":")
            self.links.append(EdgeLink(self, host or "127.0.0.1",
                                       int(port)))
        if not self.links:
            raise ValueError("edge role needs roleipcconnect "
                             "(host:port[,host:port...])")
        #: hash -> ([BMConnection], fetch-sent monotonic) awaiting a
        #: FETCH payload for getdata service
        self._fetch_waiters: dict[bytes, tuple[list, float]] = {}
        self._outbox_ok = asyncio.Event()
        self._outbox_ok.set()
        self.outbox_high = OUTBOX_HIGH
        #: re-issue a FETCH this long after an unanswered one; waiters
        #: older than twice this are dropped (the relay lacks it)
        self.fetch_retry = 10.0
        #: stream -> ReplicaSet, rebuilt on every learned map change
        self.replica_sets: dict = {}
        self.ping_interval = PING_INTERVAL
        self._probe_task: asyncio.Task | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self.on_shard_change(None)
        for link in self.links:
            link.start()
        self._probe_task = asyncio.create_task(self._probe_loop())
        self.node.ctx.payload_fetcher = self.fetch_for_getdata

    async def stop(self) -> None:
        # drain objects the cancelled pump never forwarded straight
        # into the outbox (no headroom wait — shutdown must not
        # deadlock on a dead relay), then flush every link bounded
        from ..models.objects import extract_tag
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except asyncio.CancelledError:
                pass
        queue = self.node.ctx.object_queue
        while True:
            try:
                h, header, payload = queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            record = ipc.encode_record(
                h, header.object_type, header.stream, header.expires,
                extract_tag(header, payload), bytes(payload))
            self.fan_out(header.stream, record)
        for link in self.links:
            await link.stop()

    # -- hand-off ------------------------------------------------------------

    def note_outbox(self) -> None:
        depth = sum(link.depth() for link in self.links)
        OUTBOX_DEPTH.set(depth)
        if depth < self.outbox_high:
            self._outbox_ok.set()
        else:
            self._outbox_ok.clear()

    def on_shard_change(self, link: EdgeLink | None) -> None:
        """A link learned a (newer) shard map — rebuild the replica
        sets and push the link's banked records back through routing,
        so anything it no longer owns moves to the new owners (the
        epoch-flip re-route; in-flight un-acked frames are covered by
        the old owner's forwarding mode)."""
        self.replica_sets = build_replica_sets(
            self.links, self.node.ctx.streams)
        if link is not None and link.outbox:
            pending = list(link.outbox)
            link.outbox.clear()
            self.reroute(pending, fallback=link)

    def members_for(self, stream: int) -> list[EdgeLink]:
        """The stream's replica-set members (all known owners)."""
        rset = self.replica_sets.get(stream)
        if rset is not None and rset.members:
            return rset.members
        link = shard_owner(stream, {lk: lk.relay_streams
                                    for lk in self.links})
        return [link if link is not None else self.links[0]]

    def link_for(self, stream: int) -> EdgeLink:
        """The healthiest member of the stream's replica set (control
        traffic: FETCH; fan object records via :meth:`fan_out`)."""
        rset = self.replica_sets.get(stream)
        if rset is not None and rset.members:
            return rset.primary()
        return self.members_for(stream)[0]

    def fan_out(self, stream: int, record: bytes) -> None:
        """Enqueue one record on every live member of the stream's
        replica set — active-active replication (roles/replica.py).
        Members currently down are skipped (their healthy siblings
        carry the record) unless the WHOLE set is down, when the
        record banks on every member's outbox for the reconnect
        race."""
        members = self.members_for(stream)
        live = [m for m in members if m.health() > HEALTH_DOWN]
        for member in (live or members):
            member.enqueue(record)

    def reroute(self, records, fallback: EdgeLink) -> None:
        """Re-queue encoded records on whichever links CURRENTLY own
        their stream (links re-learn shards from HELLO_ACK on every
        reconnect — a relay restarted with a different ``rolestreams``
        must not be re-sent records a sibling now owns).  A record
        whose ``fallback`` member is down shifts to the healthy
        siblings (failover; relay dedupe absorbs any overlap); with
        no healthy owner anywhere it stays banked on ``fallback``."""
        shifted = 0
        for record in records:
            try:
                stream = ipc.record_stream(record)
            except ipc.IPCError:
                fallback.enqueue(record)
                continue
            members = self.members_for(stream)
            if fallback in members and fallback.health() > HEALTH_DOWN:
                fallback.enqueue(record)
                continue
            live = [m for m in members
                    if m is not fallback and m.health() > HEALTH_DOWN]
            if live:
                for member in live:
                    member.enqueue(record)
                if fallback in members:
                    shifted += 1
            elif members and fallback not in members:
                # the shard moved wholesale; bank on the new owners
                for member in members:
                    member.enqueue(record)
            else:
                fallback.enqueue(record)
        if shifted:
            FAILOVERS.inc(shifted)

    async def handoff(self, h: bytes, header, payload: bytes) -> None:
        """Pump destination for accepted objects (the edge's
        ``_pump_objects``): fan by the object's stream to every live
        replica of its shard.  The record is enqueued FIRST, then
        headroom is awaited — backpressure flows pump -> object queue
        -> connection reads -> TCP, and a pump task cancelled mid-wait
        (shutdown) has already banked the object in the outbox."""
        from ..models.objects import extract_tag
        record = ipc.encode_record(
            h, header.object_type, header.stream, header.expires,
            extract_tag(header, payload), bytes(payload))
        self.fan_out(header.stream, record)
        HANDOFFS.labels(result="queued").inc()
        self.note_outbox()
        await self._outbox_ok.wait()

    # -- replica health prober ----------------------------------------------

    async def _probe_loop(self) -> None:
        """Periodic PING per connected link (the RTT rung of the
        health ladder) + ``role_replica_health`` gauge refresh.
        Planted with the ``role.replica`` chaos site — an injected
        probe failure feeds the link's breaker exactly like a real
        dead peer."""
        while True:
            await asyncio.sleep(self.ping_interval)
            for link in self.links:
                if not link.connected:
                    continue
                try:
                    inject("role.replica")
                    link.ping()
                except (OSError, ConnectionError) as exc:
                    link.breaker.record_failure()
                    ERRORS.labels(site="role.replica").inc()
                    logger.debug("edge link %s probe failed: %r",
                                 link.addr, exc)
            for rset in self.replica_sets.values():
                rset.export_health()

    # -- relay -> edge traffic ----------------------------------------------

    def on_inv(self, entries, origin: EdgeLink) -> None:
        """Inventory delta: remember the hashes (dedupe) and announce
        them to our own peers — relays have no P2P sockets; edges are
        the fleet's mouth as well as its ears."""
        cache = self.node.inventory
        for stream, expires, h in entries:
            if h in cache:
                continue
            cache.note_known(h, stream, expires)
            self.node.pool.announce_object(h, stream, local=False)

    def on_push(self, record, origin: EdgeLink) -> None:
        """A full object from the relay: cache it, serve any getdata
        waiters, announce to peers."""
        h, type_, stream, expires, tag, payload = record
        cache = self.node.inventory
        fresh = h not in cache or cache.is_known_uncached(h)
        cache.add(h, type_, stream, payload, expires, tag)
        plane = self.node.client_plane
        if plane is not None and fresh:
            # relay-originated objects reach light-client subscribers
            # too, not only locally ingested ones
            plane.on_record(h, type_, stream, expires, tag, payload)
        waiters, _ = self._fetch_waiters.pop(h, ([], 0.0))
        for conn in waiters:
            FETCHES.labels(result="served").inc()
            conn.pending_upload.append(h)
            task = asyncio.ensure_future(conn.flush_uploads())
            task.add_done_callback(_log_task_error)
        if fresh and not waiters:
            self.node.pool.announce_object(h, stream, local=False)

    def fetch_for_getdata(self, h: bytes, conn) -> bool:
        """``ctx.payload_fetcher`` hook (connection.flush_uploads): a
        peer getdata'd a hash we know exists relay-side but don't hold
        — fetch it and re-serve when the payload lands.  Returns False
        for truly unknown hashes (the anti-intersection delay
        applies)."""
        cache = self.node.inventory
        if not cache.is_known_uncached(h):
            return False
        now = time.monotonic()
        # prune stale entries: an unanswered fetch twice past the
        # retry window means the relay lacks the payload — drop the
        # waiters so closed connections can't pin here forever
        stale = [k for k, (_, sent) in self._fetch_waiters.items()
                 if now - sent > 2 * self.fetch_retry]
        for k in stale:
            FETCHES.labels(result="expired").inc()
            del self._fetch_waiters[k]
        waiters, sent_at = self._fetch_waiters.get(h, ([], 0.0))
        if conn not in waiters:
            waiters.append(conn)
        if not sent_at or now - sent_at > self.fetch_retry:
            FETCHES.labels(result="requested").inc()
            stream = cache.known_stream(h) or 1
            self.link_for(stream).send_control(
                ipc.pack_frame(ipc.MSG_FETCH, ipc.encode_fetch(h)))
            sent_at = now
        self._fetch_waiters[h] = (waiters, sent_at)
        return True

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "links": [{
                "relay": link.addr,
                "relayId": link.relay_id,
                "relayStreams": list(link.relay_streams),
                "epoch": link.epoch,
                "connected": link.connected,
                "health": link.health(),
                "rttMs": round(link.rtt * 1000, 1)
                if link.rtt is not None else None,
                "ackLagS": round(link.ack_lag(), 3),
                "outbox": len(link.outbox),
                "unacked": sum(len(v) for v in link.unacked.values()),
                "acked": link.acked_objects,
                "duplicates": link.duplicate_objects,
                "rejected": link.rejected_objects,
                "breakerOpen": not link.breaker.available(),
            } for link in self.links],
            "replicaSets": {
                str(stream): rset.snapshot()["members"]
                for stream, rset in sorted(self.replica_sets.items())},
            "fetchWaiters": len(self._fetch_waiters),
        }


def _log_task_error(task: asyncio.Task) -> None:
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        ERRORS.labels(site="role.ipc").inc()
        logger.debug("fetch re-serve failed: %r", exc)
