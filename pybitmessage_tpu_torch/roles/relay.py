"""The relay role: stream-shard inventory authority behind role IPC
(copy of ``pybitmessage_tpu.roles.relay``, over any of the node's
inventory backends).

A relay owns storage, the object processor and the sender for its shard
of streams (``rolestreams``), and serves the role IPC channel edges hand
objects over.  It does not open the shared P2P listener: edges own the
port.

Ingest is idempotent by inventory hash, so the edge's at-least-once
redelivery after a crash or a ``role.ipc`` fault nets exactly-once
acceptance.  What a relay accepts over IPC flows back out to the other
edges as INV deltas; what its own workers announce (the sender's
pubkeys and messages, the processor's acks) goes to every edge as an
``OBJECT_PUSH`` with the payload, since edges are its only way out.

Shards are elastic: the relay carries a monotonic shard-map epoch in
every ``HELLO_ACK``, broadcasts ``SHARD_UPDATE`` to its edges when the
map changes, serves incoming ``HANDOFF`` drains (acquiring the stream on
``BEGIN``), and can itself :meth:`~RelayRuntime.shed_stream`: drain a
stream to a new owner over acked OBJECTS frames (behind the
``role.handoff`` chaos site), then forward records that raced the epoch
flip, stored and relayed onward, deduped at the destination.  On the
slab store a drain walks the store's expiry buckets
(``SlabStore.export_buckets``); a backend without buckets drains as one
pseudo-bucket over ``unexpired_hashes_by_stream``.  A bucket is the
unit an interrupted drain re-sends whole; the receiver's hash dedupe
absorbs the overlap.  The receiver makes its inventory durable
(``flush``) before it acks the drain's ``END``, on which the sender
sheds the stream: unlike the JAX relay, whose receiver acks with the
drained records still in its write-behind buffer.

:meth:`~RelayRuntime.stop` closes every connection it serves, the peer
relays' handoff and forwarding connections as well as the edges',
before it waits for its listener (Python 3.12's ``Server.wait_closed``
waits for every connection).
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque

from ..observability import REGISTRY
from ..resilience import inject
from ..resilience.policy import ERRORS
from . import ipc

logger = logging.getLogger("pybitmessage_tpu_torch.roles")

RELAY_OBJECTS = REGISTRY.counter(
    "role_relay_objects_total",
    "Objects ingested over role IPC, by outcome", ("result",))
RELAY_EDGES = REGISTRY.gauge(
    "role_relay_edges", "Edge processes connected over role IPC")
RELAY_PUSHES = REGISTRY.counter(
    "role_relay_push_total",
    "Relay->edge pushes by kind (inv delta / full object)", ("kind",))
RELAY_EPOCH = REGISTRY.gauge(
    "role_shard_epoch",
    "This relay's shard-map epoch (bumps on every live "
    "acquire/shed; carried in HELLO_ACK and SHARD_UPDATE)")
HANDOFF_RECORDS = REGISTRY.counter(
    "role_handoff_records_total",
    "Objects moved to another relay by the live split/merge "
    "machinery: bucket-drained during a shed, or forwarded after it "
    "(a late record that raced the epoch flip)", ("direction",))

#: INV delta flush cadence, seconds
INV_FLUSH_INTERVAL = 0.05
#: max records per OBJECTS frame on the handoff drain / forward path
HANDOFF_BATCH = 256


class _RecordHeader:
    """Header-shaped view of an IPC object record — what the pool's
    per-stream announcement routing and the processor pump need."""

    __slots__ = ("object_type", "stream", "expires", "version",
                 "header_length")

    def __init__(self, object_type: int, stream: int, expires: int):
        self.object_type = object_type
        self.stream = stream
        self.expires = expires
        self.version = 0
        self.header_length = 0


class _EdgeConn:
    """One connected edge process (relay side)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.edge_id = ""
        #: "edge", or "relay" for a peer draining a shard handoff
        self.role = "edge"
        self.edge_streams: tuple[int, ...] = ()
        self.lock = asyncio.Lock()
        #: accumulated INV delta entries awaiting the next flush
        self.pending_inv: list[tuple[int, int, bytes]] = []
        self.objects_received = 0

    #: per-send drain ceiling — a blackholed edge must fail fast and
    #: reconnect, not wedge the relay's fan-out paths for TCP-timeout
    #: minutes
    SEND_TIMEOUT = 10.0

    async def send(self, frame: bytes) -> None:
        async with self.lock:
            inject("role.ipc")
            self.writer.write(frame)
            try:
                await asyncio.wait_for(self.writer.drain(),
                                       self.SEND_TIMEOUT)
            except asyncio.TimeoutError:
                self.writer.close()
                raise ConnectionError("edge %s wedged mid-send"
                                      % self.edge_id[:8])


class RelayRuntime:
    """Serves the role IPC channel and wires relay-side hooks."""

    def __init__(self, node, listen: str):
        self.node = node
        host, _, port = str(listen).rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.edges: list[_EdgeConn] = []
        #: every connection being served, peer relays' included
        self._conns: set[_EdgeConn] = set()
        self._server: asyncio.AbstractServer | None = None
        self._flush_task: asyncio.Task | None = None
        self.objects_accepted = 0
        self.objects_duplicate = 0
        self.objects_rejected = 0
        self.objects_forwarded = 0
        self._chain_on_object = None
        #: shard-map epoch, monotonic for this relay's lifetime —
        #: bumps on every live acquire/shed so edges can order maps
        self.epoch = 0
        #: shed stream -> new owner "host:port": forwarding mode for
        #: records that raced the epoch flip
        self.forwarding: dict[int, str] = {}
        #: stream mid-drain -> handoff target: accepted records are
        #: shadow-forwarded while the bucket walk runs, because an
        #: arrival can land in a bucket the walk already exported
        self._draining: dict[int, str] = {}
        self._forwarders: dict[str, _Forwarder] = {}

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port)
        pool = self.node.pool
        self._chain_on_object = pool.on_object
        pool.on_object = self._on_object
        pool.on_announce = self._on_announce
        self._flush_task = asyncio.create_task(self._inv_flush_loop())

    @property
    def listen_port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
            try:
                await self._flush_task
            except asyncio.CancelledError:
                pass
        await self._flush_inv()
        for fwd in list(self._forwarders.values()):
            await fwd.stop()
        if self._server is not None:
            self._server.close()
        for edge in list(self._conns):
            try:
                edge.writer.close()
            except Exception as exc:
                ERRORS.labels(site="role.ipc").inc()
                logger.debug("edge close failed: %r", exc)
        if self._server is not None:
            await self._server.wait_closed()

    # -- IPC serving ---------------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        edge = _EdgeConn(writer)
        self._conns.add(edge)
        try:
            msg_type, payload = await asyncio.wait_for(
                ipc.read_frame(reader), 10.0)
            if msg_type != ipc.MSG_HELLO:
                raise ipc.IPCError("expected HELLO, got %d" % msg_type)
            edge.role, edge.edge_id, edge.edge_streams, _ = \
                ipc.decode_hello(payload)
            await edge.send(ipc.pack_frame(
                ipc.MSG_HELLO_ACK, ipc.encode_hello(
                    "relay", self.node.node_id,
                    tuple(self.node.ctx.streams), self.epoch)))
            if edge.role != "relay":
                # peer relays (handoff drains/forwards) are served but
                # never joined to the edge fan-out set: they must not
                # receive INV deltas or SHARD_UPDATE broadcasts
                self.edges.append(edge)
                RELAY_EDGES.set(len(self.edges))
            logger.info("%s %s connected (streams %s)", edge.role,
                        edge.edge_id[:8], edge.edge_streams or "(all)")
            while True:
                msg_type, payload = await ipc.read_frame(reader)
                if msg_type == ipc.MSG_OBJECTS:
                    await self._handle_objects(edge, payload)
                elif msg_type == ipc.MSG_FETCH:
                    await self._handle_fetch(edge, payload)
                elif msg_type == ipc.MSG_HANDOFF:
                    await self._handle_handoff(edge, payload)
                elif msg_type == ipc.MSG_PING:
                    await edge.send(ipc.pack_frame(ipc.MSG_PONG, b""))
                elif msg_type == ipc.MSG_PONG:
                    pass
                else:
                    logger.debug("unexpected role-ipc frame %d from "
                                 "edge %s", msg_type, edge.edge_id[:8])
        except asyncio.CancelledError:
            raise
        except (OSError, ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, ipc.IPCError) as exc:
            ERRORS.labels(site="role.ipc").inc()
            logger.debug("edge connection closed: %r", exc)
        except Exception:
            ERRORS.labels(site="role.ipc").inc()
            logger.exception("edge connection failed")
        finally:
            self._conns.discard(edge)
            if edge in self.edges:
                self.edges.remove(edge)
                RELAY_EDGES.set(len(self.edges))
            try:
                writer.close()
                await asyncio.wait_for(writer.wait_closed(), 2.0)
            except Exception as exc:
                ERRORS.labels(site="role.ipc").inc()
                logger.debug("edge transport close failed: %r", exc)

    async def _handle_objects(self, edge: _EdgeConn,
                              payload: bytes) -> None:
        # ingest backpressure: while the processor queue sits above its
        # watermark, stop consuming frames — the edge's outbox fills,
        # its pump pauses, its connection reads pause, TCP pushes back
        wait_resume = getattr(self.node.ctx.object_queue,
                              "wait_resume", None)
        if wait_resume is not None:
            await wait_resume()
        seq, records = ipc.decode_objects(payload)
        accepted = duplicate = rejected = forwarded = 0
        for record in records:
            result = self._accept_record(record, edge)
            if result == "accepted":
                accepted += 1
            elif result == "forwarded":
                # stored AND relayed to the stream's new owner; to the
                # sender it is an ordinary accept (stop re-sending)
                forwarded += 1
                accepted += 1
            elif result == "duplicate":
                duplicate += 1
            else:
                rejected += 1
            RELAY_OBJECTS.labels(result=result).inc()
        edge.objects_received += len(records)
        self.objects_accepted += accepted
        self.objects_duplicate += duplicate
        self.objects_rejected += rejected
        self.objects_forwarded += forwarded
        # INV deltas ride the periodic flusher, NOT this path: one
        # wedged sibling edge must never head-of-line-block another
        # edge's ingest ack
        await edge.send(ipc.pack_frame(
            ipc.MSG_OBJECTS_ACK,
            ipc.encode_objects_ack(seq, accepted, duplicate, rejected)))

    def _accept_record(self, record, edge: _EdgeConn) -> str:
        h, type_, stream, expires, tag, payload = record
        ctx = self.node.ctx
        if h in ctx.inventory:
            return "duplicate"
        if stream not in ctx.streams:
            target = self.forwarding.get(stream)
            if target is None:
                # shard boundary: this relay does not own the stream —
                # the edge mis-routed (stale routing table).  Refuse
                # rather than pollute the shard's digest and sketches.
                return "rejected"
            # forwarding mode (live split/merge): the record raced the
            # epoch flip on a shed stream.  Store it (the node's
            # stream-restricted sync digest keeps it out of sketches;
            # dedupe and getdata service keep working) and forward a
            # copy to the new owner: double-delivered, never dropped,
            # deduped at the destination.
            ctx.inventory.add(h, type_, stream, payload, expires, tag)
            self._forwarder_for(target).enqueue(
                ipc.encode_record(h, type_, stream, expires, tag,
                                  payload))
            return "forwarded"
        ctx.inventory.add(h, type_, stream, payload, expires, tag)
        drain_target = self._draining.get(stream)
        if drain_target is not None:
            # mid-drain arrival on a stream being handed off: the drain
            # may have read the stream's hashes already, so the walk
            # alone cannot be trusted to carry it —
            # shadow-forward a copy to the acquiring relay (deduped
            # there when the walk or the edge fan-out delivers it too)
            self._forwarder_for(drain_target).enqueue(
                ipc.encode_record(h, type_, stream, expires, tag,
                                  payload))
        self.node.pool.object_received(
            h, _RecordHeader(type_, stream, expires), payload,
            source=edge)
        return "accepted"

    async def _handle_fetch(self, edge: _EdgeConn,
                            payload: bytes) -> None:
        h = ipc.decode_fetch(payload)
        try:
            item = self.node.ctx.inventory[h]
        except KeyError:
            logger.debug("fetch for unknown hash %s", h.hex()[:16])
            return
        RELAY_PUSHES.labels(kind="object").inc()
        await edge.send(ipc.pack_frame(
            ipc.MSG_OBJECT_PUSH, ipc.encode_record(
                h, item.type, item.stream, item.expires, item.tag,
                item.payload)))

    # -- live split/merge ----------------------------------------------------

    async def _handle_handoff(self, edge: _EdgeConn,
                              payload: bytes) -> None:
        """Receiver side of a shard handoff.  ``BEGIN`` auto-acquires
        the stream (idempotent — an interrupted drain re-begins), so
        the drain's OBJECTS frames pass the shard check and this
        relay's edges learn the new map before the first record lands;
        ``END`` flushes the inventory, then acks: the SENDER sheds on
        that ack, so what it drained is durable here first."""
        kind, stream, epoch, bucket = ipc.decode_handoff(payload)
        if kind == ipc.HANDOFF_BEGIN:
            if self.acquire_stream(stream):
                logger.info("handoff: acquired stream %d from %s "
                            "(epoch %d)", stream, edge.edge_id[:8],
                            self.epoch)
        elif kind == ipc.HANDOFF_END:
            await asyncio.to_thread(self.node.ctx.inventory.flush)
            logger.info("handoff: stream %d drain from %s complete "
                        "(inventory flushed)", stream, edge.edge_id[:8])
        await edge.send(ipc.pack_frame(ipc.MSG_HANDOFF, ipc.encode_handoff(
            ipc.HANDOFF_ACK, stream, self.epoch, bucket)))

    def acquire_stream(self, stream: int) -> bool:
        """Add ``stream`` to this relay's shard mid-session: bump the
        epoch and SHARD_UPDATE every edge.  Returns False when the
        stream was already owned (idempotent re-begin)."""
        ctx = self.node.ctx
        if stream in ctx.streams:
            return False
        self.node.set_streams(tuple(ctx.streams) + (stream,))
        # (re)acquiring cancels any earlier shed of the same stream
        self.forwarding.pop(stream, None)
        self._bump_epoch()
        return True

    async def shed_stream(self, stream: int, target: str) -> dict:
        """Sender side of a live shard handoff: drain ``stream``'s
        retained objects to the relay at ``target`` (``host:port``),
        bucket-granular over acked OBJECTS frames, then shed the
        stream — bump the epoch, SHARD_UPDATE every edge, and enter
        forwarding mode so in-flight records that raced the flip are
        double-delivered, never dropped.  Records accepted WHILE the
        drain runs shadow-forward to the target as they arrive — the
        bucket walk cannot carry an arrival into a bucket it already
        exported.  An interruption anywhere
        leaves this relay still owning the stream; re-invoking resumes
        (re-begin is idempotent, re-drained records dedupe)."""
        ctx = self.node.ctx
        if stream not in ctx.streams:
            raise ValueError("stream %d not owned (streams %s)"
                             % (stream, list(ctx.streams)))
        if len(ctx.streams) == 1:
            raise ValueError("cannot shed the last owned stream")
        host, _, port = str(target).rpartition(":")
        reader, writer = await asyncio.open_connection(
            host or "127.0.0.1", int(port))
        drained = buckets = seq = 0
        try:
            await self._relay_hello(reader, writer)
            await self._handoff_control(reader, writer,
                                        ipc.HANDOFF_BEGIN, stream)
            # from BEGIN-ack on the receiver owns the stream too, so a
            # record accepted mid-drain shadow-forwards immediately —
            # the bucket walk below would miss arrivals into buckets
            # it has already exported (rescale-under-load zero-loss)
            self._draining[stream] = str(target)
            for bucket, hashes in self._export_stream(stream):
                batch = []
                for h in hashes:
                    try:
                        item = ctx.inventory[h]
                    except KeyError:
                        continue    # TTL-dropped mid-drain
                    batch.append(ipc.encode_record(
                        h, item.type, item.stream, item.expires,
                        item.tag, item.payload))
                    if len(batch) >= HANDOFF_BATCH:
                        seq += 1
                        await self._handoff_objects(reader, writer,
                                                    seq, batch)
                        drained += len(batch)
                        batch = []
                if batch:
                    seq += 1
                    await self._handoff_objects(reader, writer, seq,
                                                batch)
                    drained += len(batch)
                buckets += 1
            await self._handoff_control(reader, writer,
                                        ipc.HANDOFF_END, stream)
        finally:
            self._draining.pop(stream, None)
            try:
                writer.close()
                await asyncio.wait_for(writer.wait_closed(), 2.0)
            except Exception as exc:
                ERRORS.labels(site="role.handoff").inc()
                logger.debug("handoff close to %s failed: %r",
                             target, exc)
        # shed ONLY after the receiver acked END — an interrupted
        # drain leaves ownership (and edge routing) unchanged
        self.node.set_streams(s for s in ctx.streams if s != stream)
        self.forwarding[stream] = str(target)
        self._bump_epoch()
        HANDOFF_RECORDS.labels(direction="drained").inc(drained)
        logger.info("handoff: shed stream %d to %s (%d objects, %d "
                    "buckets, epoch %d)", stream, target, drained,
                    buckets, self.epoch)
        return {"stream": stream, "target": str(target),
                "objectsDrained": drained, "buckets": buckets,
                "epoch": self.epoch}

    def _export_stream(self, stream: int):
        """``(bucket, [hashes])`` pairs to drain: the slab store's
        expiry buckets, or one pseudo-bucket for a backend without
        bucket sharding."""
        inv = self.node.ctx.inventory
        if hasattr(inv, "export_buckets"):
            return inv.export_buckets(stream)
        return iter([(-1, inv.unexpired_hashes_by_stream(stream))])

    async def _relay_hello(self, reader, writer) -> None:
        """Dial-side handshake of a relay->relay drain/forward
        connection (the receiver serves it like an edge)."""
        inject("role.handoff")
        writer.write(ipc.pack_frame(ipc.MSG_HELLO, ipc.encode_hello(
            "relay", self.node.node_id, tuple(self.node.ctx.streams),
            self.epoch)))
        await writer.drain()
        msg_type, _ = await asyncio.wait_for(ipc.read_frame(reader),
                                             10.0)
        if msg_type != ipc.MSG_HELLO_ACK:
            raise ipc.IPCError("expected HELLO_ACK, got %d" % msg_type)

    async def _handoff_control(self, reader, writer, kind: int,
                               stream: int, bucket: int = -1) -> int:
        """Send one HANDOFF control frame and wait for its ack;
        returns the receiver's epoch.  Interleaved INV/PUSH frames the
        receiver fans to all its connections are skipped — they are
        not ours to serve on a drain connection."""
        inject("role.handoff")
        writer.write(ipc.pack_frame(ipc.MSG_HANDOFF, ipc.encode_handoff(
            kind, stream, self.epoch, bucket)))
        await writer.drain()
        while True:
            msg_type, payload = await asyncio.wait_for(
                ipc.read_frame(reader), 30.0)
            if msg_type != ipc.MSG_HANDOFF:
                continue
            k, s, epoch, _ = ipc.decode_handoff(payload)
            if k == ipc.HANDOFF_ACK and s == stream:
                return epoch

    async def _handoff_objects(self, reader, writer, seq: int,
                               batch: list[bytes]) -> None:
        """One acked OBJECTS frame on a drain/forward connection."""
        inject("role.handoff")
        writer.write(ipc.pack_frame(
            ipc.MSG_OBJECTS, ipc.encode_objects(seq, batch)))
        await writer.drain()
        while True:
            msg_type, payload = await asyncio.wait_for(
                ipc.read_frame(reader), 30.0)
            if msg_type != ipc.MSG_OBJECTS_ACK:
                continue
            acked_seq, _, _, _ = ipc.decode_objects_ack(payload)
            if acked_seq == seq:
                return

    def _bump_epoch(self) -> None:
        """Advance the shard-map epoch and broadcast the new map to
        every connected edge (stale-epoch rule orders concurrent
        updates edge-side)."""
        self.epoch += 1
        RELAY_EPOCH.set(self.epoch)
        frame = ipc.pack_frame(
            ipc.MSG_SHARD_UPDATE, ipc.encode_shard_update(
                self.epoch, tuple(self.node.ctx.streams)))
        for edge in list(self.edges):
            task = asyncio.ensure_future(edge.send(frame))
            task.add_done_callback(_log_send_error)

    def _forwarder_for(self, target: str) -> "_Forwarder":
        fwd = self._forwarders.get(target)
        if fwd is None:
            fwd = self._forwarders[target] = _Forwarder(self, target)
        return fwd

    # -- relay -> edge fan-out ----------------------------------------------

    def _on_object(self, h: bytes, header, payload, source) -> None:
        """Every accepted object (IPC, P2P, local) becomes an INV
        delta to every edge except the one that delivered it."""
        entry = (header.stream, header.expires, h)
        for edge in self.edges:
            if edge is not source:
                edge.pending_inv.append(entry)
        if self._chain_on_object is not None:
            self._chain_on_object(h, header, payload, source)

    def _on_announce(self, h: bytes, stream: int, local: bool) -> None:
        """An object this relay's own workers announce: the sender's
        (``local``) and the processor's acks (not ``local``).  Edges need
        the payload, not just the hash: they serve the getdata.  (The
        JAX relay pushes only ``local`` ones, so its acks never leave
        it.)"""
        if not self.edges:
            return
        try:
            item = self.node.ctx.inventory[h]
        except KeyError:
            return
        frame = ipc.pack_frame(
            ipc.MSG_OBJECT_PUSH, ipc.encode_record(
                h, item.type, item.stream, item.expires, item.tag,
                item.payload))
        for edge in list(self.edges):
            RELAY_PUSHES.labels(kind="object").inc()
            task = asyncio.ensure_future(edge.send(frame))
            task.add_done_callback(_log_send_error)

    async def _inv_flush_loop(self) -> None:
        while True:
            await asyncio.sleep(INV_FLUSH_INTERVAL)
            try:
                await self._flush_inv()
            except asyncio.CancelledError:
                raise
            except Exception:
                ERRORS.labels(site="role.ipc").inc()
                logger.exception("inv delta flush failed")

    async def _flush_inv(self) -> None:
        for edge in list(self.edges):
            if not edge.pending_inv:
                continue
            entries, edge.pending_inv = edge.pending_inv, []
            RELAY_PUSHES.labels(kind="inv").inc()
            try:
                await edge.send(ipc.pack_frame(
                    ipc.MSG_INV, ipc.encode_inv(entries)))
            except (OSError, ConnectionError) as exc:
                # a dead edge's INV delta is harmless to drop — the
                # edge re-learns on reconnect HELLO + future deltas;
                # count it so the loss is visible
                ERRORS.labels(site="role.ipc").inc()
                logger.debug("inv delta to edge %s failed: %r",
                             edge.edge_id[:8], exc)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "listen": "%s:%d" % (self.host, self.listen_port),
            "epoch": self.epoch,
            "edges": [{
                "edgeId": e.edge_id,
                "streams": list(e.edge_streams),
                "objectsReceived": e.objects_received,
            } for e in self.edges],
            "accepted": self.objects_accepted,
            "duplicates": self.objects_duplicate,
            "rejected": self.objects_rejected,
            "forwarded": self.objects_forwarded,
            "forwarding": {str(s): t
                           for s, t in sorted(self.forwarding.items())},
            "draining": {str(s): t
                         for s, t in sorted(self._draining.items())},
            "forwardPending": sum(len(f.queue)
                                  for f in self._forwarders.values()),
        }


class _Forwarder:
    """At-least-once late-record forwarding to a shed stream's new
    owner (relay->relay, batched acked OBJECTS frames over one
    persistent connection).  A failed batch stays queued and retries —
    the record is meanwhile stored locally AND re-routed by the edge's
    own epoch-flip handling, so every path ends deduped at the new
    owner, never dropped."""

    RETRY = 0.5

    def __init__(self, runtime: RelayRuntime, target: str):
        self.runtime = runtime
        self.target = str(target)
        host, _, port = self.target.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.queue: deque[bytes] = deque()
        self.forwarded = 0
        self._wakeup = asyncio.Event()
        self.task = asyncio.create_task(self._run())

    def enqueue(self, record: bytes) -> None:
        self.queue.append(record)
        self._wakeup.set()

    async def stop(self) -> None:
        self.task.cancel()
        try:
            await self.task
        except asyncio.CancelledError:
            pass

    async def _run(self) -> None:
        seq = 0
        reader = writer = None
        while True:
            if not self.queue:
                self._wakeup.clear()
                await self._wakeup.wait()
            batch = []
            while self.queue and len(batch) < HANDOFF_BATCH:
                batch.append(self.queue.popleft())
            try:
                if writer is None:
                    reader, writer = await asyncio.open_connection(
                        self.host, self.port)
                    await self.runtime._relay_hello(reader, writer)
                seq += 1
                await self.runtime._handoff_objects(reader, writer,
                                                    seq, batch)
                self.forwarded += len(batch)
                HANDOFF_RECORDS.labels(direction="forwarded").inc(
                    len(batch))
            except asyncio.CancelledError:
                if writer is not None:
                    writer.close()
                raise
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ipc.IPCError) as exc:
                self.queue.extendleft(reversed(batch))
                ERRORS.labels(site="role.handoff").inc()
                logger.debug("forward to %s failed: %r",
                             self.target, exc)
                if writer is not None:
                    writer.close()
                reader = writer = None
                await asyncio.sleep(self.RETRY)


def _log_send_error(task: asyncio.Task) -> None:
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        ERRORS.labels(site="role.ipc").inc()
        logger.debug("object push failed: %r", exc)
