"""One peer connection: framed packets, handshake, command dispatch
(copy of ``pybitmessage_tpu.network.connection``; every framed send is
the ``net.send`` chaos site).  When both ends advertise NODE_SSL the
stream upgrades to TLS right after the veracks (``_upgrade_tls``).
Frames, framing errors and handshake timeouts go to the JAX
connection's metric families.

Wire behavior kept: 24-byte header with magic resync
(bmproto.py:85-104), sha512/4 checksum, version validity checks
(bmproto.py:563-643), big-inv sync on establishment (tcp.py:210-253)
unless both ends advertise NODE_SYNC (then the reconciler's digest
catch-up replaces it), addr sample exchange (tcp.py:175-208).  Between
two NODE_TRACE ends, sync payloads carry a 32-byte trace trailer and
object pushes travel as ``tobject`` frames whose trace context the
receiver's lifecycle adopts.

A received object goes through three steps, split where the JAX
connection splits them:

1. :func:`parse_object`, inline in the read loop: the header, the
   per-type length and the expiry bounds.  An ``ObjectError`` drops
   only the object; a ``VarintError`` escapes to the read loop, which
   closes the peer.
2. The PoW, through ``ctx.pow_verifier`` (the batch verifier on the
   card) in a task per object, at most ``VERIFY_WINDOW`` in flight per
   connection, so a peer's flood coalesces into device batches.  A
   failed PoW closes the peer.
3. :func:`store_object`: the trace adoption, the duplicate check, the
   inventory and ``pool.object_received``.

:func:`accept_object` composes the three for a caller without a
socket.
"""

from __future__ import annotations

import asyncio
import logging
import math
import random
import struct
import time
from collections import deque
from typing import TYPE_CHECKING

from ..models.constants import (MAGIC, MAX_OBJECT_COUNT, MAX_TIME_OFFSET,
                                NODE_SSL, NODE_SYNC, NODE_TRACE)
from ..models.objects import (ObjectError, ObjectHeader, check_by_type,
                              extract_tag)
from ..observability import REGISTRY
from ..observability.lifecycle import LIFECYCLE
from ..observability.tracing import (TRACE_CTX_INVALID, TRACE_CTX_LEN,
                                     TRACE_CTX_RECEIVED, TRACE_CTX_SENT,
                                     SkewEstimator, TraceContext)
from ..resilience.chaos import inject
from ..resilience.policy import ERRORS
from ..models.packet import (HEADER_LEN, PacketError, pack_packet,
                             unpack_header, verify_payload)
from ..storage.knownnodes import Peer
from ..utils.hashes import inventory_hash
from ..utils.varint import VarintError
from .bufpool import RECV_POOL, PooledBuffer
from .messages import (AddrEntry, MessageError, VersionPayload,
                       append_trace_ctx, decode_addr, decode_error,
                       decode_inv, encode_addr, encode_error, encode_host,
                       encode_inv, split_trace_ctx)
from .tracker import ConnectionTracker

if TYPE_CHECKING:  # pragma: no cover
    from .pool import ConnectionPool

logger = logging.getLogger("pybitmessage_tpu_torch.network")

#: maximum addr entries sent on establishment (tcp.py:175-208)
MAX_ADDR_SAMPLE = 500
#: inv chunking for the initial big inv (tcp.py:210-253)
BIG_INV_CHUNK = 50000
#: max objects per connection with PoW verification still in flight —
#: lets one peer's flood coalesce into device batches without letting
#: it queue unbounded payloads
VERIFY_WINDOW = 32

PACKETS = REGISTRY.counter(
    "network_packets_total", "Framed protocol packets by direction",
    ("direction",))
# children bound once: the per-packet path must not pay a family lock
# and label lookup per frame
PACKETS_RX = PACKETS.labels(direction="rx")
PACKETS_TX = PACKETS.labels(direction="tx")
PACKET_ERRORS = REGISTRY.counter(
    "network_packet_errors_total",
    "Frames dropped for bad checksum / oversize payload")
HANDSHAKE_TIMEOUTS = REGISTRY.counter(
    "network_handshake_timeout_total",
    "Connections closed because version/verack never completed — "
    "black-holed peers no longer pin a slot forever")
_MAGIC = struct.pack(">L", MAGIC)


class ConnectionClosed(Exception):
    pass


def parse_object(payload) -> ObjectHeader | None:
    """The inline checks of a received object: its header, the
    per-type length and the expiry bounds.  ``None`` when an
    ``ObjectError`` drops the object; a ``VarintError`` in the header
    is raised (the connection closes on it, as the JAX one does)."""
    try:
        header = ObjectHeader.parse(payload)
        check_by_type(header.object_type, header.version, len(payload))
        header.check_expiry()
    except ObjectError as exc:
        logger.debug("rejected object: %s", exc)
        return None
    return header


def store_object(ctx, pool, header, payload, source=None,
                 trace_ctx: TraceContext | None = None) -> str:
    """Accept a parsed, PoW-checked object: ``"duplicate"`` when the
    inventory holds it, else it enters the inventory and
    ``pool.object_received`` and the answer is ``"accepted"``.  A
    memoryview payload is turned into ``bytes`` here, for new objects
    only.  An object that arrived with a wire trace context joins the
    sender's trace first (first writer wins)."""
    h = inventory_hash(payload)
    if trace_ctx is not None:
        LIFECYCLE.adopt(h, trace_ctx.trace_id, trace_ctx.parent_span)
    if source is not None:
        source.tracker.object_received(h)
    ctx.global_tracker.received(h)
    if h in ctx.inventory:
        return "duplicate"
    if not isinstance(payload, bytes):
        payload = bytes(payload)
    ctx.inventory.add(h, header.object_type, header.stream, payload,
                      header.expires, extract_tag(header, payload))
    pool.object_received(h, header, payload, source=source)
    return "accepted"


async def accept_object(ctx, pool, payload: bytes) -> str:
    """Check one received object and accept it, as a connection does.
    Returns ``"accepted"`` or why it was not: ``"varint"`` (a malformed
    varint in the header; a connection closes on it), ``"invalid"``
    (parse, length, expiry), ``"stream"`` (not one of ours), ``"pow"``
    (insufficient PoW; a connection closes on it) or ``"duplicate"``
    (already held)."""
    try:
        header = parse_object(payload)
    except VarintError as exc:
        logger.debug("malformed object header: %s", exc)
        return "varint"
    if header is None:
        return "invalid"
    if header.stream not in ctx.streams:
        return "stream"
    if not await ctx.pow_verifier.check(payload):
        logger.debug("insufficient PoW")
        return "pow"
    return store_object(ctx, pool, header, payload)


class BMConnection:
    """A framed Bitmessage peer connection over asyncio streams."""

    def __init__(self, pool: "ConnectionPool", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, outbound: bool,
                 host: str, port: int):
        self.pool = pool
        self.ctx = pool.ctx
        self.reader = reader
        self.writer = writer
        self.outbound = outbound
        self.host = host
        self.port = port
        self.tracker = ConnectionTracker(buckets=self.ctx.announce_buckets)
        self.services = 0
        self.streams: tuple[int, ...] = ()
        self.remote_protocol = 0
        self.user_agent = ""
        self.verack_received = False
        self.verack_sent = False
        self.fully_established = False
        self.tls_established = False
        self.last_activity = time.time()
        self._closed = False
        self.pending_upload: deque[bytes] = deque()
        #: getdata service suppressed until this time
        #: (antiIntersectionDelay, reference tcp.py:96-127)
        self.skip_until = 0.0
        self._connected_at = time.time()
        #: bounded per-connection clock-offset estimator, fed by the
        #: send timestamps of incoming wire trace contexts
        self.skew = SkewEstimator()
        #: bounded in-flight object-verification pipeline (per peer)
        self._verify_sem = asyncio.Semaphore(VERIFY_WINDOW)
        self._verify_tasks: set[asyncio.Task] = set()
        self._task: asyncio.Task | None = None
        self._handshake_task: asyncio.Task | None = None
        #: frames read and written, objects sent on getdata
        self.frames_rx = 0
        self.frames_tx = 0
        self.objects_sent = 0
        #: the most objects this connection had in its PoW window at once
        self.verify_window_peak = 0
        #: why the connection closed (``None`` while open, ``""`` for a
        #: local close)
        self.close_reason: str | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> asyncio.Task:
        self._task = asyncio.create_task(self._run())
        return self._task

    def arm_handshake_timeout(self, timeout: float) -> None:
        """Close the connection if version/verack has not completed
        within ``timeout`` seconds (a watchdog task, so the read loop
        itself stays untouched) — a black-holed peer must not hang the
        slot forever."""
        if timeout and timeout > 0 and not self.fully_established:
            self._handshake_task = asyncio.create_task(
                self._handshake_watchdog(timeout))

    async def _handshake_watchdog(self, timeout: float) -> None:
        try:
            await asyncio.sleep(timeout)
        except asyncio.CancelledError:
            return
        if not self.fully_established and not self._closed:
            HANDSHAKE_TIMEOUTS.inc()
            logger.debug("connection %s:%s handshake timed out after "
                         "%.0fs; closing", self.host, self.port, timeout)
            await self.close("handshake timeout")

    async def _run(self) -> None:
        reason = ""
        try:
            if self.outbound:
                await self.send_version()
            while True:
                await self._read_packet()
        except (ConnectionClosed, PacketError, MessageError, VarintError,
                asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
            reason = repr(exc)
            logger.debug("connection %s:%s closed: %r",
                         self.host, self.port, exc)
        except asyncio.CancelledError:
            pass
        except Exception as exc:
            reason = repr(exc)
            ERRORS.labels(site="net.parse").inc()
            logger.exception("connection %s:%s parser error",
                             self.host, self.port)
        finally:
            await self.close(reason)

    async def close(self, reason: str = "") -> None:
        if self._closed:
            return
        self._closed = True
        self.close_reason = reason
        # in-flight verifications are NOT cancelled: the payloads are
        # fully received, and cancelling would have another connection
        # download them again.  They settle within one verifier round;
        # node shutdown settles them as unverified (BatchVerifier.stop
        # sets False, never cancels).
        if self._handshake_task is not None and \
                not self._handshake_task.done() and \
                self._handshake_task is not asyncio.current_task():
            self._handshake_task.cancel()
        if self._task is not None and not self._task.done() and \
                self._task is not asyncio.current_task():
            self._task.cancel()
        try:
            self.writer.close()
            await asyncio.wait_for(self.writer.wait_closed(), 3.0)
        except Exception as exc:
            # a transport that fails to close cleanly is routine for a
            # dead peer, but is counted, never swallowed silently
            ERRORS.labels(site="net.close").inc()
            logger.debug("transport close for %s:%s failed: %r",
                         self.host, self.port, exc)
        self.pool.connection_closed(self)

    # -- framing -------------------------------------------------------------

    async def _read_chunked(self, n: int, sink) -> None:
        """THE throttled read loop: consume download tokens BEFORE each
        32 KiB chunk, so a burst cannot outrun ``maxdownloadrate``
        (reference asyncore_pollchoose.py:109-130), and hand each chunk
        to ``sink(offset, chunk)``."""
        bucket = self.ctx.download_bucket
        offset = 0
        while offset < n:
            take = min(n - offset, 32768)
            await bucket.consume(take)
            sink(offset, await self.reader.readexactly(take))
            offset += take
            # a paced transfer IS activity: the inactivity reaper must
            # not close a connection mid-payload
            self.last_activity = time.time()

    async def _read_throttled(self, n: int) -> bytes:
        """Read ``n`` bytes as ``bytes`` (header/resync-sized only —
        payloads fill a pooled buffer)."""
        if n == 0:
            return b""
        chunks: list[bytes] = []
        await self._read_chunked(n, lambda off, chunk: chunks.append(chunk))
        return chunks[0] if len(chunks) == 1 else b"".join(chunks)

    async def _read_packet(self) -> None:
        # ingest backpressure: while the validated-object queue sits
        # above its high watermark, stop reading — TCP flow control
        # pushes the flood back onto the peers instead of into memory
        await self.ctx.object_queue.wait_resume()
        header = await self._read_throttled(HEADER_LEN)
        # resync on bad magic: scan forward (reference bmproto.py:85-98)
        while not header.startswith(_MAGIC):
            nxt = header.find(_MAGIC[0:1], 1)
            if nxt == -1:
                header = await self._read_throttled(HEADER_LEN)
                continue
            header = header[nxt:] + await self._read_throttled(nxt)
        # a bad magic after resync or an oversize length raises
        # PacketError, which closes the connection
        try:
            command, length, checksum = unpack_header(header)
        except PacketError:
            PACKET_ERRORS.inc()
            raise
        # the payload fills a pooled buffer; checksum, object-header
        # parse, PoW check and duplicate detection run over views of
        # it, and only a NEW object (or a non-object command's payload)
        # becomes stable bytes
        buf = RECV_POOL.acquire(length)
        try:
            await self._read_chunked(length, buf.write_at)
            view = buf.view()
            if not verify_payload(view, checksum):
                PACKET_ERRORS.inc()
                raise ConnectionClosed("bad checksum")
            self.frames_rx += 1
            PACKETS_RX.inc()
            self.last_activity = time.time()
            if command == "object":
                await self.cmd_object(view, buf=buf)
                return
            if command == "tobject":
                await self.cmd_tobject(view, buf=buf)
                return
            handler = getattr(self, "cmd_" + command, None)
            if handler is None:
                logger.debug("unimplemented command %r", command)
                return
            await handler(buf.materialize())
        finally:
            buf.release()

    async def send_packet(self, command: str, payload: bytes = b"") -> None:
        inject("net.send")
        frame = pack_packet(command, payload)
        await self.ctx.upload_bucket.consume(len(frame))
        self.frames_tx += 1
        PACKETS_TX.inc()
        self.writer.write(frame)
        await self.writer.drain()

    # -- handshake -----------------------------------------------------------

    async def send_version(self) -> None:
        payload = VersionPayload(
            services=self.ctx.services,
            remote_host=self.host, remote_port=self.port,
            my_port=self.ctx.port, nonce=self.ctx.nonce,
            streams=tuple(self.ctx.streams)).encode()
        await self.send_packet("version", payload)

    async def cmd_version(self, payload: bytes) -> None:
        try:
            ver = VersionPayload.decode(payload)
        except Exception as exc:
            raise ConnectionClosed(f"bad version: {exc}") from exc
        # peer validity checks (reference bmproto.py:563-643)
        if ver.nonce == self.ctx.nonce:
            raise ConnectionClosed("connection to self")
        if ver.protocol_version < 3:
            await self.send_packet("error", encode_error(
                2, 0, b"", "protocol version too old"))
            raise ConnectionClosed("ancient protocol")
        if abs(ver.timestamp - time.time()) > MAX_TIME_OFFSET:
            await self.send_packet("error", encode_error(
                2, 0, b"", "time offset too large"))
            raise ConnectionClosed("time offset")
        if not set(ver.streams) & set(self.ctx.streams):
            raise ConnectionClosed("no stream overlap")
        self.remote_protocol = ver.protocol_version
        self.services = ver.services
        self.streams = ver.streams
        self.user_agent = ver.user_agent
        if not self.outbound:
            # knownnodes/addr-gossip must use the peer's advertised
            # LISTENING port, not the ephemeral source port we accepted
            self.port = ver.my_port
        # the OUTBOUND side veracks as soon as it has the peer's
        # version; the INBOUND side answers with its version and defers
        # its verack until the peer's verack has arrived.  The inbound
        # verack is then the last plaintext packet on the wire: when the
        # outbound side reads it and sends its ClientHello, the inbound
        # side has already swapped its transport, so no handshake byte
        # can strand in a plaintext buffer (the JAX package's order)
        if self.outbound:
            await self.send_packet("verack")
            self.verack_sent = True
        else:
            await self.send_version()
        if self.verack_sent and self.verack_received:
            await self._establish()

    async def cmd_verack(self, payload: bytes) -> None:
        if not self.remote_protocol:
            # verack before version: establishment would skip every
            # peer-validity check
            raise ConnectionClosed("verack before version")
        self.verack_received = True
        if not self.outbound and not self.verack_sent:
            await self.send_packet("verack")
            self.verack_sent = True
        if self.verack_sent:
            await self._establish()

    async def _upgrade_tls(self) -> None:
        """Mid-stream TLS after the verack exchange (reference
        tls.py:62-220, bmproto.py:552-560).  The handlers run inline in
        the read loop and a verack has no payload, so neither the
        stream reader nor a pooled receive buffer holds a byte past the
        verack when the transport is swapped."""
        from .tls import make_client_context, make_server_context
        if self.outbound:
            tls_ctx = make_client_context()
        else:
            tls_ctx = make_server_context(*self.ctx.tls_files)
        await self.writer.start_tls(tls_ctx, ssl_handshake_timeout=10)
        self.tls_established = True
        logger.debug("TLS established with %s:%s (%s)", self.host,
                     self.port, self.writer.get_extra_info("cipher"))

    async def _establish(self) -> None:
        if self.fully_established:
            return
        if self.ctx.tls_files is not None and self.services & NODE_SSL \
                and self.ctx.services & NODE_SSL:
            await self._upgrade_tls()
        self.fully_established = True
        if self._handshake_task is not None:
            self._handshake_task.cancel()
            self._handshake_task = None
        self._anti_intersection_delay(initial=True)
        await self._send_addr_sample()
        if not await self._start_sync():
            await self._send_big_inv()
        self.pool.connection_established(self)

    async def _start_sync(self) -> bool:
        """Negotiate set-reconciliation sync: when both ends advertise
        NODE_SYNC and a reconciler is attached, register the session and
        replace the big-inv flood with a digest-sized IBLT catch-up.
        The OUTBOUND end initiates (one exchange converges both
        directions).  Returns False when the classic big inv should be
        sent instead."""
        rec = getattr(self.pool, "reconciler", None)
        if rec is None or not self.services & NODE_SYNC \
                or not self.ctx.services & NODE_SYNC:
            return False
        rec.register(self)
        if not self.outbound:
            return True
        return await rec.start_catchup(self)

    async def _send_addr_sample(self) -> None:
        entries = []
        for stream in self.ctx.streams:
            peers = self.ctx.knownnodes.peers(stream)
            random.shuffle(peers)
            for p in peers[:MAX_ADDR_SAMPLE]:
                info = self.ctx.knownnodes.get(p, stream)
                if not info or info.get("self"):
                    continue
                try:
                    encode_host(p.host)
                except (OSError, ValueError):
                    # DNS bootstrap names / v3 onions aren't
                    # wire-encodable
                    continue
                entries.append(AddrEntry(
                    info["lastseen"], stream, 1, p.host, p.port))
        if entries:
            await self.send_packet("addr", encode_addr(entries))

    async def _send_big_inv(self) -> None:
        """Advertise our whole unexpired inventory per stream —
        excluding objects still in the dandelion stem phase, which must
        not be linkable to us (reference tcp.py:210-253)."""
        dand = self.ctx.dandelion
        for stream in self.ctx.streams:
            hashes = [
                h for h in self.ctx.inventory.unexpired_hashes_by_stream(
                    stream)
                if dand is None or not dand.in_stem_phase(h)]
            for i in range(0, len(hashes), BIG_INV_CHUNK):
                await self.send_packet(
                    "inv", encode_inv(hashes[i:i + BIG_INV_CHUNK]))

    # -- gossip --------------------------------------------------------------

    async def cmd_inv(self, payload: bytes) -> None:
        self._require_established()
        for h in decode_inv(payload):
            self._handle_inventory_announcement(h)

    async def cmd_dinv(self, payload: bytes) -> None:
        """Dandelion stem announcement (reference bmproto.py:340-360)."""
        self._require_established()
        hashes = decode_inv(payload)
        if self.ctx.dandelion is not None:
            for h in hashes:
                self.ctx.dandelion.add_hash(h, stream=1, source=self)
        for h in hashes:
            self._handle_inventory_announcement(h)

    def _handle_inventory_announcement(self, h: bytes) -> None:
        rec = getattr(self.pool, "reconciler", None)
        if rec is not None:
            # the peer has this object: drop it from the sync pending
            # set so neither a sketch nor an inv echoes it back
            rec.peer_announced(self, h)
        self.tracker.peer_announced(h)
        if h in self.ctx.inventory:
            self.tracker.object_received(h)
            return
        # a peer advertising more un-fetched objects than the whole
        # protocol allows is attacking our memory (reference
        # MAX_OBJECT_COUNT disconnect)
        if len(self.tracker.objects_new_to_me) > MAX_OBJECT_COUNT:
            raise ConnectionClosed("peer advertised too many objects")

    async def cmd_getdata(self, payload: bytes) -> None:
        self._require_established()
        for h in decode_inv(payload):
            if len(self.pending_upload) >= MAX_OBJECT_COUNT:
                break  # bounded backlog: a getdata flood can't grow memory
            self.pending_upload.append(h)
        await self.flush_uploads()

    def _anti_intersection_delay(self, initial: bool = False) -> None:
        """Defense against intersection attacks (reference
        tcp.py:96-127): pause getdata service for roughly the time a
        small object needs to propagate network-wide, (a) right after
        establishment and (b) whenever the peer requests an object we
        don't have."""
        nodes = max(len(self.ctx.knownnodes.peers(s) or ())
                    for s in self.ctx.streams) if self.ctx.streams else 0
        pending = self.tracker.pending_announcements()
        delay = math.ceil(math.log(nodes + 2, 20)) * (0.2 + pending / 2.0)
        if delay <= 0:
            return
        base = self._connected_at if initial else time.time()
        self.skip_until = max(self.skip_until, base + delay)

    async def flush_uploads(self, limit: int = 10) -> None:
        """Serve up to ``limit`` queued getdata requests (reference
        uploadthread.py:15-69).  Objects still in the dandelion stem
        phase are withheld from everyone but their stem child."""
        if time.time() < self.skip_until:
            return  # antiIntersectionDelay window — serve nothing yet
        dand = self.ctx.dandelion
        served = 0
        while self.pending_upload and served < limit:
            h = self.pending_upload.popleft()
            if dand is not None and dand.in_stem_phase(h) and \
                    dand.child_for(h) is not self:
                continue
            try:
                item = self.ctx.inventory[h]
            except KeyError:
                # edge role: a hash known to exist relay-side but not
                # held here is fetched over role IPC and served when the
                # payload lands, not treated as unknown
                fetcher = getattr(self.ctx, "payload_fetcher", None)
                if fetcher is not None and fetcher(h, self):
                    continue
                self._anti_intersection_delay()
                continue
            await self.send_object(h, item.payload)
            self.objects_sent += 1
            self.tracker.object_received(h)
            served += 1

    # -- wire trace context ---------------------------------------------------

    @property
    def trace_negotiated(self) -> bool:
        """Both ends advertised NODE_TRACE: sync payloads carry the
        32-byte trace trailer and object pushes travel as ``tobject``.
        Legacy peers (no bit) see the classic wire format, byte for
        byte."""
        return bool(self.services & NODE_TRACE
                    and self.ctx.services & NODE_TRACE)

    def attach_trace(self, command: str, payload: bytes) -> bytes:
        """Append the trace trailer for a sync-round payload when the
        peer negotiated NODE_TRACE (reconciler send hook; simulated
        connections simply lack this method)."""
        if not self.trace_negotiated:
            return payload
        ctx = TraceContext(self.ctx.nonce.ljust(16, b"\x00"), 0)
        TRACE_CTX_SENT.labels(command=command).inc()
        return append_trace_ctx(payload, ctx)

    def _strip_trace(self, command: str, payload: bytes) -> bytes:
        """Split and consume an incoming sync payload's trace trailer:
        feed the skew estimator, count it, hand back the bare payload.
        A malformed trailer is dropped (counted) without killing the
        round — telemetry must not break sync."""
        if not self.trace_negotiated:
            return payload
        try:
            payload, ctx = split_trace_ctx(payload)
        except MessageError:
            TRACE_CTX_INVALID.inc()
            return payload
        TRACE_CTX_RECEIVED.labels(command=command).inc()
        self.skew.observe(ctx.sent_at)
        return payload

    async def send_object(self, h: bytes, payload: bytes) -> None:
        """Push one object: a ``tobject`` frame (32-byte trace context
        + object payload) to NODE_TRACE peers so the receiver's
        lifecycle timeline joins this object's trace, the classic
        ``object`` frame otherwise."""
        if not self.trace_negotiated:
            await self.send_packet("object", payload)
            return
        ctx = LIFECYCLE.trace_ctx_for(h)
        if ctx is None:
            await self.send_packet("object", payload)
            return
        TRACE_CTX_SENT.labels(command="tobject").inc()
        await self.send_packet("tobject", ctx.encode() + payload)

    async def cmd_tobject(self, payload, *,
                          buf: PooledBuffer | None = None) -> None:
        """A trace-carrying object push.  Only trace-negotiated peers
        send these; from anyone else the command is ignored like any
        unknown command would be (the object will arrive again through
        normal paths)."""
        self._require_established()
        if not self.trace_negotiated or len(payload) <= TRACE_CTX_LEN:
            logger.debug("tobject from %s without negotiation; ignored",
                         self.host)
            return
        try:
            ctx = TraceContext.decode(bytes(payload[:TRACE_CTX_LEN]))
        except ValueError:
            TRACE_CTX_INVALID.inc()
            return
        TRACE_CTX_RECEIVED.labels(command="tobject").inc()
        self.skew.observe(ctx.sent_at)
        await self._handle_object(payload[TRACE_CTX_LEN:], buf=buf,
                                  trace_ctx=ctx)

    # -- objects -------------------------------------------------------------

    async def cmd_object(self, payload, *,
                         buf: PooledBuffer | None = None) -> None:
        self._require_established()
        await self._handle_object(payload, buf=buf)

    async def _handle_object(self, payload, *,
                             buf: PooledBuffer | None = None,
                             trace_ctx: TraceContext | None = None) -> None:
        """``payload`` is ``bytes`` or a memoryview over ``buf``; the
        checks run on either without copying.  ``trace_ctx`` is the
        wire trace context a ``tobject`` frame carried."""
        header = parse_object(payload)       # a VarintError closes us
        if header is None or header.stream not in self.ctx.streams:
            return
        # Bounded verification pipeline: the read loop keeps parsing (up
        # to VERIFY_WINDOW objects in flight) while the PoW checks
        # coalesce into device batches in the verifier's drain task.
        # The pooled buffer rides along retained until the task settles.
        await self._verify_sem.acquire()
        if buf is not None:
            buf.retain()
        task = asyncio.create_task(
            self._verify_and_accept(header, payload, buf, trace_ctx))
        self._verify_tasks.add(task)
        self.verify_window_peak = max(self.verify_window_peak,
                                      len(self._verify_tasks))
        task.add_done_callback(self._verify_task_done)

    def _verify_task_done(self, task: asyncio.Task) -> None:
        self._verify_tasks.discard(task)
        self._verify_sem.release()
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            logger.error("object acceptance failed on %s:%s",
                         self.host, self.port, exc_info=exc)

    async def _verify_and_accept(self, header, payload,
                                 buf: PooledBuffer | None = None,
                                 trace_ctx: TraceContext | None = None
                                 ) -> None:
        try:
            if not await self.ctx.pow_verifier.check(payload):
                logger.debug("insufficient PoW from %s", self.host)
                await self.close("object with insufficient PoW")
                return
            store_object(self.ctx, self.pool, header, payload, source=self,
                         trace_ctx=trace_ctx)
        finally:
            if buf is not None:
                buf.release()

    # -- set-reconciliation sync ----------------------------------------------

    def _reconciler(self):
        rec = getattr(self.pool, "reconciler", None)
        if rec is None or not rec.negotiated(self):
            logger.debug("sync message from %s without a negotiated "
                         "session; ignored", self.host)
            return None
        return rec

    async def cmd_sketchreq(self, payload: bytes) -> None:
        self._require_established()
        payload = self._strip_trace("sketchreq", payload)
        rec = self._reconciler()
        if rec is not None:
            await rec.handle_sketchreq(self, payload)

    async def cmd_sketch(self, payload: bytes) -> None:
        self._require_established()
        payload = self._strip_trace("sketch", payload)
        rec = self._reconciler()
        if rec is not None:
            await rec.handle_sketch(self, payload)

    async def cmd_recondiff(self, payload: bytes) -> None:
        self._require_established()
        payload = self._strip_trace("recondiff", payload)
        rec = self._reconciler()
        if rec is not None:
            await rec.handle_recondiff(self, payload)

    async def cmd_addr(self, payload: bytes) -> None:
        self._require_established()
        for entry in decode_addr(payload):
            if entry.stream not in self.ctx.streams:
                continue
            if not (1 <= entry.port <= 65535):
                continue
            if time.time() - entry.time > 10800 * 2:  # stale addr
                continue
            self.pool.peer_discovered(entry)

    # -- keepalive / errors --------------------------------------------------

    async def cmd_portcheck(self, payload: bytes) -> None:
        """Peer asks us to verify its advertised listen port is
        reachable (reference bmproto.py:477-479): queue a dial back to
        its source address + advertised port."""
        self.pool.portcheck_requested(Peer(self.host, self.port))

    async def cmd_ping(self, payload: bytes) -> None:
        await self.send_packet("pong")

    async def cmd_pong(self, payload: bytes) -> None:
        pass

    async def cmd_error(self, payload: bytes) -> None:
        fatal, _ban, _iv, text = decode_error(payload)
        logger.info("peer %s error (fatal=%d): %s", self.host, fatal, text)
        if fatal >= 2:
            raise ConnectionClosed("fatal peer error")

    def _require_established(self) -> None:
        if not self.fully_established:
            raise ConnectionClosed("command before handshake complete")

    # -- outgoing gossip helpers --------------------------------------------

    async def announce(self, hashes: list[bytes], stem: bool = False) -> None:
        if hashes:
            await self.send_packet("dinv" if stem else "inv",
                                   encode_inv(hashes))

    async def request_objects(self) -> None:
        """Request a fair share of missing objects (downloadthread.py)."""
        n_conns = max(1, len(self.pool.established()))
        wanted = []
        for h in self.tracker.request_batch(1000 // n_conns):
            if h in self.ctx.inventory:
                # obtained through another connection meanwhile: stop
                # tracking so it doesn't pin a pending-window slot
                self.tracker.object_received(h)
            elif not self.ctx.global_tracker.was_requested(h):
                wanted.append(h)
        if wanted:
            self.ctx.global_tracker.mark_requested(wanted, via=self)
            try:
                await self.send_packet("getdata", encode_inv(wanted))
            except (ConnectionError, OSError):
                # not sent: the next round (here or on another
                # connection) asks again
                self.ctx.global_tracker.forget(wanted)
                self.tracker.request_failed(wanted)
                raise
