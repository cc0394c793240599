"""The edge's light-client subscription plane (twin of
``pybitmessage_tpu.roles.subscription``; every frame is the JAX
package's byte for byte).

Light clients store and forward nothing: they SUBSCRIBE to a handful of
**digest buckets** (``sync/digest.py``) derived from their own addresses
and receive full payloads only for objects landing in those buckets.
The edge's cost per object is O(matched clients), not O(connected
clients): one inverted-index probe finds the subscriber set of the
object's bucket and the fan-out stops there.

One frame per message, with a fixed 8-byte header::

    magic(2) = 0xC1 0x07 | version(1) | type(1) | payload_len(u32 BE)

Messages:

``SUBSCRIBE`` (client -> edge)
    The client's full state: client id, farm tenant, its bucket count
    and per-stream bucket id lists, so a re-subscription after a
    reconnect is idempotent.
``SUB_ACK`` (edge -> client)
    Index epoch, the edge's authoritative bucket count and how many
    bucket subscriptions were accepted.  A client whose bucket count
    disagrees is accepted for zero buckets and re-derives its ids under
    the edge's count.
``UNSUBSCRIBE`` (client -> edge)
    Drop buckets (an empty bucket list drops the whole stream).
``DIGEST_DELTA`` (edge -> client)
    ``(bucket, count, xor)`` summaries of the client's subscribed
    buckets that changed.  A client whose local summary disagrees
    fetches the bucket: the repair that makes a reconnect converge with
    no subscribed object lost.
``OBJECT_PUSH`` (edge -> client) / ``OBJECT_ACK`` (client -> edge)
    One full object record under a monotonic per-session ``seq``; acks
    are cumulative.  A slow client's outbox at its watermark stops
    payload pushes for that client, which repairs later through
    DIGEST_DELTA + FETCH.
``FETCH`` (client -> edge)
    Catch-up: push every current object in the named buckets.
``POW_DELEGATE`` (client -> edge) / ``POW_RESULT`` (edge -> client)
    PoW proxied to the edge's solver farm (``powfarm/client.py``
    ``FarmClient``, one per client tenant) or, with no farm, solved by
    the edge's own ``PowDispatcher`` on the card.  A returned nonce is
    checked with ``host_trial`` before it is forwarded.
``PING``/``PONG``
    Liveness probe over the full framing path.

Client-labelled metrics ride the ``peer_bucket`` labeler.  The frame
send paths (both sides) plant the ``role.client`` chaos site.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import threading
import time
from collections import OrderedDict, deque

from ..observability import REGISTRY
from ..observability.metrics import peer_bucket
from ..resilience import inject
from ..resilience.policy import ERRORS
from ..sync.digest import DIGEST_BUCKETS, InventoryDigest, bucket_of
from . import ipc

logger = logging.getLogger("pybitmessage_tpu_torch.roles")

MAGIC = b"\xc1\x07"
VERSION = 1
HEADER = struct.Struct(">2sBBI")
HEADER_LEN = HEADER.size

#: hard frame ceiling — one object record plus headers; a Bitmessage
#: object tops out far below this, so anything larger is hostile
MAX_FRAME = 1 << 20

MSG_SUBSCRIBE = 1
MSG_SUB_ACK = 2
MSG_UNSUBSCRIBE = 3
MSG_DIGEST_DELTA = 4
MSG_OBJECT_PUSH = 5
MSG_OBJECT_ACK = 6
MSG_FETCH = 7
MSG_POW_DELEGATE = 8
MSG_POW_RESULT = 9
MSG_PING = 10
MSG_PONG = 11

#: bounded label vocabulary for the frame counter
FRAME_NAMES = {
    MSG_SUBSCRIBE: "subscribe", MSG_SUB_ACK: "sub_ack",
    MSG_UNSUBSCRIBE: "unsubscribe", MSG_DIGEST_DELTA: "digest_delta",
    MSG_OBJECT_PUSH: "object_push", MSG_OBJECT_ACK: "object_ack",
    MSG_FETCH: "fetch", MSG_POW_DELEGATE: "pow_delegate",
    MSG_POW_RESULT: "pow_result", MSG_PING: "ping", MSG_PONG: "pong",
}

#: POW_RESULT status codes (mirrors powfarm ST_*)
POW_OK = 0
POW_ERROR = 1
POW_REJECTED = 2

FRAMES = REGISTRY.counter(
    "client_plane_frames_total",
    "Light-client plane frames by type and direction",
    ("type", "direction"))
PUSHES = REGISTRY.counter(
    "client_plane_push_total",
    "Object payloads fanned to subscribed clients, by outcome — "
    "'overflow' is a slow client's watermark deferring it to "
    "DIGEST_DELTA + FETCH repair, never silent loss",
    ("result",))
DELTAS = REGISTRY.counter(
    "client_plane_delta_total",
    "DIGEST_DELTA frames pushed to subscribed clients")
FETCHES = REGISTRY.counter(
    "client_plane_fetch_total",
    "Catch-up FETCH records served, by outcome", ("result",))
SESSIONS = REGISTRY.gauge(
    "client_plane_sessions",
    "Connected light-client sessions on this edge")
SUBSCRIPTIONS = REGISTRY.gauge(
    "client_plane_subscriptions",
    "Live (stream, bucket) -> client memberships in the inverted "
    "index")
INDEX_EPOCH = REGISTRY.gauge(
    "client_plane_index_epoch",
    "Subscription-index epoch (bumps on every membership change and "
    "on a bucket-count rebucket)")
DELEGATES = REGISTRY.counter(
    "client_pow_delegate_total",
    "PoW jobs delegated by light clients through this edge, by "
    "terminal outcome", ("outcome",))
MATCH_FAN = REGISTRY.histogram(
    "client_plane_match_fan_size",
    "Subscribed clients matched per arriving object — the quantity "
    "that must stay O(matched), independent of connected clients",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))


class ClientProtocolError(ValueError):
    """Malformed client-plane frame or payload."""


def pack_frame(msg_type: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise ClientProtocolError(
            "frame payload %d > %d" % (len(payload), MAX_FRAME))
    FRAMES.labels(type=FRAME_NAMES.get(msg_type, "subscribe"),
                  direction="tx").inc()
    return HEADER.pack(MAGIC, VERSION, msg_type, len(payload)) + payload


def parse_header(data: bytes) -> tuple[int, int]:
    """-> (msg_type, payload_len); raises on bad magic/version/size."""
    magic, version, msg_type, length = HEADER.unpack(data)
    if magic != MAGIC:
        raise ClientProtocolError("bad client frame magic %r" % magic)
    if version != VERSION:
        raise ClientProtocolError(
            "unsupported client protocol version %d" % version)
    if length > MAX_FRAME:
        raise ClientProtocolError(
            "frame payload %d > %d" % (length, MAX_FRAME))
    return msg_type, length


async def read_frame(reader) -> tuple[int, bytes]:
    """Read one frame from an asyncio StreamReader."""
    header = await reader.readexactly(HEADER_LEN)
    msg_type, length = parse_header(header)
    payload = await reader.readexactly(length) if length else b""
    FRAMES.labels(type=FRAME_NAMES.get(msg_type, "subscribe"),
                  direction="rx").inc()
    return msg_type, payload


# -- field helpers ------------------------------------------------------------

def _pack_str(value: str | bytes, limit: int = 255) -> bytes:
    raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    if len(raw) > limit:
        raise ClientProtocolError(
            "field too long (%d > %d)" % (len(raw), limit))
    return bytes((len(raw),)) + raw


def _unpack_str(data: bytes, offset: int) -> tuple[bytes, int]:
    if offset >= len(data):
        raise ClientProtocolError("truncated client payload")
    n = data[offset]
    end = offset + 1 + n
    if end > len(data):
        raise ClientProtocolError("truncated client payload")
    return data[offset + 1:end], end


def _pack_entries(entries) -> bytes:
    """``[(stream, [buckets])]`` -> wire bytes."""
    out = struct.pack(">H", len(entries))
    for stream, buckets in entries:
        out += struct.pack(">IH", stream, len(buckets))
        out += b"".join(struct.pack(">H", b) for b in buckets)
    return out


def _unpack_entries(data: bytes, offset: int):
    try:
        (n,) = struct.unpack_from(">H", data, offset)
        offset += 2
        entries = []
        for _ in range(n):
            stream, nb = struct.unpack_from(">IH", data, offset)
            offset += 6
            buckets = struct.unpack_from(">%dH" % nb, data, offset)
            offset += 2 * nb
            entries.append((stream, tuple(buckets)))
        return entries, offset
    except struct.error as exc:
        raise ClientProtocolError("truncated bucket entries: %s" % exc)


# -- messages -----------------------------------------------------------------

def encode_subscribe(client_id: str, tenant: str, bucket_count: int,
                     entries) -> bytes:
    """``entries`` = [(stream, [bucket ids])] — the client's FULL
    desired subscription state."""
    return (_pack_str(client_id, 64) + _pack_str(tenant, 64)
            + struct.pack(">H", bucket_count) + _pack_entries(entries))


def decode_subscribe(data: bytes):
    """-> (client_id, tenant, bucket_count, entries)."""
    client_id, off = _unpack_str(data, 0)
    tenant, off = _unpack_str(data, off)
    try:
        (bucket_count,) = struct.unpack_from(">H", data, off)
    except struct.error as exc:
        raise ClientProtocolError("truncated subscribe: %s" % exc)
    entries, _ = _unpack_entries(data, off + 2)
    return (client_id.decode("utf-8", "replace"),
            tenant.decode("utf-8", "replace"), bucket_count, entries)


_SUB_ACK = struct.Struct(">QHI")


def encode_sub_ack(epoch: int, bucket_count: int, accepted: int) -> bytes:
    return _SUB_ACK.pack(epoch, bucket_count, accepted)


def decode_sub_ack(data: bytes) -> tuple[int, int, int]:
    """-> (epoch, bucket_count, accepted)."""
    try:
        return _SUB_ACK.unpack_from(data, 0)
    except struct.error as exc:
        raise ClientProtocolError("truncated sub_ack: %s" % exc)


def encode_unsubscribe(entries) -> bytes:
    return _pack_entries(entries)


def decode_unsubscribe(data: bytes):
    entries, _ = _unpack_entries(data, 0)
    return entries


def encode_digest_delta(epoch: int, bucket_count: int, stream: int,
                        summaries) -> bytes:
    """``summaries`` = [(bucket, count, xor)] for CHANGED buckets."""
    out = struct.pack(">QHIH", epoch, bucket_count, stream,
                      len(summaries))
    for bucket, count, xor in summaries:
        out += struct.pack(">HIQ", bucket, count, xor & (2 ** 64 - 1))
    return out


def decode_digest_delta(data: bytes):
    """-> (epoch, bucket_count, stream, [(bucket, count, xor)])."""
    try:
        epoch, bucket_count, stream, n = struct.unpack_from(
            ">QHIH", data, 0)
        off, summaries = struct.calcsize(">QHIH"), []
        for _ in range(n):
            summaries.append(struct.unpack_from(">HIQ", data, off))
            off += struct.calcsize(">HIQ")
        return epoch, bucket_count, stream, summaries
    except struct.error as exc:
        raise ClientProtocolError("truncated digest delta: %s" % exc)


def encode_object_push(seq: int, record: bytes) -> bytes:
    """``record`` is a pre-encoded :func:`ipc.encode_record` blob."""
    return struct.pack(">Q", seq) + record


def decode_object_push(data: bytes):
    """-> (seq, (hash, type, stream, expires, tag, payload))."""
    try:
        (seq,) = struct.unpack_from(">Q", data, 0)
    except struct.error as exc:
        raise ClientProtocolError("truncated object push: %s" % exc)
    try:
        record, _ = ipc.decode_record(data, 8)
    except ipc.IPCError as exc:
        raise ClientProtocolError(str(exc))
    return seq, record


def encode_object_ack(seq: int) -> bytes:
    return struct.pack(">Q", seq)


def decode_object_ack(data: bytes) -> int:
    try:
        (seq,) = struct.unpack_from(">Q", data, 0)
        return seq
    except struct.error as exc:
        raise ClientProtocolError("truncated object ack: %s" % exc)


def encode_fetch(stream: int, buckets) -> bytes:
    return (struct.pack(">IH", stream, len(buckets))
            + b"".join(struct.pack(">H", b) for b in buckets))


def decode_fetch(data: bytes) -> tuple[int, tuple[int, ...]]:
    try:
        stream, n = struct.unpack_from(">IH", data, 0)
        return stream, tuple(struct.unpack_from(">%dH" % n, data, 6))
    except struct.error as exc:
        raise ClientProtocolError("truncated fetch: %s" % exc)


def encode_pow_delegate(job_ref: int, initial_hash: bytes, target: int,
                        deadline_ms: int = 0) -> bytes:
    return (struct.pack(">QQI", job_ref, target & (2 ** 64 - 1),
                        deadline_ms)
            + _pack_str(initial_hash, 128))


def decode_pow_delegate(data: bytes):
    """-> (job_ref, initial_hash, target, deadline_ms)."""
    try:
        job_ref, target, deadline_ms = struct.unpack_from(">QQI", data, 0)
    except struct.error as exc:
        raise ClientProtocolError("truncated pow delegate: %s" % exc)
    initial_hash, _ = _unpack_str(data, struct.calcsize(">QQI"))
    return job_ref, bytes(initial_hash), target, deadline_ms


def encode_pow_result(job_ref: int, status: int, nonce: int = 0,
                      trials: int = 0, detail: str = "") -> bytes:
    return (struct.pack(">QBQQ", job_ref, status,
                        nonce & (2 ** 64 - 1), trials & (2 ** 64 - 1))
            + _pack_str(detail, 160))


def decode_pow_result(data: bytes):
    """-> (job_ref, status, nonce, trials, detail)."""
    try:
        job_ref, status, nonce, trials = struct.unpack_from(
            ">QBQQ", data, 0)
    except struct.error as exc:
        raise ClientProtocolError("truncated pow result: %s" % exc)
    detail, _ = _unpack_str(data, struct.calcsize(">QBQQ"))
    return job_ref, status, nonce, trials, detail.decode(
        "utf-8", "replace")


def routing_key(tag: bytes, h: bytes) -> bytes:
    """The bucket key of one object: its address-derived tag when it
    carries one (getpubkey/pubkey v4+, broadcast v5+ — the kinds a
    client can PREDICT from an address), else its inventory hash
    (msgs carry no addressing by design; clients wanting them
    subscribe to bucket ranges and trial-decrypt locally)."""
    return tag if tag else h


# ---------------------------------------------------------------------------
# the inverted index
# ---------------------------------------------------------------------------

class SubscriptionIndex:
    """Bucket -> client-set inverted index, bounded and
    epoch-versioned (the shard map's idiom): every
    membership change bumps ``epoch``, and a bucket-count ``rebucket``
    clears all memberships (clients re-derive their ids under the new
    count — the index cannot, since clients reveal buckets, never
    addresses).  Thread-safe: subscribe/unsubscribe churn races object
    fan-out probes by design.

    The membership count is kept as it changes, so a ``replace`` costs
    O(its own buckets); the JAX index recounts every client's set on
    each change (its ``_export`` and ``__len__``), which makes filling
    it with N clients O(N^2).  The decisions are the same."""

    def __init__(self, buckets: int = DIGEST_BUCKETS,
                 max_clients: int = 1 << 17,
                 max_buckets_per_client: int = 4096):
        self.buckets = buckets
        self.max_clients = max_clients
        self.max_buckets_per_client = max_buckets_per_client
        self.epoch = 1
        self._lock = threading.RLock()
        #: (stream, bucket) -> set of client ids
        self._members: dict[tuple[int, int], set[str]] = {}
        #: client id -> set of (stream, bucket) — the churn reverse map
        self._subs: dict[str, set[tuple[int, int]]] = {}
        #: live (stream, bucket) -> client memberships, kept as they change
        self._memberships = 0

    def __len__(self) -> int:
        with self._lock:
            return self._memberships

    def client_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def replace(self, client: str, entries) -> int:
        """Adopt a client's FULL desired state (the SUBSCRIBE
        semantics); returns how many (stream, bucket) memberships were
        accepted.  Out-of-range buckets are dropped, the per-client
        bucket cap and the client cap are enforced."""
        with self._lock:
            if client not in self._subs and \
                    len(self._subs) >= self.max_clients:
                return 0
            wanted: set[tuple[int, int]] = set()
            for stream, buckets in entries:
                for b in buckets:
                    if 0 <= b < self.buckets and \
                            len(wanted) < self.max_buckets_per_client:
                        wanted.add((stream, b))
            current = self._subs.get(client, set())
            for key in current - wanted:
                self._drop_membership(client, key)
            for key in wanted - current:
                self._members.setdefault(key, set()).add(client)
            self._memberships += len(wanted) - len(current)
            self._subs[client] = wanted
            if not wanted:
                self._subs.pop(client, None)
            self.epoch += 1
            self._export()
            return len(wanted)

    def unsubscribe(self, client: str, entries) -> None:
        """Drop specific buckets; an entry with an empty bucket list
        drops the client's whole stream."""
        with self._lock:
            current = self._subs.get(client)
            if current is None:
                return
            for stream, buckets in entries:
                doomed = [k for k in current if k[0] == stream
                          and (not buckets or k[1] in buckets)]
                for key in doomed:
                    self._drop_membership(client, key)
                    current.discard(key)
                self._memberships -= len(doomed)
            if not current:
                self._subs.pop(client, None)
            self.epoch += 1
            self._export()

    def drop(self, client: str) -> None:
        """Forget a disconnected client entirely — convergence after a
        reconnect is digest-driven (re-subscribe + FETCH), so dead
        clients must not keep costing fan-out probes."""
        with self._lock:
            gone = self._subs.pop(client, set())
            for key in gone:
                self._drop_membership(client, key)
            self._memberships -= len(gone)
            self.epoch += 1
            self._export()

    def _drop_membership(self, client: str, key) -> None:
        members = self._members.get(key)
        if members is not None:
            members.discard(client)
            if not members:
                del self._members[key]

    def clients_for(self, stream: int, bucket: int) -> tuple[str, ...]:
        """The object-arrival probe: subscribers of ONE bucket."""
        with self._lock:
            return tuple(self._members.get((stream, bucket), ()))

    def subscribers_of(self, stream: int, buckets) -> dict:
        """client -> [buckets] for a set of (dirty) buckets — the
        delta push grouping, still O(members of those buckets)."""
        out: dict[str, list[int]] = {}
        with self._lock:
            for b in buckets:
                for client in self._members.get((stream, b), ()):
                    out.setdefault(client, []).append(b)
        return out

    def buckets_of(self, client: str) -> dict:
        """stream -> sorted bucket list for one client."""
        out: dict[int, list[int]] = {}
        with self._lock:
            for stream, b in self._subs.get(client, ()):
                out.setdefault(stream, []).append(b)
        return {s: sorted(bs) for s, bs in out.items()}

    def rebucket(self, buckets: int) -> None:
        """Adopt a new bucket count: all memberships clear (derived
        ids are meaningless under the new count) and the epoch bump
        makes every next SUB_ACK/DIGEST_DELTA carry the new count, so
        clients re-derive and re-subscribe."""
        if buckets < 1:
            raise ValueError("bucket count must be >= 1")
        with self._lock:
            self.buckets = buckets
            self._members.clear()
            self._subs.clear()
            self._memberships = 0
            self.epoch += 1
            self._export()

    def _export(self) -> None:
        SUBSCRIPTIONS.set(self._memberships)
        INDEX_EPOCH.set(self.epoch)

    def snapshot(self) -> dict:
        with self._lock:
            return {"epoch": self.epoch, "buckets": self.buckets,
                    "clients": len(self._subs),
                    "memberships": self._memberships}


# ---------------------------------------------------------------------------
# the edge-side plane
# ---------------------------------------------------------------------------

#: per-client outbox watermark (queued + un-acked pushes) beyond which
#: payload pushes stop for that client (delta+fetch repairs later)
CLIENT_OUTBOX_HIGH = 512
#: max records served per FETCH frame (a client re-fetches for more)
FETCH_MAX = 4096
#: dirty-bucket delta flush cadence, seconds
DELTA_INTERVAL = 0.05
#: farm connections kept per distinct client tenant (LRU)
FARM_POOL_MAX = 64


class _ClientSession:
    """One connected light client: identity, its acked outbox and the
    writer task (the EdgeLink outbox shape, per client)."""

    def __init__(self, plane: "ClientPlane", writer: asyncio.StreamWriter):
        self.plane = plane
        self.writer = writer
        self.client_id = ""
        self.tenant = ""
        self.connected_at = time.monotonic()
        #: encoded record blobs awaiting a push slot
        self.outbox: deque[bytes] = deque()
        #: seq -> encoded record awaiting a (cumulative) OBJECT_ACK
        self.unacked: "OrderedDict[int, bytes]" = OrderedDict()
        #: control frames (SUB_ACK/DELTA/POW_RESULT/PONG) jump pushes
        self.control: deque[bytes] = deque()
        self.seq = 0
        self.pushed = 0
        self.acked = 0
        self.overflowed = 0
        self._wakeup = asyncio.Event()
        self._writer_task: asyncio.Task | None = None

    def depth(self) -> int:
        return len(self.outbox) + len(self.unacked)

    def push(self, record: bytes, force: bool = False) -> bool:
        """Queue one payload push; False = watermark hit (the client
        repairs via DIGEST_DELTA + FETCH — deferred, never lost).
        ``force`` bypasses the watermark: FETCH replies are client-
        paced (the client asked, one bounded frame at a time), so
        dropping them would leave a backpressured client with no
        repair path at all — the watermark only guards UNSOLICITED
        fan-out."""
        if not force and self.depth() >= self.plane.outbox_high:
            self.overflowed += 1
            PUSHES.labels(result="overflow").inc()
            return False
        self.outbox.append(record)
        PUSHES.labels(result="queued").inc()
        self._wakeup.set()
        return True

    def send_control(self, frame: bytes) -> None:
        self.control.append(frame)
        self._wakeup.set()

    def ack(self, seq: int) -> None:
        """Cumulative: drop every un-acked push at or below ``seq``."""
        while self.unacked:
            first = next(iter(self.unacked))
            if first > seq:
                break
            del self.unacked[first]
            self.acked += 1
        self._wakeup.set()

    def start_writer(self) -> None:
        self._writer_task = asyncio.create_task(self._send_loop())

    async def stop_writer(self) -> None:
        if self._writer_task is not None:
            self._writer_task.cancel()
            try:
                await self._writer_task
            except asyncio.CancelledError:
                pass

    async def _send_loop(self) -> None:
        try:
            while True:
                if not self.control and not self.outbox:
                    self._wakeup.clear()
                    await self._wakeup.wait()
                while self.control:
                    # peek-send-pop: a failed send leaves the frame at
                    # the head (the EdgeLink control idiom)
                    frame = self.control[0]
                    inject("role.client")
                    self.writer.write(frame)
                    await self.writer.drain()
                    self.control.popleft()
                while self.outbox:
                    record = self.outbox.popleft()
                    self.seq += 1
                    self.unacked[self.seq] = record
                    inject("role.client")
                    self.writer.write(pack_frame(
                        MSG_OBJECT_PUSH,
                        encode_object_push(self.seq, record)))
                    await self.writer.drain()
                    self.pushed += 1
                    PUSHES.labels(result="sent").inc()
        except asyncio.CancelledError:
            raise
        except (OSError, ConnectionError) as exc:
            ERRORS.labels(site="role.client").inc()
            logger.debug("client session %s send failed: %r",
                         peer_bucket(self.client_id), exc)
            self.writer.close()


class ClientPlane:
    """The edge-side subscription server: the inverted index, a
    routing-key-bucketed :class:`InventoryDigest` (the filter the
    deltas summarize), per-session acked outboxes, FETCH catch-up
    service from the edge's payload cache, and the farm POW proxy."""

    def __init__(self, node, listen: str, *,
                 buckets: int = DIGEST_BUCKETS):
        self.node = node
        host, _, port = str(listen).rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.index = SubscriptionIndex(buckets)
        #: the plane's own digest, bucketed by ROUTING KEY (tag when
        #: present) — distinct from the peer-sync digest, which must
        #: stay hash-bucketed to match remote peers
        self.digest = InventoryDigest(buckets=buckets)
        #: client id -> live session (latest connection wins)
        self.sessions: dict[str, _ClientSession] = {}
        self.outbox_high = CLIENT_OUTBOX_HIGH
        self.delta_interval = DELTA_INTERVAL
        self.fetch_max = FETCH_MAX
        #: stream -> set of buckets dirtied since the last delta flush
        self._dirty: dict[int, set[int]] = {}
        self._server: asyncio.AbstractServer | None = None
        self._delta_task: asyncio.Task | None = None
        self._pow_tasks: set[asyncio.Task] = set()
        #: client tenant -> blocking FarmClient (bounded LRU)
        self._farms: "OrderedDict[str, object]" = OrderedDict()
        self._pow_executor = None
        self.delegated_ok = 0
        self.delegated_err = 0

    @property
    def listen_port(self) -> int:
        if self._server is None or not self._server.sockets:
            return self.port
        return self._server.sockets[0].getsockname()[1]

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port)
        self._delta_task = asyncio.create_task(self._delta_loop())
        logger.info("client plane listening on %s:%d (%d buckets)",
                    self.host, self.listen_port, self.index.buckets)

    async def stop(self) -> None:
        if self._delta_task is not None:
            self._delta_task.cancel()
            try:
                await self._delta_task
            except asyncio.CancelledError:
                pass
        for task in list(self._pow_tasks):
            task.cancel()
        if self._pow_tasks:
            await asyncio.gather(*self._pow_tasks,
                                 return_exceptions=True)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for session in list(self.sessions.values()):
            await session.stop_writer()
        self.sessions.clear()
        SESSIONS.set(0)
        for farm in self._farms.values():
            farm.close()
        self._farms.clear()
        if self._pow_executor is not None:
            self._pow_executor.shutdown(wait=False)

    def rebucket(self, buckets: int) -> None:
        """Adopt a new bucket count live: index memberships clear,
        the plane digest re-buckets in place, and every connected
        session is told via an empty DIGEST_DELTA carrying the new
        count — clients re-derive and re-subscribe."""
        self.index.rebucket(buckets)
        self.digest.resize(buckets)
        self._dirty.clear()
        frame = pack_frame(MSG_DIGEST_DELTA, encode_digest_delta(
            self.index.epoch, buckets, 0, []))
        for session in self.sessions.values():
            session.send_control(frame)

    # -- object arrival (the O(matched) hot path) ----------------------------

    def on_object(self, h: bytes, header, payload) -> None:
        """Hot-path hook from the edge's object pump: ONE index probe
        plus fan-out to the (usually tiny) matched subscriber set."""
        from ..models.objects import extract_tag
        tag = extract_tag(header, payload)
        self.on_record(h, header.object_type, header.stream,
                       header.expires, tag, bytes(payload))

    def on_record(self, h: bytes, type_: int, stream: int, expires: int,
                  tag: bytes, payload: bytes) -> None:
        """Record-shaped entrance (relay OBJECT_PUSH arrivals)."""
        if h in self.digest:
            return
        key = routing_key(tag, h)
        self.digest.add(h, stream, expires, key=key)
        bucket = bucket_of(key, self.index.buckets)
        self._dirty.setdefault(stream, set()).add(bucket)
        clients = self.index.clients_for(stream, bucket)
        MATCH_FAN.observe(len(clients))
        if not clients:
            return
        record = ipc.encode_record(h, type_, stream, expires, tag,
                                   payload)
        for cid in clients:
            session = self.sessions.get(cid)
            if session is not None:
                session.push(record)

    # -- the digest-delta push loop ------------------------------------------

    async def _delta_loop(self) -> None:
        while True:
            await asyncio.sleep(self.delta_interval)
            self.flush_deltas()

    def flush_deltas(self) -> None:
        """Push per-client DIGEST_DELTA frames for buckets dirtied
        since the last flush — grouped per client, subscribed buckets
        only (an unsubscribed bucket's churn is nobody's traffic)."""
        dirty, self._dirty = self._dirty, {}
        epoch = self.index.epoch
        count = self.index.buckets
        for stream, buckets in dirty.items():
            grouped = self.index.subscribers_of(stream, buckets)
            if not grouped:
                continue
            summaries = self.digest.summaries(stream)
            for cid, bs in grouped.items():
                session = self.sessions.get(cid)
                if session is None:
                    continue
                entries = [(b, summaries[b][0], summaries[b][1])
                           for b in sorted(bs) if b < len(summaries)]
                session.send_control(pack_frame(
                    MSG_DIGEST_DELTA, encode_digest_delta(
                        epoch, count, stream, entries)))
                DELTAS.inc()

    # -- serving -------------------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        session = _ClientSession(self, writer)
        session.start_writer()
        try:
            while True:
                msg_type, payload = await read_frame(reader)
                self._dispatch(session, msg_type, payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except ClientProtocolError as exc:
            ERRORS.labels(site="role.client").inc()
            logger.debug("client session %s protocol error: %r",
                         peer_bucket(session.client_id), exc)
        finally:
            await session.stop_writer()
            try:
                writer.close()
            except OSError:
                pass    # already torn down
            if session.client_id and \
                    self.sessions.get(session.client_id) is session:
                del self.sessions[session.client_id]
                self.index.drop(session.client_id)
            SESSIONS.set(len(self.sessions))

    def _dispatch(self, session: _ClientSession, msg_type: int,
                  payload: bytes) -> None:
        if msg_type == MSG_SUBSCRIBE:
            self._on_subscribe(session, payload)
        elif msg_type == MSG_UNSUBSCRIBE:
            if session.client_id:
                self.index.unsubscribe(session.client_id,
                                       decode_unsubscribe(payload))
        elif msg_type == MSG_OBJECT_ACK:
            session.ack(decode_object_ack(payload))
        elif msg_type == MSG_FETCH:
            self._on_fetch(session, payload)
        elif msg_type == MSG_POW_DELEGATE:
            task = asyncio.create_task(
                self._delegate(session, payload))
            self._pow_tasks.add(task)
            task.add_done_callback(self._pow_tasks.discard)
        elif msg_type == MSG_PING:
            session.send_control(pack_frame(MSG_PONG, b""))
        else:
            logger.debug("client plane: unexpected frame type %d",
                         msg_type)

    def _on_subscribe(self, session: _ClientSession,
                      payload: bytes) -> None:
        client_id, tenant, bucket_count, entries = \
            decode_subscribe(payload)
        old = self.sessions.get(client_id)
        if old is not None and old is not session:
            # a reconnect raced the old session's teardown: the new
            # connection wins (latest wins)
            old.control.clear()
            old.outbox.clear()
        session.client_id = client_id
        session.tenant = tenant or client_id
        self.sessions[client_id] = session
        SESSIONS.set(len(self.sessions))
        if bucket_count != self.index.buckets:
            # bucket-count disagreement: accept nothing, return the
            # authoritative count — the client re-derives its ids
            accepted = 0
        else:
            accepted = self.index.replace(client_id, entries)
        session.send_control(pack_frame(MSG_SUB_ACK, encode_sub_ack(
            self.index.epoch, self.index.buckets, accepted)))

    def _on_fetch(self, session: _ClientSession, payload: bytes) -> None:
        stream, buckets = decode_fetch(payload)
        inventory = self.node.inventory
        served = 0
        for h in self.digest.hashes_in_buckets(stream, buckets):
            if served >= self.fetch_max:
                break
            try:
                item = inventory[h]
            except KeyError:
                # known but evicted from the edge cache: the bounded-
                # cache tradeoff, counted so operators can size it
                FETCHES.labels(result="miss").inc()
                continue
            session.push(ipc.encode_record(
                h, item.type, item.stream, item.expires, item.tag,
                item.payload), force=True)
            FETCHES.labels(result="served").inc()
            served += 1

    # -- farm-delegated PoW ---------------------------------------------------

    def _executor(self):
        if self._pow_executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pow_executor = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="bmtpu-clientpow")
        return self._pow_executor

    def _farm_for(self, tenant: str):
        """A blocking FarmClient under the CLIENT'S tenant (bounded
        LRU pool) — per-client attribution rides the farm's existing
        ``farm_tenant_cpu_seconds_total`` join, nothing new."""
        farm = self._farms.get(tenant)
        if farm is not None:
            self._farms.move_to_end(tenant)
            return farm
        node_farm = getattr(self.node, "farm_client", None)
        if node_farm is None:
            return None
        from ..powfarm.client import FarmClient
        farm = FarmClient(
            node_farm.client.host, node_farm.client.port,
            tenant=tenant, secret=node_farm.client.secret,
            timeout=node_farm.client.timeout)
        self._farms[tenant] = farm
        while len(self._farms) > FARM_POOL_MAX:
            _, evicted = self._farms.popitem(last=False)
            evicted.close()
        return farm

    async def _delegate(self, session: _ClientSession,
                        payload: bytes) -> None:
        job_ref, initial_hash, target, deadline_ms = \
            decode_pow_delegate(payload)
        tenant = session.tenant or "client"
        deadline_s = deadline_ms / 1e3 if deadline_ms else None
        loop = asyncio.get_running_loop()
        try:
            farm = self._farm_for(tenant)
            if farm is not None:
                results = await loop.run_in_executor(
                    self._executor(), lambda: farm.solve_batch(
                        [(initial_hash, target)],
                        deadline_s=deadline_s))
            else:
                # no farm configured: solve on the edge's own dispatcher,
                # still attributed to the client (bucketed — local
                # label values must stay bounded)
                from ..observability.metrics import peer_bucket_label
                from ..powfarm.server import TENANT_CPU
                t0 = time.monotonic()
                results = await loop.run_in_executor(
                    self._executor(),
                    lambda: [self.node.solver(initial_hash, target)])
                TENANT_CPU.labels(tenant=peer_bucket_label(
                    "client.pow", tenant)).inc(time.monotonic() - t0)
            nonce, trials = results[0]
            from ..pow.dispatcher import host_trial
            if host_trial(nonce, initial_hash) > target:
                raise ValueError("delegated nonce failed host "
                                 "verification")
            self.delegated_ok += 1
            DELEGATES.labels(outcome="ok").inc()
            session.send_control(pack_frame(
                MSG_POW_RESULT, encode_pow_result(
                    job_ref, POW_OK, nonce, trials)))
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self.delegated_err += 1
            DELEGATES.labels(outcome="error").inc()
            ERRORS.labels(site="role.client").inc()
            logger.debug("client pow delegation failed: %r", exc)
            session.send_control(pack_frame(
                MSG_POW_RESULT, encode_pow_result(
                    job_ref, POW_ERROR, detail=str(exc)[:150])))

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        sessions = list(self.sessions.values())
        return {
            "listen": "%s:%d" % (self.host, self.listen_port),
            "sessions": len(sessions),
            "index": self.index.snapshot(),
            "digestObjects": len(self.digest),
            "outboxDepth": sum(s.depth() for s in sessions),
            "pushed": sum(s.pushed for s in sessions),
            "overflowed": sum(s.overflowed for s in sessions),
            "farmDelegation": {
                "ok": self.delegated_ok,
                "errors": self.delegated_err,
                "tenants": len(self._farms),
                "endpoint": ("%s:%d" % (self.node.farm_client.client.host,
                                        self.node.farm_client.client.port)
                             if getattr(self.node, "farm_client", None)
                             is not None else None),
            },
        }
