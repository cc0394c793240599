"""Length-prefixed wire protocol for the PoW solver farm (copy of
``pybitmessage_tpu.powfarm.protocol``: its frames byte for byte).

One frame per message, fixed 8-byte header::

    magic(2) = 0xFA 0x12 | version(1) | type(1) | payload_len(u32 BE)

followed by ``payload_len`` bytes of message payload.  Everything is
big-endian, mirroring the Bitmessage wire convention.  The protocol is
deliberately tiny — four message kinds carry the whole job lifecycle —
and versioned per frame so a future farm can speak to older edges.

Messages:

``SUBMIT`` (client -> farm)
    One PoW job: tenant id, priority lane, ``initial_hash``, target,
    an optional resumable ``start_nonce`` (journal checkpoint), an
    optional deadline (the client's remaining time budget — deadline
    propagation across the wire), an optional 32-byte wire trace
    context (carried here as opaque bytes: this package neither sends
    nor decodes one) and an optional HMAC-SHA256 over the preceding payload bytes keyed by the
    tenant's shared secret (signed submissions).
``ACCEPT`` (farm -> client)
    The job passed admission: journal job id, current queue depth and
    the scheduler's wait estimate.
``REJECT`` (farm -> client)
    Admission refused *before* the queue melts: a bounded reason
    string plus ``retry_after`` — the client backs off or falls back
    to local solving (no job is ever silently dropped).
``RESULT`` (farm -> client)
    Terminal job outcome: ``ok`` (nonce + trials), ``error`` (the
    ladder exhausted its attempts; the job stays journaled farm-side)
    or ``expired`` (the deadline passed while queued).  Queue-wait and
    solve latency ride along so the edge can attribute both without a
    second round trip.

``PING``/``PONG`` frames give clients a liveness probe that exercises
the full framing path.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import socket as _socket
import struct
import time as _time
from dataclasses import dataclass, field

MAGIC = b"\xfa\x12"
VERSION = 1
HEADER = struct.Struct(">2sBBI")
HEADER_LEN = HEADER.size

#: hard frame ceiling — a farm job is a few hundred bytes; anything
#: larger is a broken or hostile peer
MAX_FRAME = 1 << 16

MSG_SUBMIT = 1
MSG_ACCEPT = 2
MSG_REJECT = 3
MSG_RESULT = 4
MSG_PING = 5
MSG_PONG = 6

#: priority lanes (tentpole): a user-visible message send vs a bulk
#: broadcast/storm batch
LANE_INTERACTIVE = "interactive"
LANE_BULK = "bulk"
LANES = (LANE_INTERACTIVE, LANE_BULK)
_LANE_CODE = {LANE_INTERACTIVE: 0, LANE_BULK: 1}
_LANE_NAME = {0: LANE_INTERACTIVE, 1: LANE_BULK}

#: RESULT status codes
ST_OK = 0
ST_ERROR = 1
ST_EXPIRED = 2

MAC_LEN = 32


class ProtocolError(ValueError):
    """Malformed frame or payload."""


def compute_mac(secret: bytes, payload: bytes) -> bytes:
    """HMAC-SHA256 of a SUBMIT payload (sans the mac field itself)."""
    return _hmac.new(secret, payload, hashlib.sha256).digest()


def mac_ok(secret: bytes, payload: bytes, mac: bytes) -> bool:
    return _hmac.compare_digest(compute_mac(secret, payload), mac)


def pack_frame(msg_type: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise ProtocolError("frame payload %d > %d" % (len(payload),
                                                       MAX_FRAME))
    return HEADER.pack(MAGIC, VERSION, msg_type, len(payload)) + payload


def parse_header(data: bytes) -> tuple[int, int]:
    """-> (msg_type, payload_len); raises on bad magic/version/size."""
    magic, version, msg_type, length = HEADER.unpack(data)
    if magic != MAGIC:
        raise ProtocolError("bad farm frame magic %r" % magic)
    if version != VERSION:
        raise ProtocolError("unsupported farm protocol version %d"
                            % version)
    if length > MAX_FRAME:
        raise ProtocolError("frame payload %d > %d" % (length, MAX_FRAME))
    return msg_type, length


async def read_frame(reader) -> tuple[int, bytes]:
    """Read one frame from an asyncio StreamReader."""
    header = await reader.readexactly(HEADER_LEN)
    msg_type, length = parse_header(header)
    payload = await reader.readexactly(length) if length else b""
    return msg_type, payload


#: once a frame has started arriving, wait this long for the rest
#: before declaring the connection dead (frames are a few hundred
#: bytes — anything slower is a wedged farm, not congestion)
MID_FRAME_TIMEOUT = 30.0


def recv_frame(sock) -> tuple[int, bytes]:
    """Read one frame from a blocking socket (the client tier runs in
    the dispatcher's executor thread, not on the event loop).

    The caller uses a short socket timeout as a poll slice between
    frames (``should_stop`` responsiveness); ``socket.timeout`` is
    only ever raised here when ZERO bytes of the frame have been
    consumed, so a retry always restarts on a frame boundary.  A
    timeout that fires mid-frame (a frame split across slow TCP
    segments) keeps accumulating instead — discarding the partial
    read would desync the stream and burn the tier breaker on a
    perfectly healthy farm."""
    header = _recv_exact(sock, HEADER_LEN, poll_on_empty=True)
    msg_type, length = parse_header(header)
    payload = _recv_exact(sock, length) if length else b""
    return msg_type, payload


def _recv_exact(sock, n: int, *, poll_on_empty: bool = False) -> bytes:
    buf = bytearray()
    stall_deadline = None
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except _socket.timeout:
            if poll_on_empty and not buf:
                raise            # clean poll slice: nothing consumed
            if stall_deadline is None:
                stall_deadline = _time.monotonic() + MID_FRAME_TIMEOUT
            elif _time.monotonic() > stall_deadline:
                raise ConnectionError(
                    "farm connection stalled mid-frame")
            continue
        if not chunk:
            raise ConnectionError("farm connection closed mid-frame")
        buf += chunk
        stall_deadline = None
    return bytes(buf)


# -- field helpers ------------------------------------------------------------

def _pack_str(value: str | bytes, limit: int = 255) -> bytes:
    raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    if len(raw) > limit:
        raise ProtocolError("field too long (%d > %d)" % (len(raw), limit))
    return bytes((len(raw),)) + raw


def _unpack_str(data: bytes, offset: int) -> tuple[bytes, int]:
    if offset >= len(data):
        raise ProtocolError("truncated farm payload")
    n = data[offset]
    end = offset + 1 + n
    if end > len(data):
        raise ProtocolError("truncated farm payload")
    return data[offset + 1:end], end


# -- messages -----------------------------------------------------------------

@dataclass
class SubmitMsg:
    job_ref: int                     # client-chosen correlation id
    tenant: str
    lane: str
    initial_hash: bytes
    target: int
    start_nonce: int = 0             # journal-checkpoint resume offset
    deadline_ms: int = 0             # 0 = no deadline
    trace: bytes = b""               # 0 or TRACE_CTX_LEN bytes
    mac: bytes = b""                 # 0 or MAC_LEN bytes

    def encode(self, secret: bytes | None = None) -> bytes:
        body = self.encode_unsigned()
        mac = self.mac
        if secret:
            mac = compute_mac(secret, body)
        return body + _pack_str(mac, MAC_LEN)

    def encode_unsigned(self) -> bytes:
        if self.lane not in _LANE_CODE:
            raise ProtocolError("unknown lane %r" % self.lane)
        return (struct.pack(">QBQQI", self.job_ref,
                            _LANE_CODE[self.lane],
                            self.target & (2 ** 64 - 1),
                            self.start_nonce & (2 ** 64 - 1),
                            self.deadline_ms)
                + _pack_str(self.tenant, 64)
                + _pack_str(self.initial_hash, 128)
                + _pack_str(self.trace, 64))

    @classmethod
    def decode(cls, data: bytes) -> "SubmitMsg":
        try:
            job_ref, lane_code, target, start, deadline_ms = \
                struct.unpack_from(">QBQQI", data, 0)
        except struct.error as exc:
            raise ProtocolError("truncated submit: %s" % exc)
        if lane_code not in _LANE_NAME:
            raise ProtocolError("unknown lane code %d" % lane_code)
        off = struct.calcsize(">QBQQI")
        tenant, off = _unpack_str(data, off)
        initial_hash, off = _unpack_str(data, off)
        trace, off = _unpack_str(data, off)
        signed_end = off
        mac, off = _unpack_str(data, off)
        msg = cls(job_ref=job_ref,
                  tenant=tenant.decode("utf-8", "replace"),
                  lane=_LANE_NAME[lane_code],
                  initial_hash=bytes(initial_hash), target=target,
                  start_nonce=start, deadline_ms=deadline_ms,
                  trace=bytes(trace), mac=bytes(mac))
        # the byte range the mac covers (everything before the mac)
        msg._signed = data[:signed_end]
        return msg

    #: filled by decode(): the exact bytes the mac was computed over
    _signed: bytes = field(default=b"", repr=False, compare=False)


_ACCEPT = struct.Struct(">QQII")


@dataclass
class AcceptMsg:
    job_ref: int
    job_id: int                      # farm journal id
    queue_depth: int
    est_wait_ms: int

    def encode(self) -> bytes:
        return _ACCEPT.pack(self.job_ref, self.job_id,
                            self.queue_depth, self.est_wait_ms)

    @classmethod
    def decode(cls, data: bytes) -> "AcceptMsg":
        try:
            return cls(*_ACCEPT.unpack_from(data, 0))
        except struct.error as exc:
            raise ProtocolError("truncated accept: %s" % exc)


@dataclass
class RejectMsg:
    job_ref: int
    reason: str                      # bounded vocabulary (scheduler.py)
    retry_after_ms: int

    def encode(self) -> bytes:
        return (struct.pack(">QI", self.job_ref, self.retry_after_ms)
                + _pack_str(self.reason, 64))

    @classmethod
    def decode(cls, data: bytes) -> "RejectMsg":
        try:
            job_ref, retry_ms = struct.unpack_from(">QI", data, 0)
        except struct.error as exc:
            raise ProtocolError("truncated reject: %s" % exc)
        reason, _ = _unpack_str(data, struct.calcsize(">QI"))
        return cls(job_ref, reason.decode("utf-8", "replace"), retry_ms)


_RESULT = struct.Struct(">QBQQII")


@dataclass
class ResultMsg:
    job_ref: int
    status: int                      # ST_OK / ST_ERROR / ST_EXPIRED
    nonce: int = 0
    trials: int = 0
    queue_wait_ms: int = 0
    solve_ms: int = 0
    detail: str = ""

    def encode(self) -> bytes:
        return (_RESULT.pack(self.job_ref, self.status,
                             self.nonce & (2 ** 64 - 1),
                             self.trials & (2 ** 64 - 1),
                             self.queue_wait_ms, self.solve_ms)
                + _pack_str(self.detail, 160))

    @classmethod
    def decode(cls, data: bytes) -> "ResultMsg":
        try:
            ref, status, nonce, trials, qw, sm = \
                _RESULT.unpack_from(data, 0)
        except struct.error as exc:
            raise ProtocolError("truncated result: %s" % exc)
        detail, _ = _unpack_str(data, _RESULT.size)
        return cls(ref, status, nonce, trials, qw, sm,
                   detail.decode("utf-8", "replace"))
