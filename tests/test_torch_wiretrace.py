"""The port's wire trace against the JAX package's, on the CPU.

Held against ``pybitmessage_tpu.observability.tracing`` (``TraceContext``,
``SkewEstimator``), ``.lifecycle`` (``adopt``, ``trace_ctx_for``,
``trace_meta``), ``pybitmessage_tpu.network.messages``
(``append_trace_ctx`` / ``split_trace_ctx``) and the API's
``objectTimeline``:

- a ``TraceContext`` over seeded ids, spans and send times encodes to
  the same 32 bytes, each package decodes the other's, and a short one
  is refused alike;
- ``SkewEstimator`` gives the same offsets, deviations and snapshots
  over a seeded sequence with clamped outliers;
- the sync-payload trailer codecs split what the other appends and
  refuse the same short payloads;
- a ``LifecycleTracer``'s stitching metadata follows the same rules:
  first writer wins, a pushing origin mints its trace, the metadata
  dies with its timeline and stays bounded;
- two port pools over loopback TCP with NODE_TRACE: an object crosses
  as ``tobject``, the receiver adopts the sender's trace and samples
  its clock, sync payloads carry trailers the receiver strips; against
  a pool without the bit, plain ``object`` frames;
- ``objectTimeline``'s trace block and the flight recorder's skew.

Nothing of JAX is imported at module level; each socket test runs under
its own limit.
"""

import asyncio
import functools
import json
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch.models.constants import NODE_SYNC, NODE_TRACE
from pybitmessage_tpu_torch.models.pow_math import pow_initial_hash, pow_target
from pybitmessage_tpu_torch.network import dandelion
from pybitmessage_tpu_torch.network import messages as port_msgs
from pybitmessage_tpu_torch.network.pool import ConnectionPool, NodeContext
from pybitmessage_tpu_torch.observability import LIFECYCLE as PORT_LIFECYCLE
from pybitmessage_tpu_torch.observability import REGISTRY as PORT_REGISTRY
from pybitmessage_tpu_torch.observability import lifecycle as port_lifecycle
from pybitmessage_tpu_torch.observability import tracing as port_tracing
from pybitmessage_tpu_torch.pow.dispatcher import python_solve
from pybitmessage_tpu_torch.pow.verify_service import BatchVerifier
from pybitmessage_tpu_torch.storage.db import Database
from pybitmessage_tpu_torch.storage.inventory import Inventory
from pybitmessage_tpu_torch.storage.knownnodes import KnownNodes, Peer
from pybitmessage_tpu_torch.sync import InventoryDigest, Reconciler
from pybitmessage_tpu_torch.utils.hashes import inventory_hash
from pybitmessage_tpu_torch.utils.varint import encode_varint

#: the limit of each socket test, seconds
LIMIT = 30.0
TEST_NTPB = 10
LOOPBACK = "127.0.0.1"


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.api.commands import CommandHandler
    from pybitmessage_tpu.network import messages
    from pybitmessage_tpu.observability import LIFECYCLE, lifecycle, tracing
    return SimpleNamespace(tracing=tracing, lifecycle=lifecycle,
                           msgs=messages, LIFECYCLE=LIFECYCLE,
                           CommandHandler=CommandHandler)


def limited(fn):
    """Run an async test body under ``asyncio.wait_for(LIMIT)``."""
    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), LIMIT)
    return wrapper


def _contexts(seed: int, n: int = 16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tid = rng.bytes(int(rng.integers(0, 20)))  # padded or cut to 16
        span = int(rng.integers(0, 2 ** 63, dtype=np.uint64)) * 2 + 1
        sent = float(rng.integers(0, 2 ** 40)) / 1e6 + 1.7e9
        out.append((tid, span, sent))
    return out


# ---------------------------------------------------------------------------
# TraceContext, SkewEstimator, the trailer codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_trace_context_round_trips_byte_equal(seed):
    tr = _jax().tracing
    assert port_tracing.TRACE_CTX_LEN == tr.TRACE_CTX_LEN == 32
    for tid, span, sent in _contexts(seed):
        mine = port_tracing.TraceContext(tid, span, sent)
        theirs = tr.TraceContext(tid, span, sent)
        assert mine.encode() == theirs.encode()
        assert len(mine.encode()) == 32
        back = port_tracing.TraceContext.decode(theirs.encode())
        assert back.as_dict() == \
            tr.TraceContext.decode(mine.encode()).as_dict()
        assert back.encode() == mine.encode()


def test_short_trace_context_is_refused_alike():
    tr = _jax().tracing
    for n in (0, 1, 31):
        with pytest.raises(ValueError) as theirs:
            tr.TraceContext.decode(b"\x00" * n)
        with pytest.raises(ValueError) as mine:
            port_tracing.TraceContext.decode(b"\x00" * n)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("seed", range(3))
def test_skew_estimators_agree_over_a_seeded_sequence(seed):
    tr = _jax().tracing
    rng = np.random.default_rng([seed, 7])
    mine, theirs = port_tracing.SkewEstimator(), tr.SkewEstimator()
    assert mine.offset() == theirs.offset() == 0.0
    recv = 1.7e9
    for _ in range(200):
        recv += float(rng.exponential(0.5))
        offset = float(rng.normal(0.8, 0.05))
        if rng.random() < 0.05:
            offset = float(rng.choice([-1, 1])) * 1e5   # clamped
        got = mine.observe(recv + offset, recv)
        assert got == theirs.observe(recv + offset, recv)
    assert mine.offset() == theirs.offset()
    assert mine.deviation() == theirs.deviation()
    assert mine.snapshot() == theirs.snapshot()
    assert mine.normalize(recv) == theirs.normalize(recv)


@pytest.mark.parametrize("seed", range(2))
def test_trailers_split_what_the_other_appends(seed):
    msgs = _jax().msgs
    rng = np.random.default_rng([seed, 9])
    for tid, span, _ in _contexts(seed, 6):
        body = rng.bytes(int(rng.integers(0, 200)))
        ctx = port_tracing.TraceContext(tid, span)
        for append, split in ((port_msgs.append_trace_ctx,
                               msgs.split_trace_ctx),
                              (msgs.append_trace_ctx,
                               port_msgs.split_trace_ctx)):
            wire = append(body, ctx)
            assert len(wire) == len(body) + 32
            got, back = split(wire)
            assert got == body
            assert (back.trace_id, back.parent_span) == \
                (ctx.trace_id, ctx.parent_span)
            assert abs(back.sent_at - time.time()) < 60
    with pytest.raises(msgs.MessageError) as theirs:
        msgs.split_trace_ctx(b"\x00" * 31)
    with pytest.raises(port_msgs.MessageError) as mine:
        port_msgs.split_trace_ctx(b"\x00" * 31)
    assert str(mine.value) == str(theirs.value)


def test_trace_families_and_constants_agree():
    from pybitmessage_tpu.models import constants
    from pybitmessage_tpu_torch.models import constants as port_constants
    assert (port_constants.NODE_SYNC, port_constants.NODE_TRACE) == \
        (constants.NODE_SYNC, constants.NODE_TRACE) == (16, 32)
    tr = _jax().tracing
    for name in ("TRACE_CTX_SENT", "TRACE_CTX_RECEIVED",
                 "TRACE_CTX_INVALID", "TRACE_CLOCK_SKEW"):
        mine, theirs = getattr(port_tracing, name), getattr(tr, name)
        assert (mine.name, mine.kind, mine.help, mine.labelnames) == \
            (theirs.name, theirs.kind, theirs.help, theirs.labelnames)


# ---------------------------------------------------------------------------
# lifecycle stitching
# ---------------------------------------------------------------------------


def _stitch(mod):
    """One sequence of stitching calls; what it leaves, with the random
    span ids replaced by whether they are set."""
    lc = mod.LifecycleTracer(maxlen=4, stage_histogram=None,
                             propagation_histogram=None,
                             update_gauge=False)
    hs = [bytes([i]) * 32 for i in range(12)]
    out = []
    lc.record(hs[0], "received")
    lc.adopt(hs[0], b"\x01" * 16, 7)
    lc.adopt(hs[0], b"\x02" * 16, 9)          # first writer wins
    ctx = lc.trace_ctx_for(hs[1])             # the origin mints one
    out.append((ctx.trace_id == lc.trace_meta(hs[1])["trace_id"],
                ctx.parent_span == lc.trace_meta(hs[1])["span"]))
    again = lc.trace_ctx_for(hs[1])
    out.append(again.trace_id == ctx.trace_id)
    for h in hs[2:6]:                         # evicts hs[0]'s timeline
        lc.record(h, "received")
    for h in hs[6:12]:                        # metadata without timelines
        lc.trace_ctx_for(h)
    lc.discard(hs[7])
    out.append(lc.trace_ctx_for(None))
    for h in hs:
        meta = lc.trace_meta(h)
        out.append(None if meta is None else (
            meta["trace_id"] if h == hs[0] else len(meta["trace_id"]),
            bool(meta["span"]), meta["parent_span"]))
    return out


def test_lifecycle_stitching_follows_the_same_rules():
    assert _stitch(port_lifecycle) == _stitch(_jax().lifecycle)


def test_object_timeline_trace_block_matches_the_jax_command():
    from pybitmessage_tpu_torch.api.commands import CommandHandler
    j = _jax()
    h = b"\x5a" * 32
    for lc in (PORT_LIFECYCLE, j.LIFECYCLE):
        lc.discard(h)
        lc.record(h, "received", t=1.0)
        lc.adopt(h, b"\x42" * 16, 1234)
    try:
        mine = json.loads(CommandHandler(node=None).cmd_objectTimeline(
            h.hex()))
        theirs = json.loads(j.CommandHandler(node=None).cmd_objectTimeline(
            h.hex()))
        assert mine["trace"]["span"] and theirs["trace"]["span"]
        mine["trace"].pop("span")
        theirs["trace"].pop("span")
        assert mine == theirs
        assert mine["trace"] == {"traceId": "42" * 16, "parentSpan": 1234}
    finally:
        PORT_LIFECYCLE.discard(h)
        j.LIFECYCLE.discard(h)


# ---------------------------------------------------------------------------
# over loopback TCP
# ---------------------------------------------------------------------------


def _solved(body: bytes, ttl: int = 600) -> bytes:
    sans_nonce = struct.pack(">QI", int(time.time()) + ttl, 2) \
        + encode_varint(1) + encode_varint(1) + body
    target = pow_target(len(sans_nonce) + 8, ttl, TEST_NTPB, TEST_NTPB,
                        clamp=False)
    nonce, _ = python_solve(pow_initial_hash(sans_nonce), target)
    return struct.pack(">Q", nonce) + sans_nonce


def _pool(*, trace=True, sync=True):
    verifier = BatchVerifier("cpu", ntpb=TEST_NTPB, extra=TEST_NTPB,
                             clamp=False)
    inv = Inventory(Database(":memory:"))
    ctx = NodeContext(inventory=inv, pow_verifier=verifier,
                      knownnodes=KnownNodes(),
                      dandelion=dandelion.Dandelion(enabled=False), port=0,
                      allow_private_peers=True, announce_buckets=1)
    pool = ConnectionPool(ctx, listen_host=LOOPBACK, max_outbound=0)
    if sync:
        digest = InventoryDigest()
        inv.attach_digest(digest)
        pool.reconciler = Reconciler(pool, digest=digest, interval=0.3)
        ctx.services |= NODE_SYNC
    if trace:
        ctx.services |= NODE_TRACE
    return pool


async def _until(pred, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        await asyncio.sleep(0.02)


def _spy(conn) -> dict:
    seen = {"tobject": [], "object": []}
    orig_t, orig_o = conn.cmd_tobject, conn.cmd_object

    async def spy_t(payload, **kw):
        seen["tobject"].append(bytes(payload))
        await orig_t(payload, **kw)

    async def spy_o(payload, **kw):
        seen["object"].append(bytes(payload))
        await orig_o(payload, **kw)
    conn.cmd_tobject, conn.cmd_object = spy_t, spy_o
    return seen


async def _pair(a, b):
    for pool in (a, b):
        pool.ctx.pow_verifier.start()
    await a.start()
    await b.start(listen=False)
    conn = await b.connect_to(Peer(LOOPBACK, a.listen_port))
    assert conn is not None
    await _until(lambda: conn.fully_established and a.established(),
                 "the handshake")
    return conn


async def _close(*pools):
    for pool in pools:
        await pool.stop()
        await pool.ctx.pow_verifier.stop()


def _sample(name, labels=None) -> float:
    return PORT_REGISTRY.sample(name, labels or {})


@limited
async def test_an_object_crosses_as_tobject_and_joins_the_trace():
    a, b = _pool(), _pool()
    try:
        conn = await _pair(a, b)
        assert conn.trace_negotiated
        seen = _spy(conn)
        sent0 = _sample("trace_ctx_sent_total", {"command": "tobject"})
        got0 = _sample("trace_ctx_received_total", {"command": "tobject"})
        payload = _solved(b"traced push")
        h = inventory_hash(payload)
        a.ctx.inventory.add(h, 2, 1, payload, int(time.time()) + 600)
        a.announce_object(h, local=False)
        await _until(lambda: h in b.ctx.inventory, "the push")
        assert seen["tobject"] and not seen["object"]
        wire = port_tracing.TraceContext.decode(seen["tobject"][0][:32])
        # both pools share this process's tracer: the sender's minted
        # trace is the one the receiver's adoption finds (first writer)
        meta = PORT_LIFECYCLE.trace_meta(h)
        assert meta["trace_id"] == wire.trace_id
        assert meta["span"] == wire.parent_span
        assert conn.skew.samples >= 1 and abs(conn.skew.offset()) < 5.0
        assert _sample("trace_ctx_sent_total",
                       {"command": "tobject"}) > sent0
        assert _sample("trace_ctx_received_total",
                       {"command": "tobject"}) > got0
        PORT_LIFECYCLE.discard(h)
    finally:
        await _close(b, a)


@limited
async def test_sync_payloads_carry_trailers_the_receiver_strips():
    """A reconciliation round between two NODE_TRACE pools: every
    sketchreq/sketch/recondiff carries the 32-byte trailer, the
    receiver strips it (the round decodes) and counts it."""
    a, b = _pool(), _pool()
    try:
        # fanout 0: every announcement waits for a round
        a.reconciler.fanout = b.reconciler.fanout = 0
        conn = await _pair(a, b)
        await _until(lambda: a.reconciler.negotiated(a.established()[0])
                     and b.reconciler.negotiated(conn), "the sessions")
        got0 = sum(_sample("trace_ctx_received_total", {"command": c})
                   for c in ("sketchreq", "sketch", "recondiff"))
        bad0 = _sample("trace_ctx_invalid_total")
        payloads = [_solved(b"round %d" % i) for i in range(6)]
        hs = []
        for i, p in enumerate(payloads):
            h = inventory_hash(p)
            hs.append(h)
            pool = a if i % 2 else b
            pool.ctx.inventory.add(h, 2, 1, p, int(time.time()) + 600)
            pool.announce_object(h, local=False)
        await _until(lambda: all(h in a.ctx.inventory
                                 and h in b.ctx.inventory for h in hs),
                     "the rounds")
        assert sum(_sample("trace_ctx_received_total", {"command": c})
                   for c in ("sketchreq", "sketch", "recondiff")) > got0
        assert _sample("trace_ctx_invalid_total") == bad0
    finally:
        await _close(b, a)


@pytest.mark.parametrize("off", ["receiver", "sender"])
@limited
async def test_a_peer_without_the_bit_gets_plain_objects(off):
    a = _pool(trace=off != "sender")
    b = _pool(trace=off != "receiver")
    try:
        conn = await _pair(a, b)
        assert not conn.trace_negotiated
        assert not a.established()[0].trace_negotiated
        seen = _spy(conn)
        payload = _solved(b"untraced push %s" % off.encode())
        h = inventory_hash(payload)
        a.ctx.inventory.add(h, 2, 1, payload, int(time.time()) + 600)
        a.announce_object(h, local=False)
        await _until(lambda: h in b.ctx.inventory, "the push")
        assert seen["object"] and not seen["tobject"]
        # attach_trace leaves a sync payload untouched
        assert conn.attach_trace("sketch", b"abc") == b"abc"
    finally:
        await _close(b, a)


def test_flight_recorder_dump_carries_the_nodes_skew():
    """``Node.mean_skew`` (the mean of its connections' estimators)
    feeds the flight recorder's dump and the federation push."""
    from pybitmessage_tpu_torch.api.commands import CommandHandler
    from pybitmessage_tpu_torch.core import Node
    from pybitmessage_tpu_torch.observability import FLIGHT_RECORDER
    node = Node(device="cpu", listen=False, test_mode=True,
                crypto_batch=False)
    try:
        assert FLIGHT_RECORDER.skew_provider == node.mean_skew
        conns = []
        for offset in (0.25, 0.75, None):
            est = port_tracing.SkewEstimator()
            if offset is not None:
                est.observe(1000.0 + offset, 1000.0)
            conns.append(SimpleNamespace(skew=est))
        node.pool.established = lambda: conns
        assert node.mean_skew() == pytest.approx(0.5)
        dump = json.loads(CommandHandler(node).cmd_dumpFlightRecorder())
        assert dump["skew"] == pytest.approx(0.5)
        assert dump["node"] == node.node_id
        push, _ = node.federation_publisher.build_push()
        assert push["skew"] == pytest.approx(0.5)
    finally:
        FLIGHT_RECORDER.skew_provider = None
        node.pow_journal.close()
        node.db.close()
