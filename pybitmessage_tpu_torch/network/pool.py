"""Shared node state and the connection pool: dialer, listener, gossip
cadences (copy of ``pybitmessage_tpu.network.pool``; every outbound dial
is the ``net.dial`` chaos site).  ``NodeContext.enable_tls`` writes the
node's certificate and advertises NODE_SSL; a set ``ctx.proxy`` sends
every dial through a SOCKS5 or SOCKS4a proxy (``network/socks.py``);
peers heard over UDP discovery (``lan_peer_discovered``) are dialled
first half of the time.  With a ``reconciler`` attached
(set-reconciliation sync), fluff announcements go through its flood /
pending split and the inv loop drives its rounds.
The roles' hooks are here: ``on_object`` and ``on_announce`` (a relay's
INV deltas and pushes), ``reuse_port`` (edges sharing one P2P port),
``ctx.payload_fetcher`` (an edge's getdata service of a hash its relay
holds) and the per-stream overlay (``established(stream)``,
``stream_overlay``).  Connections, dials, received objects and requeued
announcements go to the JAX pool's metric families; an object's
lifecycle gains ``received`` and ``announced`` here.

Reference: src/network/connectionpool.py (dial loop with rating-weighted
choice + network-group diversity), invthread.py (1 s inv batching with
dandelion split), downloadthread.py / uploadthread.py cadences,
knownnodes rating lifecycle on connect/close (tcp.py:284-300).
"""

from __future__ import annotations

import asyncio
import logging
import random
import socket
import time
from collections import deque
from typing import Callable, Optional

from ..models.constants import NODE_DANDELION, NODE_NETWORK, NODE_SSL
from ..observability import REGISTRY
from ..observability.lifecycle import LIFECYCLE
from ..observability.metrics import peer_bucket_label
from ..resilience import CircuitBreaker
from ..resilience.chaos import inject
from ..resilience.policy import ERRORS
from ..storage.knownnodes import KnownNodes, Peer
from ..utils.queues import WatermarkQueue
from .connection import BMConnection
from .messages import (AddrEntry, encode_addr, encode_host,
                       is_private_host, network_group)
from .ratelimit import TokenBucket
from .tracker import ANNOUNCE_BUCKETS, GlobalTracker

logger = logging.getLogger("pybitmessage_tpu_torch.network")


def _is_local_address(host: str) -> bool:
    """True when ``host`` is one of this machine's own addresses: a UDP
    connect (no packet sent) to a local address picks that same address
    as its source."""
    if host in ("127.0.0.1", "::1", "localhost"):
        return True
    try:
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        with socket.socket(family, socket.SOCK_DGRAM) as s:
            s.connect((host, 9))
            return s.getsockname()[0] == host
    except OSError:
        return False

DEFAULT_MAX_OUTBOUND = 8
DEFAULT_MAX_TOTAL = 200
PING_INTERVAL = 300
INV_INTERVAL = 1.0
DOWNLOAD_INTERVAL = 1.0
#: TCP connect budget for one outbound dial (``connecttimeout``)
DEFAULT_DIAL_TIMEOUT = 10.0
#: version/verack must complete within this or the slot is reclaimed
DEFAULT_HANDSHAKE_TIMEOUT = 30.0
#: per-peer dial breakers kept at most (oldest dropped beyond this)
MAX_DIAL_BREAKERS = 512

CONNECTIONS = REGISTRY.gauge(
    "network_connections", "Open connections by direction",
    ("direction",))
DIALS = REGISTRY.counter(
    "network_dial_total", "Outbound dial attempts by outcome",
    ("result",))
OBJECTS_RECEIVED = REGISTRY.counter(
    "network_objects_received_total",
    "Valid objects accepted from the network")
ANNOUNCE_RETRIES = REGISTRY.counter(
    "network_announce_requeue_total",
    "Inv/addr announcements put back after a failed send — retried "
    "next tick instead of silently lost")


class NodeContext:
    """Shared state every connection needs: the inventory, the peer
    table, the dandelion state, this node's version fields, the batch
    PoW verifier every received object goes through (set to the node's
    network-minimum difficulty), the rate buckets, the download
    tracker, and the watermarked queue validated objects leave
    through."""

    def __init__(self, *, inventory, pow_verifier, knownnodes=None,
                 dandelion=None, streams=(1,), port=8444,
                 allow_private_peers: bool = False,
                 announce_buckets: int | None = None):
        self.inventory = inventory
        #: the BatchVerifier every incoming object's PoW goes through
        self.pow_verifier = pow_verifier
        self.knownnodes = knownnodes if knownnodes is not None \
            else KnownNodes()
        self.dandelion = dandelion
        self.streams = tuple(streams)
        self.port = port
        self.services = NODE_NETWORK | NODE_DANDELION
        self.nonce = random.getrandbits(64).to_bytes(8, "big")
        self.allow_private_peers = allow_private_peers
        #: inv/addr timing-decorrelation bucket count (MultiQueue role)
        self.announce_buckets = announce_buckets or ANNOUNCE_BUCKETS
        #: byte/s global throttles (0 = unlimited), reference
        #: maxdownloadrate/maxuploadrate semantics
        self.download_bucket = TokenBucket(0, direction="rx")
        self.upload_bucket = TokenBucket(0, direction="tx")
        self.global_tracker = GlobalTracker()
        #: validated objects flow out here: (hash, header, payload).
        #: Crossing HIGH pauses every connection's read loop until the
        #: processor drains it back under LOW
        self.object_queue = WatermarkQueue()
        #: edge role: payload fetch for getdata hashes known relay-side
        #: but not cached here, ``(hash, conn) -> bool``, or None
        self.payload_fetcher = None
        #: opportunistic TLS (NODE_SSL): (certfile, keyfile) or None,
        #: set by :meth:`enable_tls`
        self.tls_files: tuple[str, str] | None = None
        #: SOCKS proxy for outbound dials: None or {type: "SOCKS5" |
        #: "SOCKS4a", host, port, username, password}
        self.proxy: dict | None = None

    def enable_tls(self, directory=None) -> None:
        """Write this node's self-signed certificate (under
        ``directory``, or a temporary directory) and advertise NODE_SSL.
        A certificate that cannot be made raises: TLS is never switched
        off here."""
        from .tls import generate_self_signed_cert
        self.tls_files = generate_self_signed_cert(directory)
        self.services |= NODE_SSL


class ConnectionPool:
    def __init__(self, ctx: NodeContext, *,
                 max_outbound: int = DEFAULT_MAX_OUTBOUND,
                 max_total: int = DEFAULT_MAX_TOTAL,
                 listen_host: str = "127.0.0.1",
                 trusted_peer: Optional[Peer] = None,
                 dial_timeout: float = DEFAULT_DIAL_TIMEOUT,
                 handshake_timeout: float = DEFAULT_HANDSHAKE_TIMEOUT):
        self.ctx = ctx
        self.max_outbound = max_outbound
        self.max_total = max_total
        self.listen_host = listen_host
        self.trusted_peer = trusted_peer
        self.dial_timeout = dial_timeout
        self.handshake_timeout = handshake_timeout
        self.dial_breaker_threshold = 3
        self.dial_breaker_cooldown = 120.0
        #: per-peer dial circuit breakers: a repeatedly unreachable
        #: peer stops consuming dial-loop ticks until its cooldown
        self._dial_breakers: dict[str, CircuitBreaker] = {}
        self.inbound: dict[BMConnection, None] = {}
        self.outbound: dict[BMConnection, None] = {}
        self._server: asyncio.AbstractServer | None = None
        self._tasks: list[asyncio.Task] = []
        #: ``(h, header, payload, source)`` for every accepted object
        self.on_object: Callable | None = None
        #: ``(h, stream, local)`` for every announced object
        self.on_announce: Callable | None = None
        #: share the listen socket across processes (edge processes
        #: accepting on one port, balanced by the kernel)
        self.reuse_port = False
        #: set-reconciliation subsystem (``sync/reconciler.py``); None
        #: keeps the classic flooding-only paths
        self.reconciler = None
        #: LAN peers heard over UDP discovery -> last-heard time
        self.lan_peers: dict[Peer, float] = {}
        #: (AddrEntry, due_time) queue for ongoing addr relay
        self._addr_gossip: list = []
        #: peers that asked us to verify their reachability
        #: (reference portCheckerQueue) — dialed before rating choice
        self._portcheck_queue: deque[Peer] = deque()
        #: new objects accepted, and of those the ones announced on to
        #: at least one other peer
        self.objects_received = 0
        self.objects_relayed = 0

    # -- queries -------------------------------------------------------------

    def connections(self) -> list[BMConnection]:
        return list(self.outbound) + list(self.inbound)

    @staticmethod
    def _subscribes(conn, stream: int) -> bool:
        """A connection hears stream k when its negotiated streams
        include k; one that never advertised streams always does."""
        streams = getattr(conn, "streams", None)
        return not streams or stream in streams

    def established(self, stream: int | None = None) -> list[BMConnection]:
        """Fully-established connections, optionally only those whose
        negotiated streams overlay ``stream``."""
        conns = [c for c in self.connections() if c.fully_established]
        if stream is None:
            return conns
        return [c for c in conns if self._subscribes(c, stream)]

    def stream_overlay(self) -> dict[int, int]:
        """Established-peer count per subscribed stream (roleStatus)."""
        return {s: len(self.established(s)) for s in self.ctx.streams}

    def _used_groups(self) -> set[bytes]:
        return {network_group(c.host) for c in self.outbound}

    # -- lifecycle -----------------------------------------------------------

    async def start(self, listen: bool = True) -> None:
        self._count_connections()
        if listen:
            self._server = await asyncio.start_server(
                self._accept, self.listen_host, self.ctx.port,
                reuse_port=True if self.reuse_port else None)
        self._tasks = [
            asyncio.create_task(self._dial_loop()),
            asyncio.create_task(self._inv_loop()),
            asyncio.create_task(self._download_loop()),
            asyncio.create_task(self._maintenance_loop()),
        ]

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        if self._server:
            self._server.close()
        # Close connections BEFORE Server.wait_closed(): since Python
        # 3.12 wait_closed() blocks until every handler transport is
        # gone, so the other order deadlocks on any live connection.
        for conn in self.connections():
            await conn.close()
        if self._server:
            await self._server.wait_closed()
            self._server = None

    @property
    def listen_port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.ctx.port

    # -- connection management ----------------------------------------------

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername") or ("?", 0)
        if len(self.connections()) >= self.max_total:
            writer.close()
            return
        conn = BMConnection(self, reader, writer, outbound=False,
                            host=peer[0], port=peer[1])
        self.inbound[conn] = None
        self._count_connections()
        conn.start()
        # a peer that never completes version/verack must not pin an
        # inbound slot forever
        conn.arm_handshake_timeout(self.handshake_timeout)

    def _dial_breaker(self, peer: Peer) -> CircuitBreaker:
        key = "%s:%d" % (peer.host, peer.port)
        br = self._dial_breakers.get(key)
        if br is None:
            while len(self._dial_breakers) >= MAX_DIAL_BREAKERS:
                self._dial_breakers.pop(next(iter(self._dial_breakers)))
            # hashed peer-bucket label (``net.dial/bNN``): per-bucket
            # visibility without per-peer label cardinality
            br = self._dial_breakers[key] = CircuitBreaker(
                "net.dial:%s" % key,
                threshold=self.dial_breaker_threshold,
                cooldown=self.dial_breaker_cooldown,
                label=peer_bucket_label("net.dial", key), register=False)
        return br

    def _count_connections(self) -> None:
        CONNECTIONS.labels(direction="inbound").set(len(self.inbound))
        CONNECTIONS.labels(direction="outbound").set(len(self.outbound))

    async def connect_to(self, peer: Peer) -> BMConnection | None:
        breaker = self._dial_breaker(peer)
        if not breaker.allow():
            # repeatedly-dead peer: don't pay the connect timeout again
            # until the breaker's cooldown lets a probe through
            DIALS.labels(result="skipped").inc()
            return None
        try:
            inject("net.dial")
            if self.ctx.proxy is not None:
                from .socks import open_via_proxy
                p = self.ctx.proxy
                reader, writer = await asyncio.wait_for(
                    open_via_proxy(
                        p["type"], p["host"], p["port"], peer.host,
                        peer.port, username=p.get("username", ""),
                        password=p.get("password", ""), timeout=30),
                    timeout=max(self.dial_timeout, 30))
            else:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(peer.host, peer.port),
                    timeout=self.dial_timeout)
        except (OSError, asyncio.TimeoutError) as exc:
            logger.debug("dial %s failed: %r", peer, exc)
            DIALS.labels(result="failed").inc()
            ERRORS.labels(site="net.dial").inc()
            breaker.record_failure()
            self.ctx.knownnodes.decrease_rating(peer)
            return None
        breaker.record_success()
        conn = BMConnection(self, reader, writer, outbound=True,
                            host=peer.host, port=peer.port)
        self.outbound[conn] = None
        DIALS.labels(result="connected").inc()
        self._count_connections()
        conn.start()
        conn.arm_handshake_timeout(self.handshake_timeout)
        return conn

    def connection_established(self, conn: BMConnection) -> None:
        peer = Peer(conn.host, conn.port)
        self.ctx.knownnodes.add(peer)
        self.ctx.knownnodes.increase_rating(peer)
        if self.ctx.dandelion and conn.services & NODE_DANDELION:
            self.ctx.dandelion.maybe_add_stem(conn)

    def connection_closed(self, conn: BMConnection) -> None:
        self.inbound.pop(conn, None)
        self.outbound.pop(conn, None)
        self._count_connections()
        # what this connection was asked for and never delivered may be
        # fetched over another one
        self.ctx.global_tracker.release(conn)
        if self.reconciler is not None:
            self.reconciler.unregister(conn)
        if self.ctx.dandelion:
            self.ctx.dandelion.remove_connection(conn)
        if conn.outbound and not conn.fully_established:
            self.ctx.knownnodes.decrease_rating(Peer(conn.host, conn.port))

    def portcheck_requested(self, peer: Peer) -> None:
        """Queue a reachability-verification dial (cmd_portcheck)."""
        if peer not in self._portcheck_queue:
            self._portcheck_queue.append(peer)

    def lan_peer_discovered(self, peer: Peer, stream: int = 1) -> None:
        """A peer announced itself over LAN UDP: heard from its own
        source address, so the dialer prefers it half of the time
        (reference connectionchooser.py:57-62)."""
        if peer.port == self.listen_port and _is_local_address(peer.host):
            return  # our own broadcast echoed back from a local interface
        self.lan_peers[peer] = time.time()

    def peer_discovered(self, entry: AddrEntry) -> None:
        # Reject unroutable addresses from gossip — loopback/private/
        # reserved hosts would poison the dial loop
        if is_private_host(entry.host) and not self.ctx.allow_private_peers:
            return
        self.ctx.knownnodes.add(
            Peer(entry.host, entry.port), entry.stream,
            lastseen=min(int(entry.time), int(time.time())))

    def _route_announcement(self, h: bytes, conns,
                            stream: int | None = None) -> None:
        """Fan one announcement out: stem-phase hashes always ride the
        classic trackers (dandelion routing decides who may see them —
        they must NEVER enter a reconciliation sketch), everything else
        goes through the reconciler's flood/pending split when sync is
        enabled.  With a known ``stream`` only peers subscribed to it
        hear it, and a stream outside ``ctx.streams`` is never
        announced (the shard boundary)."""
        if stream is not None:
            if stream not in self.ctx.streams:
                return
            conns = [c for c in conns if self._subscribes(c, stream)]
        LIFECYCLE.record(h, "announced")
        dand = self.ctx.dandelion
        if self.reconciler is not None and \
                (dand is None or not dand.in_stem_phase(h)):
            self.reconciler.route_announcement(h, conns, stream=stream)
            return
        for conn in conns:
            conn.tracker.we_should_announce(h)

    def object_received(self, h: bytes, header, payload: bytes,
                        source=None) -> None:
        """A new valid object arrived: relay it and queue it for the
        processor.  The source connection is excluded — an inv must
        never echo back to the peer that delivered the object."""
        self.objects_received += 1
        OBJECTS_RECEIVED.inc()
        LIFECYCLE.record(h, "received")
        peers = [c for c in self.established() if c is not source]
        if peers:
            self.objects_relayed += 1
        self._route_announcement(h, peers,
                                 stream=getattr(header, "stream", None))
        self.ctx.object_queue.put_nowait((h, header, payload))
        if self.on_object is not None:
            self.on_object(h, header, payload, source)

    def announce_object(self, h: bytes, stream: int = 1,
                        local: bool = True) -> None:
        """Advertise a (locally generated or relayed) object.  Local
        objects may enter the dandelion stem phase."""
        dand = self.ctx.dandelion
        if local and dand and dand.enabled and \
                random.randrange(100) < dand.stem_probability:
            dand.add_hash(h, stream, source=None)
        self._route_announcement(h, self.established(), stream=stream)
        if self.on_announce is not None:
            self.on_announce(h, stream, local)

    # -- periodic tasks ------------------------------------------------------

    async def _dial_loop(self) -> None:
        while True:
            try:
                await self._dial_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                ERRORS.labels(site="net.dial_loop").inc()
                logger.exception("dial loop error")
            await asyncio.sleep(2)

    async def _dial_once(self) -> None:
        if self.trusted_peer is not None:
            if not self.outbound:
                await self.connect_to(self.trusted_peer)
            return
        if len(self.outbound) >= self.max_outbound:
            return
        peer = None
        # portcheck requests first (connectionchooser.py:37-44)
        while self._portcheck_queue:
            candidate = self._portcheck_queue.popleft()
            if candidate not in [Peer(c.host, c.port)
                                 for c in self.outbound]:
                peer = candidate
                break
        # 50% preference for LAN-discovered peers heard in the last 3 h
        # (connectionchooser.py)
        fresh_lan = [p for p, ts in self.lan_peers.items()
                     if time.time() - ts < 10800]
        if peer is None and fresh_lan and random.random() < 0.5:
            peer = random.choice(fresh_lan)
        if peer is None:
            peer = self.ctx.knownnodes.choose()
        if peer is None:
            return
        if peer in [Peer(c.host, c.port) for c in self.outbound]:
            return
        # network-group diversity (anti-Sybil, connectionpool.py:303-317)
        if network_group(peer.host) in self._used_groups():
            return
        await self.connect_to(peer)

    async def _inv_loop(self) -> None:
        """Per-second inv/dinv announcement batching (invthread.py)."""
        while True:
            await asyncio.sleep(INV_INTERVAL)
            try:
                await self._inv_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                ERRORS.labels(site="net.inv_loop").inc()
                logger.exception("inv loop error")

    async def _flush_addr_gossip(self) -> None:
        """Ongoing addr relay (reference addrthread.py:13-49): peers
        newly learned since the last tick are re-advertised to every
        established connection, each entry leaving after a random
        sub-tick delay (the MultiQueue decorrelation)."""
        fresh = self.ctx.knownnodes.newly_added
        if fresh:
            self.ctx.knownnodes.newly_added = []
            now = time.time()
            jitter = self.ctx.announce_buckets
            for peer, stream in fresh:
                info = self.ctx.knownnodes.get(peer, stream)
                if not info or info.get("self"):
                    continue
                try:
                    encode_host(peer.host)
                except (OSError, ValueError):
                    continue
                entry = AddrEntry(info["lastseen"], stream, 1,
                                  peer.host, peer.port)
                self._addr_gossip.append(
                    (entry, now + random.uniform(0, jitter)))
        if not self._addr_gossip:
            return
        now = time.time()
        due = [e for e, d in self._addr_gossip if d <= now]
        if not due:
            return
        self._addr_gossip = [(e, d) for e, d in self._addr_gossip
                             if d > now]
        packet = encode_addr(due)
        for conn in self.established():
            try:
                await conn.send_packet("addr", packet)
            except (ConnectionError, OSError) as exc:
                # best-effort: the entries re-advertise through other
                # peers, but the failed send is counted
                ERRORS.labels(site="net.send").inc()
                logger.debug("addr gossip to %s failed: %r",
                             conn.host, exc)

    async def _inv_once(self) -> None:
        await self._flush_addr_gossip()
        dand = self.ctx.dandelion
        if dand:
            for h, stream in dand.expire_fluffed():
                # stem timer expired: the hash is now an ordinary
                # fluff announcement and may use the sync paths
                self._route_announcement(h, self.established(),
                                         stream=stream)
        if self.reconciler is not None:
            await self.reconciler.tick()
        for conn in self.established():
            chunk = conn.tracker.take_announcements()
            if not chunk:
                continue
            fluffs, stems = [], []
            for h in chunk:
                child = dand.child_for(h) if dand else None
                if child is None:
                    fluffs.append(h)
                elif child is conn:
                    stems.append(h)
                # else: in stem phase routed to another child — skip
            random.shuffle(fluffs)
            sends = [(hs, stem) for hs, stem in
                     ((fluffs, False), (stems, True)) if hs]
            for i, (hashes, stem) in enumerate(sends):
                try:
                    await conn.announce(hashes, stem=stem)
                except (ConnectionError, OSError) as exc:
                    # requeue ONLY the unsent groups so the next tick
                    # re-delivers them
                    unsent = [h for hs, _ in sends[i:] for h in hs]
                    ERRORS.labels(site="net.send").inc()
                    ANNOUNCE_RETRIES.inc(len(unsent))
                    logger.debug("announce to %s failed (%r); requeued "
                                 "%d hashes", conn.host, exc, len(unsent))
                    for h in unsent:
                        conn.tracker.we_should_announce(h)
                    break

    async def _download_loop(self) -> None:
        while True:
            await asyncio.sleep(DOWNLOAD_INTERVAL)
            try:
                for conn in self.established():
                    await conn.request_objects()
                    # drain queued getdata backlogs (10/round cadence of
                    # the reference's uploadthread)
                    await conn.flush_uploads()
            except asyncio.CancelledError:
                raise
            except Exception:
                ERRORS.labels(site="net.download_loop").inc()
                logger.exception("download loop error")

    async def _maintenance_loop(self) -> None:
        while True:
            await asyncio.sleep(30)
            try:
                now = time.time()
                self.ctx.global_tracker.expire()
                for conn in self.connections():
                    conn.tracker.clean()
                    if conn.fully_established and \
                            now - conn.last_activity > PING_INTERVAL:
                        await conn.send_packet("ping")
                    if now - conn.last_activity > PING_INTERVAL * 2:
                        await conn.close("inactive")
                if self.ctx.dandelion:
                    self.ctx.dandelion.maybe_reassign(self.established())
            except asyncio.CancelledError:
                raise
            except Exception:
                ERRORS.labels(site="net.maintenance_loop").inc()
                logger.exception("maintenance loop error")
