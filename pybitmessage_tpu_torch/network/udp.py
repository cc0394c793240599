"""UDP LAN peer discovery and the periodic self-announce (the twin of
``pybitmessage_tpu.network.udp``: the same datagrams, byte for byte).

Reference behavior (src/network/udp.py:65-98, announcethread.py:14-43):
a UDP socket on the node port receives framed ``addr`` packets
broadcast by LAN peers; only private-network sources are believed (a
WAN host shouting "I am 10.0.0.5" is meaningless) and the datagram's
source host is taken over the advertised one; discovered peers are
preferred by the dialer (``ConnectionPool.lan_peer_discovered``).
Every 60 s the node broadcasts its own address to ``<broadcast>:port``;
``announce(to=...)`` sends one to a given address (a container may not
route broadcast).  The endpoint shares its port (``SO_REUSEPORT``) with
the node's listener and its sibling edge processes.

A ``DatagramProtocol`` replaces the reference's ``UDPSocket(BMProto)``:
only ``addr`` means anything on UDP, and the framing and codecs are the
TCP ones.  A malformed datagram counts at the ``net.udp_datagram``
error site, a failed announce at ``net.udp_announce``.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import time

from ..models.packet import (HEADER_LEN, pack_packet, unpack_header,
                             verify_payload)
from ..resilience.policy import ERRORS
from ..storage.knownnodes import Peer
from .messages import AddrEntry, decode_addr, encode_addr, is_private_host

logger = logging.getLogger("pybitmessage_tpu_torch.network")

ANNOUNCE_INTERVAL = 60.0  # reference announcethread.py:23


class UDPDiscovery(asyncio.DatagramProtocol):
    """LAN discovery endpoint: receive peer announcements, send ours."""

    def __init__(self, pool, *, port: int | None = None,
                 broadcast_host: str = "255.255.255.255",
                 announce_interval: float = ANNOUNCE_INTERVAL,
                 bind_host: str = "0.0.0.0"):
        self.pool = pool
        self.ctx = pool.ctx
        self.port = port if port is not None else self.ctx.port
        self.broadcast_host = broadcast_host
        self.announce_interval = announce_interval
        self.bind_host = bind_host
        self.transport: asyncio.DatagramTransport | None = None
        self._announce_task: asyncio.Task | None = None
        #: (host, port) peers seen via LAN discovery -> last-seen time
        self.discovered: dict[Peer, float] = {}
        self.announcements_sent = 0
        self.peers_heard = 0

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: self,
            local_addr=(self.bind_host, self.port),
            allow_broadcast=True,
            reuse_port=hasattr(socket, "SO_REUSEPORT") or None)
        # port 0 binds any free port; the announces name the bound one
        self.port = self.listen_port
        self._announce_task = asyncio.create_task(self._announce_loop())
        logger.info("UDP discovery listening on %s:%d",
                    self.bind_host, self.listen_port)

    async def stop(self) -> None:
        if self._announce_task:
            self._announce_task.cancel()
            try:
                await self._announce_task
            except asyncio.CancelledError:
                pass
        if self.transport:
            self.transport.close()

    @property
    def listen_port(self) -> int:
        if self.transport:
            return self.transport.get_extra_info("sockname")[1]
        return self.port

    # -- receive -------------------------------------------------------------

    def datagram_received(self, data: bytes, addr) -> None:
        src_host = addr[0]
        try:
            if len(data) < HEADER_LEN:
                return
            command, length, checksum = unpack_header(data[:HEADER_LEN])
            payload = data[HEADER_LEN:HEADER_LEN + length]
            if len(payload) != length or not verify_payload(payload,
                                                            checksum):
                return
            if command != "addr":
                return  # only addr is enabled on UDP (udp.py:65-78)
            self._handle_addr(payload, src_host)
        except Exception:
            ERRORS.labels(site="net.udp_datagram").inc()
            logger.debug("malformed UDP datagram from %s", src_host,
                         exc_info=True)

    def _handle_addr(self, payload: bytes, src_host: str) -> None:
        # LAN announcements are believed only from private sources, and
        # the datagram's source address replaces the advertised host
        # (reference udp.py:84-98)
        if not (is_private_host(src_host)
                or self.ctx.allow_private_peers):
            return
        for entry in decode_addr(payload):
            if entry.stream not in self.ctx.streams:
                continue
            if not (1 <= entry.port <= 65535):
                continue
            peer = Peer(src_host, entry.port)
            self.discovered[peer] = time.time()
            self.peers_heard += 1
            self.pool.lan_peer_discovered(peer, entry.stream)

    # -- announce ------------------------------------------------------------

    async def _announce_loop(self) -> None:
        while True:
            try:
                self.announce()
            except Exception:
                ERRORS.labels(site="net.udp_announce").inc()
                logger.exception("UDP announce failed")
            await asyncio.sleep(self.announce_interval)

    def announce(self, to: tuple[str, int] | None = None) -> None:
        """Broadcast our own addr, or send it to ``to`` (reference
        announcethread.py:26-43)."""
        if self.transport is None:
            return
        entries = [AddrEntry(int(time.time()), stream, self.ctx.services,
                             "127.0.0.1", self.pool.listen_port or
                             self.ctx.port)
                   for stream in self.ctx.streams]
        packet = pack_packet("addr", encode_addr(entries))
        self.transport.sendto(packet, to or (self.broadcast_host, self.port))
        self.announcements_sent += 1
