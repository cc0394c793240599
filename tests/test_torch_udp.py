"""The port's UDP LAN discovery against the JAX package's, on the CPU.

Endpoints bind 127.0.0.1 and announce to a given address
(``announce(to=...)``) or to 127.0.0.1: a container may not route
broadcast, and nothing here sends to another host.  The port hears a
JAX node's announce and the JAX node hears the port's, each keyed on the
datagram's source and the advertised listening port; garbage, non-addr
frames, bad checksums, foreign streams and public sources are ignored
in both packages alike; the announce datagram is byte-identical for the
same context and clock; a discovered peer is what the dial loop picks
when it prefers LAN peers, and the link comes up; a ``Node`` with
``udp_enabled`` runs its endpoint on its listening port and stops it.
"""

import asyncio
import importlib
import random
import time

import pytest

from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.models.packet import pack_packet
from pybitmessage_tpu_torch.network import messages
from pybitmessage_tpu_torch.network.udp import UDPDiscovery
from pybitmessage_tpu_torch.storage.knownnodes import Peer

from tests.test_torch_network import jax_pool, port_pool

LOOPBACK = "127.0.0.1"


def ref(module: str):
    return importlib.import_module("pybitmessage_tpu." + module)


async def until(pred, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        await asyncio.sleep(0.02)


def _port_node(**kw) -> Node:
    return Node(device="cpu", test_mode=True, allow_private_peers=True,
                crypto_batch=False, dandelion_enabled=False,
                federation_enabled=False, **kw)


def _jax_node():
    import jax
    jax.config.update("jax_platforms", "cpu")
    core = ref("core")
    return core.Node(None, listen=True, solver=lambda *a, **k: (0, 0),
                     test_mode=True, dandelion_enabled=False,
                     federation_enabled=False, allow_private_peers=True,
                     tls_enabled=False)


def _endpoints(port_node, jax_node):
    mine = UDPDiscovery(port_node.pool, port=0, bind_host=LOOPBACK,
                        broadcast_host=LOOPBACK, announce_interval=3600)
    theirs = ref("network.udp").UDPDiscovery(
        jax_node.pool, port=0, bind_host=LOOPBACK, broadcast_host=LOOPBACK,
        announce_interval=3600)
    return mine, theirs


async def _discover_both_ways():
    port, jax = _port_node(), _jax_node()
    await port.start()
    await jax.start()
    mine, theirs = _endpoints(port, jax)
    await mine.start()
    await theirs.start()
    try:
        theirs.announce(to=(LOOPBACK, mine.listen_port))
        mine.announce(to=(LOOPBACK, theirs.listen_port))
        await until(lambda: port.pool.lan_peers and jax.pool.lan_peers,
                    "both announcements")
        assert list(port.pool.lan_peers) == [
            Peer(LOOPBACK, jax.pool.listen_port)]
        assert list(jax.pool.lan_peers) == [
            ref("storage").Peer(LOOPBACK, port.pool.listen_port)]
        # (the port's endpoint also heard its own first announce, sent
        # to its bound port on 127.0.0.1, which the pool dropped)
        assert Peer(LOOPBACK, jax.pool.listen_port) in mine.discovered
        assert theirs.peers_heard == 1
        # the discovered peer is dialable
        peer, = port.pool.lan_peers
        conn = await port.pool.connect_to(peer)
        assert conn is not None
        await until(lambda: conn.fully_established, "the handshake")
    finally:
        await mine.stop()
        await theirs.stop()
        await port.stop()
        await jax.stop()


async def test_each_package_hears_the_others_announce():
    await asyncio.wait_for(_discover_both_ways(), 30)


def _datagrams():
    """(label, datagram) pairs neither package may believe."""
    ok = messages.AddrEntry(int(time.time()), 1, 9, "127.0.0.1", 8555)
    other_stream = messages.AddrEntry(int(time.time()), 7, 9, "127.0.0.1",
                                      8555)
    port0 = messages.AddrEntry(int(time.time()), 1, 9, "127.0.0.1", 0)
    good = pack_packet("addr", messages.encode_addr([ok]))
    bad_sum = good[:20] + bytes(4) + good[24:]
    return [("garbage", b"garbage not a packet"),
            ("short", good[:10]),
            ("ping", pack_packet("ping", b"")),
            ("checksum", bad_sum),
            ("truncated", good[:-3]),
            ("stream", pack_packet("addr",
                                   messages.encode_addr([other_stream]))),
            ("port 0", pack_packet("addr", messages.encode_addr([port0])))]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_garbage_and_non_addr_datagrams_are_ignored(pkg):
    """In process, without sockets: each datagram reaches
    ``datagram_received`` directly; none adds a peer, in either
    package.  A good addr from a public source is ignored too unless the
    node allows private peers."""
    if pkg == "port":
        pool, cls = port_pool(), UDPDiscovery
    else:
        pool, cls = jax_pool(), ref("network.udp").UDPDiscovery
    udp = cls(pool, port=0, bind_host=LOOPBACK)
    for label, data in _datagrams():
        udp.datagram_received(data, ("192.168.1.5", 8444))
        assert not pool.lan_peers, label
    ok = messages.AddrEntry(int(time.time()), 1, 9, "127.0.0.1", 8555)
    good = pack_packet("addr", messages.encode_addr([ok]))
    pool.ctx.allow_private_peers = False
    udp.datagram_received(good, ("8.8.8.8", 8444))
    assert not pool.lan_peers and udp.peers_heard == 0
    udp.datagram_received(good, ("192.168.1.5", 8444))
    peer_cls = Peer if pkg == "port" else ref("storage").Peer
    assert list(pool.lan_peers) == [peer_cls("192.168.1.5", 8555)]
    assert udp.peers_heard == 1


class _Sent:
    def __init__(self):
        self.datagrams = []

    def sendto(self, data, addr):
        self.datagrams.append((data, addr))

    def get_extra_info(self, key):
        return (LOOPBACK, 8444)


@pytest.mark.parametrize("services", [9, 9 | 2 | 16 | 32])
def test_the_announce_is_byte_identical(services, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25)
    sent = []
    for pool, cls in ((port_pool(), UDPDiscovery),
                      (jax_pool(), ref("network.udp").UDPDiscovery)):
        pool.ctx.port = 8444
        pool.ctx.services = services
        pool.ctx.streams = (1, 2)
        udp = cls(pool, port=8444, broadcast_host=LOOPBACK)
        udp.transport = _Sent()
        udp.announce(to=(LOOPBACK, 9999))
        udp.announce()
        sent.append(udp.transport.datagrams)
    assert sent[0] == sent[1]
    assert [addr for _, addr in sent[0]] == [(LOOPBACK, 9999),
                                             (LOOPBACK, 8444)]


async def _dial_a_lan_peer(monkeypatch):
    port, jax = _port_node(), _jax_node()
    await port.start()
    await jax.start()
    mine, theirs = _endpoints(port, jax)
    await mine.start()
    await theirs.start()
    try:
        theirs.announce(to=(LOOPBACK, mine.listen_port))
        await until(lambda: port.pool.lan_peers, "the announcement")
        # the dial loop prefers a fresh LAN peer half of the time: here
        # the draw says "prefer", and no known node competes
        monkeypatch.setattr(random, "random", lambda: 0.0)
        assert port.knownnodes.choose() is None
        await port.pool._dial_once()
        conn, = port.pool.outbound
        assert (conn.host, conn.port) == (LOOPBACK, jax.pool.listen_port)
        await until(lambda: conn.fully_established, "the handshake")
    finally:
        await mine.stop()
        await theirs.stop()
        await port.stop()
        await jax.stop()


async def test_the_dial_loop_dials_a_discovered_peer(monkeypatch):
    await asyncio.wait_for(_dial_a_lan_peer(monkeypatch), 30)


async def _node_endpoint():
    node = _port_node(udp_enabled=True)
    assert node.udp is not None and _port_node().udp is None
    # the first announce goes out at start: keep it on this host
    node.udp.broadcast_host = LOOPBACK
    await node.start()
    try:
        assert node.udp.listen_port == node.pool.listen_port
        await until(lambda: node.udp.announcements_sent >= 1,
                    "the first announce")
        await asyncio.sleep(0.1)
        # its own announce came back over loopback and was dropped
        assert not node.pool.lan_peers
    finally:
        await node.stop()
    assert node.udp.transport.is_closing()


async def test_a_node_runs_discovery_on_its_listening_port():
    await asyncio.wait_for(_node_endpoint(), 30)


# ---------------------------------------------------------------------------
# UPnP against a fake gateway
# ---------------------------------------------------------------------------

DESCRIPTION = (
    '<?xml version="1.0"?><root><device><serviceList><service>'
    "<serviceType>urn:schemas-upnp-org:service:WANIPConnection:1"
    "</serviceType><controlURL>/ctl/ip</controlURL>"
    "</service></serviceList></device></root>").encode()


class FakeIGD:
    """An SSDP responder and the gateway's HTTP server on 127.0.0.1,
    keeping every datagram and request byte they receive."""

    def __init__(self):
        self.searches: list[bytes] = []
        self.requests: list[bytes] = []

    async def start(self):
        loop = asyncio.get_running_loop()
        self.http = await asyncio.start_server(self._http, LOOPBACK, 0)
        http_port = self.http.sockets[0].getsockname()[1]
        igd = self

        class SSDP(asyncio.DatagramProtocol):
            def connection_made(self, transport):
                self.transport = transport

            def datagram_received(self, data, addr):
                igd.searches.append(data)
                self.transport.sendto(
                    b"HTTP/1.1 200 OK\r\nLOCATION: http://127.0.0.1:%d"
                    b"/desc.xml\r\n\r\n" % http_port, addr)
        self.ssdp, _ = await loop.create_datagram_endpoint(
            SSDP, local_addr=(LOOPBACK, 0))
        return (LOOPBACK, self.ssdp.get_extra_info("sockname")[1])

    async def _http(self, reader, writer):
        head = await reader.readuntil(b"\r\n\r\n")
        length = int(head.lower().split(b"content-length: ")[1]
                     .split(b"\r\n")[0])
        body = await reader.readexactly(length)
        self.requests.append(head + body)
        payload = DESCRIPTION if head.startswith(b"GET") else b"<ok/>"
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n"
                     % len(payload) + payload)
        await writer.drain()
        writer.close()

    def stop(self):
        self.ssdp.close()
        self.http.close()


async def _map_and_unmap(cls):
    igd = FakeIGD()
    ssdp = await igd.start()
    try:
        client = cls(ssdp_addr=ssdp)
        url = await client.discover(timeout=5)
        assert url.endswith("/ctl/ip") and client.local_ip == LOOPBACK
        assert await client.add_port_mapping(8444) == 8444
        await client.delete_port_mapping()
        assert client.mapped_port is None
    finally:
        igd.stop()
    port = ssdp[1]
    # the description request and the SOAP bodies name the gateway's
    # ephemeral port: keep it out of the comparison
    http_port = client.control_url.split(":")[2].split("/")[0]
    return igd.searches, [r.replace(http_port.encode(), b"<port>")
                          for r in igd.requests], port


async def test_upnp_requests_are_byte_identical():
    """The M-SEARCH datagram, the description fetch and the
    AddPortMapping and DeletePortMapping requests of the port's client
    are the JAX client's, byte for byte."""
    from pybitmessage_tpu_torch.network.upnp import UPnPClient
    mine = await asyncio.wait_for(_map_and_unmap(UPnPClient), 30)
    theirs = await asyncio.wait_for(
        _map_and_unmap(ref("network.upnp").UPnPClient), 30)
    assert mine[0] == theirs[0] and len(mine[0]) == 1
    assert mine[0][0].startswith(b"M-SEARCH * HTTP/1.1\r\n")
    assert mine[1] == theirs[1] and len(mine[1]) == 3
    get, add, delete = mine[1]
    assert get.startswith(b"GET /desc.xml HTTP/1.1\r\n")
    assert b"#AddPortMapping" in add and \
        b"<NewInternalPort>8444</NewInternalPort>" in add
    assert b"#DeletePortMapping" in delete
