"""The port's SOCKS5 / SOCKS4a dials against the JAX package's, on the CPU.

Each case scripts a proxy's replies into a stream reader and records
what the client writes: the port's and the JAX functions must send
byte-identical requests and end the same way (the same result, or the
same error and message) for SOCKS5 without and with authentication, a
domain, an IPv6 host, a ``.onion`` host passed on unresolved, a
rejection, a refused login, a non-SOCKS5 answer, SOCKS4a by name and by
address, and Tor's remote resolve.  Over loopback TCP, a port ``Node``
dials a JAX ``Node`` through the JAX tests' fake SOCKS5 proxy (with a
login, and an ``.onion`` name the proxy tunnels) and through a SOCKS4a
one, and the proxy counts one connect per dial.
"""

import asyncio
import importlib
import struct
import time

import pytest

from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.network import socks
from pybitmessage_tpu_torch.storage.knownnodes import Peer

LOOPBACK = "127.0.0.1"


def ref(module: str):
    return importlib.import_module("pybitmessage_tpu." + module)


class Recorder:
    """The client's side of a proxy stream: what it writes is kept."""

    def __init__(self):
        self.sent = bytearray()

    def write(self, data: bytes) -> None:
        self.sent += data

    async def drain(self) -> None:
        pass

    def close(self) -> None:
        pass


def _reply5(atyp: int = 1, rep: int = 0) -> bytes:
    bound = {1: b"\x0a\x00\x00\x01", 3: b"\x05proxy",
             4: b"\x00" * 15 + b"\x01"}[atyp]
    return bytes([5, rep, 0, atyp]) + bound + b"\x1f\x90"


#: case -> (function name, args, kwargs, the proxy's scripted replies)
CASES = {
    "socks5_no_auth_ipv4": (
        "socks5_connect", ("10.1.2.3", 8444), {},
        b"\x05\x00" + _reply5()),
    "socks5_auth_domain": (
        "socks5_connect", ("bootstrap8444.bitmessage.org", 8444),
        {"username": "alice", "password": "s3cret"},
        b"\x05\x02" + b"\x01\x00" + _reply5(3)),
    "socks5_ipv6_bound_ipv6": (
        "socks5_connect", ("2001:db8::7", 8080), {},
        b"\x05\x00" + _reply5(4)),
    "socks5_onion_unresolved": (
        "socks5_connect", ("quintessential22.onion", 8444), {},
        b"\x05\x00" + _reply5()),
    "socks5_rejected": (
        "socks5_connect", ("10.1.2.3", 8444), {},
        b"\x05\x00" + _reply5(rep=5)),
    "socks5_login_refused": (
        "socks5_connect", ("10.1.2.3", 8444),
        {"username": "alice", "password": "wrong"},
        b"\x05\x02" + b"\x01\x01"),
    "socks5_auth_demanded_none_given": (
        "socks5_connect", ("10.1.2.3", 8444), {}, b"\x05\x02"),
    "not_socks5": (
        "socks5_connect", ("10.1.2.3", 8444), {}, b"\x04\x00"),
    "socks4a_by_name": (
        "socks4a_connect", ("example.onion", 8444), {"user": "bm"},
        b"\x00\x5a" + b"\x00" * 6),
    "socks4a_by_address": (
        "socks4a_connect", ("10.1.2.3", 8444), {},
        b"\x00\x5a" + b"\x00" * 6),
    "socks4a_rejected": (
        "socks4a_connect", ("example.onion", 8444), {},
        b"\x00\x5b" + b"\x00" * 6),
    "socks5_remote_resolve": (
        "socks5_resolve", ("bootstrap8080.bitmessage.org",),
        {"username": "u", "password": "p"},
        b"\x05\x02" + b"\x01\x00" + b"\x05\x00\x00\x01"
        + b"\x0a\x0b\x0c\x0d" + b"\x00\x00"),
    "socks5_resolve_failed": (
        "socks5_resolve", ("unknown.example",), {},
        b"\x05\x00" + b"\x05\x04\x00\x01" + b"\x00" * 6),
}


async def _run(module, name, args, kwargs, replies):
    reader = asyncio.StreamReader()
    reader.feed_data(replies)
    reader.feed_eof()
    writer = Recorder()
    try:
        out = await getattr(module, name)(reader, writer, *args, **kwargs)
    except Exception as exc:        # the ending is compared, not judged
        out = (type(exc).__name__, str(exc))
    return bytes(writer.sent), out


@pytest.mark.parametrize("case", sorted(CASES))
async def test_requests_are_byte_identical(case):
    name, args, kwargs, replies = CASES[case]
    mine = await _run(socks, name, args, kwargs, replies)
    theirs = await _run(ref("network.socks"), name, args, kwargs, replies)
    assert mine == theirs
    sent, out = mine
    assert sent
    if case.endswith(("rejected", "refused", "none_given", "not_socks5",
                      "failed")):
        assert out[0] == "SocksError"
    else:
        assert out == ("10.11.12.13" if name == "socks5_resolve" else None)
    if "onion" in case or "domain" in case or "by_name" in case:
        # the name goes to the proxy as it is: no local lookup
        assert args[0].encode() in sent


async def until(pred, what: str, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        await asyncio.sleep(0.02)


class FakeSocks4a:
    """A SOCKS4a proxy that tunnels each CONNECT to ``tunnel_to`` and
    counts its connects."""

    def __init__(self, tunnel_to):
        self.tunnel_to = tunnel_to
        self.connects = []
        self.server = None

    async def start(self) -> int:
        self.server = await asyncio.start_server(self._handle, LOOPBACK, 0)
        return self.server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        self.server.close()
        await self.server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            head = await reader.readexactly(8)
            user = (await reader.readuntil(b"\x00"))[:-1]
            if head[4:7] == b"\x00\x00\x00" and head[7]:
                # the 0.0.0.x marker: a name follows the user id
                host = (await reader.readuntil(b"\x00"))[:-1].decode()
            else:
                host = ".".join(map(str, head[4:8]))
            self.connects.append((user, host,
                                  struct.unpack(">H", head[2:4])[0]))
            writer.write(b"\x00\x5a" + b"\x00" * 6)
            await writer.drain()
            tr, tw = await asyncio.open_connection(*self.tunnel_to)

            async def pump(src, dst):
                try:
                    while data := await src.read(65536):
                        dst.write(data)
                        await dst.drain()
                except ConnectionError:
                    pass
                finally:
                    dst.close()
            await asyncio.gather(pump(reader, tw), pump(tr, writer))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass


def _jax_node():
    import jax
    jax.config.update("jax_platforms", "cpu")
    core, dispatcher = ref("core"), ref("pow.dispatcher")

    def solver(ih, target, should_stop=None):
        return dispatcher.python_solve(ih, target, should_stop=should_stop)
    return core.Node(None, listen=True, solver=solver, test_mode=True,
                     dandelion_enabled=False, federation_enabled=False,
                     allow_private_peers=True, tls_enabled=False)


@pytest.mark.parametrize("proxy_type", ["SOCKS5", "SOCKS4a"])
async def test_a_port_node_dials_a_jax_node_through_a_proxy(proxy_type):
    await asyncio.wait_for(_dial_through(proxy_type), 30)


async def _dial_through(proxy_type):
    """The pool's dials go through ``ctx.proxy``: one to the JAX node's
    address and one to an ``.onion`` name the proxy tunnels to it; the
    proxy sees the name, unresolved, and one connect per dial."""
    from tests.test_socks import FakeSocks5
    jax = _jax_node()
    port = Node(device="cpu", test_mode=True, allow_private_peers=True,
                crypto_batch=False, listen=False, dandelion_enabled=False,
                federation_enabled=False)
    await jax.start()
    target = (LOOPBACK, jax.pool.listen_port)
    if proxy_type == "SOCKS5":
        proxy = FakeSocks5(require_auth=True, user=b"tor", pwd=b"pass",
                           tunnel_to=target)
    else:
        proxy = FakeSocks4a(target)
    pport = await proxy.start()
    await port.start()
    port.ctx.proxy = {"type": proxy_type, "host": LOOPBACK, "port": pport,
                      "username": "tor", "password": "pass"}
    seen = []
    try:
        for host in (LOOPBACK, "quintessential22.onion"):
            conn = await asyncio.wait_for(port.pool.connect_to(
                Peer(host, jax.pool.listen_port)), 30)
            assert conn is not None
            await until(lambda: conn.fully_established, "the handshake")
            seen.append(proxy.connected_to if proxy_type == "SOCKS5"
                        else proxy.connects[-1][1:])
            await conn.close()
            await until(lambda: not jax.pool.connections(), "the close")
        assert seen == [(host, jax.pool.listen_port)
                        for host in (LOOPBACK, "quintessential22.onion")]
        if proxy_type == "SOCKS4a":
            assert [c[0] for c in proxy.connects] == [b"tor", b"tor"]
    finally:
        await port.stop()
        await jax.stop()
        await proxy.stop()
