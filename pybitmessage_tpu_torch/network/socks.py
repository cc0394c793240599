"""SOCKS5 / SOCKS4a client negotiation for proxied (Tor) dialing (the
twin of ``pybitmessage_tpu.network.socks``: the same requests, byte for
byte).

Reference: src/network/socks5.py:1-224, socks4a.py:1-147, proxy.py:1-148
— asyncore state machines (init -> auth -> connect -> proxy_handshake),
here plain async functions over an established stream to the proxy: the
state machine is the await sequence, so each protocol step is a couple
of lines and testable against a scripted fake proxy.

SOCKS5 (RFC 1928/1929): greeting with method list, optional
username/password subnegotiation, CONNECT with domain or IPv4/6
address.  SOCKS4a: CONNECT with the 0.0.0.x marker and a trailing
hostname.  Names, ``.onion`` hosts among them, go to the proxy
unresolved in both cases: no DNS lookup leaks around Tor.
"""

from __future__ import annotations

import asyncio
import ipaddress
import struct


class SocksError(ConnectionError):
    """Proxy refused or broke the negotiation."""


SOCKS5_ERRORS = {
    1: "general failure",
    2: "connection not allowed by ruleset",
    3: "network unreachable",
    4: "host unreachable",
    5: "connection refused",
    6: "TTL expired",
    7: "command not supported",
    8: "address type not supported",
}


async def _socks5_greet(reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter,
                        username: str, password: str) -> None:
    """The method negotiation and, when the proxy picks it, the
    username/password subnegotiation (RFC 1929)."""
    auth = bool(username or password)
    if auth:
        writer.write(b"\x05\x02\x00\x02")   # no-auth or user/pass
    else:
        writer.write(b"\x05\x01\x00")       # no-auth only
    await writer.drain()
    ver, method = await reader.readexactly(2)
    if ver != 5:
        raise SocksError("not a SOCKS5 proxy")
    if method == 0x02:
        if not auth:
            raise SocksError("proxy demands auth but none configured")
        u, p = username.encode(), password.encode()
        writer.write(bytes([1, len(u)]) + u + bytes([len(p)]) + p)
        await writer.drain()
        _, status = await reader.readexactly(2)
        if status != 0:
            raise SocksError("SOCKS5 authentication failed")
    elif method != 0x00:
        raise SocksError("no acceptable SOCKS5 auth method")


async def socks5_connect(reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         host: str, port: int, *,
                         username: str = "", password: str = "") -> None:
    """Negotiate a SOCKS5 CONNECT to host:port over the proxy stream."""
    await _socks5_greet(reader, writer, username, password)
    req = b"\x05\x01\x00" + _socks5_addr(host) + struct.pack(">H", port)
    writer.write(req)
    await writer.drain()
    ver, rep, _ = await reader.readexactly(3)
    if ver != 5:
        raise SocksError("malformed SOCKS5 reply")
    if rep != 0:
        raise SocksError("SOCKS5 connect failed: "
                         + SOCKS5_ERRORS.get(rep, "code %d" % rep))
    atyp = (await reader.readexactly(1))[0]
    if atyp == 1:
        await reader.readexactly(4 + 2)
    elif atyp == 3:
        n = (await reader.readexactly(1))[0]
        await reader.readexactly(n + 2)
    elif atyp == 4:
        await reader.readexactly(16 + 2)
    else:
        raise SocksError("bad SOCKS5 bound-address type")


def _socks5_addr(host: str) -> bytes:
    try:
        ip = ipaddress.ip_address(host)
    except ValueError:
        h = host.encode("idna")
        if len(h) > 255:
            raise SocksError("hostname too long")
        return b"\x03" + bytes([len(h)]) + h   # domain: remote DNS
    if ip.version == 4:
        return b"\x01" + ip.packed
    return b"\x04" + ip.packed


async def socks5_resolve(reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         hostname: str, *,
                         username: str = "", password: str = "") -> str:
    """Resolve ``hostname`` THROUGH the proxy (Tor's RESOLVE extension,
    command 0xF0) — no local DNS query ever leaves the machine.

    Reference: Socks5Resolver (socks5.py:169-224); here it returns the
    resolved address.
    """
    await _socks5_greet(reader, writer, username, password)
    h = hostname.encode("idna")
    if len(h) > 255:
        raise SocksError("hostname too long")
    writer.write(b"\x05\xf0\x00\x03" + bytes([len(h)]) + h
                 + struct.pack(">H", 0))
    await writer.drain()
    ver, rep, _ = await reader.readexactly(3)
    if ver != 5:
        raise SocksError("malformed SOCKS5 reply")
    if rep != 0:
        raise SocksError("SOCKS5 resolve failed: "
                         + SOCKS5_ERRORS.get(rep, "code %d" % rep))
    atyp = (await reader.readexactly(1))[0]
    if atyp == 1:
        addr = str(ipaddress.IPv4Address(await reader.readexactly(4)))
    elif atyp == 4:
        addr = str(ipaddress.IPv6Address(await reader.readexactly(16)))
    else:
        raise SocksError("bad RESOLVE reply address type")
    await reader.readexactly(2)      # bound port, unused
    return addr


async def resolve_via_proxy(proxy_host: str, proxy_port: int,
                            hostname: str, *, username: str = "",
                            password: str = "",
                            timeout: float = 30.0) -> str:
    """One-shot leak-free DNS resolution through a Tor SOCKS5 proxy."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(proxy_host, proxy_port), timeout)
    try:
        return await asyncio.wait_for(
            socks5_resolve(reader, writer, hostname,
                           username=username, password=password), timeout)
    finally:
        writer.close()


async def socks4a_connect(reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter,
                          host: str, port: int, *,
                          user: str = "") -> None:
    """Negotiate a SOCKS4a CONNECT (hostname form, remote DNS)."""
    try:
        ip = ipaddress.ip_address(host)
        if ip.version != 4:
            raise SocksError("SOCKS4a cannot carry IPv6")
        addr = ip.packed
        trailer = user.encode() + b"\x00"
    except ValueError:
        addr = b"\x00\x00\x00\x01"           # 0.0.0.x marker
        trailer = user.encode() + b"\x00" + host.encode("idna") + b"\x00"
    writer.write(b"\x04\x01" + struct.pack(">H", port) + addr + trailer)
    await writer.drain()
    resp = await reader.readexactly(8)
    if resp[0] != 0:
        raise SocksError("malformed SOCKS4a reply")
    if resp[1] != 0x5A:
        raise SocksError("SOCKS4a connect rejected (code 0x%02x)" % resp[1])


async def open_via_proxy(proxy_type: str, proxy_host: str, proxy_port: int,
                         host: str, port: int, *,
                         username: str = "", password: str = "",
                         timeout: float = 30.0):
    """Dial host:port through the configured proxy.

    Returns a connected (reader, writer) pair whose stream is already
    end-to-end with the target (reference proxy.py state 'proxy
    handshake done' -> connection reused by TCPConnection).
    """
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(proxy_host, proxy_port), timeout)
    try:
        if proxy_type == "SOCKS5":
            await asyncio.wait_for(
                socks5_connect(reader, writer, host, port,
                               username=username, password=password),
                timeout)
        elif proxy_type == "SOCKS4a":
            await asyncio.wait_for(
                socks4a_connect(reader, writer, host, port,
                                user=username), timeout)
        else:
            raise SocksError("unknown proxy type %r" % proxy_type)
    except BaseException:
        writer.close()
        raise
    return reader, writer
