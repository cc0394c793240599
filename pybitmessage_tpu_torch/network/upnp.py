"""UPnP IGD port mapping (the twin of ``pybitmessage_tpu.network.upnp``:
the same M-SEARCH and SOAP bodies, byte for byte; reference src/upnp.py,
uPnPThread).

Protocol: an SSDP M-SEARCH discovers the router, its LOCATION URL
serves a device-description XML naming the WAN(IP)Connection service's
controlURL, and SOAP POSTs there add and remove the TCP port mapping
for the P2P listener (reference createRequestXML / AddPortMapping,
upnp.py:68-220).  One ``UPnPClient`` with three awaitables replaces the
reference's thread and socket loops.  The daemon maps its listening
port with ``upnp=true`` and deletes the mapping when it stops; a
gateway that does not answer costs a warning, never the start.
"""

from __future__ import annotations

import asyncio
import logging
import re
import socket
import urllib.parse

logger = logging.getLogger("pybitmessage_tpu_torch.network")

SSDP_ADDR = ("239.255.255.250", 1900)
SSDP_SEARCH = (
    "M-SEARCH * HTTP/1.1\r\n"
    "HOST: 239.255.255.250:1900\r\n"
    'MAN: "ssdp:discover"\r\n'
    "MX: 2\r\n"
    "ST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n\r\n")

_SERVICE_RE = re.compile(
    r"<serviceType>(urn:schemas-upnp-org:service:WAN(?:IP|PPP)"
    r"Connection:\d)</serviceType>.*?<controlURL>([^<]+)</controlURL>",
    re.S)

_SOAP_BODY = """<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"
 s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">
<s:Body><u:{action} xmlns:u="{service}">{args}</u:{action}></s:Body>
</s:Envelope>"""


class UPnPError(ConnectionError):
    pass


class _SSDPProtocol(asyncio.DatagramProtocol):
    def __init__(self):
        self.location: asyncio.Future = \
            asyncio.get_running_loop().create_future()

    def datagram_received(self, data: bytes, addr) -> None:
        for line in data.decode("latin-1").splitlines():
            k, _, v = line.partition(":")
            if k.strip().lower() == "location" and not self.location.done():
                self.location.set_result(v.strip())


class UPnPClient:
    """Discover the gateway and manage one port mapping."""

    def __init__(self, *, ssdp_addr: tuple[str, int] = SSDP_ADDR,
                 local_ip: str | None = None):
        self.ssdp_addr = ssdp_addr
        self.local_ip = local_ip
        self.control_url: str | None = None
        self.service_type: str | None = None
        self.mapped_port: int | None = None

    # -- discovery -----------------------------------------------------------

    async def discover(self, timeout: float = 3.0) -> str:
        """SSDP search -> fetch description -> locate controlURL."""
        loop = asyncio.get_running_loop()
        transport, proto = await loop.create_datagram_endpoint(
            _SSDPProtocol, family=socket.AF_INET, allow_broadcast=True)
        try:
            transport.sendto(SSDP_SEARCH.encode(), self.ssdp_addr)
            location = await asyncio.wait_for(proto.location, timeout)
        finally:
            transport.close()
        if self.local_ip is None:
            # the interface that routes to the gateway is our LAN address
            host = urllib.parse.urlparse(location).hostname
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect((host, 9))
                self.local_ip = s.getsockname()[0]
            finally:
                s.close()
        desc = await self._http("GET", location)
        m = _SERVICE_RE.search(desc.decode("utf-8", "replace"))
        if not m:
            raise UPnPError("no WANIPConnection service in description")
        self.service_type = m.group(1)
        self.control_url = urllib.parse.urljoin(location, m.group(2))
        logger.info("UPnP gateway control URL: %s", self.control_url)
        return self.control_url

    # -- mapping -------------------------------------------------------------

    async def add_port_mapping(self, port: int, *,
                               external_port: int | None = None,
                               protocol: str = "TCP",
                               description: str = "pybitmessage-tpu") -> int:
        external_port = external_port or port
        args = (
            "<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{external_port}</NewExternalPort>"
            f"<NewProtocol>{protocol}</NewProtocol>"
            f"<NewInternalPort>{port}</NewInternalPort>"
            f"<NewInternalClient>{self.local_ip}</NewInternalClient>"
            "<NewEnabled>1</NewEnabled>"
            f"<NewPortMappingDescription>{description}"
            "</NewPortMappingDescription>"
            "<NewLeaseDuration>0</NewLeaseDuration>")
        await self._soap("AddPortMapping", args)
        self.mapped_port = external_port
        logger.info("UPnP mapped external port %d -> %s:%d",
                    external_port, self.local_ip, port)
        return external_port

    async def delete_port_mapping(self, external_port: int | None = None,
                                  protocol: str = "TCP") -> None:
        external_port = external_port or self.mapped_port
        if external_port is None:
            return
        args = ("<NewRemoteHost></NewRemoteHost>"
                f"<NewExternalPort>{external_port}</NewExternalPort>"
                f"<NewProtocol>{protocol}</NewProtocol>")
        await self._soap("DeletePortMapping", args)
        self.mapped_port = None

    # -- transport helpers ---------------------------------------------------

    async def _soap(self, action: str, args: str) -> bytes:
        if not self.control_url:
            raise UPnPError("gateway not discovered")
        body = _SOAP_BODY.format(action=action, service=self.service_type,
                                 args=args).encode()
        headers = {
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{self.service_type}#{action}"',
        }
        return await self._http("POST", self.control_url, body, headers)

    async def _http(self, method: str, url: str, body: bytes = b"",
                    headers: dict | None = None) -> bytes:
        u = urllib.parse.urlparse(url)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(u.hostname, u.port or 80), 10)
        try:
            path = u.path or "/"
            if u.query:
                path += "?" + u.query
            req = [f"{method} {path} HTTP/1.1", f"Host: {u.netloc}",
                   f"Content-Length: {len(body)}", "Connection: close"]
            for k, v in (headers or {}).items():
                req.append(f"{k}: {v}")
            writer.write(("\r\n".join(req) + "\r\n\r\n").encode() + body)
            await writer.drain()
            status = await reader.readline()
            if b"200" not in status.split(b" ", 2)[1:2][0:1] and \
                    b" 200 " not in status:
                raise UPnPError("HTTP error: " + status.decode().strip())
            while (await reader.readline()).strip():
                pass
            return await reader.read()
        finally:
            writer.close()
