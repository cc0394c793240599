"""Namecoin identity lookup: ``id/name`` -> BM- address (copy of
``pybitmessage_tpu.gateways.namecoin``).

Reference: src/namecoin.py:1-373 — resolves recipients through a local
namecoind (JSON-RPC ``name_show``) or nmcontrol (``data getValue``)
daemon; the name's JSON value carries a ``bitmessage`` (or legacy
``bm``) key with the address.  Used by the reference Qt send tab's
"fetch namecoin id" button; here it backs the API/CLI lookup.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging

logger = logging.getLogger("pybitmessage_tpu_torch.namecoin")


class NamecoinError(RuntimeError):
    pass


class NamecoinLookup:
    def __init__(self, *, host: str = "localhost", port: int = 8336,
                 user: str = "", password: str = "",
                 rpc_type: str = "namecoind"):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.rpc_type = rpc_type

    async def lookup(self, name: str) -> str:
        """Resolve ``name`` (with or without the id/ prefix) to a
        BM- address (reference namecoin.py query())."""
        if not name.startswith("id/"):
            name = "id/" + name
        if self.rpc_type == "nmcontrol":
            res = await self._call("data", ["getValue", name])
            if isinstance(res, dict):
                res = res.get("reply", res)
            value = res
        else:
            res = await self._call("name_show", [name])
            value = res.get("value") if isinstance(res, dict) else res
        if isinstance(value, str):
            try:
                value = json.loads(value)
            except ValueError:
                value = {}
        if not isinstance(value, dict):
            raise NamecoinError("name %r has no parseable value" % name)
        address = value.get("bitmessage") or value.get("bm")
        if not address:
            raise NamecoinError("name %r carries no bitmessage key" % name)
        return address

    async def test_connection(self) -> str:
        """Connectivity probe (reference HandleFetchNamecoinAddress
        'Test' button): returns the daemon's version string."""
        info = await self._call("getinfo", [])
        if isinstance(info, dict) and "version" in info:
            return str(info["version"])
        return "ok"

    async def _call(self, method: str, params: list):
        req = json.dumps({"jsonrpc": "1.0", "id": "bm", "method": method,
                          "params": params}).encode()
        auth = base64.b64encode(
            f"{self.user}:{self.password}".encode()).decode()
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), 10)
        except (OSError, asyncio.TimeoutError) as exc:
            raise NamecoinError(
                f"cannot reach namecoin daemon at "
                f"{self.host}:{self.port} ({exc})") from exc
        try:
            writer.write((
                f"POST / HTTP/1.1\r\nHost: {self.host}\r\n"
                f"Authorization: Basic {auth}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(req)}\r\n"
                f"Connection: close\r\n\r\n").encode() + req)
            await writer.drain()
            status = await reader.readline()
            if b"401" in status:
                raise NamecoinError("namecoin daemon rejected credentials")
            while (await reader.readline()).strip():
                pass
            body = await reader.read()
        finally:
            writer.close()
        try:
            resp = json.loads(body)
        except ValueError as exc:
            raise NamecoinError("malformed namecoin response") from exc
        if resp.get("error"):
            raise NamecoinError(str(resp["error"]))
        return resp.get("result")
