"""Minimal asyncio HTTP RPC server with basic auth: JSON-RPC + XML-RPC
(copy of ``pybitmessage_tpu.api.server``; every command dispatch,
JSON-RPC and XML-RPC alike, is the ``api.dispatch`` chaos site).

Reference: src/api.py singleAPI — XML/JSON-RPC on 127.0.0.1:8442 with
HTTP basic auth (api.py:437-457).  Both of the reference's apivariants
are served on the same port, auto-detected per request: a JSON body is
JSON-RPC 2.0 (``{"method", "params", "id"}``), an XML body is XML-RPC —
the protocol the reference's own ``bitmessagecli.py`` (xmlrpclib)
speaks.  API errors surface as numbered ``APIError NN: message``
strings (JSON error object / XML-RPC Fault), matching the reference's
error vocabulary (api.py:111-153).

GETs, under the same basic auth: ``/metrics`` serves the Prometheus
text exposition of the process-wide registry; ``/debug/device`` the
device-telemetry table, or with ``?seconds=N`` a ``torch.profiler``
trace captured for N seconds; ``/debug/profile`` the sampling
profiler's dump (collapsed stacks and a speedscope document; with
``?seconds=N`` the rolling window of the last N seconds);
``/metrics/federated`` the node's federation aggregator's merged fleet
view (404 "federation disabled" with federation off).  ``POST
/federation/push`` takes a child's or peer's delta-encoded snapshot
push into that aggregator and answers its ack.  Blocking work runs in
the executor.  Every other GET answers 404.
"""

from __future__ import annotations

import asyncio
import base64
import hmac
import json
import logging
import time
import xmlrpc.client

from ..observability import (PROFILER, REGISTRY, capture_device_trace,
                             device_status, render_prometheus)
from ..resilience import Deadline
from ..resilience.chaos import inject
from .commands import APIError, CommandHandler

logger = logging.getLogger("pybitmessage_tpu_torch.api")

MAX_REQUEST = 32 * 1024 * 1024
#: per-request wall budget; propagated as a resilience Deadline so
#: nested retries stop scheduling attempts that cannot finish in time
DEFAULT_REQUEST_TIMEOUT = 120.0

API_REQUESTS = REGISTRY.counter(
    "api_requests_total", "RPC dispatches by outcome", ("outcome",))
API_REQUEST_SECONDS = REGISTRY.histogram(
    "api_request_seconds", "RPC dispatch wall time")


class APIServer:
    def __init__(self, node, *, host: str = "127.0.0.1", port: int = 8442,
                 username: str = "", password: str = ""):
        self.node = node
        self.host = host
        self.port = port
        self.username = username
        self.password = password
        self.handler = CommandHandler(node)
        self._server: asyncio.AbstractServer | None = None

    async def _call(self, method: str, params: list):
        """One command dispatch under the request deadline (also a
        chaos injection site, ``api.dispatch``)."""
        t0 = time.monotonic()
        try:
            inject("api.dispatch")
            with Deadline(DEFAULT_REQUEST_TIMEOUT):
                result = await asyncio.wait_for(
                    self.handler.dispatch(method, params),
                    timeout=DEFAULT_REQUEST_TIMEOUT)
            API_REQUESTS.labels(outcome="ok").inc()
            return result
        except APIError:
            API_REQUESTS.labels(outcome="api_error").inc()
            raise
        except asyncio.TimeoutError:
            API_REQUESTS.labels(outcome="timeout").inc()
            raise APIError(
                1, "request exceeded the %.0fs server deadline"
                % DEFAULT_REQUEST_TIMEOUT)
        except Exception:
            API_REQUESTS.labels(outcome="error").inc()
            raise
        finally:
            API_REQUEST_SECONDS.observe(time.monotonic() - t0)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)

    @property
    def listen_port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # -- request handling ----------------------------------------------------

    def _authorized(self, headers: dict[str, str]) -> bool:
        if not self.username and not self.password:
            return True
        auth = headers.get("authorization", "")
        if not auth.lower().startswith("basic "):
            return False
        try:
            user, _, pwd = base64.b64decode(
                auth.split(None, 1)[1]).decode("utf-8").partition(":")
        except Exception:
            return False
        # constant-time comparison — don't leak credential prefixes to
        # local timing observers
        user_ok = hmac.compare_digest(user.encode(), self.username.encode())
        pwd_ok = hmac.compare_digest(pwd.encode(), self.password.encode())
        return user_ok and pwd_ok

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            headers: dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            length = int(headers.get("content-length", 0))
            if length > MAX_REQUEST:
                await self._respond(writer, 413, {"error": "too large"})
                return
            body = await reader.readexactly(length) if length else b""

            if request_line.startswith(b"GET"):
                await self._get(writer, request_line, headers)
                return
            if not request_line.startswith(b"POST"):
                await self._respond(writer, 405,
                                    {"error": "POST JSON-RPC only"})
                return
            if not self._authorized(headers):
                await self._respond(writer, 401, {"error": "unauthorized"},
                                    extra="WWW-Authenticate: Basic\r\n")
                return
            post_path = request_line.split()[1].decode(
                "latin-1", "replace").split("?")[0] \
                if len(request_line.split()) > 1 else ""
            if post_path == "/federation/push":
                await self._federation_push(writer, body)
                return
            is_xml = body.lstrip().startswith(b"<") or \
                "xml" in headers.get("content-type", "")
            if is_xml:
                xml_body = await self._dispatch_xml(body)
                await self._respond_raw(writer, 200, xml_body, "text/xml")
                return
            try:
                req = json.loads(body)
            except Exception:
                await self._respond(writer, 400, {"error": "bad json"})
                return
            response = await self._dispatch(req)
            await self._respond(writer, 200, response)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except Exception:
            logger.exception("API request failed")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception as exc:
                # routine for an already-dead client, but never silent
                logger.debug("API connection close failed: %r", exc)

    async def _get(self, writer, request_line: bytes,
                   headers: dict[str, str]) -> None:
        """The GET endpoints: ``/metrics``, ``/metrics/federated``,
        ``/debug/device[?seconds=N]`` and ``/debug/profile[?seconds=N]``;
        anything else is 404."""
        parts = request_line.split()
        raw_path = parts[1].decode("latin-1", "replace") \
            if len(parts) > 1 else ""
        path, _, query = raw_path.partition("?")
        if path not in ("/metrics", "/metrics/federated", "/debug/device",
                        "/debug/profile"):
            await self._respond(writer, 404, {"error": "not found"})
            return
        if not self._authorized(headers):
            await self._respond(writer, 401, {"error": "unauthorized"},
                                extra="WWW-Authenticate: Basic\r\n")
            return
        if path == "/metrics/federated":
            # the fleet-wide merged view; 404 when federation is off
            agg = getattr(self.node, "federation", None)
            if agg is None:
                await self._respond(writer, 404,
                                    {"error": "federation disabled"})
                return
            await self._respond_raw(
                writer, 200, agg.render().encode("utf-8"),
                "text/plain; version=0.0.4; charset=utf-8")
            return
        if path == "/metrics":
            await self._respond_raw(
                writer, 200, render_prometheus().encode("utf-8"),
                "text/plain; version=0.0.4; charset=utf-8")
            return
        seconds = None
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "seconds":
                try:
                    seconds = float(v)
                except ValueError:
                    await self._respond(writer, 400,
                                        {"error": "bad seconds"})
                    return
        if path == "/debug/profile":
            # the whole-run trie walk, the speedscope build and the
            # serialization run in the executor, not on the event loop
            win = seconds if seconds and seconds > 0 else None
            node_id = getattr(self.node, "node_id", "")
            body = await asyncio.get_running_loop().run_in_executor(
                None, lambda: json.dumps(
                    PROFILER.dump(win, node_id=node_id)).encode("utf-8"))
            await self._respond_raw(writer, 200, body, "application/json")
            return
        # the device table and a trace capture both block: executor,
        # not the event loop
        if seconds and seconds > 0:
            def work():
                return capture_device_trace(seconds)
        else:
            work = device_status
        try:
            doc = await asyncio.get_running_loop().run_in_executor(
                None, work)
        except ValueError as exc:
            await self._respond(writer, 400, {"error": str(exc)})
            return
        await self._respond_raw(
            writer, 200, json.dumps(doc, default=repr).encode("utf-8"),
            "application/json")

    async def _federation_push(self, writer, body: bytes) -> None:
        """Child processes and peer nodes push delta-encoded registry
        snapshots here; the ack drives their delta/resync
        bookkeeping."""
        agg = getattr(self.node, "federation", None)
        if agg is None:
            await self._respond(writer, 404,
                                {"error": "federation disabled"})
            return
        try:
            push = json.loads(body)
        except ValueError:
            await self._respond(writer, 400, {"error": "bad json"})
            return
        await self._respond(writer, 200, agg.ingest(push))

    async def _dispatch(self, req: dict) -> dict:
        method = req.get("method", "")
        params = req.get("params", [])
        rid = req.get("id")
        try:
            result = await self._call(method, list(params))
            return {"jsonrpc": "2.0", "result": result, "id": rid}
        except APIError as exc:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": exc.code, "message": str(exc)}}

    async def _dispatch_xml(self, body: bytes) -> bytes:
        """XML-RPC request -> methodResponse / Fault bytes.

        Faults use the reference convention: numbered APIError text in
        faultString (xmlrpclib clients see the same strings the
        reference's SimpleXMLRPCServer returned)."""
        try:
            params, method = xmlrpc.client.loads(body)
        except Exception:
            return xmlrpc.client.dumps(
                xmlrpc.client.Fault(1, "malformed XML-RPC request"),
                allow_none=True).encode()
        try:
            result = await self._call(method, list(params))
            return xmlrpc.client.dumps((result,), methodresponse=True,
                                       allow_none=True).encode()
        except APIError as exc:
            return xmlrpc.client.dumps(
                xmlrpc.client.Fault(exc.code, str(exc)),
                allow_none=True).encode()
        except xmlrpc.client.Fault as exc:
            return xmlrpc.client.dumps(exc, allow_none=True).encode()
        except Exception as exc:
            logger.exception("XML-RPC dispatch failed")
            return xmlrpc.client.dumps(
                xmlrpc.client.Fault(1, repr(exc)),
                allow_none=True).encode()

    @staticmethod
    async def _respond_raw(writer, status: int, body: bytes,
                           content_type: str, extra: str = "") -> None:
        reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                  404: "Not Found", 405: "Method Not Allowed",
                  413: "Payload Too Large"}
        head = (f"HTTP/1.1 {status} {reason.get(status, '')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{extra}Connection: close\r\n\r\n")
        writer.write(head.encode("latin-1") + body)
        await writer.drain()

    @classmethod
    async def _respond(cls, writer, status: int, payload: dict,
                       extra: str = "") -> None:
        await cls._respond_raw(writer, status,
                               json.dumps(payload).encode("utf-8"),
                               "application/json", extra)
