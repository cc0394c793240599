"""Inbound SMTP gateway: email submission -> bitmessage send (copy of
``pybitmessage_tpu.gateways.smtp_server``).

Reference: src/class_smtpServer.py:25-180 — an smtpd.SMTPChannel on
127.0.0.1:8425 accepting AUTH PLAIN, mapping ``<BM-addr>@bmaddr.lan``
envelope addresses to bitmessage identities, and queuing a send.
Python 3.12 removed ``smtpd``, so this is a small asyncio SMTP server
speaking exactly the subset the gateway needs (EHLO/HELO, AUTH PLAIN,
MAIL, RCPT, DATA, RSET, NOOP, QUIT).
"""

from __future__ import annotations

import asyncio
import base64
import email
import email.header
import email.parser
import hmac
import logging
import re

from ..utils.tasks import spawn

logger = logging.getLogger("pybitmessage_tpu_torch.smtp")

SMTP_DOMAIN = "bmaddr.lan"     # reference class_smtpServer.py:24
DEFAULT_PORT = 8425
MAX_MESSAGE_BYTES = 2 * 1024 * 1024

_ANGLE = re.compile(r".*<([^>]+)>")


def _envelope_addr(arg: str) -> str:
    """Extract the address from 'MAIL FROM:<x@y>' style args."""
    m = _ANGLE.match(arg)
    return m.group(1) if m else arg.strip()


class SMTPGateway:
    """Accepts local email submissions and relays them as bitmessages."""

    def __init__(self, node, *, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT,
                 username: str = "", password: str = ""):
        self.node = node
        self.host = host
        self.port = port
        self.username = username
        self.password = password
        self._server: asyncio.AbstractServer | None = None
        #: observability
        self.relayed = 0
        self.rejected = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        logger.info("SMTP gateway on %s:%d", self.host, self.listen_port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    @property
    def listen_port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.port

    # -- SMTP conversation ---------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        async def send(line: str) -> None:
            writer.write((line + "\r\n").encode())
            await writer.drain()

        authed = not (self.username or self.password)
        mail_from = ""
        rcpt_to: list[str] = []
        try:
            await send("220 pybitmessage-tpu SMTP gateway")
            while True:
                raw = await reader.readline()
                if not raw:
                    return
                line = raw.decode("utf-8", "replace").rstrip("\r\n")
                verb, _, arg = line.partition(" ")
                verb = verb.upper()
                if verb == "EHLO":
                    await send("250-pybitmessage-tpu")
                    await send("250 AUTH PLAIN")
                elif verb == "HELO":
                    await send("250 pybitmessage-tpu")
                elif verb == "AUTH":
                    authed = await self._auth(arg, send, reader)
                elif verb == "MAIL":
                    mail_from = _envelope_addr(arg.partition(":")[2])
                    await send("250 OK")
                elif verb == "RCPT":
                    rcpt_to.append(_envelope_addr(arg.partition(":")[2]))
                    await send("250 OK")
                elif verb == "DATA":
                    if not authed:
                        await send("530 Authentication required")
                        continue
                    await send("354 End data with <CR><LF>.<CR><LF>")
                    data = await self._read_data(reader)
                    if data is None:
                        await send("552 Message too large")
                        continue
                    n = self._process_message(mail_from, rcpt_to, data)
                    if n:
                        await send("250 OK: queued %d message(s)" % n)
                    else:
                        await send("554 No valid bitmessage recipients")
                    mail_from, rcpt_to = "", []
                elif verb == "RSET":
                    mail_from, rcpt_to = "", []
                    await send("250 OK")
                elif verb == "NOOP":
                    await send("250 OK")
                elif verb == "QUIT":
                    await send("221 Bye")
                    return
                else:
                    await send("500 Unrecognized command")
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception as exc:
                # routine for a client that hung up mid-session, but
                # never silent (bmlint silent-swallow)
                logger.debug("SMTP connection close failed: %r", exc)

    async def _auth(self, arg: str, send, reader) -> bool:
        """AUTH PLAIN, inline or challenge form (RFC 4616)."""
        parts = arg.split(None, 1)
        if not parts or parts[0].upper() != "PLAIN":
            await send("504 Only AUTH PLAIN supported")
            return False
        if len(parts) == 2:
            blob = parts[1]
        else:
            await send("334 ")
            blob = (await reader.readline()).decode().strip()
        try:
            _, user, pwd = base64.b64decode(blob).decode().split("\x00")
        except Exception:
            await send("501 Malformed AUTH PLAIN")
            return False
        ok = hmac.compare_digest(user, self.username) and \
            hmac.compare_digest(pwd, self.password)
        if ok:
            await send("235 Authentication successful")
        else:
            await send("535 Authentication failed")
        return ok

    async def _read_data(self, reader) -> str | None:
        lines: list[bytes] = []
        size = 0
        while True:
            raw = await reader.readline()
            if not raw:
                raise ConnectionError("client vanished mid-DATA")
            if raw.rstrip(b"\r\n") == b".":
                break
            if raw.startswith(b".."):    # dot-stuffing
                raw = raw[1:]
            size += len(raw)
            if size > MAX_MESSAGE_BYTES:
                return None
            lines.append(raw)
        return b"".join(lines).decode("utf-8", "replace")

    # -- email -> bitmessage -------------------------------------------------

    def _process_message(self, mail_from: str, rcpt_to: list[str],
                         data: str) -> int:
        """Map envelope/headers to identities and queue sends.

        Sender resolution mirrors the reference (envelope first, From:
        header fallback, class_smtpServer.py:122-152): the local part
        must be one of OUR identities and the domain ``bmaddr.lan``.
        """
        msg = email.parser.Parser().parsestr(data)
        sender = self._resolve_sender(mail_from, msg)
        if sender is None:
            self.rejected += 1
            return 0
        subject = _decode_header(msg.get("Subject", "")) or \
            "Subject missing..."
        body = _extract_text(msg)
        queued = 0
        for rcpt in rcpt_to:
            local, _, domain = rcpt.partition("@")
            if domain != SMTP_DOMAIN:
                logger.warning("SMTP rcpt %s: not @%s", rcpt, SMTP_DOMAIN)
                continue
            try:
                from ..utils.addresses import decode_address
                decode_address(local)      # validate before queuing
                # cap TTL at 2 days (class_smtpServer.py:106-108)
                spawn(self.node.send_message(local, sender, subject, body,
                                             ttl=2 * 86400))
                queued += 1
                self.relayed += 1
            except Exception:
                logger.warning("SMTP relay to %s failed", rcpt,
                               exc_info=True)
        return queued

    def _resolve_sender(self, mail_from: str, msg) -> str | None:
        for candidate in (mail_from,
                          _envelope_addr(
                              _decode_header(msg.get("From", "")))):
            local, _, domain = candidate.partition("@")
            if domain == SMTP_DOMAIN and \
                    self.node.keystore.get(local) is not None:
                return local
        logger.error("SMTP sender %r is not a local identity", mail_from)
        return None


def _decode_header(value: str) -> str:
    out = []
    for chunk, charset in email.header.decode_header(value):
        if isinstance(chunk, bytes):
            out.append(chunk.decode(charset or "utf-8", "replace"))
        else:
            out.append(chunk)
    return "".join(out)


def _extract_text(msg) -> str:
    body = []
    for part in msg.walk():
        if part.get_content_type() == "text/plain":
            payload = part.get_payload(decode=True)
            if payload is not None:
                body.append(payload.decode(
                    part.get_content_charset("utf-8"), "replace"))
    if body:
        return "".join(body)
    payload = msg.get_payload()
    return payload if isinstance(payload, str) else ""
