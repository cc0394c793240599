"""API command handlers over a Node (copy of
``pybitmessage_tpu.api.commands``).

Same command names, semantics, and error codes as the reference
(src/api.py:111-153 error table, 550-1500 handlers); subjects/bodies
are base64 on the wire exactly as the reference's API encodes them.
Each command returns the JAX package's JSON text, or raises its
numbered ``APIError``, for the same node state.

All 77 JAX commands are here, the email gateway's
(``setEmailGateway``, ``emailGatewayRegister``,
``emailGatewayUnregister``, ``emailGatewayStatus``,
``emailGatewaySettings``, ``sendEmail``) and ``setMailingList`` among
them.
``federatedStatus`` answers the node's federation aggregator's fleet
view.  ``roleStatus``, ``shardStatus`` and
``shardShed`` answer as the JAX ones do over the port's ``roles``
runtimes (an edge's relay links and client plane, a relay's edges and
its live shard handoff, a light client's session); ``costStatus`` and
``profileDump`` over the port's sampling profiler.

The telemetry commands (``metrics``, ``dumpFlightRecorder``,
``deviceStatus``, ``profileDevice``, ``objectTimeline``) answer as the
JAX ones do, over the port's ``observability`` package; ``clientStatus``
carries the JAX ``device`` (per-program launches from the registry),
``health``, ``farm`` and ``clients`` blocks, and of the JAX
``resilience`` block the PoW journal's part (pending jobs, checkpoints,
jobs recovered at open) and the armed chaos sites.  ``farmStatus`` answers the JAX command's
text: the farm daemon's scheduler, tenants and job outcomes, and the
client tier's endpoint and breaker.
"""

from __future__ import annotations

import asyncio
import base64
import json
import time
from binascii import hexlify, unhexlify

from ..models.constants import OBJECT_MSG, OBJECT_PUBKEY
from ..models.objects import ObjectHeader
from ..core.config import DEFAULTS, Settings, SettingsError
from ..crypto.keys import grind_deterministic_keys
from ..observability import (FLIGHT_RECORDER, LIFECYCLE, PROFILER,
                             REGISTRY, HealthMonitor, capture_device_trace,
                             cost_status, device_status, render_prometheus)
from ..resilience import breaker_snapshot
from ..resilience.chaos import CHAOS
from ..utils.addresses import AddressError, decode_address, encode_address
from ..utils.hashes import inventory_hash

#: reference error table (api.py:111-153)
ERROR_CODES = {
    0: "Invalid command parameters number",
    1: "The specified passphrase is blank.",
    2: "The address version number currently must be 3, 4, or 0 (which "
       "means auto-select).",
    3: "The stream number must be 1 (or 0 which means auto-select). "
       "Others aren't supported.",
    4: "Why would you ask me to generate 0 addresses for you?",
    5: "You have (accidentally?) specified too many addresses to make.",
    6: "The encoding type must be 2 or 3.",
    7: "Could not decode address",
    8: "Checksum failed for address",
    9: "Invalid characters in address",
    10: "Address version number too high (or zero)",
    11: "The address version number currently must be 2, 3 or 4. Others "
        "aren't supported. Check the address.",
    12: "The stream number must be 1. Others aren't supported. Check the "
        "address.",
    13: "Could not find this address in your keys.dat file.",
    14: "Your fromAddress is disabled. Cannot send.",
    15: "Invalid ackData object size.",
    16: "You are already subscribed to that address.",
    17: "Label is not valid UTF-8 data.",
    18: "Chan name does not match address.",
    19: "The length of hash should be 32 bytes (encoded in hex thus 64 "
        "characters).",
    20: "Invalid method:",
    21: "Unexpected API Failure",
    22: "Decode error",
    23: "Bool expected in eighteenByteRipe",
    24: "Chan address is already present.",
    25: "Specified address is not a chan address. Use deleteAddress API "
        "call instead.",
    26: "Malformed varint in address: ",
    27: "Message is too long.",
}

_ADDRESS_ERROR_TO_CODE = {
    "checksumfailed": 8,
    "invalidcharacters": 9,
    "versiontoohigh": 10,
    "varintmalformed": 26,
    "ripetoolong": 25,
    "ripetooshort": 25,
}


class APIError(Exception):
    def __init__(self, code: int, detail: str = ""):
        self.code = code
        msg = ERROR_CODES.get(code, "Unknown error")
        super().__init__(f"API Error {code:04d}: {msg}"
                         + (f" {detail}" if detail else ""))


def _b64(s) -> str:
    if isinstance(s, str):
        s = s.encode("utf-8")
    return base64.b64encode(s).decode("ascii")


def _from_b64(s: str, code: int = 22) -> str:
    try:
        return base64.b64decode(s).decode("utf-8")
    except Exception as exc:
        raise APIError(code, str(exc))


class CommandHandler:
    """All RPC commands; dispatch by method name."""

    def __init__(self, node):
        self.node = node

    async def dispatch(self, method: str, params: list):
        handler = getattr(self, "cmd_" + method, None)
        if handler is None:
            raise APIError(20, method)
        try:
            result = handler(*params)
            if hasattr(result, "__await__"):
                result = await result
            return result
        except APIError:
            raise
        except AddressError as exc:
            raise APIError(_ADDRESS_ERROR_TO_CODE.get(exc.status, 7),
                           str(exc))
        except TypeError as exc:
            if "positional argument" in str(exc):
                raise APIError(0, str(exc))
            raise APIError(21, str(exc))
        except Exception as exc:
            raise APIError(21, repr(exc))

    # -- trivial / diagnostics ----------------------------------------------

    def cmd_helloWorld(self, a, b):
        return f"{a}-{b}"

    def cmd_add(self, a, b):
        return a + b

    def cmd_statusBar(self, message):
        self.node.ui.emit("updateStatusBar", (_from_b64(message, 22),))
        return None

    def cmd_getStatusBar(self):
        """Testmode helper (reference api.py @testmode('getStatusBar')):
        last updateStatusBar text pushed through the UI signaler."""
        for _seq, command, data in reversed(self.node.ui.recent):
            if command == "updateStatusBar" and data:
                return data[0]
        return ""

    async def cmd_waitForEvents(self, since=0, timeout=20):
        """Long-poll the UISignal stream (the event-driven frontend
        contract, reference bitmessageqt/uisignaler.py:8-60 — but over
        the API so out-of-process frontends need not refresh-poll).

        Returns ``{"events": [{"seq", "command", "data"}...], "next"}``
        immediately when events newer than ``since`` are buffered,
        otherwise after the first new event or ``timeout`` seconds
        (capped at 60).  Pass ``next`` back as ``since`` to resume."""
        try:
            since = int(since)
            timeout = min(float(timeout), 60.0)
        except (TypeError, ValueError):
            raise APIError(0, "since/timeout must be numeric")
        # a cursor ahead of our seq means the daemon restarted (seq
        # reset to 0) — clamp so the client resynchronizes instead of
        # waiting for the counter to catch its stale cursor up
        since = min(since, self.node.ui.seq)
        events = await self.node.ui.wait_for_events(since, timeout)
        out = [{"seq": s, "command": c,
                "data": [x.hex() if isinstance(x, (bytes, bytearray))
                         else x for x in d]}
               for s, c, d in events]
        return json.dumps({
            "events": out,
            "next": events[-1][0] if events else since})

    def cmd_clearUISignalQueue(self):
        """Testmode helper: drop buffered UI events (the reference
        empties its UISignalQueue; our analog is the recent-events
        ring frontends replay on attach)."""
        self.node.ui.recent.clear()
        return "success"

    # -- addresses -----------------------------------------------------------

    def cmd_decodeAddress(self, address):
        a = decode_address(address)
        return json.dumps({
            "status": "success", "addressVersion": a.version,
            "streamNumber": a.stream, "ripe": _b64(a.ripe)})

    def _list_addresses(self, encode_label):
        out = []
        for ident in self.node.keystore.identities.values():
            out.append({
                "label": encode_label(ident.label),
                "address": ident.address, "stream": ident.stream,
                "enabled": ident.enabled, "chan": ident.chan,
                "mailinglist": ident.mailinglist,
                "mailinglistname": ident.mailinglistname})
        return json.dumps({"addresses": out}, indent=4)

    def cmd_setMailingList(self, address, enabled, name=""):
        """Extension: toggle mailing-list mode on an own identity (the
        reference's per-address 'mailinglist'/'mailinglistname' config
        keys, set from the Qt identities context menu)."""
        ident = self.node.keystore.get(address)
        if ident is None:
            raise APIError(13)
        if not isinstance(enabled, bool):
            raise APIError(23)
        ident.mailinglist = enabled
        ident.mailinglistname = _from_b64(name, 17) if name else ""
        self.node.keystore.save()
        return "success"

    def cmd_listAddresses(self):
        return self._list_addresses(lambda label: label)

    def cmd_listAddresses2(self):
        # reference api.py registers listAddresses2 on the same handler
        # but base64-encodes labels when invoked under that name
        # (api.py: if self._method == 'listAddresses2': b64encode(label))
        return self._list_addresses(_b64)

    def cmd_createRandomAddress(self, label, eighteenByteRipe=False,
                                *_ignored):
        if not isinstance(eighteenByteRipe, bool):
            raise APIError(23)
        label = _from_b64(label, 17)
        ident = self.node.keystore.create_random(
            label, leading_zeros=2 if eighteenByteRipe else 1)
        self.node.sender.queue.put_nowait(("sendpubkey", ident.address))
        return ident.address

    def cmd_createDeterministicAddresses(
            self, passphrase, numberOfAddresses=1, addressVersionNumber=0,
            streamNumber=0, eighteenByteRipe=False, *_ignored):
        passphrase = _from_b64(passphrase, 1)
        if not passphrase:
            raise APIError(1)
        if numberOfAddresses == 0:
            raise APIError(4)
        if numberOfAddresses > 999:
            raise APIError(5)
        if addressVersionNumber not in (0, 3, 4):
            raise APIError(2)
        if streamNumber not in (0, 1):
            raise APIError(3)
        addresses = []
        nonce = 0
        for _ in range(numberOfAddresses):
            sk, ek, ripe, nonce = self._grind(passphrase, start_nonce=nonce)
            ident = self.node.keystore._register(
                "", addressVersionNumber or 4, streamNumber or 1, ripe,
                sk, ek)
            addresses.append(ident.address)
            nonce += 2
        return json.dumps({"addresses": addresses}, indent=4)

    def cmd_getDeterministicAddress(self, passphrase,
                                    addressVersionNumber=4,
                                    streamNumber=1):
        passphrase = _from_b64(passphrase, 1)
        if not passphrase:
            raise APIError(1)
        if addressVersionNumber not in (3, 4):
            raise APIError(2)
        if streamNumber != 1:
            raise APIError(3)
        _, _, ripe, _ = self._grind(passphrase)
        return encode_address(addressVersionNumber, streamNumber, ripe)

    def _grind(self, passphrase: str, start_nonce: int = 0):
        """The deterministic key grind, derived on the node's device as
        the keystore derives (``priv_to_pub_many``)."""
        ks = self.node.keystore
        return grind_deterministic_keys(
            passphrase.encode("utf-8"), start_nonce=start_nonce,
            derive=ks._derive, batch=ks._grind_batch)

    def cmd_createChan(self, passphrase):
        passphrase_raw = _from_b64(passphrase, 1)
        if not passphrase_raw:
            raise APIError(1)
        ident = self.node.keystore.create_deterministic(
            passphrase_raw.encode("utf-8"), f"[chan] {passphrase_raw}",
            chan=True)
        return ident.address

    def cmd_joinChan(self, passphrase, address):
        passphrase_raw = _from_b64(passphrase, 1)
        if not passphrase_raw:
            raise APIError(1)
        a = decode_address(address)
        if a.version not in (2, 3, 4):
            raise APIError(2)
        # ownership check on the canonical form — decode tolerates a
        # missing BM- prefix but the keystore stores canonical strings
        if self.node.keystore.owns(
                encode_address(a.version, a.stream, a.ripe)):
            raise APIError(24)
        # derive FIRST, register only on a match — a mismatch must not
        # leave a stray derived identity in the keystore (the reference
        # validator does this check pre-registration too,
        # bitmessageqt/addressvalidator.py).  RIPE-byte comparison, not
        # string equality: decode tolerates a missing BM- prefix.
        sk, ek, ripe, _ = self._grind(passphrase_raw)
        if a.ripe != ripe:
            raise APIError(18)
        self.node.keystore._register(
            f"[chan] {passphrase_raw}", a.version, a.stream, ripe, sk, ek,
            chan=True)
        return "success"

    def cmd_leaveChan(self, address):
        ident = self.node.keystore.get(address)
        if ident is None:
            raise APIError(13)
        if not ident.chan:
            raise APIError(25)
        self._delete_identity(address)
        return "success"

    def cmd_deleteAddress(self, address):
        if not self.node.keystore.owns(address):
            raise APIError(13)
        self._delete_identity(address)
        return "success"

    def _delete_identity(self, address):
        # KeyStore.remove bumps the keyring epoch, flushing the
        # trial-decrypt negative screen (crypto/screen.py)
        self.node.keystore.remove(address)

    def cmd_enableAddress(self, address, enable=True):
        ident = self.node.keystore.get(address)
        if ident is None:
            raise APIError(13)
        ident.enabled = bool(enable)
        self.node.keystore.save()
        return "success"

    # -- address book --------------------------------------------------------

    def cmd_listAddressBookEntries(self):
        entries = [{"label": _b64(label), "address": address}
                   for label, address in self.node.store.addressbook()]
        return json.dumps({"addresses": entries}, indent=4)

    def cmd_addAddressBookEntry(self, address, label):
        decode_address(address)
        if not self.node.store.addressbook_add(address, _from_b64(label, 17)):
            raise APIError(16, "Already have this address in the book")
        return "Added address %s to address book" % address

    def cmd_deleteAddressBookEntry(self, address):
        decode_address(address)
        self.node.store.addressbook_delete(address)
        return "Deleted address book entry for %s" % address

    # -- black/whitelist (extension) -----------------------------------------
    # The reference manages these tables only through the Qt GUI
    # (bitmessageqt/blacklist.py over the blacklist/whitelist SQL
    # tables); our frontends are out-of-process RPC clients, so the
    # same operations are exposed as API extensions.

    def _listing(self, which):
        rows = [{"label": _b64(label), "address": address,
                 "enabled": enabled}
                for label, address, enabled in self.node.store.listing(which)]
        return json.dumps({which: rows}, indent=4)

    def cmd_listBlacklistEntries(self):
        return self._listing("blacklist")

    def cmd_listWhitelistEntries(self):
        return self._listing("whitelist")

    def _listing_add(self, which, address, label):
        decode_address(address)
        if not self.node.store.listing_add(which, address,
                                           _from_b64(label, 17)):
            raise APIError(16, "%s already in %s" % (address, which))
        return "Added %s to %s" % (address, which)

    def cmd_addBlacklistEntry(self, address, label):
        return self._listing_add("blacklist", address, label)

    def cmd_addWhitelistEntry(self, address, label):
        return self._listing_add("whitelist", address, label)

    def cmd_deleteBlacklistEntry(self, address):
        self.node.store.listing_delete("blacklist", address)
        return "Deleted blacklist entry for %s" % address

    def cmd_deleteWhitelistEntry(self, address):
        self.node.store.listing_delete("whitelist", address)
        return "Deleted whitelist entry for %s" % address

    def cmd_getBlackWhitelistMode(self):
        return self.node.processor.list_mode

    def cmd_setBlackWhitelistMode(self, mode):
        if mode not in ("black", "white"):
            raise APIError(23, "mode must be 'black' or 'white'")
        self.node.processor.list_mode = mode
        settings = getattr(self.node, "settings", None)
        if settings is not None:
            settings.set("blackwhitelist", mode)
            settings.save()
        return "success"

    # -- settings (extension) ------------------------------------------------
    # The reference's settings dialog edits keys.dat in-process
    # (bitmessageqt/settings.py over BMConfigParser); the RPC analog
    # lets an attached GUI read and persist daemon settings.

    def _settings(self):
        settings = getattr(self.node, "settings", None)
        if settings is None:
            settings = self.node.settings = Settings()
        return settings

    def cmd_getSettings(self):
        s = self._settings()
        # never hand secrets back out — drop every credential-bearing
        # option (api, socks, smtpd, namecoin, and any future *password*)
        out = {k: v for k, v in s.options().items()
               if "password" not in k}
        out["powBackends"] = getattr(self.node.solver, "backends",
                                     lambda: [])()
        return json.dumps(out, indent=4)

    def cmd_updateSetting(self, key, value):
        s = self._settings()
        if key not in DEFAULTS:
            # Settings.set would happily persist a typo'd option name
            # and the caller would believe it took effect
            raise APIError(20, "unknown setting %r" % key)
        try:
            s.set(key, value)
        except SettingsError as exc:
            raise APIError(23, str(exc))
        s.save()
        self._apply_live_setting(key, value)
        return "success"

    def _apply_live_setting(self, key, value):
        """Settings that can take effect without a restart do."""
        node = self.node
        if key == "maxdownloadrate":
            node.ctx.download_bucket.rate = int(value) * 1024
        elif key == "maxuploadrate":
            node.ctx.upload_bucket.rate = int(value) * 1024
        elif key == "maxoutboundconnections":
            node.pool.max_outbound = int(value)
        elif key == "maxtotalconnections":
            node.pool.max_total = int(value)
        elif key == "dandelion":
            node.dandelion.stem_probability = int(value)
        elif key == "blackwhitelist":
            node.processor.list_mode = value

    # -- inbox / sent --------------------------------------------------------

    @staticmethod
    def _inbox_json(m):
        return {
            "msgid": hexlify(m.msgid).decode(),
            "toAddress": m.toaddress, "fromAddress": m.fromaddress,
            "subject": _b64(m.subject), "message": _b64(m.message),
            "encodingType": m.encodingtype, "receivedTime": m.received,
            "read": int(m.read)}

    @staticmethod
    def _sent_json(m):
        return {
            "msgid": hexlify(m.msgid).decode(),
            "toAddress": m.toaddress, "fromAddress": m.fromaddress,
            "subject": _b64(m.subject), "message": _b64(m.message),
            "encodingType": m.encodingtype,
            "lastActionTime": m.lastactiontime, "status": m.status,
            "ackData": hexlify(m.ackdata).decode()}

    def cmd_getAllInboxMessages(self):
        msgs = [self._inbox_json(m) for m in self.node.store.inbox()]
        return json.dumps({"inboxMessages": msgs}, indent=4)

    def cmd_getAllInboxMessageIds(self):
        msgs = [{"msgid": hexlify(m.msgid).decode()}
                for m in self.node.store.inbox()]
        return json.dumps({"inboxMessageIds": msgs}, indent=4)

    def cmd_getInboxMessageById(self, msgid_hex, read_flag=None):
        msgid = self._hex_msgid(msgid_hex)
        m = self.node.store.inbox_by_id(msgid)
        if m is None:
            return json.dumps({"inboxMessage": []})
        if read_flag is not None:
            self.node.store.mark_read(msgid, bool(read_flag))
        return json.dumps({"inboxMessage": [self._inbox_json(m)]}, indent=4)

    def cmd_getInboxMessagesByReceiver(self, toAddress):
        msgs = [self._inbox_json(m) for m in self.node.store.inbox()
                if m.toaddress == toAddress]
        return json.dumps({"inboxMessages": msgs}, indent=4)

    def cmd_getAllSentMessages(self):
        msgs = [self._sent_json(m) for m in self.node.store.all_sent()]
        return json.dumps({"sentMessages": msgs}, indent=4)

    def cmd_searchMessages(self, what, folder="inbox", where=""):
        """Store-backed LIKE search (reference helper_search.search_sql,
        the query behind the Qt search bar and curses search).  ``folder``
        is inbox/sent/trash/new; ``where`` optionally restricts to
        toaddress/fromaddress/subject/message."""
        hits = self.node.store.search(str(folder), str(what),
                                      str(where) or None)
        if folder == "sent":
            return json.dumps(
                {"sentMessages": [self._sent_json(m) for m in hits]},
                indent=4)
        return json.dumps(
            {"inboxMessages": [self._inbox_json(m) for m in hits]},
            indent=4)

    def cmd_getAllSentMessageIds(self):
        msgs = [{"msgid": hexlify(m.msgid).decode()}
                for m in self.node.store.all_sent()]
        return json.dumps({"sentMessageIds": msgs}, indent=4)

    def cmd_getSentMessageById(self, msgid_hex):
        m = self.node.store.sent_by_id(self._hex_msgid(msgid_hex))
        if m is None:
            return json.dumps({"sentMessage": []})
        return json.dumps({"sentMessage": [self._sent_json(m)]}, indent=4)

    def cmd_getSentMessagesByAddress(self, fromAddress):
        msgs = [self._sent_json(m) for m in self.node.store.all_sent()
                if m.fromaddress == fromAddress]
        return json.dumps({"sentMessages": msgs}, indent=4)

    def cmd_getSentMessageByAckData(self, ackdata_hex):
        ack = unhexlify(ackdata_hex)
        m = self.node.store.sent_by_ackdata(ack)
        if m is None:
            return json.dumps({"sentMessage": []})
        return json.dumps({"sentMessage": [self._sent_json(m)]}, indent=4)

    def cmd_trashMessage(self, msgid_hex):
        msgid = self._hex_msgid(msgid_hex)
        self.node.store.trash_inbox(msgid)
        self.node.store.trash_sent(msgid)
        return "Trashed message (assuming message existed)."

    def cmd_undeleteMessage(self, msgid_hex):
        """Restore a trashed inbox message (reference testmode-only
        HandleUndeleteMessage, api.py)."""
        self.node.store.undelete_inbox(self._hex_msgid(msgid_hex))
        return "Undeleted message (assuming message existed)."

    def cmd_trashInboxMessage(self, msgid_hex):
        self.node.store.trash_inbox(self._hex_msgid(msgid_hex))
        return "Trashed inbox message (assuming message existed)."

    def cmd_trashSentMessage(self, msgid_hex):
        self.node.store.trash_sent(self._hex_msgid(msgid_hex))
        return "Trashed sent message (assuming message existed)."

    def cmd_trashSentMessageByAckData(self, ackdata_hex):
        self.node.store.trash_sent_by_ackdata(unhexlify(ackdata_hex))
        return "Trashed sent message (assuming message existed)."

    @staticmethod
    def _hex_msgid(msgid_hex) -> bytes:
        try:
            return unhexlify(msgid_hex)
        except Exception as exc:
            raise APIError(22, str(exc))

    # -- sending -------------------------------------------------------------

    async def cmd_sendMessage(self, toAddress, fromAddress, subject,
                              message, encodingType=2, TTL=4 * 24 * 3600):
        if encodingType not in (2, 3):
            raise APIError(6)
        subject = _from_b64(subject)
        message = _from_b64(message)
        if len(message) > 2**18:
            raise APIError(27)
        decode_address(toAddress)
        ident = self.node.keystore.get(fromAddress)
        if ident is None:
            raise APIError(13)
        if not ident.enabled:
            raise APIError(14)
        TTL = max(60 * 60, min(int(TTL), 28 * 24 * 3600))
        ack = await self.node.send_message(
            toAddress, fromAddress, subject, message,
            ttl=TTL, encoding=encodingType)
        return hexlify(ack).decode()

    async def cmd_sendBroadcast(self, fromAddress, subject, message,
                                encodingType=2, TTL=4 * 24 * 3600):
        if encodingType not in (2, 3):
            raise APIError(6)
        subject = _from_b64(subject)
        message = _from_b64(message)
        if len(message) > 2**18:
            raise APIError(27)
        ident = self.node.keystore.get(fromAddress)
        if ident is None:
            raise APIError(13)
        TTL = max(60 * 60, min(int(TTL), 28 * 24 * 3600))
        ack = await self.node.send_broadcast(
            fromAddress, subject, message, ttl=TTL, encoding=encodingType)
        return hexlify(ack).decode()

    # -- email gateway (reference bitmessageqt/account.py:185-345) -----------

    def cmd_setEmailGateway(self, address, gateway, registration="",
                            unregistration="", relay=""):
        """Register/unregister one of our identities with an email
        gateway operator ('mailchuck' ships built in; the three
        service addresses can be overridden for other operators).
        Empty gateway clears the setting."""
        if self.node.keystore.get(address) is None:
            raise APIError(13)
        self.node.set_email_gateway(
            address, str(gateway), registration=str(registration),
            unregistration=str(unregistration), relay=str(relay))
        return "Set email gateway of %s to %r" % (address, str(gateway))

    async def _gateway_cmd(self, address, action, email=""):
        try:
            ack = await self.node.email_gateway_command(
                str(address), action, email=str(email))
        except KeyError as exc:
            raise APIError(13, str(exc))
        return hexlify(ack).decode()

    async def cmd_emailGatewayRegister(self, address, email):
        """Request an email address from the identity's gateway."""
        return await self._gateway_cmd(address, "register", email)

    async def cmd_emailGatewayUnregister(self, address):
        return await self._gateway_cmd(address, "unregister")

    async def cmd_emailGatewayStatus(self, address):
        return await self._gateway_cmd(address, "status")

    async def cmd_emailGatewaySettings(self, address):
        """Send the commented settings template to the gateway."""
        return await self._gateway_cmd(address, "settings")

    async def cmd_sendEmail(self, fromAddress, toEmail, subject, message):
        """Send an email through the registered gateway's relay
        (subject/message base64 like sendMessage)."""
        if "@" not in str(toEmail):
            raise APIError(0, "toEmail does not look like an email")
        try:
            ack = await self.node.send_email(
                str(fromAddress), str(toEmail), _from_b64(subject),
                _from_b64(message))
        except KeyError as exc:
            raise APIError(13, str(exc))
        return hexlify(ack).decode()

    def cmd_getStatus(self, ackdata_hex):
        if len(ackdata_hex) not in range(64, 200):
            raise APIError(15)
        return self.node.message_status(unhexlify(ackdata_hex))

    # -- subscriptions -------------------------------------------------------

    def cmd_addSubscription(self, address, label=""):
        decode_address(address)
        if address in self.node.keystore.subscriptions:
            raise APIError(16)
        self.node.keystore.subscribe(address, _from_b64(label, 17)
                                     if label else "")
        return "Added subscription."

    def cmd_deleteSubscription(self, address):
        self.node.keystore.unsubscribe(address)
        return "Deleted subscription if it existed."

    def cmd_listSubscriptions(self):
        subs = [{"label": _b64(s.label), "address": s.address,
                 "enabled": s.enabled}
                for s in self.node.keystore.subscriptions.values()]
        return json.dumps({"subscriptions": subs}, indent=4)

    # -- raw dissemination ---------------------------------------------------

    async def cmd_disseminatePreEncryptedMsg(self, payload_hex,
                                             *_ignored):
        """Accept a fully-formed, pre-PoW'd msg object and flood it
        (api.py:1275-1340)."""
        payload = unhexlify(payload_hex)
        return await self._disseminate(payload, OBJECT_MSG)

    async def cmd_disseminatePubkey(self, payload_hex):
        payload = unhexlify(payload_hex)
        return await self._disseminate(payload, OBJECT_PUBKEY)

    async def _disseminate(self, payload: bytes, expected_type: int) -> str:
        hdr = ObjectHeader.parse(payload)
        # the node's verifier holds it to the network minimum, on the
        # device like every received object's PoW
        if not await self.node.pow_verifier.check(payload):
            raise APIError(21, "proof of work insufficient")
        h = inventory_hash(payload)
        tag = b""
        if expected_type == OBJECT_PUBKEY and hdr.version >= 4:
            tag = payload[hdr.header_length:hdr.header_length + 32]
        self.node.inventory.add(h, hdr.object_type, hdr.stream, payload,
                                hdr.expires, tag)
        self.node.pool.announce_object(h, hdr.stream, local=True)
        return hexlify(h).decode()

    # -- inventory queries ---------------------------------------------------

    def cmd_getMessageDataByDestinationHash(self, ripe_hex):
        return self.cmd_getMessageDataByDestinationTag(ripe_hex)

    def cmd_getMessageDataByDestinationTag(self, tag_hex):
        if len(tag_hex) != 64:
            raise APIError(19)
        tag = unhexlify(tag_hex)
        items = self.node.inventory.by_type_and_tag(OBJECT_MSG, tag)
        return json.dumps({"receivedMessageDatas": [
            {"data": hexlify(i.payload).decode()} for i in items]})

    # -- status / admin ------------------------------------------------------

    def cmd_metrics(self):
        """Prometheus text exposition of the process-wide registry: the
        same bytes ``GET /metrics`` serves."""
        return render_prometheus()

    def cmd_federatedStatus(self):
        """Fleet view from the federation aggregator: per-node health
        verdicts (pushed health blocks), last-push age, sequence,
        clock-skew estimate, and an ok/degraded/stale roll-up.  The
        merged metric families themselves are served as ``GET
        /metrics/federated``."""
        agg = getattr(self.node, "federation", None)
        if agg is None:
            return json.dumps({"enabled": False})
        out = agg.status()
        out["enabled"] = True
        return json.dumps(out)

    def cmd_dumpFlightRecorder(self, kind=""):
        """Dump the flight-recorder ring: the last structured events
        (breaker flips, requeues, sync round verdicts, slab traffic,
        watermark pauses), newest last; also logged as one line
        (trigger=api).  ``kind`` filters by event kind.  The dump
        carries the node id and its clock-skew estimate (the mean of
        its connections' wire-trace estimators), so many nodes' dumps
        fold onto one clock."""
        events = FLIGHT_RECORDER.dump("api")
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        return json.dumps({"node": FLIGHT_RECORDER.node_id,
                           "skew": round(FLIGHT_RECORDER.skew(), 6),
                           "events": events}, default=repr)

    def cmd_costStatus(self):
        """CPU and cost attribution: the sampler's state, CPU-sample
        shares by subsystem and thread class, CPU-µs per object per
        ingest stage, per-tenant farm CPU, the crypto engine's seconds
        and items, and the card's busy seconds by program."""
        return json.dumps(cost_status(self.node), indent=4)

    async def cmd_profileDump(self, seconds=0, fmt=""):
        """Dump the sampling profiler: collapsed folded stacks and a
        speedscope document, classified by thread class and subsystem.
        ``seconds > 0`` dumps the rolling window of the last N seconds;
        0 the whole-run bounded trie.  ``fmt="collapsed"`` leaves out
        the speedscope document.  Also ``GET /debug/profile``."""
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            raise APIError(0, "seconds must be numeric")
        win = seconds if seconds > 0 else None
        node_id = getattr(self.node, "node_id", "")
        # the walk and the serialization scale with the whole-run
        # profile: off the event loop
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: json.dumps(PROFILER.dump(
                win, speedscope=fmt != "collapsed",
                node_id=node_id), default=repr))

    def cmd_deviceStatus(self):
        """The device telemetry plane: per-program launches, first
        launches and repeats, dispatch and wait seconds, busy seconds,
        bytes, hashrate and share of the card's bound, the card's
        identity and memory, and the environment.  Also served as
        ``GET /debug/device``."""
        return json.dumps(device_status(), indent=4)

    async def cmd_profileDevice(self, seconds=1):
        """Capture a ``torch.profiler`` trace (CPU, plus CUDA when a
        context exists) for ``seconds`` (default 1, max 60) and return
        its directory and files (Chrome trace JSON).  The capture runs
        off the event loop.  Also ``GET /debug/device?seconds=N``."""
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            raise APIError(0, "seconds must be numeric")
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: json.dumps(
                capture_device_trace(seconds), default=repr))

    def cmd_objectTimeline(self, hash_hex):
        """Lifecycle timeline of one inventory hash: the recorded stage
        events, oldest first, plus the wire trace-stitching metadata
        (trace id, local span, the sending node's parent span) when the
        object crossed a NODE_TRACE link or was pushed by this node."""
        if len(hash_hex) != 64:
            raise APIError(19)
        h = unhexlify(hash_hex)
        out = {"timeline": LIFECYCLE.timeline(h)}
        meta = LIFECYCLE.trace_meta(h)
        if meta is not None:
            out["trace"] = {"traceId": meta["trace_id"].hex(),
                            "span": meta["span"],
                            "parentSpan": meta["parent_span"]}
        return json.dumps(out)

    def _pow_stats(self) -> dict:
        """The PowService's batch counters (the JAX block's ``batch``
        part; the port keeps no per-tier registry histograms)."""
        svc = self.node.pow_service
        return {"batch": {"batches": svc.batches, "solved": svc.solved,
                          "window": svc.window}}

    def _crypto_stats(self) -> dict:
        """Receive-side crypto block: whether the batch engine runs, the
        engine's routing (``BatchCryptoEngine.snapshot``: the rung of
        its last drain, the card rung's threshold, the items each rung
        settled; ``native`` and ``rungs``, each rung's drains and fans,
        are the port's own keys), the native breaker and fallbacks, its
        drains and their ECDH pairs.  ``hostChecks`` (the port's own
        key) counts verifies and decrypts run on the crypto pool's host
        threads (no engine); ``clientEngine`` is a light client's engine
        routing."""
        crypto = self.node.crypto
        engine = crypto.batch
        out: dict = {"batchEngine": engine is not None and engine.running,
                     "hostChecks": {"verifies": crypto.host_verifies,
                                    "decrypts": crypto.host_decrypts}}
        client = getattr(self.node, "client_crypto", None)
        if client is not None:
            out["clientEngine"] = client.snapshot()
        if engine is not None:
            out.update(engine.snapshot())
            out["breakers"] = {
                "native": engine.breaker.snapshot()["state"]}
            out["fallbacks"] = {"native": int(REGISTRY.sample(
                "crypto_native_fallback_total"))}
            out["drains"] = {
                "budget": engine.drain_max,
                "count": engine.drains,
                "ecdhPairs": engine.drain_pairs,
                "meanWidth": round(engine.drain_pairs / engine.drains, 1)
                if engine.drains else 0.0,
                "failed": engine.failed_drains,
            }
        return out

    @staticmethod
    def _device_stats() -> dict:
        """Compact device-telemetry block: per-program launch counts and
        rates from the registry (programs that never launched are
        elided; the full table is ``deviceStatus``)."""
        st = device_status()
        progs = {name: {"launches": row["launches"],
                        "compiles": row["compiles"],
                        "cacheHits": row["cacheHits"],
                        "hashrateHps": row["hashrateHps"],
                        "mfu": row["mfu"]}
                 for name, row in st["programs"].items()
                 if row["launches"]}
        return {"programs": progs, "env": st["env"],
                "dropped": st["dropped"]}

    def _health_stats(self) -> dict:
        """Per-subsystem health verdicts (loop lag, PoW queue and
        breakers, ingest watermark and saturation, write-behind
        backlog)."""
        health = getattr(self.node, "health", None)
        if health is None:
            health = HealthMonitor(self.node)
        return health.health_block()

    def _resilience_stats(self) -> dict:
        """The JAX ``resilience`` block: breaker states, the slab-stall
        and handshake-timeout counters, requeues by reason, the PoW
        journal's depth, and the armed chaos sites."""
        requeues = {}
        rq = REGISTRY.get("pow_requeue_total")
        if rq is not None:
            for values, child in rq.children():
                requeues[values[0]] = int(child.value)
        journal = getattr(self.node, "pow_journal", None)
        return {
            "breakers": breaker_snapshot(),
            "stallEvents": int(REGISTRY.sample(
                "pow_stall_total", {"site": "pow.slab"})),
            "handshakeTimeouts": int(REGISTRY.sample(
                "network_handshake_timeout_total")),
            "powRequeues": requeues,
            "journal": {
                "pending": (journal.pending_count()
                            if journal is not None else None),
                "checkpoints": int(REGISTRY.sample(
                    "pow_journal_checkpoints_total")),
                "recovered": int(REGISTRY.sample(
                    "pow_journal_recovered_total")),
            },
            "chaos": CHAOS.active(),
        }

    def _farm_stats(self) -> dict:
        """PoW solver-farm block: the farm daemon's scheduler and tenant
        state when this node serves PoW-as-a-service, and the client
        tier's endpoint and breaker when it delegates its own PoW."""
        server = getattr(self.node, "farm_server", None)
        client = getattr(self.node, "farm_client", None)
        out: dict = {"serving": server is not None,
                     "delegating": client is not None}
        if server is not None:
            out["server"] = server.status()
            jobs = {}
            fam = REGISTRY.get("farm_jobs_total")
            if fam is not None:
                for values, child in fam.children():
                    jobs["/".join(values)] = int(child.value)
            out["server"]["jobs"] = jobs
        if client is not None:
            out["client"] = client.snapshot()
        return out

    def _client_tier_stats(self) -> dict:
        """Light-client tier block: the edge's subscription plane (with
        its ``farmDelegation``) and this node's own light-client
        session under ``role=client``."""
        plane = getattr(self.node, "client_plane", None)
        light = getattr(self.node, "light_client", None)
        out: dict = {"serving": plane is not None,
                     "lightClient": light is not None}
        if plane is not None:
            out["plane"] = plane.snapshot()
        if light is not None:
            out["session"] = light.snapshot()
        return out

    def cmd_roleStatus(self):
        """Role-split deployment status: this node's role, subscribed
        streams, per-stream peer overlay, inventory size, the role IPC
        runtime's snapshot (an edge's relay links, a relay's edges and
        ingest counts), an edge's client plane and a client's
        session."""
        node = self.node
        out = {
            "role": getattr(node, "role", "all"),
            "streams": list(node.ctx.streams),
            "p2pListen": bool(node.listen),
            "streamPeers": {str(s): n for s, n
                            in node.pool.stream_overlay().items()},
            "inventoryObjects": len(node.inventory),
        }
        runtime = getattr(node, "role_runtime", None)
        if runtime is not None:
            out["ipc"] = runtime.snapshot()
        plane = getattr(node, "client_plane", None)
        if plane is not None:
            out["clientPlane"] = plane.snapshot()
        light = getattr(node, "light_client", None)
        if light is not None:
            out["lightClient"] = light.snapshot()
        return json.dumps(out, indent=4)

    def cmd_shardStatus(self):
        """Elastic shard status: this node's shard-map epoch, owned
        streams, and the role runtime's view (an edge's replica sets
        and per-link epochs, a relay's forwarding table and edges)."""
        node = self.node
        runtime = getattr(node, "role_runtime", None)
        out = {
            "role": getattr(node, "role", "all"),
            "streams": list(node.ctx.streams),
            "epoch": getattr(runtime, "epoch", 0),
            "inventoryObjects": len(node.inventory),
        }
        if runtime is not None:
            out["ipc"] = runtime.snapshot()
        return json.dumps(out, indent=4)

    async def cmd_shardShed(self, stream, target):
        """Relay only: hand ``stream`` off live to the relay at
        ``target`` (``host:port`` of its role-IPC listener): drain the
        stream over acked OBJECTS frames, shed it, SHARD_UPDATE every
        edge and forward late records.  Safe to re-invoke after an
        interruption; returns drain counts and the new epoch."""
        runtime = getattr(self.node, "role_runtime", None)
        shed = getattr(runtime, "shed_stream", None)
        if shed is None:
            raise APIError(0, "shardShed requires the relay role")
        try:
            stream = int(stream)
        except (TypeError, ValueError):
            raise APIError(0, "stream must be an integer")
        try:
            result = await shed(stream, str(target))
        except ValueError as exc:
            raise APIError(0, str(exc))
        except (OSError, ConnectionError, asyncio.TimeoutError) as exc:
            raise APIError(0, "handoff to %s failed (re-invoke to "
                           "resume): %r" % (target, exc))
        return json.dumps(result)

    def cmd_farmStatus(self):
        """Full PoW solver-farm status: scheduler snapshot (per-lane
        depths, projected waits, per-tenant queued/solved/weights),
        job outcomes and the client tier's breaker state."""
        return json.dumps(self._farm_stats(), indent=4)

    def cmd_clientStatus(self):
        pool = self.node.pool
        established = len(pool.established())
        status = ("connectedAndReceivingIncomingConnections"
                  if pool.inbound else
                  "connectedButHaveNotReceivedIncomingConnections"
                  if established else "notConnected")
        # up/down speed from the global byte counters, sampled between
        # successive clientStatus calls (reference network/stats.py:19-78
        # over the asyncore sentBytes/receivedBytes counters)
        rx = self.node.ctx.download_bucket.total_bytes
        tx = self.node.ctx.upload_bucket.total_bytes
        now = time.monotonic()
        last = getattr(self, "_rate_sample", None)
        down_rate = up_rate = 0.0
        if last is not None:
            dt = max(now - last[0], 1e-6)
            down_rate = (rx - last[1]) / dt
            up_rate = (tx - last[2]) / dt
        self._rate_sample = (now, rx, tx)
        solver = self.node.solver
        return json.dumps({
            "networkConnections": established,
            "numberOfNetworkConnections": established,
            "networkStatus": status,
            "numberOfMessagesProcessed":
                self.node.processor.messages_processed,
            "numberOfBroadcastsProcessed":
                self.node.processor.broadcasts_processed,
            "numberOfPubkeysProcessed":
                self.node.processor.pubkeys_processed,
            "pendingDownload": self.node.ctx.global_tracker.pending_count(),
            "bytesReceived": rx,
            "bytesSent": tx,
            "downloadRate": round(down_rate, 1),
            "uploadRate": round(up_rate, 1),
            "softwareName": "pybitmessage-tpu",
            "softwareVersion": "0.1.0",
            "powBackends": solver.backends(),
            "powBackend": solver.last_backend,
            "powRate": round(solver.last_rate, 1),
            # solve-only rate (no host verify)
            "powSolveRate": round(solver.last_solve_rate, 1),
            "powQueueDepth": self.node.pow_service.queue.qsize(),
            "powStats": self._pow_stats(),
            "resilience": self._resilience_stats(),
            "crypto": self._crypto_stats(),
            "farm": self._farm_stats(),
            "clients": self._client_tier_stats(),
            "device": self._device_stats(),
            "health": self._health_stats(),
            "powVerify": {
                "host": self.node.pow_verifier.host_checked,
                "device": self.node.pow_verifier.device_checked,
                "deviceBatches": self.node.pow_verifier.device_batches,
            },
        }, indent=4)

    def cmd_deleteAndVacuum(self):
        self.node.db.execute("DELETE FROM inbox WHERE folder='trash'")
        self.node.db.execute("DELETE FROM sent WHERE folder='trash'")
        self.node.db.vacuum()
        return "done"

    async def cmd_shutdown(self):
        asyncio.get_running_loop().call_soon(
            lambda: asyncio.ensure_future(self.node.stop()))
        return "done"

    # -- reference alias spellings (api.py registers both casings) -----------
    cmd_getAllInboxMessageIDs = cmd_getAllInboxMessageIds
    cmd_getAllSentMessageIDs = cmd_getAllSentMessageIds
    cmd_getInboxMessageByID = cmd_getInboxMessageById
    cmd_getSentMessageByID = cmd_getSentMessageById
    cmd_getSentMessagesBySender = cmd_getSentMessagesByAddress
