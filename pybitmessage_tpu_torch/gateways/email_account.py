"""Email-gateway account flows, Mailchuck-style command messages (copy of
``pybitmessage_tpu.gateways.email_account``).

Role model: the reference's ``GatewayAccount``/``MailchuckAccount``
(src/bitmessageqt/account.py:185-345) — an email gateway is an
ordinary Bitmessage peer that bridges to SMTP; the client talks to it
with *command messages* sent to its published service addresses:

- register:   msg to the registration address, subject = your email
- unregister: msg to the unregistration address, empty subject
- status:     msg to the registration address, subject "status"
- settings:   msg to the registration address, subject "config", body
  = a commented key/value template the operator parses
- outgoing email: msg to the relay address, subject
  "rcpt@example.com Subject"  (account.py:240-245, regExpOutgoing)
- incoming email: msg FROM the relay address with subject
  "...MAILCHUCK-FROM::sender@example.com | Subject" which the client
  rewrites for display (account.py:320-333, regExpIncoming)
- denial: msg from the registration address with subject
  "Registration Request Denied" (account.py:341-344)

This module is pure logic: it composes/parses those messages; the
node wires them into its normal send/receive pipeline
(workers/processor.py, core/node.py) and the API/CLI/GUI surface them.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

ALL_OK = 0
REGISTRATION_DENIED = 1

#: the denial subject the reference matches verbatim (account.py:342)
DENIED_SUBJECT = "Registration Request Denied"

#: incoming relay rewrite: "<pre>MAILCHUCK-FROM::<email> | <subject>"
INCOMING_RE = re.compile(r"(.*)MAILCHUCK-FROM::(\S+) \| (.*)")
#: outgoing relay form: "<email> <subject>"
OUTGOING_RE = re.compile(r"(\S+) (.*)")

#: gateway command messages never need a long shelf life; the
#: reference caps their TTL at 2 days (account.py:216-217)
COMMAND_TTL = 2 * 86400

#: settings template sent with the "config" command.  The option KEYS
#: are the gateway's parse surface (account.py:271-311); the prose is
#: ours.
SETTINGS_TEMPLATE = """\
# Email gateway account settings. Uncomment a line to apply it.
#
# pgp: server        - the gateway holds PGP keys and signs/encrypts
#                      for you (subscription feature)
# pgp: local         - no PGP operations on the server
# attachments: yes   - incoming attachments are uploaded and linked
#                      (subscription feature)
# attachments: no    - incoming attachments are dropped
# archive: yes       - keep delivered mail on the server (debugging /
#                      third-party proof; the operator can read it)
# archive: no        - delete mail from the server after relay
#
# masterpubkey_btc: <BIP44 xpub or electrum v1 public seed>
# offset_btc: <integer, default 0>
# feeamount: <number, up to 8 decimal places>
# feecurrency: <BTC, XBT, USD, EUR or GBP>
#   charge unknown senders an incoming-mail fee, paid to keys derived
#   from your master key; feeamount: 0 turns it off (subscription
#   feature)
"""


@dataclass(frozen=True)
class GatewaySpec:
    """One gateway operator's published service addresses."""
    name: str
    registration: str
    unregistration: str
    relay: str


#: the operator the reference ships built in (account.py:228-232)
MAILCHUCK = GatewaySpec(
    name="mailchuck",
    registration="BM-2cVYYrhaY5Gbi3KqrX9Eae2NRNrkfrhCSA",
    unregistration="BM-2cVMAHTRjZHCTPMue75XBK5Tco175DtJ9J",
    relay="BM-2cWim8aZwUNqxzjMxstnUMtVEUQJeezstf",
)

GATEWAYS = {MAILCHUCK.name: MAILCHUCK}


def spec_for_identity(ident) -> GatewaySpec | None:
    """Resolve an identity's gateway spec from its per-address config
    (``gateway`` key + optional address overrides), or None when the
    identity is not gateway-registered."""
    if not getattr(ident, "gateway", ""):
        return None
    base = GATEWAYS.get(ident.gateway,
                        GatewaySpec(ident.gateway, "", "", ""))
    return GatewaySpec(
        name=base.name,
        registration=ident.gateway_registration or base.registration,
        unregistration=ident.gateway_unregistration or base.unregistration,
        relay=ident.gateway_relay or base.relay,
    )


@dataclass(frozen=True)
class Command:
    """A composed gateway command message, ready for the send path."""
    to_address: str
    subject: str
    body: str
    ttl: int = COMMAND_TTL


class EmailGatewayAccount:
    """Compose/parse gateway traffic for one of our identities."""

    def __init__(self, address: str, spec: GatewaySpec = MAILCHUCK):
        self.address = address
        self.spec = spec

    # -- command messages (account.py:247-269) -------------------------------

    def register(self, email: str) -> Command:
        return Command(self.spec.registration, email, "")

    def unregister(self) -> Command:
        return Command(self.spec.unregistration, "", "")

    def status(self) -> Command:
        return Command(self.spec.registration, "status", "")

    def settings(self) -> Command:
        return Command(self.spec.registration, "config", SETTINGS_TEMPLATE)

    # -- email relay ---------------------------------------------------------

    def compose_email(self, to_email: str, subject: str,
                      body: str) -> Command:
        """Outgoing email rides the relay address with the recipient
        folded into the subject (account.py:240-245)."""
        return Command(self.spec.relay, "%s %s" % (to_email, subject),
                       body)

    def parse_incoming(self, from_address: str,
                       subject: str) -> tuple[str, str, int]:
        """(display_from, display_subject, feedback) for a received
        message — relay mail is rewritten to its real sender/subject,
        registration denials are flagged (account.py:316-345)."""
        if from_address == self.spec.relay:
            m = INCOMING_RE.search(subject)
            if m is not None:
                return (m.group(2) or from_address,
                        (m.group(1) or "") + (m.group(3) or ""), ALL_OK)
        if from_address == self.spec.registration \
                and subject == DENIED_SUBJECT:
            return from_address, subject, REGISTRATION_DENIED
        return from_address, subject, ALL_OK

    @staticmethod
    def parse_outgoing(subject: str) -> tuple[str, str] | None:
        """Split a relay-bound subject back into (email, subject) —
        what a gateway node does with our mail (account.py:334-340)."""
        m = OUTGOING_RE.search(subject)
        if m is None:
            return None
        return m.group(1), m.group(2)
