"""Deterministic test fixtures (copy of ``pybitmessage_tpu.core.testdata``;
reference testmode_init.py:13-41).

The reference's ``-t`` mode calls ``populate_api_test_data()`` so API
conformance tests find a known address and a sample inbox message.
Here seeding is explicit (``--populate-test-data``) because the test
suite runs daemons in ``-t`` mode and asserts on EMPTY stores — the
reference's always-on seeding would poison those assertions.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("pybitmessage_tpu_torch.testdata")

#: deterministic passphrase — same address every run, like the
#: reference's fixed testmode address
PASSPHRASE = b"pybitmessage-tpu test fixtures"

SAMPLE_SUBJECT = "Test fixture message"
SAMPLE_BODY = ("This message was seeded by --populate-test-data so "
               "API clients have something to list, read and trash.")


def populate(node) -> str:
    """Seed a deterministic identity, an address-book entry and one
    inbox message; idempotent.  Returns the fixture address."""
    ident = node.keystore.create_deterministic(PASSPHRASE, "test fixture")
    node.store.addressbook_add(ident.address, "test fixture contact")
    from ..utils.hashes import sha512
    msgid = sha512(b"fixture message " + ident.address.encode())[:32]
    if node.store.deliver_inbox(
            msgid=msgid, toaddress=ident.address,
            fromaddress=ident.address, subject=SAMPLE_SUBJECT,
            message=SAMPLE_BODY, sighash=sha512(msgid)):
        logger.info("seeded test fixtures for %s", ident.address)
    return ident.address
