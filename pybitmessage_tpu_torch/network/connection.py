"""The checks a connection runs on every received object (from
``pybitmessage_tpu.network.connection`` ``_handle_object``,
``_verify_and_accept`` and ``_accept_object``), as one function of
``(ctx, pool, payload)``.

In order: parse, the per-type length check, the expiry bounds, the
stream, the PoW through ``ctx.pow_verifier`` (the batch verifier on
the card), the inventory dedup; then the object enters the inventory
and ``pool.object_received`` queues it for the processor.
"""

from __future__ import annotations

import logging

from ..models.objects import ObjectHeader, check_by_type, extract_tag
from ..utils.hashes import inventory_hash

logger = logging.getLogger("pybitmessage_tpu_torch.network")

async def accept_object(ctx, pool, payload: bytes) -> str:
    """Check one received object and accept it.  Returns ``"accepted"``
    or why it was not: ``"invalid"`` (parse, length, expiry),
    ``"stream"`` (not one of ours), ``"pow"`` (insufficient PoW; a
    connection closes on it) or ``"duplicate"`` (already held)."""
    try:
        header = ObjectHeader.parse(payload)
        check_by_type(header.object_type, header.version, len(payload))
        header.check_expiry()
    except ValueError as exc:           # ObjectError, VarintError
        logger.debug("rejected object: %s", exc)
        return "invalid"
    if header.stream not in ctx.streams:
        return "stream"
    if not await ctx.pow_verifier.check(payload):
        logger.debug("insufficient PoW")
        return "pow"
    h = inventory_hash(payload)
    if h in ctx.inventory:
        return "duplicate"
    ctx.inventory.add(h, header.object_type, header.stream, payload,
                      header.expires, extract_tag(header, payload))
    pool.object_received(h, header, payload)
    return "accepted"
