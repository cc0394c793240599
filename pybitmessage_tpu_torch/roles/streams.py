"""Dynamic stream assignment (copy of ``pybitmessage_tpu.roles.streams``).

The deterministic address -> stream mapper spreads new identities
across a configured stream count, so capacity scales by adding stream
shards (relays).  It is a pure function of the address ripe, the same
in every node, edge and package, and must stay stable once deployed (a
re-mapped address would strand its mail on the old shard).
"""

from __future__ import annotations

import hashlib
import struct


def stream_for_ripe(ripe: bytes, nstreams: int = 1) -> int:
    """Deterministic stream for an address ripe: 1-based, uniform over
    ``nstreams`` via the first 8 bytes of sha512(ripe)."""
    if nstreams <= 1:
        return 1
    digest = hashlib.sha512(ripe).digest()
    (word,) = struct.unpack_from(">Q", digest, 0)
    return 1 + word % nstreams


def stream_for_address(address: str, nstreams: int = 1) -> int:
    """Deterministic stream for an encoded ``BM-`` address."""
    from ..utils.addresses import decode_address
    return stream_for_ripe(decode_address(address).ripe, nstreams)


def shard_owner(stream: int, shards: dict) -> object | None:
    """Pick the owner of ``stream`` from a ``{owner: streams}`` table
    (an edge's relay-link routing table, built from HELLO_ACKs).
    Falls back to an owner with an empty stream set (a catch-all
    relay), then None."""
    catch_all = None
    for owner, streams in shards.items():
        if stream in streams:
            return owner
        if not streams:
            catch_all = owner
    return catch_all


def shard_members(stream: int, shards: dict) -> list:
    """All owners of ``stream``: the stream's replica set.  Explicit
    owners win; when none declares the stream, every catch-all owner
    (empty stream set) is the set."""
    members = [owner for owner, streams in shards.items()
               if stream in streams]
    if members:
        return members
    return [owner for owner, streams in shards.items() if not streams]
