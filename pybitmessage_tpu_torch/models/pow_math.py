"""Proof-of-work target math (copy of ``pybitmessage_tpu.models.pow_math``).

An object's PoW is valid when

    u64_be( SHA512(SHA512( nonce(8B) || SHA512(rest_of_payload) ))[:8] )
        <= 2**64 // (nTPB * (len + extra + TTL*(len+extra)//2**16))

where ``len`` includes the 8-byte nonce, with floor division throughout
(reference src/protocol.py:258-286).
"""

from __future__ import annotations

import time

from ..utils.hashes import double_sha512, sha512
from .constants import DEFAULT_EXTRA_BYTES, DEFAULT_NONCE_TRIALS_PER_BYTE


def pow_target(
    payload_length: int,
    ttl: int,
    nonce_trials_per_byte: int = DEFAULT_NONCE_TRIALS_PER_BYTE,
    extra_bytes: int = DEFAULT_EXTRA_BYTES,
    clamp: bool = True,
) -> int:
    """Target threshold for a payload of ``payload_length`` bytes
    (nonce included) living for ``ttl`` seconds.

    ``clamp=False`` skips the network-minimum floor (test mode).
    """
    if clamp:
        if nonce_trials_per_byte < DEFAULT_NONCE_TRIALS_PER_BYTE:
            nonce_trials_per_byte = DEFAULT_NONCE_TRIALS_PER_BYTE
        if extra_bytes < DEFAULT_EXTRA_BYTES:
            extra_bytes = DEFAULT_EXTRA_BYTES
    weight = payload_length + extra_bytes
    return 2**64 // (nonce_trials_per_byte * (weight + (ttl * weight) // 2**16))


def pow_initial_hash(object_bytes_sans_nonce: bytes) -> bytes:
    """The 64-byte initial hash the nonce search runs against."""
    return sha512(object_bytes_sans_nonce)


def pow_value(object_bytes: bytes) -> int:
    """The trial value of a full object (nonce || payload)."""
    trial = double_sha512(bytes(object_bytes[:8]) + sha512(object_bytes[8:]))
    return int.from_bytes(trial[:8], "big")


def check_pow(
    object_bytes: bytes,
    nonce_trials_per_byte: int = 0,
    extra_bytes: int = 0,
    recv_time: float = 0,
    clamp: bool = True,
) -> bool:
    """Validate an object's embedded PoW (reference: protocol.py:258-286).

    ``object_bytes`` = nonce(8) || expires(8) || type(4) || ...
    TTL is clamped to >= 300s so stale objects still verify cheaply.
    ``clamp=False`` honors sub-minimum difficulty values (test mode).
    """
    expires = int.from_bytes(object_bytes[8:16], "big")
    ttl = expires - int(recv_time if recv_time else time.time())
    ttl = max(ttl, 300)
    target = pow_target(
        len(object_bytes), ttl,
        nonce_trials_per_byte or DEFAULT_NONCE_TRIALS_PER_BYTE,
        extra_bytes or DEFAULT_EXTRA_BYTES,
        clamp=clamp,
    )
    return pow_value(object_bytes) <= target


def expected_trials(payload_length: int, ttl: int,
                    nonce_trials_per_byte: int = DEFAULT_NONCE_TRIALS_PER_BYTE,
                    extra_bytes: int = DEFAULT_EXTRA_BYTES) -> int:
    """Mean number of double-SHA512 trials to find a valid nonce."""
    return 2**64 // pow_target(payload_length, ttl,
                               nonce_trials_per_byte, extra_bytes)
