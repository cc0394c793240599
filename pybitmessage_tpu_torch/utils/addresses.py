"""Bitmessage address codec (copy of ``pybitmessage_tpu.utils.addresses``).

An address is ``BM-`` + base58( varint(version) || varint(stream) ||
ripe-with-leading-zeros-stripped || checksum ), where the checksum is the
first 4 bytes of double-SHA512 of the payload.  Versions 2-3 may strip at
most two leading zero bytes; version 4 strips all of them and *requires*
them stripped on decode (address non-malleability).

Reference behavior: src/addresses.py:146-277.
"""

from __future__ import annotations

from dataclasses import dataclass

from .base58 import b58decode_int, b58encode_int
from .hashes import double_sha512
from .varint import VarintError, decode_varint, encode_varint


class AddressError(ValueError):
    """Raised on a malformed address; ``status`` carries the reference's
    status keyword (checksumfailed / invalidcharacters / versiontoohigh /
    varintmalformed / ripetooshort / ripetoolong / encodingproblem)."""

    def __init__(self, status: str, detail: str = ""):
        super().__init__(f"{status}: {detail}" if detail else status)
        self.status = status


@dataclass(frozen=True)
class Address:
    version: int
    stream: int
    ripe: bytes  # always 20 bytes, zero-padded back on decode

    def encode(self) -> str:
        return encode_address(self.version, self.stream, self.ripe)


def encode_address(version: int, stream: int, ripe: bytes) -> str:
    if len(ripe) != 20:
        raise AddressError("ripeinvalid", "ripe must be 20 bytes")
    if 2 <= version < 4:
        if ripe.startswith(b"\x00\x00"):
            stripped = ripe[2:]
        elif ripe.startswith(b"\x00"):
            stripped = ripe[1:]
        else:
            stripped = ripe
    elif version == 4:
        stripped = ripe.lstrip(b"\x00")
    else:
        raise AddressError("versiontoohigh", f"cannot encode version {version}")

    payload = encode_varint(version) + encode_varint(stream) + stripped
    checksum = double_sha512(payload)[:4]
    return "BM-" + b58encode_int(int.from_bytes(payload + checksum, "big"))


def decode_address(address: str) -> Address:
    """Decode and validate an address; raises :class:`AddressError`."""
    text = str(address).strip()
    if text.startswith("BM-"):
        text = text[3:]
    as_int = b58decode_int(text)
    if as_int == 0:
        raise AddressError("invalidcharacters")
    raw = as_int.to_bytes((as_int.bit_length() + 7) // 8, "big")
    if len(raw) < 5:
        raise AddressError("checksumfailed", "too short")
    payload, checksum = raw[:-4], raw[-4:]
    if double_sha512(payload)[:4] != checksum:
        raise AddressError("checksumfailed")

    try:
        version, nver = decode_varint(payload)
        stream, nstream = decode_varint(payload, nver)
    except VarintError as exc:
        raise AddressError("varintmalformed", str(exc)) from exc
    if version > 4 or version == 0:
        raise AddressError("versiontoohigh", f"version {version}")

    ripe_data = payload[nver + nstream:]
    if version in (2, 3):
        if len(ripe_data) > 20:
            raise AddressError("ripetoolong")
        if len(ripe_data) < 18:
            raise AddressError("ripetooshort")
        return Address(version, stream, ripe_data.rjust(20, b"\x00"))
    if version == 4:
        if ripe_data[:1] == b"\x00":
            # non-malleability: v4 RIPE data must arrive zero-stripped
            raise AddressError("encodingproblem")
        if len(ripe_data) > 20:
            raise AddressError("ripetoolong")
        if len(ripe_data) < 4:
            raise AddressError("ripetooshort")
        return Address(version, stream, ripe_data.rjust(20, b"\x00"))
    # version 1: last 20 bytes before checksum
    return Address(version, stream, payload[-20:])


def with_bm_prefix(address: str) -> str:
    address = str(address).strip()
    return address if address.startswith("BM-") else "BM-" + address
