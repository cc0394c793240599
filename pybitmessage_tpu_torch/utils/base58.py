"""Base58 codec (Bitcoin alphabet), as used by Bitmessage addresses and
WIF (copy of ``pybitmessage_tpu.utils.base58``).

Reference behavior: src/addresses.py:16-53 (integer-based base58).
"""

from __future__ import annotations

ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(ALPHABET)}


def b58encode_int(value: int) -> str:
    if value < 0:
        raise ValueError("cannot base58-encode a negative integer")
    if value == 0:
        return ALPHABET[0]
    out = []
    while value:
        value, rem = divmod(value, 58)
        out.append(ALPHABET[rem])
    return "".join(reversed(out))


def b58decode_int(text: str) -> int:
    """Decode base58 text to an integer.

    Returns 0 for text containing invalid characters, matching the
    reference's tolerant decoder (src/addresses.py:43-53) which address
    decoding maps to the 'invalidcharacters' status.
    """
    value = 0
    for ch in text:
        idx = _INDEX.get(ch)
        if idx is None:
            return 0
        value = value * 58 + idx
    return value


def b58encode(data: bytes) -> str:
    """Encode bytes, preserving leading zero bytes as '1' characters."""
    leading = len(data) - len(data.lstrip(b"\x00"))
    body = b58encode_int(int.from_bytes(data, "big")) if data.lstrip(b"\x00") else ""
    return ALPHABET[0] * leading + body


def b58decode(text: str) -> bytes:
    leading = len(text) - len(text.lstrip(ALPHABET[0]))
    value = b58decode_int(text.lstrip(ALPHABET[0]))
    if value == 0 and text.lstrip(ALPHABET[0]):
        raise ValueError("invalid base58 character")
    body = value.to_bytes((value.bit_length() + 7) // 8, "big") if value else b""
    return b"\x00" * leading + body
