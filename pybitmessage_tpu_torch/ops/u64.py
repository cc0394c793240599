"""u64 words as int64 tensors (the port's twin of ``ops/u64.py``).

The reference carries every 64-bit word as a (hi, lo) pair of uint32
arrays because its vector unit has no 64-bit integers.  torch has
int64 on every device, but its unsigned dtypes lack ``+``, ``>>``,
``<``, ``where`` and ``min`` on the CPU, so a u64 word here is the
int64 with the same bit pattern:

* ``+`` and ``<<`` wrap mod 2^64 exactly as u64 arithmetic does;
* ``>>`` on int64 is arithmetic, so logical shifts mask the sign copies
  away: ``(x >> n) & ((1 << (64 - n)) - 1)``;
* unsigned ``<=`` flips the sign bit of both sides, then compares.

``from_reference_pairs`` / ``to_reference_pairs`` carry the reference's
(..., 2) uint32 (hi, lo) layout of initial-hash words, nonce bases and
targets across, so both packages see the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1
#: the u64 sign bit as an int64 (flips unsigned order into signed order)
_SIGN = -(1 << 63)
#: every u64 value is <= this: the always-hit target, and the "no hit"
#: offset sentinel (int64 -1)
ALWAYS_HIT = MASK64


def to_i64(value: int) -> int:
    """Python int (taken mod 2^64) -> the int64 with the same bits."""
    value &= MASK64
    return value - (1 << 64) if value >> 63 else value


def from_i64(value: int) -> int:
    """int64 (Python int or 0-dim tensor) -> the u64 it encodes."""
    return int(value) & MASK64


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift by a static amount 1..63."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate right by a static amount 1..63."""
    return shr(x, n) | (x << (64 - n))


def le_u(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a <= b`` elementwise (``b`` a tensor or an int64 int)."""
    return (a ^ _SIGN) <= (b ^ _SIGN)


def words_from_bytes(data: bytes) -> list[int]:
    """Big-endian u64 words of ``data`` as int64 ints."""
    return [to_i64(int.from_bytes(data[i:i + 8], "big"))
            for i in range(0, len(data), 8)]


def from_reference_pairs(pairs: np.ndarray, device=None) -> torch.Tensor:
    """(..., 2) uint32 (hi, lo) pairs -> (...) int64 u64 words."""
    pairs = np.asarray(pairs, dtype=np.uint32)
    if pairs.shape[-1:] != (2,):
        raise ValueError("expected (..., 2) uint32 pairs, got shape %r"
                         % (pairs.shape,))
    words = ((pairs[..., 0].astype(np.uint64) << np.uint64(32))
             | pairs[..., 1].astype(np.uint64))
    return torch.from_numpy(words.view(np.int64).copy()).to(device)


def to_reference_pairs(words: torch.Tensor) -> np.ndarray:
    """(...) int64 u64 words -> (..., 2) uint32 (hi, lo) pairs."""
    u = words.detach().cpu().numpy().astype(np.int64).view(np.uint64)
    return np.stack([(u >> np.uint64(32)).astype(np.uint32),
                     (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=-1)
