"""Batch secp256k1 on the card: the drain ABI of ``crypto/tpu.py``
``TpuSecp`` over the port's CUDA kernels.

- ``verify_prepared(n, u1s, u2s, pubs, rs)``: batch ECDSA acceptance
  over host-prepared scalars (the batched s^-1 prep and the digest-hint
  rounds stay in ``crypto/batch.py``);
- ``ecdh_batch(n, points, scalars)``: one ECDH per (point, scalar) pair,
  the trial-decrypt drain;
- ``base_mult_batch`` / ``base_mult``: fixed-base multiplication, the
  ECDH kernel with P = G.

Arguments are packed bytes: 32 big-endian bytes per scalar, 64 (X || Y)
per point.  The host screens what the device cannot tell apart: an
out-of-field coordinate, r outside [1, n-1] or k outside [1, n-1] is
False or None, as the reference's screens make it.  One drain is one
launch: the kernels take any lane count and mask the ragged edge
themselves, so there is no chunking and no padding.

``CudaSecp(device="cpu")`` runs the kernels' plain torch versions (the
tests' path).  There is no other rung here: a failed launch raises to
the caller.  Each drain is attributed to the device-telemetry program
``secp_verify`` or ``secp_ecdh`` (dispatch, the wait for its results,
lanes, bytes), as ``crypto/tpu.py`` attributes its drains.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..observability.devicetelemetry import record_launch
from ..ops import secp256k1_cuda
from . import fallback

_P = fallback.P
_N = fallback.N
_G_BYTES = fallback.GX.to_bytes(32, "big") + fallback.GY.to_bytes(32, "big")


def _ints(buf: bytes, width: int, offset: int, n: int) -> list[int]:
    """The 32-byte big-endian integers at ``offset`` of each ``width``-
    byte record of ``buf``."""
    return [int.from_bytes(buf[width * i + offset:width * i + offset + 32],
                           "big") for i in range(n)]


class CudaSecp:
    """Batch secp256k1 on one device (``None``: the CUDA card, raising
    without one; ``"cpu"``: the plain torch versions)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.calls = {"verify": 0, "ecdh": 0}
        self.lanes = {"verify": 0, "ecdh": 0}

    def _upload(self, *rows: np.ndarray) -> list[torch.Tensor]:
        """(n, 32) uint8 host arrays -> device tensors, in one copy."""
        host = torch.from_numpy(np.ascontiguousarray(np.stack(rows)))
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        return list(dev.unbind(0))

    def _count(self, op: str, n: int) -> None:
        self.calls[op] += 1
        self.lanes[op] += n

    # -- the drain ABI -----------------------------------------------------

    def verify_prepared(self, n: int, u1s: bytes, u2s: bytes, pubs: bytes,
                        rs: bytes) -> list[bool]:
        """Batch ECDSA acceptance over pre-reduced scalars."""
        if not (len(u1s) == len(u2s) == len(rs) == 32 * n
                and len(pubs) == 64 * n):
            raise ValueError("bad verify batch packing")
        if n == 0:
            return []
        xs, ys, rr = _ints(pubs, 64, 0, n), _ints(pubs, 64, 32, n), \
            _ints(rs, 32, 0, n)
        valid = [x < _P and y < _P and 0 < r < _N
                 for x, y, r in zip(xs, ys, rr)]
        points = np.frombuffer(pubs, dtype=np.uint8).reshape(n, 64)

        def rows(buf):
            return np.frombuffer(buf, dtype=np.uint8).reshape(n, 32)

        t0 = time.monotonic()
        u1, u2, qx, qy, r = self._upload(rows(u1s), rows(u2s),
                                         points[:, :32], points[:, 32:],
                                         rows(rs))
        ok_dev = secp256k1_cuda.secp_verify(u1, u2, qx, qy, r)
        t1 = time.monotonic()
        ok = ok_dev.cpu().tolist()
        t2 = time.monotonic()
        record_launch("secp_verify", key=self.device.type,
                      dispatch_seconds=t1 - t0, wait_seconds=t2 - t1,
                      span=(t0, t2), items=n, bytes_in=160 * n,
                      bytes_out=n)
        self._count("verify", n)
        return [bool(ok[i]) and valid[i] for i in range(n)]

    def _ecdh(self, n: int, points: np.ndarray, scalars: bytes):
        t0 = time.monotonic()
        k, px, py = self._upload(
            np.frombuffer(scalars, dtype=np.uint8).reshape(n, 32),
            points[:, :32], points[:, 32:])
        x, y, ok = secp256k1_cuda.secp_ecdh(k, px, py)
        t1 = time.monotonic()
        x, y, ok = x.cpu().numpy(), y.cpu().numpy(), ok.cpu().tolist()
        t2 = time.monotonic()
        record_launch("secp_ecdh", key=self.device.type,
                      dispatch_seconds=t1 - t0, wait_seconds=t2 - t1,
                      span=(t0, t2), items=n, bytes_in=96 * n,
                      bytes_out=65 * n)
        self._count("ecdh", n)
        return x, y, ok

    def ecdh_batch(self, n: int, points: bytes,
                   scalars: bytes) -> list[bytes | None]:
        """Batch ECDH: the 32-byte X of each k*P, None for an invalid
        point or scalar."""
        if not (len(points) == 64 * n and len(scalars) == 32 * n):
            raise ValueError("bad ecdh batch packing")
        if n == 0:
            return []
        xs, ys, ks = _ints(points, 64, 0, n), _ints(points, 64, 32, n), \
            _ints(scalars, 32, 0, n)
        valid = [x < _P and y < _P and 0 < k < _N
                 for x, y, k in zip(xs, ys, ks)]
        x, _, ok = self._ecdh(
            n, np.frombuffer(points, dtype=np.uint8).reshape(n, 64), scalars)
        return [x[i].tobytes() if (ok[i] and valid[i]) else None
                for i in range(n)]

    def base_mult_batch(self, scalars: bytes, n: int) -> list[bytes | None]:
        """n scalars -> n 64-byte X||Y points (None out of range)."""
        if len(scalars) != 32 * n:
            raise ValueError("bad base mult packing")
        if n == 0:
            return []
        valid = [0 < k < _N for k in _ints(scalars, 32, 0, n)]
        g = np.broadcast_to(np.frombuffer(_G_BYTES, dtype=np.uint8), (n, 64))
        x, y, ok = self._ecdh(n, g, scalars)
        return [x[i].tobytes() + y[i].tobytes() if (ok[i] and valid[i])
                else None for i in range(n)]

    def base_mult(self, scalar: bytes) -> bytes | None:
        """scalar * G -> 64-byte X||Y."""
        return self.base_mult_batch(scalar, 1)[0]

    def snapshot(self) -> dict:
        """Device, kernel route and per-op calls and lanes."""
        return {
            "device": str(self.device),
            "kernel": "cuda" if self.device.type == "cuda" else "torch",
            "calls": dict(self.calls),
            "lanes": dict(self.lanes),
        }

