"""Batch secp256k1 kernels on the card (twin of the Pallas kernels of
``ops/secp256k1_pallas.py``).

Two wrappers, one per hand-written CUDA kernel of
``csrc/secp256k1_kernels.cu``:

* :func:`secp_verify` - ECDSA acceptance per lane (replaces
  ``_verify_kernel`` / ``pallas_verify``);
* :func:`secp_ecdh` - k*P per lane, also the fixed-base multiply with
  P = G (replaces ``_ecdh_kernel`` / ``pallas_ecdh``).

Inputs are (n, 32) uint8 tensors of big-endian values: exactly the bytes
of the drain ABI (``crypto/gpu.py``), whatever representation the
arithmetic uses behind them.  For tensors on the CPU a wrapper runs its
plain torch version (``secp256k1.verify_ref`` / ``ecdh_ref``); for CUDA
tensors it launches its kernel or raises.  Each launch adds one to
``LAUNCHES``.

Both kernels take the fixed-base comb, :func:`comb_table`: affine
``j * 16^i * G`` for 64 windows and j = 1..15, computed here once per
device from the port's ``crypto/fallback.py`` integers and kept on the
card (61,440 bytes).

Source notes.  ``bm_secp_verify_kernel`` replaces
``pybitmessage_tpu/ops/secp256k1_pallas.py:470`` (``_verify_kernel``,
body ``verify_core``); ``bm_secp_ecdh_kernel`` replaces ``:477``
(``_ecdh_kernel``, body ``ecdh_core``).  Both are bound by 32-bit
integer multiply issue: a chain of 256-bit modular multiplications and
squarings over 161 bytes of input and output a lane.  The design cuts
that chain and spreads it: PTX carry chains on 8 x 32-bit limbs with a
dedicated squaring, uniform group steps (a = 0 doubling, mixed
additions with selects for every exceptional case), the comb for every
multiple of G, 4-bit window tables sharing one Z for a variable base,
and the GLV split with two threads a lane
(``csrc/secp256k1_kernels.cu`` says how).  ``chip_smoke.py`` bounds
them by the least work a lane's data needs, one GLV walk whose halves
share their doublings, and prints beside it the count of the kernels'
two threads, which double the doublings (~1.3-1.4x the least).
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import fallback
from ..observability.devicetelemetry import register_program
from . import _build
from .bounds import SECP_ECDH_LANE, SECP_VERIFY_LANE
from .secp256k1 import ecdh_ref, verify_ref

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"secp_verify": 0, "secp_ecdh": 0}


#: windows of the fixed-base comb (4 bits each, 256 bits)
COMB_WINDOWS = 64
_COMB: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def comb_words() -> np.ndarray:
    """The fixed-base comb as the kernels read it: (64, 15, 16) uint32,
    entry [i, j - 1] holding j * 16^i * G as x then y, each 8
    little-endian 32-bit limbs (canonical)."""
    words = np.zeros((COMB_WINDOWS, 15, 16), dtype=np.uint32)
    base = (fallback.GX, fallback.GY, 1)
    for i in range(COMB_WINDOWS):
        acc = None
        for j in range(15):
            acc = fallback._jac_add(acc, base)
            x, y = fallback._jac_to_affine(acc)
            for w, v in enumerate((x, y)):
                words[i, j, 8 * w:8 * w + 8] = [(v >> (32 * m)) & 0xFFFFFFFF
                                                for m in range(8)]
        base = fallback._jac_add(acc, base)               # 16 * base
    return words


def comb_table(device: torch.device) -> torch.Tensor:
    """:func:`comb_words` on ``device``, made once per device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    table = _COMB.get(device)
    if table is None:
        table = _COMB[device] = torch.from_numpy(
            comb_words().reshape(-1)).to(device)
    return table


def _lanes(first: torch.Tensor) -> int:
    if not isinstance(first, torch.Tensor) or first.dim() != 2:
        raise ValueError("inputs must be (n, 32) uint8 tensors")
    return first.shape[0]


def secp_verify(u1: torch.Tensor, u2: torch.Tensor, qx: torch.Tensor,
                qy: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """ECDSA acceptance of n lanes: ok (n,) uint8, 1 where
    (u1*G + u2*Q).x mod n == r, 0 for an off-curve Q or an infinity
    result.  Every input is (n, 32) uint8, big-endian."""
    n = _lanes(u1)
    dev = u1.device
    for name, t in (("u1", u1), ("u2", u2), ("qx", qx), ("qy", qy),
                    ("r", r)):
        _build.check_tensor(name, t, torch.uint8, (n, 32), dev)
    if _build.on_cpu(u1):
        return verify_ref(u1, u2, qx, qy, r)
    ok = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return ok
    lib = _build.load()
    comb = comb_table(dev)
    with torch.cuda.device(dev):
        err = lib.bm_secp_verify(
            u1.data_ptr(), u2.data_ptr(), qx.data_ptr(), qy.data_ptr(),
            r.data_ptr(), comb.data_ptr(), ok.data_ptr(), n,
            _build.stream(dev))
    _build.check(lib, err, "bm_secp_verify")
    LAUNCHES["secp_verify"] += 1
    return ok


def secp_ecdh(k: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """k*P for n lanes: x, y (n, 32) uint8 canonical affine coordinates
    (zero where ok is 0) and ok (n,) uint8, 0 for an off-curve P or an
    infinity result.  Every input is (n, 32) uint8, big-endian."""
    n = _lanes(k)
    dev = k.device
    for name, t in (("k", k), ("px", px), ("py", py)):
        _build.check_tensor(name, t, torch.uint8, (n, 32), dev)
    if _build.on_cpu(k):
        return ecdh_ref(k, px, py)
    x = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    y = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    ok = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return x, y, ok
    lib = _build.load()
    comb = comb_table(dev)
    with torch.cuda.device(dev):
        err = lib.bm_secp_ecdh(
            k.data_ptr(), px.data_ptr(), py.data_ptr(), comb.data_ptr(),
            x.data_ptr(), y.data_ptr(), ok.data_ptr(), n,
            _build.stream(dev))
    _build.check(lib, err, "bm_secp_ecdh")
    LAUNCHES["secp_ecdh"] += 1
    return x, y, ok


# the host driver that attributes their launches is crypto/gpu.py
register_program("secp_verify", cost=SECP_VERIFY_LANE,
                 module="ops/secp256k1_cuda.py")
register_program("secp_ecdh", cost=SECP_ECDH_LANE,
                 module="ops/secp256k1_cuda.py")
