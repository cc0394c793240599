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

Source notes.  ``bm_secp_verify_kernel`` replaces
``pybitmessage_tpu/ops/secp256k1_pallas.py:470`` (``_verify_kernel``,
body ``verify_core``); ``bm_secp_ecdh_kernel`` replaces ``:477``
(``_ecdh_kernel``, body ``ecdh_core``).  Both are bound by 32-bit
integer multiply issue: a lane needs a chain of about 2,300 256-bit
modular multiplications and 2,100 squarings (verify), or 1,800 and
1,600 (ECDH), over 161 bytes of input and output.  A main-path drain (<= 4,096 lanes, one thread
each) leaves most of the card's issue slots idle, so a launch takes one
thread's serial chain.  The design keeps that chain short per step
(4 x 64-bit limbs with ``__umul64hi``, 16 wide products per
multiplication instead of 400 13-bit partials) and spreads a drain over
as many SMs as it can (32-thread blocks); ``csrc/secp256k1_kernels.cu``
says how the bound is counted.
"""

from __future__ import annotations

import torch

from . import _build
from .secp256k1 import ecdh_ref, verify_ref

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"secp_verify": 0, "secp_ecdh": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    with torch.cuda.device(dev):
        err = lib.bm_secp_verify(
            u1.data_ptr(), u2.data_ptr(), qx.data_ptr(), qy.data_ptr(),
            r.data_ptr(), ok.data_ptr(), n, _build.stream(dev))
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
    with torch.cuda.device(dev):
        err = lib.bm_secp_ecdh(
            k.data_ptr(), px.data_ptr(), py.data_ptr(), x.data_ptr(),
            y.data_ptr(), ok.data_ptr(), n, _build.stream(dev))
    _build.check(lib, err, "bm_secp_ecdh")
    LAUNCHES["secp_ecdh"] += 1
    return x, y, ok
