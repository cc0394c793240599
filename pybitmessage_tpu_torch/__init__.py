"""PyTorch + CUDA port of ``pybitmessage_tpu``.

The JAX package stays the reference; this package holds the node path:
``core.Node`` (``send_message`` -> ``workers.sender`` -> the card's PoW;
``network.connection.accept_object`` -> ``workers.processor`` -> the
card's verify and ECDH -> the inbox -> the ack), with its storage
(``storage``, the JAX package's SQLite schema and keys.dat), keystore,
wire models and host crypto.  Below it, the modules a sent object's
proof-of-work runs through (``pow.service`` -> ``pow.dispatcher`` ->
``pow.pipeline`` / ``ops.sha512_cuda``) and those a received object's
checks run through (``pow.verify_service``, ``crypto.batch`` ->
``crypto.gpu`` -> ``ops.secp256k1_cuda``), down to the hand-written
sm_90a kernels in ``csrc/``.  It imports torch, numpy and the standard
library only.

Every entry point takes a ``device``: ``None`` means the CUDA device
(``RuntimeError`` when there is none), ``"cpu"`` runs the plain torch
versions of the kernels, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` asks for the CUDA device and raises ``RuntimeError`` when
    the process has none: the port never falls back to the CPU on its
    own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "torch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)
