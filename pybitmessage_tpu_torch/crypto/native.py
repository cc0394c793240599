"""ctypes binding for the native batch secp256k1 library, the engine's
native rung (the twin of ``pybitmessage_tpu.crypto.native``).

The library is built from the repository's source,
``native/secp256k1/bmsecp256k1.cpp``, with ``g++ -O3 -std=c++17 -fPIC
-pthread -shared`` into ``build/native/`` of the checkout: its file name
carries a hash of the source and the command (a stamp beside it holds
both), so a stale library is never loaded.  Concurrent first uses (test
workers, daemons started together) serialize on a file lock, and a
library appears only through an atomic rename.  A failed build, a
library that does not load and a failed known-answer self-test
(``tpu_secp_selftest``) all raise: with the rung on, nothing here turns
it off quietly.

The entry points are batch-shaped: one ctypes call per drain, the GIL
released for the whole batch, ``std::thread`` fan-out across items
inside the library (``nthreads``; 0 = every hardware thread).  Scalar
preparation (DER parsing, digest truncation, u1 = e/s, u2 = r/s mod n)
stays in ``crypto/batch.py``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent.parent
#: the library's source in the repository
SOURCE = _ROOT / "native" / "secp256k1" / "bmsecp256k1.cpp"
#: where it is built (git-ignored)
BUILD_DIR = _ROOT / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_u8p = ctypes.c_char_p
_ENTRY_POINTS = {
    # (n, u1s, u2s, pubs, rs, nthreads, ok)
    "tpu_secp_verify_batch": (None, [ctypes.c_int, _u8p, _u8p, _u8p, _u8p,
                                     ctypes.c_int, _u8p]),
    # (n, points, scalars, nthreads, xout, ok)
    "tpu_secp_ecdh_batch": (None, [ctypes.c_int, _u8p, _u8p, ctypes.c_int,
                                   _u8p, _u8p]),
    "tpu_secp_base_mult": (ctypes.c_int, [_u8p, _u8p]),
    "tpu_secp_point_check": (ctypes.c_int, [_u8p]),
    # (encrypt, key, iv, data, len, out)
    "tpu_secp_aes256cbc": (ctypes.c_int, [ctypes.c_int, _u8p, _u8p, _u8p,
                                          ctypes.c_int, _u8p]),
    "tpu_secp_selftest": (ctypes.c_int, []),
}

_lock = threading.Lock()
#: loaded and self-tested libraries by path
_LIBS: dict[str, ctypes.CDLL] = {}


def _command(source: Path, out: Path) -> list[str]:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: cannot build %s" % source)
    return [cxx, *FLAGS, "-o", str(out), str(source)]


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR, *,
          stem: str = "bmsecp256k1") -> Path:
    """The library ``lib<stem>-<hash>.so`` built from ``source``,
    compiled first when no library of this source and command exists.
    Raises when it cannot be built."""
    source, build_dir = Path(source), Path(build_dir)
    digest = hashlib.sha256(
        " ".join(FLAGS).encode() + b"\0" + source.read_bytes()).hexdigest()
    lib = build_dir / ("lib%s-%s.so" % (stem, digest[:16]))
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():            # another process built it meanwhile
            return lib
        tmp = build_dir / (".%s.%d.tmp" % (lib.name, os.getpid()))
        cmd = _command(source, tmp)
        try:
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            if run.returncode != 0:
                raise RuntimeError("native %s build failed (%d): %s\n%s"
                                   % (stem, run.returncode, " ".join(cmd),
                                      run.stderr))
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
        cmd[-2] = str(lib)
        (build_dir / (lib.name + ".stamp")).write_text(
            "%s\n%s\n" % (digest, " ".join(cmd)))
    return lib


def load(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The library of ``source``, built if needed, loaded and passed
    through its known-answer self-test once per process."""
    path = build(source, build_dir)
    with _lock:
        lib = _LIBS.get(str(path))
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        if not lib.tpu_secp_selftest():
            raise RuntimeError("native secp256k1 %s failed its self-test"
                               % path)
        _LIBS[str(path)] = lib
        return lib


class NativeSecp:
    """Batch secp256k1 and AES-256-CBC on the host, the drain ABI of
    ``CudaSecp``.  ``num_threads`` is each call's fan-out inside the
    library (``cryptonativethreads``; 0 = every hardware thread)."""

    def __init__(self, num_threads: int = 1, *, source: Path = SOURCE,
                 build_dir: Path = BUILD_DIR):
        self.num_threads = num_threads
        self._lib = load(source, build_dir)

    def _threads(self, nthreads: int | None) -> int:
        return self.num_threads if nthreads is None else nthreads

    def verify_prepared(self, n: int, u1s: bytes, u2s: bytes, pubs: bytes,
                        rs: bytes, nthreads: int | None = None) -> list[bool]:
        """Batch ECDSA acceptance over pre-reduced scalars: ``u1s``,
        ``u2s``, ``rs`` hold n 32-byte big-endian scalars, ``pubs`` n
        64-byte X || Y points.  An unloadable point or a zero u2 is
        False."""
        if not (len(u1s) == len(u2s) == len(rs) == 32 * n
                and len(pubs) == 64 * n):
            raise ValueError("bad verify batch packing")
        ok = ctypes.create_string_buffer(n)
        self._lib.tpu_secp_verify_batch(n, u1s, u2s, pubs, rs,
                                        self._threads(nthreads), ok)
        return [b == 1 for b in ok.raw]

    def ecdh_batch(self, n: int, points: bytes, scalars: bytes,
                   nthreads: int | None = None) -> list[bytes | None]:
        """Per item, scalar_i * point_i -> the 32-byte X the ECIES KDF
        hashes, or None for an invalid point or scalar."""
        if not (len(points) == 64 * n and len(scalars) == 32 * n):
            raise ValueError("bad ecdh batch packing")
        xout = ctypes.create_string_buffer(32 * n)
        ok = ctypes.create_string_buffer(n)
        self._lib.tpu_secp_ecdh_batch(n, points, scalars,
                                      self._threads(nthreads), xout, ok)
        raw = xout.raw
        return [raw[32 * i:32 * i + 32] if ok.raw[i] == 1 else None
                for i in range(n)]

    def base_mult(self, scalar: bytes) -> bytes | None:
        """scalar * G -> 64-byte X || Y, or None out of range."""
        out = ctypes.create_string_buffer(64)
        if not self._lib.tpu_secp_base_mult(scalar, out):
            return None
        return out.raw

    def point_check(self, point64: bytes) -> bool:
        """Curve membership of a 64-byte X || Y point."""
        return bool(self._lib.tpu_secp_point_check(point64))

    def aes256_cbc(self, encrypt: bool, key: bytes, iv: bytes,
                   data: bytes) -> bytes:
        """AES-256-CBC over ``len(data) % 16 == 0`` bytes (PKCS7 stays
        with the caller)."""
        if len(key) != 32 or len(iv) != 16 or len(data) % 16:
            raise ValueError("bad AES-256-CBC parameters")
        out = ctypes.create_string_buffer(len(data) or 1)
        if not self._lib.tpu_secp_aes256cbc(1 if encrypt else 0, key, iv,
                                            data, len(data), out):
            raise RuntimeError("native AES-256-CBC failed")
        return out.raw[:len(data)]
