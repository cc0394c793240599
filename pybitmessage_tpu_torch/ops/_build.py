"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> ctypes).

``nvcc`` compiles ``csrc/pow_kernels.cu`` into a shared library with a
plain C interface, for ``sm_90a`` only, at first use.  The library goes
to ``build/torch_kernels/`` in the checkout, beside a stamp holding a
hash of the sources and the command; a library whose stamp differs is
stale and is rebuilt, never loaded.  A failed build raises: there is no
fallback.  The first build prints ptxas' register and spill lines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libbmpow.so"
_MAIN_SOURCE = CSRC / "pow_kernels.cu"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: what the last build in this process did: seconds, ptxas lines (empty
#: when an up-to-date library was loaded instead)
build_info: dict = {"built": False, "seconds": 0.0, "ptxas": []}

_c = ctypes
_ENTRY_POINTS = {
    # (ih, base, target, n, best, stream)
    "bm_pow_search": [_c.c_void_p, _c.c_uint64, _c.c_uint64, _c.c_uint64,
                      _c.c_void_p, _c.c_void_p],
    # (ih, bases, targets, n, objs, best, stream)
    "bm_pow_batch_search": [_c.c_void_p, _c.c_void_p, _c.c_void_p,
                            _c.c_uint64, _c.c_int, _c.c_void_p,
                            _c.c_void_p],
    # (ih, bases, targets, groups, pack, steps, span, best, stream)
    "bm_pow_packed_search": [_c.c_void_p, _c.c_void_p, _c.c_void_p,
                             _c.c_int, _c.c_int, _c.c_uint64, _c.c_uint64,
                             _c.c_void_p, _c.c_void_p],
}


def nvcc() -> str:
    """Path of nvcc: PATH first, then CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the "
                       "CUDA kernels of %s" % CSRC)


def source_digest() -> str:
    """Hash of every kernel source and the build flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def _build(lib_path: Path, stamp: Path, digest: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name("%s.%d.tmp" % (LIB_NAME, os.getpid()))
    cmd = [nvcc(), *_FLAGS, "-o", str(tmp), str(_MAIN_SOURCE)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed (%d): %s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr or proc.stdout))
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    ptxas = [line.strip() for line in (proc.stderr + proc.stdout).splitlines()
             if "registers" in line or "spill" in line
             or "Compiling entry" in line]
    build_info.update(built=True, seconds=seconds, ptxas=ptxas)
    print("built %s in %.1f s" % (lib_path, seconds), file=sys.stderr)
    for line in ptxas:
        print(line, file=sys.stderr)


def load():
    """The kernels' ctypes library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".stamp")
        digest = source_digest()
        fresh = (lib_path.exists() and stamp.exists()
                 and stamp.read_text() == digest)
        if not fresh:
            _build(lib_path, stamp, digest)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bm_error_string.argtypes = [ctypes.c_int]
        lib.bm_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib, err: int, what: str) -> None:
    """Raise if an entry point did not launch its kernel."""
    if err != 0:
        raise RuntimeError("%s failed: CUDA error %d (%s)" % (
            what, err, lib.bm_error_string(err).decode(errors="replace")))
