"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> ctypes).

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all
started together) and links them into one shared library with a plain C
interface, for ``sm_90a`` only, at first use.  The library goes to
``build/torch_kernels/`` in the checkout, beside a stamp holding a hash
of the sources and the command; a library whose stamp differs is stale
and is rebuilt, never loaded.  A failed build raises: there is no
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libbmpow.so"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    # (u1, u2, qx, qy, r, comb, ok, n, stream)
    "bm_secp_verify": [_c.c_void_p] * 7 + [_c.c_int, _c.c_void_p],
    # (k, px, py, comb, x, y, ok, n, stream)
    "bm_secp_ecdh": [_c.c_void_p] * 7 + [_c.c_int, _c.c_void_p],
    # (op, a, b, out, n, stream)
    "bm_secp_selftest": [_c.c_int] + [_c.c_void_p] * 3 + [_c.c_int,
                                                          _c.c_void_p],
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


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first that fails.  Returns
    their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d): %s\n%s" % (
                proc.returncode, " ".join(cmd), out))
    return "\n".join(outs)


def _build(lib_path: Path, stamp: Path, digest: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "%d" % os.getpid()
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / ("%s.%s.o" % (src.stem, tag)) for src in sources]
    tmp = lib_path.with_name("%s.%s.tmp" % (LIB_NAME, tag))
    t0 = time.monotonic()
    try:
        out = _run([[nvcc(), *_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects)])
        _run([[nvcc(), "-shared", "-o", str(tmp), *map(str, objects)]])
    except Exception:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.monotonic() - t0
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    ptxas = [line.strip() for line in out.splitlines()
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


# ---------------------------------------------------------------------------
# what every kernel wrapper checks before it launches
# ---------------------------------------------------------------------------


def check_tensor(name: str, t, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError("%s must be a %s tensor" % (name, dtype))
    if tuple(t.shape) != shape:
        raise ValueError("%s has shape %r, expected %r"
                         % (name, tuple(t.shape), shape))
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (the wrapper runs its plain version); CUDA
    tensors launch the kernel; any other device is refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError("no kernel for tensors on %s" % t.device)
    return False


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream
