"""ctypes binding for the C++ pthread PoW solver, the native rung of the
dispatcher's card-off mode (the twin of ``pybitmessage_tpu.pow.native``).

The library is built from the repository's source,
``native/pow/bitmsgpow.cpp``, by ``crypto/native.py``'s ``build``:
``g++ -O3 -std=c++17 -fPIC -pthread -shared`` into ``build/native/`` of
the checkout, the file name carrying a hash of the source and the
command (a stamp beside it holds both), concurrent first uses
serialized on a file lock, the library appearing only through an atomic
rename.  The binary committed beside the source
(``native/pow/libbitmsgpow.so``) is never loaded: it is not built from
the repository's sources.  A failed build, a library that does not load
and a failed known-answer self-test all raise.

``num_threads`` is the ``std::thread`` fan-out of one search (0 = every
hardware thread).  With one thread the search returns the lowest valid
nonce at or above ``start_nonce``; with more, a thread that hits stops
the others, so the nonce is valid but need not be the lowest.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path
from typing import Callable

from ..crypto.native import BUILD_DIR, build
from ..ops.pow_search import PowInterrupted

_ROOT = Path(__file__).resolve().parent.parent.parent
#: the solver's source in the repository
SOURCE = _ROOT / "native" / "pow" / "bitmsgpow.cpp"
#: the prebuilt binary committed beside it, never loaded
TRACKED_BINARY = _ROOT / "native" / "pow" / "libbitmsgpow.so"

_lock = threading.Lock()
#: loaded and self-tested libraries by path
_LIBS: dict[str, ctypes.CDLL] = {}


def _self_test(lib) -> bool:
    """Known-answer check against hashlib (proofofwork.py:354-361)."""
    ih = hashlib.sha512(b"native self test").digest()
    expect = int.from_bytes(hashlib.sha512(hashlib.sha512(
        (12345).to_bytes(8, "big") + ih).digest()).digest()[:8], "big")
    return lib.tpu_bm_pow_trial(ih, 12345) == expect


def load(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The solver of ``source``, built if needed, loaded and passed
    through its self-test once per process."""
    path = build(source, build_dir, stem="bitmsgpow")
    with _lock:
        lib = _LIBS.get(str(path))
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(path))
        lib.tpu_bm_pow_solve.restype = ctypes.c_uint64
        lib.tpu_bm_pow_solve.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int)]
        lib.tpu_bm_pow_trial.restype = ctypes.c_uint64
        lib.tpu_bm_pow_trial.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        if not _self_test(lib):
            raise RuntimeError("native PoW solver %s failed its self-test"
                               % path)
        _LIBS[str(path)] = lib
        return lib


class NativeSolver:
    """C++ multithreaded double-SHA512 nonce search."""

    def __init__(self, num_threads: int = 0, *, source: Path = SOURCE,
                 build_dir: Path = BUILD_DIR):
        self.num_threads = num_threads
        self._lib = load(source, build_dir)

    def solve(self, initial_hash: bytes, target: int, *,
              start_nonce: int = 0,
              should_stop: Callable[[], bool] | None = None):
        """Blocking search, ``(nonce, trials)``; ``should_stop`` is
        polled from a watcher thread every 0.2 s and raises
        :class:`PowInterrupted` once it is true."""
        stop_flag = ctypes.c_int(0)
        trials_out = ctypes.c_uint64(0)
        found_out = ctypes.c_int(0)
        watcher_done = threading.Event()

        def watch():
            while not watcher_done.wait(0.2):
                if should_stop is not None and should_stop():
                    stop_flag.value = 1
                    return

        watcher = threading.Thread(target=watch, daemon=True,
                                   name="bmtpu-pow-native-watch")
        watcher.start()
        try:
            nonce = self._lib.tpu_bm_pow_solve(
                initial_hash, target, start_nonce, self.num_threads,
                ctypes.byref(stop_flag), ctypes.byref(trials_out),
                ctypes.byref(found_out))
        finally:
            watcher_done.set()
            watcher.join()
        if not found_out.value:
            raise PowInterrupted("native PoW interrupted")
        return nonce, int(trials_out.value)
