"""Single-object PoW search and batched verification in plain torch
(twin of ``ops/pow_search.py``).

:func:`pow_search` is the plain twin of the reference's jitted
``pow_search_jit``: it scans up to ``max_chunks`` chunks of ``lanes``
consecutive nonces and stops at the first chunk holding a hit.
:func:`solve` drives it in slabs so a shutdown callback can interrupt
any search.  :func:`verify`, the batched PoW check of received objects,
runs as plain torch ops on the device it is given and is attributed to
the device-telemetry program ``pow_verify``, as the reference's
``verify`` is.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from .. import resolve_device
from ..observability.devicetelemetry import record_launch, register_program
from ..utils.hashes import double_sha512
from .bounds import POW_TRIAL
from .sha512 import double_sha512_trial, initial_hash_words, trial_values
from .u64 import MASK64, from_i64, le_u, to_i64, words_from_bytes

#: nonces per chunk of :func:`pow_search`
DEFAULT_LANES = 1 << 19
#: chunks per :func:`pow_search` call (between shutdown polls)
DEFAULT_CHUNKS_PER_CALL = 64


class PowInterrupted(Exception):
    """Nonce search aborted by the shutdown callback.

    Carries no result; the pending object stays queued and is retried
    (the reference's sent-state machine, class_singleWorker.py:720-724).
    """


def _run_host_driver(search_once, initial_hash: bytes, target: int, *,
                     start_nonce: int, trials_per_call_step: int,
                     should_stop: Callable[[], bool] | None,
                     progress: Callable[[int], None] | None = None,
                     program: str | None = None, program_key=None,
                     devices: int = 1):
    """Shared host loop over a search slab.

    ``search_once(base) -> (found, nonce, chunks)``;
    ``trials_per_call_step`` = trials one chunk represents; ``progress``
    gets the next base after every miss-free slab.  The winning nonce is
    re-checked with hashlib before it is returned.  With ``program``,
    every slab is attributed to that device-telemetry program, over
    ``devices`` shards.
    """
    base = start_nonce & MASK64
    trials = 0
    while True:
        if should_stop is not None and should_stop():
            raise PowInterrupted("PoW interrupted by shutdown")
        t0 = time.monotonic()
        found, nonce, chunks = search_once(base)
        if program is not None:
            t1 = time.monotonic()
            record_launch(program, key=program_key, dispatch_seconds=t1 - t0,
                          span=(t0, t1), items=chunks * trials_per_call_step,
                          bytes_out=16, devices=devices)
        trials += chunks * trials_per_call_step
        if bool(found):
            nonce = from_i64(nonce)
            check = double_sha512(nonce.to_bytes(8, "big") + initial_hash)
            if int.from_bytes(check[:8], "big") > target:
                raise ArithmeticError("search returned an invalid PoW nonce")
            return nonce, trials
        base = (base + chunks * trials_per_call_step) & MASK64
        if progress is not None:
            progress(base)


def pow_search(ih_words: torch.Tensor, target: int, start: int,
               lanes: int = DEFAULT_LANES,
               max_chunks: int = DEFAULT_CHUNKS_PER_CALL):
    """Search nonces [start, start + lanes*max_chunks) for a trial value
    <= target, exiting at the first chunk with a hit.

    ``ih_words``: int64 (8,); ``target``/``start``: u64 ints.  Returns
    (found, nonce as int64, chunks_done), like ``pow_search_jit``.
    """
    t = to_i64(target)
    base = to_i64(start)
    for chunk in range(max_chunks):
        values, nonces = trial_values(base, ih_words, lanes)
        ok = le_u(values, t)
        if bool(ok.any()):
            return True, int(nonces[torch.argmax(ok.to(torch.int8))]), chunk + 1
        base = to_i64(base + lanes)
    return False, 0, max_chunks


def solve(initial_hash: bytes, target: int, *, start_nonce: int = 0,
          lanes: int = DEFAULT_LANES,
          chunks_per_call: int = DEFAULT_CHUNKS_PER_CALL,
          should_stop: Callable[[], bool] | None = None,
          progress: Callable[[int], None] | None = None, device=None):
    """Find the lowest nonce >= ``start_nonce`` whose trial value is
    <= ``target``; returns ``(nonce, trials)`` or raises
    :class:`PowInterrupted`.  The winning nonce does not depend on the
    slab shape."""
    dev = resolve_device(device)
    ih_words = initial_hash_words(initial_hash, dev)
    target &= MASK64

    def search_once(base):
        return pow_search(ih_words, target, base, lanes, chunks_per_call)

    return _run_host_driver(
        search_once, initial_hash, target, start_nonce=start_nonce,
        trials_per_call_step=lanes, should_stop=should_stop,
        progress=progress)


def pow_verify_batch(nonces: torch.Tensor, ih_words: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Vector PoW check: int64 (B,) nonces, (8, B) initial-hash words,
    (B,) targets.  Returns a (B,) bool tensor, True where valid."""
    return le_u(double_sha512_trial(nonces, ih_words), targets)


def verify(items: Sequence[tuple[int, bytes, int]], device=None) -> list[bool]:
    """Batch-verify (nonce, initial_hash, target) triples.

    Pads to the next power of two, as the reference does to bound its
    compiled shapes.
    """
    if not items:
        return []
    dev = resolve_device(device)
    n = len(items)
    size = 1
    while size < n:
        size *= 2
    pad = size - n
    nonces = [to_i64(nonce) for nonce, _, _ in items] + [0] * pad
    targets = [to_i64(target) for _, _, target in items] + [0] * pad
    words = ([words_from_bytes(ih) for _, ih, _ in items]
             + [[0] * 8] * pad)
    t0 = time.monotonic()
    ok = pow_verify_batch(
        torch.tensor(nonces, dtype=torch.int64, device=dev),
        torch.tensor(words, dtype=torch.int64, device=dev).T,
        torch.tensor(targets, dtype=torch.int64, device=dev))
    t1 = time.monotonic()
    ok = ok[:n].tolist()            # the wait for the device's results
    t2 = time.monotonic()
    record_launch("pow_verify", key=dev.type, dispatch_seconds=t1 - t0,
                  wait_seconds=t2 - t1, span=(t0, t2), items=size,
                  bytes_in=80 * size, bytes_out=n)
    return [bool(b) for b in ok]


register_program("pow_verify", cost=POW_TRIAL, module="ops/pow_search.py")
