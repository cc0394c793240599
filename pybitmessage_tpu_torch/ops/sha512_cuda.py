"""Nonce-search kernels on the card (twin of ``ops/sha512_pallas.py``).

Three wrappers, one per hand-written CUDA kernel of ``csrc/``:

* :func:`cuda_search` - one object (replaces ``pallas_search``);
* :func:`cuda_batch_search` - B objects, a full tile each
  (``pallas_batch_search``);
* :func:`cuda_packed_search` - ``pack`` objects per tile (storms;
  ``pallas_packed_search``).

Each takes u64 words as int64 tensors (see ``u64.py``).  For tensors on
the CPU it runs its plain torch version (``search_ref``,
``batch_search_ref``, ``packed_search_ref``); for CUDA tensors it
launches its kernel or raises.  Each launch adds one to ``LAUNCHES``.

The reference's nonce-range geometry stays the unit of the output
contract: a grid step covers ``rows * 128 * unroll`` trials (per object
in the packed kernel: ``rows / pack * 128 * unroll``), and outputs name
the first step with a hit and its lowest nonce, so the host drivers and
the pipeline account trials exactly as the reference does.  How a kernel
spreads its threads over a launch's range is its own business.

:func:`solve` is the single-object host loop; it keeps one launch in
flight ahead of the one being harvested, attributes each launch to the
device-telemetry program ``pallas_slab`` and leaves a ``slab_harvest``
event in the flight recorder.  Batches go through
``pow/pipeline.py`` (``batch_search``, ``packed_search``).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..observability.devicetelemetry import record_launch, register_program
from ..observability.flightrec import record as _flight
from ..utils.hashes import double_sha512
from . import _build
from .bounds import POW_TRIAL
from .pow_search import PowInterrupted
from .sha512 import double_sha512_trial, initial_hash_words
from .u64 import MASK64, le_u, shr, to_i64

LANE_COLS = 128

#: single-object slab: rows x 128 x unroll trials per grid step, chunks
#: grid steps per launch (41.9M trials)
DEFAULT_ROWS = 128
DEFAULT_CHUNKS = 512
DEFAULT_UNROLL = 5

#: batched launches: objects per launch (pad slots get always-hit
#: targets), grid steps per launch, tiles per grid step
BATCH_OBJS = 64
BATCH_CHUNKS = 64
BATCH_UNROLL = 4

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"search": 0, "batch_search": 0, "packed_search": 0}

#: the packed kernel's launch counters, the words of its scratch after
#: best[B] and next[B] (``csrc/packed_claims.cuh`` BmPackedCounter)
PACKED_COUNTERS = ("solved", "hashed_rounds", "skipped_rounds", "claims",
                   "switches")
#: the last CUDA launch of the packed kernel's scratch, kept on the card
_last_packed: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# shared output contract
# ---------------------------------------------------------------------------


def _rows(best: torch.Tensor, bases: torch.Tensor,
          step_trials: int) -> torch.Tensor:
    """(B,) lowest hit offsets (-1 = none) -> (B, 3) int64 rows
    ``[hit_step + 1, nonce_hi, nonce_lo]`` (all 0 = no hit)."""
    hit = best >= 0
    nonce = bases + best                       # wraps mod 2^64
    return torch.stack([
        torch.where(hit, best // step_trials + 1, 0),
        torch.where(hit, shr(nonce, 32), 0),
        torch.where(hit, nonce & 0xFFFFFFFF, 0)], dim=1)


def _step_outputs(best: torch.Tensor, base: int, step_trials: int,
                  chunks: int):
    """Single-object outputs per grid step, as ``pallas_search`` gives
    them: found (chunks,) is 1 at the hit step only (later steps are
    skipped), nonce (chunks, 2) holds (hi, lo) there and 0 elsewhere."""
    bases = torch.full((1,), to_i64(base), dtype=torch.int64,
                       device=best.device)
    row = _rows(best, bases, step_trials)[0]
    steps = torch.arange(1, chunks + 1, dtype=torch.int64,
                         device=best.device)
    found = (steps == row[0]).to(torch.int64)
    nonce = found[:, None] * row[1:][None, :]
    return found, nonce


# ---------------------------------------------------------------------------
# plain torch versions (what the wrappers run for CPU tensors)
# ---------------------------------------------------------------------------


def _best_offsets_ref(ih_words: torch.Tensor, bases: torch.Tensor,
                      targets: torch.Tensor, n: int) -> torch.Tensor:
    """Per object, the lowest offset in [0, n) whose trial value is
    <= its target (-1 = none).

    All objects advance together, a block of offsets per pass (about
    2^23 trials a pass on CUDA, 2^12 on the CPU), and the scan stops
    once every object has a hit.
    """
    dev = ih_words.device
    n_obj = ih_words.shape[0]
    budget = 1 << (23 if dev.type == "cuda" else 12)
    per = max(1, min(n, budget // max(n_obj, 1)))
    ih_cols = ih_words.T[:, :, None]            # (8, B, 1) per-object words
    best = torch.full((n_obj,), -1, dtype=torch.int64, device=dev)
    for start in range(0, n, per):
        offs = torch.arange(start, min(start + per, n), dtype=torch.int64,
                            device=dev)
        values = double_sha512_trial(bases[:, None] + offs, ih_cols)
        ok = le_u(values, targets[:, None]) & (best < 0)[:, None]
        first = start + torch.argmax(ok.to(torch.int8), dim=1)
        best = torch.where(ok.any(dim=1), first, best)
        if bool((best >= 0).all()):
            break
    return best


def search_ref(ih_words, base: int, target: int, *, rows: int = DEFAULT_ROWS,
               chunks: int = DEFAULT_CHUNKS, unroll: int = DEFAULT_UNROLL):
    """Plain version of :func:`cuda_search`."""
    step = rows * LANE_COLS * unroll
    dev = ih_words.device
    best = _best_offsets_ref(
        ih_words[None],
        torch.full((1,), to_i64(base), dtype=torch.int64, device=dev),
        torch.full((1,), to_i64(target), dtype=torch.int64, device=dev),
        step * chunks)
    return _step_outputs(best, base, step, chunks)


def batch_search_ref(ih_words, bases, targets, *, rows: int = DEFAULT_ROWS,
                     chunks: int = BATCH_CHUNKS, unroll: int = BATCH_UNROLL):
    """Plain version of :func:`cuda_batch_search`."""
    step = rows * LANE_COLS * unroll
    best = _best_offsets_ref(ih_words, bases, targets, step * chunks)
    return _rows(best, bases, step)


def packed_search_ref(ih_words, bases, targets, *, rows: int = DEFAULT_ROWS,
                      chunks: int = 16, pack: int = 16, unroll: int = 1):
    """Plain version of :func:`cuda_packed_search`."""
    step = rows // pack * LANE_COLS * unroll
    best = _best_offsets_ref(ih_words, bases, targets, step * chunks)
    return _rows(best, bases, step)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_words(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    _build.check_tensor(name, t, torch.int64, shape, device)


def cuda_search(ih_words: torch.Tensor, base: int, target: int, *,
                rows: int = DEFAULT_ROWS, chunks: int = DEFAULT_CHUNKS,
                unroll: int = DEFAULT_UNROLL):
    """Search nonces [base, base + chunks*unroll*rows*128) mod 2^64 for
    a trial value <= target.

    ``ih_words``: int64 (8,).  ``base``/``target``: u64 ints.  Returns
    (found (chunks,), nonce (chunks, 2)) int64 per grid step of
    ``unroll`` (rows, 128) tiles, as ``pallas_search`` does: the first
    step with a hit holds 1 and its lowest nonce, every other step 0.
    """
    dev = ih_words.device
    _check_words("ih_words", ih_words, (8,), dev)
    if _build.on_cpu(ih_words):
        return search_ref(ih_words, base, target, rows=rows, chunks=chunks,
                          unroll=unroll)
    step = rows * LANE_COLS * unroll
    lib = _build.load()
    best = torch.empty(3, dtype=torch.int64, device=dev)    # + 2 counters
    with torch.cuda.device(dev):
        err = lib.bm_pow_search(ih_words.data_ptr(), base & MASK64,
                                target & MASK64, step * chunks,
                                best.data_ptr(), _build.stream(dev))
    _build.check(lib, err, "bm_pow_search")
    LAUNCHES["search"] += 1
    return _step_outputs(best[:1], base, step, chunks)


def cuda_batch_search(ih_words: torch.Tensor, bases: torch.Tensor,
                      targets: torch.Tensor, *, rows: int = DEFAULT_ROWS,
                      chunks: int = BATCH_CHUNKS,
                      unroll: int = BATCH_UNROLL) -> torch.Tensor:
    """Search B objects' nonce ranges in ONE launch.

    ``ih_words``: int64 (B, 8); ``bases``/``targets``: int64 (B,).
    Object b searches [bases[b], bases[b] + chunks*unroll*rows*128).
    Returns int64 (B, 3) rows ``[hit_step + 1, nonce_hi, nonce_lo]``
    (first column 0 = no hit in this launch).
    """
    dev = ih_words.device
    n_obj = ih_words.shape[0]
    _check_words("ih_words", ih_words, (n_obj, 8), dev)
    _check_words("bases", bases, (n_obj,), dev)
    _check_words("targets", targets, (n_obj,), dev)
    if _build.on_cpu(ih_words):
        return batch_search_ref(ih_words, bases, targets, rows=rows,
                                chunks=chunks, unroll=unroll)
    step = rows * LANE_COLS * unroll
    lib = _build.load()
    best = torch.empty(n_obj + 2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.bm_pow_batch_search(
            ih_words.data_ptr(), bases.data_ptr(), targets.data_ptr(),
            step * chunks, n_obj, best.data_ptr(), _build.stream(dev))
    _build.check(lib, err, "bm_pow_batch_search")
    LAUNCHES["batch_search"] += 1
    return _rows(best[:n_obj], bases, step)


def cuda_packed_search(ih_words: torch.Tensor, bases: torch.Tensor,
                       targets: torch.Tensor, *, rows: int = DEFAULT_ROWS,
                       chunks: int = 16, pack: int = 16,
                       unroll: int = 1) -> torch.Tensor:
    """Search B = groups*pack objects' nonce ranges in ONE launch.

    Object k of a group owns ``rows // pack`` rows of each (rows, 128)
    tile: object b searches ``bases[b] + (step*unroll + u)*rpo*128 +
    local``, i.e. [bases[b], bases[b] + chunks*unroll*rpo*128).  Pad
    slots take the always-hit target and hit at once.  Returns int64
    (B, 3) rows ``[hit_step + 1, nonce_hi, nonce_lo]``.
    """
    if rows % pack:
        raise ValueError("rows %d not divisible by pack %d" % (rows, pack))
    dev = ih_words.device
    n_obj = ih_words.shape[0]
    if n_obj % pack:
        raise ValueError("batch %d not divisible by pack %d"
                         % (n_obj, pack))
    _check_words("ih_words", ih_words, (n_obj, 8), dev)
    _check_words("bases", bases, (n_obj,), dev)
    _check_words("targets", targets, (n_obj,), dev)
    if _build.on_cpu(ih_words):
        return packed_search_ref(ih_words, bases, targets, rows=rows,
                                 chunks=chunks, pack=pack, unroll=unroll)
    span = rows // pack * LANE_COLS
    lib = _build.load()
    # best[B], next[B] (each object's claim counter), the launch counters
    scratch = torch.empty(2 * n_obj + len(PACKED_COUNTERS),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.bm_pow_packed_search(
            ih_words.data_ptr(), bases.data_ptr(), targets.data_ptr(),
            n_obj // pack, pack, chunks * unroll, span, scratch.data_ptr(),
            _build.stream(dev))
    _build.check(lib, err, "bm_pow_packed_search")
    LAUNCHES["packed_search"] += 1
    _last_packed.update(scratch=scratch, objs=n_obj)
    return _rows(scratch[:n_obj], bases, span * unroll)


def packed_counters() -> dict:
    """The counters of the last CUDA launch of :func:`cuda_packed_search`
    (``PACKED_COUNTERS``: rounds of 32 offsets hashed, claims that found
    their object finished, claims, objects picked).  Reads the card, so
    it waits for that launch; the search itself never does."""
    if not _last_packed:
        raise RuntimeError("no CUDA launch of the packed kernel yet")
    words = _last_packed["scratch"][2 * _last_packed["objs"]:].tolist()
    return dict(zip(PACKED_COUNTERS, words))


# ---------------------------------------------------------------------------
# host <-> device transfers that keep the dispatch-ahead pipeline async
# ---------------------------------------------------------------------------


def upload(values, device: torch.device) -> torch.Tensor:
    """int64 host values -> a tensor on ``device``.  CUDA uploads go
    through pinned memory as non-blocking copies: a pageable copy would
    wait for the slab already running on the stream."""
    t = torch.as_tensor(np.asarray(values, dtype=np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class HostCopy:
    """Results of one launch on their way to the host.

    Made right after the launch: on CUDA each tensor is copied
    (non-blocking) into a pinned buffer and an event is recorded behind
    the copies, so harvesting launch N waits for N alone - not for
    launch N+1, which the host has already queued behind it on the same
    stream (a plain ``.cpu()`` would wait for both).
    """

    __slots__ = ("_host", "_event")

    def __init__(self, *tensors: torch.Tensor):
        dev = tensors[0].device
        if dev.type == "cuda":
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = list(tensors)
            self._event = None

    def result(self) -> list[np.ndarray]:
        """Block until the copies landed; the host arrays."""
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def check_nonce(nonce: int, initial_hash: bytes, target: int) -> None:
    check = double_sha512(nonce.to_bytes(8, "big") + initial_hash)
    if int.from_bytes(check[:8], "big") > target:
        raise ArithmeticError("device returned an invalid PoW nonce")


# ---------------------------------------------------------------------------
# host loops
# ---------------------------------------------------------------------------


def solve(initial_hash: bytes, target: int, *, start_nonce: int = 0,
          rows: int = DEFAULT_ROWS, chunks_per_call: int = DEFAULT_CHUNKS,
          unroll: int = DEFAULT_UNROLL,
          should_stop: Callable[[], bool] | None = None, tuner=None,
          progress: Callable[[int], None] | None = None, device=None):
    """Find the lowest nonce >= ``start_nonce`` whose trial value is
    <= ``target``; returns ``(nonce, trials)`` or raises
    :class:`PowInterrupted`.

    Slabs of ``chunks_per_call * rows * 128 * unroll`` trials; slab N+1
    is launched BEFORE slab N's results are read, so the harvest and
    the host bookkeeping hide behind device work.  ``progress(next)``
    gets each miss-free slab's end (the resumable-PoW checkpoint).
    Trials are accounted at slab granularity.
    """
    dev = resolve_device(device)
    ih_words = initial_hash_words(initial_hash, dev)
    target &= MASK64
    chunks = chunks_per_call
    if tuner is not None:
        chunks = tuner.suggest("cuda_single", chunks_per_call,
                               lo=chunks_per_call // 2,
                               hi=chunks_per_call * 2)
    step_trials = rows * LANE_COLS * unroll
    trials_per_slab = step_trials * chunks

    def launch(base: int):
        """(HostCopy, dispatch start, dispatch end) of one slab."""
        t0 = time.monotonic()
        copy = HostCopy(*cuda_search(ih_words, base, target, rows=rows,
                                     chunks=chunks, unroll=unroll))
        return copy, t0, time.monotonic()

    def harvest(copy: HostCopy, t0: float, t1: float):
        t_f = time.monotonic()
        found, nonce = copy.result()
        t_done = time.monotonic()
        idx = int(found.argmax())
        hit = bool(found[idx])
        # the trials this slab's data needed: up to the hit step
        record_launch("pallas_slab", key=dev.type, dispatch_seconds=t1 - t0,
                      wait_seconds=t_done - t_f, span=(t0, t_done),
                      items=(idx + 1) * step_trials if hit
                      else trials_per_slab, bytes_in=8,
                      bytes_out=int(found.nbytes + nonce.nbytes))
        _flight("slab_harvest", program="pallas_slab", hit=hit,
                wait_ms=round((t_done - t_f) * 1e3, 2))
        if not hit:
            return None
        value = (int(nonce[idx, 0]) << 32) | int(nonce[idx, 1])
        check_nonce(value, initial_hash, target)
        return value

    def abandon(slab) -> None:
        """A slab in flight when the answer came: a launch the host never
        reads (no wait, no work items)."""
        _, t0, t1 = slab
        record_launch("pallas_slab", key=dev.type, dispatch_seconds=t1 - t0,
                      bytes_in=8)

    base = start_nonce & MASK64
    trials = 0
    pending = None      # ((HostCopy, dispatch start, end), end base)
    while True:
        if should_stop is not None and should_stop():
            # the in-flight slab may already hold the answer
            if pending is not None:
                trials += trials_per_slab
                nonce = harvest(*pending[0])
                if nonce is not None:
                    return nonce, trials
                if progress is not None:
                    progress(pending[1])
            raise PowInterrupted("CUDA PoW interrupted by shutdown")
        end_base = (base + trials_per_slab) & MASK64
        current = (launch(base), end_base)
        base = end_base
        if pending is not None:
            trials += trials_per_slab
            nonce = harvest(*pending[0])
            if tuner is not None:
                tuner.record("cuda_single", chunks,
                             time.monotonic() - pending[0][2])
            if nonce is not None:
                abandon(current[0])
                return nonce, trials
            if progress is not None:
                progress(pending[1])
        pending = current


register_program("pallas_slab", cost=POW_TRIAL, module="ops/sha512_cuda.py")
register_program("batch_search", cost=POW_TRIAL, module="ops/sha512_cuda.py")
register_program("packed_search", cost=POW_TRIAL,
                 module="ops/sha512_cuda.py")
