"""Pod-sharded PoW on the card's nonce-search kernels (twin of
``parallel/pow_pallas_sharded.py``).

Each shard of a :class:`~.mesh.DeviceMesh` runs the same hand-written
kernel the one-card tier runs: kernel 1 (``ops.sha512_cuda.cuda_search``,
``bm_search_kernel``) for one object, kernel 2 (``cuda_batch_search``,
``bm_batch_search_kernel``) for a batch, on the shard's device and its
own stream.  Shard *d* of the nonce axis searches the contiguous slab
``[base + d*slab, base + (d+1)*slab)``, ``slab = rows*128*chunks*unroll``.

The winner of a pod slab is the lowest shard with a hit, resolved on the
host where the JAX tier gathers each device's (hit, nonce) over ICI
(``_resolve_winner``); so the nonce is the lowest valid one at or above
the start, as every tier's is.  There is no collective inside a slab,
as in the JAX tier.  The host loop keeps one pod slab in flight ahead of
the harvest; its trial accounting, ``start_nonces``/``progress`` resume,
per-object always-hit flip and padding are the JAX loop's.

Shards on CPU devices run the wrappers' plain versions, which stand in
for the JAX tier's ``impl="xla"`` slab on a host without a TPU.  A
shard's kernel failure raises out of the solve: no shard falls back to
a plain version while its tensors are on the card.

Every harvest is attributed to the device-telemetry program
``pod_slab`` / ``pod_batch`` with ``devices`` = the mesh's shards, and a
pod slab abandoned in flight counts as a launch with no work items, as
``ops.sha512_cuda.solve`` counts its own.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ..observability.devicetelemetry import record_launch, register_program
from ..ops import sha512_cuda as sc
from ..ops.bounds import POW_TRIAL
from ..ops.pow_search import PowInterrupted
from ..ops.sha512_cuda import (BATCH_CHUNKS, BATCH_OBJS, BATCH_UNROLL,
                               DEFAULT_CHUNKS, DEFAULT_ROWS, DEFAULT_UNROLL,
                               LANE_COLS)
from ..ops.u64 import MASK64, to_i64, words_from_bytes
from ..pow import pipeline as _metrics
from .mesh import DeviceMesh

register_program("pod_slab", cost=POW_TRIAL,
                 module="parallel/pow_pallas_sharded.py")
register_program("pod_batch", cost=POW_TRIAL,
                 module="parallel/pow_pallas_sharded.py")

#: per-shard object count of a batch launch: the one-card batch
#: geometry.  The host loop groups a batch so each shard's share stays
#: within it.
POD_BATCH_PER_DEVICE = BATCH_OBJS

#: always-hit target: pad and solved slots hit at their first offset
_ALWAYS_HIT = MASK64


class PodSlab:
    """One pod slab in flight: every shard's results on their way to the
    host.  ``result()`` waits for them and resolves the winner."""

    __slots__ = ("_copies", "_resolve")

    def __init__(self, copies: list, resolve: Callable):
        self._copies = copies
        self._resolve = resolve

    def result(self) -> np.ndarray:
        return self._resolve([c.result() for c in self._copies])


def shard_tensors(mesh: DeviceMesh, rows: list) -> list:
    """For each shard, the int64 values of its object row (``rows[obj]``)
    as a tensor on its device, allocated under its stream."""
    out = []
    for shard in mesh.shards:
        with shard.scope():
            out.append(sc.upload(rows[shard.obj], shard.device))
    return out


def _first_hit(found: np.ndarray, nonce: np.ndarray):
    """A shard's first hit step -> (hit, nonce_hi, nonce_lo)."""
    idx = int(found.argmax())
    return bool(found[idx]), int(nonce[idx, 0]), int(nonce[idx, 1])


def make_pallas_sharded_search(mesh: DeviceMesh, *,
                               rows: int = DEFAULT_ROWS,
                               chunks: int = DEFAULT_CHUNKS,
                               unroll: int = DEFAULT_UNROLL):
    """Pod-wide single-object search over ``mesh``.

    ``fn(words, base, target) -> PodSlab`` whose ``result()`` is int64
    ``[found, nonce_hi, nonce_lo]``: ``words`` holds each shard's (8,)
    initial-hash words (:func:`shard_tensors`); every shard runs one
    kernel-1 launch on its share of the nonce range.  On a 2D mesh each
    object row searches the same slabs, as the JAX tier's replicated
    body does.
    """
    slab = rows * LANE_COLS * chunks * unroll

    def resolve(per_shard) -> np.ndarray:
        # shards are row-major: the first hit is the lowest nonce shard
        for found, nonce in per_shard:
            hit, n_hi, n_lo = _first_hit(found, nonce)
            if hit:
                return np.array([1, n_hi, n_lo], dtype=np.int64)
        return np.zeros(3, dtype=np.int64)

    def fn(words: list, base: int, target: int) -> PodSlab:
        copies = []
        for shard in mesh.shards:
            with shard.scope():
                copies.append(sc.HostCopy(*sc.cuda_search(
                    words[shard.index], (base + shard.nonce * slab) & MASK64,
                    target, rows=rows, chunks=chunks, unroll=unroll)))
        return PodSlab(copies, resolve)

    return fn


def make_pallas_sharded_batch_search(mesh: DeviceMesh, *,
                                     rows: int = DEFAULT_ROWS,
                                     chunks: int = DEFAULT_CHUNKS,
                                     unroll: int = 1):
    """Pod-wide BATCH search over a 2D (obj x nonce) mesh.

    Objects split over the object rows (each row holds B/obj_size of
    them); each object's nonce range splits over the row's shards.  One
    kernel-2 launch per shard covers its objects.  ``fn(words, bases,
    targets) -> PodSlab``: ``words`` each shard's (B/obj_size, 8) words
    (:func:`shard_tensors`), ``bases``/``targets`` B u64 ints; its
    ``result()`` is int64 (B, 4) rows ``[found, nonce_hi, nonce_lo,
    hit_step + 1]`` of each object's winning shard.
    """
    slab = rows * LANE_COLS * chunks * unroll
    obj_size = mesh.shape[mesh.axis_names[0]]

    def resolve(per_shard) -> np.ndarray:
        block = len(per_shard[0][0])
        out = np.zeros((block * obj_size, 4), dtype=np.int64)
        for shard, (packed,) in zip(mesh.shards, per_shard):
            rows_out = out[shard.obj * block:(shard.obj + 1) * block]
            # row-major shards: a lower nonce shard has already written
            fresh = (packed[:, 0] > 0) & (rows_out[:, 0] == 0)
            rows_out[fresh] = np.stack(
                [np.ones_like(packed[:, 0]), packed[:, 1], packed[:, 2],
                 packed[:, 0]], axis=1)[fresh]
        return out

    def fn(words: list, bases: list, targets: list) -> PodSlab:
        block = len(bases) // obj_size
        copies = []
        for shard in mesh.shards:
            lo = shard.obj * block
            off = shard.nonce * slab
            with shard.scope():
                b = sc.upload([to_i64(x + off) for x in bases[lo:lo + block]],
                              shard.device)
                t = sc.upload([to_i64(x) for x in targets[lo:lo + block]],
                              shard.device)
                copies.append(sc.HostCopy(sc.cuda_batch_search(
                    words[shard.index], b, t, rows=rows, chunks=chunks,
                    unroll=unroll)))
        return PodSlab(copies, resolve)

    return fn


def _program_key(mesh: DeviceMesh, rows: int, chunks: int, unroll: int):
    return (mesh.devices.flat[0].type, rows, chunks, unroll)


def pallas_sharded_solve(initial_hash: bytes, target: int,
                         mesh: DeviceMesh, *, start_nonce: int = 0,
                         rows: int = DEFAULT_ROWS,
                         chunks_per_call: int = DEFAULT_CHUNKS,
                         unroll: int = DEFAULT_UNROLL,
                         should_stop: Callable[[], bool] | None = None,
                         progress: Callable[[int], None] | None = None):
    """Pod-wide solve, kernel 1 on every shard.

    Same contract as ``ops.sha512_cuda.solve``: ``(nonce, trials)`` or
    :class:`PowInterrupted`.  One pod slab (stride ``nonce shards *
    rows*128*chunks*unroll``) stays in flight ahead of the harvest;
    trials are accounted in whole pod slabs; ``progress(next)`` gets the
    end of each pod slab that harvests miss-free.
    """
    ndev = mesh.devices.size
    nonce_devs = mesh.shape[mesh.axis_names[-1]]
    fn = make_pallas_sharded_search(mesh, rows=rows, chunks=chunks_per_call,
                                    unroll=unroll)
    key = _program_key(mesh, rows, chunks_per_call, unroll)
    words = shard_tensors(
        mesh, [words_from_bytes(initial_hash)] * mesh.shape[
            mesh.axis_names[0]])
    target &= MASK64
    stride = nonce_devs * rows * LANE_COLS * chunks_per_call * unroll

    def launch(base: int):
        t0 = time.monotonic()
        out = fn(words, base, target)
        return out, t0, time.monotonic()

    def harvest(out: PodSlab, t0: float, t1: float):
        t2 = time.monotonic()
        found, n_hi, n_lo = out.result()
        t3 = time.monotonic()
        record_launch("pod_slab", key=key, dispatch_seconds=t1 - t0,
                      wait_seconds=t3 - t2, span=(t0, t3), items=stride,
                      bytes_out=12, devices=ndev)
        if not found:
            return None
        nonce = (int(n_hi) << 32) | int(n_lo)
        sc.check_nonce(nonce, initial_hash, target)
        return nonce

    base = start_nonce & MASK64
    trials = 0
    pending = None      # ((PodSlab, dispatch t0, t1), end base)
    while True:
        if should_stop is not None and should_stop():
            if pending is not None:
                trials += stride
                nonce = harvest(*pending[0])
                if nonce is not None:
                    return nonce, trials
                if progress is not None:
                    progress(pending[1])
            raise PowInterrupted("sharded PoW interrupted")
        end_base = (base + stride) & MASK64
        current = (launch(base), end_base)
        base = end_base
        if pending is not None:
            trials += stride
            nonce = harvest(*pending[0])
            if nonce is not None:
                # the pod slab in flight: a launch the host never reads
                _, t0, t1 = current[0]
                record_launch("pod_slab", key=key,
                              dispatch_seconds=t1 - t0, devices=ndev)
                return nonce, trials
            if progress is not None:
                progress(pending[1])
        pending = current


def pallas_sharded_solve_batch(items, mesh: DeviceMesh, *,
                               rows: int = DEFAULT_ROWS,
                               chunks_per_call: int = BATCH_CHUNKS,
                               unroll: int = BATCH_UNROLL,
                               should_stop: Callable[[], bool] | None = None,
                               start_nonces=None, progress=None):
    """Solve ``[(initial_hash, target), ...]`` pod-wide, kernel 2 on
    every shard; ``[(nonce, trials), ...]`` aligned with ``items``.

    2D (obj x nonce) mesh: objects split over the rows, each object's
    nonce range over a row.  Once an object solves, its target flips to
    always-hit, so its lanes stop at once in the next launch and its
    trials stop accruing; a group pads with always-hit dummies.  A hit
    credits the winning shard up to its hit step and the row's other
    shards their whole slab.  On a 1D mesh the objects run one after
    another through :func:`pallas_sharded_solve` (kernel 1 at this
    geometry).  ``start_nonces`` resumes each object from its
    checkpoint; ``progress(i, next)`` gets the end of item ``i``'s slab
    whenever it harvests miss-free.
    """
    n = len(items)
    if n == 0:
        return []
    starts = list(start_nonces) if start_nonces else [0] * n
    if len(mesh.axis_names) < 2:
        out = []
        for i, (ih, t) in enumerate(items):
            prog = None
            if progress is not None:
                prog = (lambda nxt, _i=i: progress(_i, nxt))
            out.append(pallas_sharded_solve(
                ih, t, mesh, rows=rows, chunks_per_call=chunks_per_call,
                unroll=unroll, start_nonce=starts[i], progress=prog,
                should_stop=should_stop))
        return out

    obj_size = mesh.shape[mesh.axis_names[0]]
    nonce_devs = mesh.shape[mesh.axis_names[-1]]
    ndev = mesh.devices.size
    fn = make_pallas_sharded_batch_search(mesh, rows=rows,
                                          chunks=chunks_per_call,
                                          unroll=unroll)
    key = _program_key(mesh, rows, chunks_per_call, unroll)
    slab = rows * LANE_COLS * chunks_per_call * unroll
    stride = nonce_devs * slab
    step_trials = rows * LANE_COLS * unroll
    # every group pads to the same width: one launch shape for any batch
    group_objs = POD_BATCH_PER_DEVICE * obj_size
    block = POD_BATCH_PER_DEVICE

    results: list = [None] * n
    for first in range(0, n, group_objs):
        group = items[first:first + group_objs]
        pad = group_objs - len(group)
        ihs = [ih for ih, _ in group] + [b"\x00" * 64] * pad
        targets = [t & MASK64 for _, t in group] + [_ALWAYS_HIT] * pad
        words = shard_tensors(mesh, [
            [words_from_bytes(ih) for ih in ihs[o * block:(o + 1) * block]]
            for o in range(obj_size)])
        bases = [starts[first + i] & MASK64 if i < len(group) else 0
                 for i in range(group_objs)]
        trials = [0] * group_objs
        done = [i >= len(group) for i in range(group_objs)]

        def dispatch():
            """Launch one pod slab for the group's live objects.  Bases
            advance at dispatch, so the next slab goes out before this
            one's results are read."""
            live = [i for i in range(group_objs) if not done[i]]
            t0 = time.monotonic()
            out = fn(words, list(bases), list(targets))
            t1 = time.monotonic()
            for i in live:
                bases[i] = (bases[i] + stride) & MASK64
            # the checkpoint each live object may report once THIS slab
            # harvests miss-free
            return out, live, {i: bases[i] for i in live}, t0, t1

        def harvest(out, live, end_bases, t0, t1):
            t2 = time.monotonic()
            packed = out.result()
            t3 = time.monotonic()
            _metrics.DEVICE_WAIT.observe(t3 - t2)
            record_launch("pod_batch", key=key, dispatch_seconds=t1 - t0,
                          wait_seconds=t3 - t2, span=(t0, t3),
                          items=stride * len(live),
                          bytes_in=16 * group_objs * nonce_devs,
                          bytes_out=24 * group_objs * nonce_devs,
                          devices=ndev)
            for i in live:
                if done[i]:
                    continue
                found, n_hi, n_lo, step1 = (int(v) for v in packed[i])
                if found:
                    trials[i] += step1 * step_trials + (nonce_devs - 1) * slab
                    nonce = (n_hi << 32) | n_lo
                    sc.check_nonce(nonce, ihs[i], targets[i])
                    results[first + i] = (nonce, trials[i])
                    done[i] = True
                    targets[i] = _ALWAYS_HIT
                else:
                    trials[i] += stride
                    if progress is not None:
                        progress(first + i, end_bases[i])

        pending = None
        while not all(done):
            if should_stop is not None and should_stop():
                if pending is not None:
                    # the slab in flight may hold answers
                    harvest(*pending)
                    pending = None
                if all(done):
                    break
                raise PowInterrupted("sharded batched PoW interrupted")
            current = dispatch()
            _metrics.PIPELINE_DEPTH.set(2 if pending else 1)
            if pending is not None:
                _metrics.DISPATCH_AHEAD.observe(2)
                harvest(*pending)
            pending = current
        if pending is not None:
            # a slab in flight for a finished group: never read
            _, _, _, t0, t1 = pending
            record_launch("pod_batch", key=key, dispatch_seconds=t1 - t0,
                          devices=ndev)
        _metrics.PIPELINE_DEPTH.set(0)
    return results
