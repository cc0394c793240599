"""Pod-wide nonce search in plain torch (twin of
``parallel/pow_sharded.py``, the JAX package's XLA tier).

Partitioning: shard *d* of *D* searches nonces
``start + d*lanes + chunk*D*lanes + lane``, contiguous per-chunk blocks
interleaved across the shards.  Each round runs one chunk of
``ops.pow_search.pow_search`` (the twin of the XLA windowed search) on
every shard, on its device and stream; the search stops after the first
round in which any shard hit (the JAX per-chunk ``psum`` becomes an OR
over the round on the host), and the lowest shard with a hit wins.
Trial counts and nonces equal the JAX tier's for the same geometry.

No route reaches this tier; it is kept for parity with the JAX package.
The dispatcher's multi-device tier is ``pow_pallas_sharded`` on the
kernels, with no rung under it.
"""

from __future__ import annotations

import time
from typing import Callable

from ..observability.devicetelemetry import record_launch, register_program
from ..ops.bounds import POW_TRIAL
from ..ops.pow_search import PowInterrupted, _run_host_driver, pow_search
from ..ops.sha512_cuda import check_nonce
from ..ops.u64 import MASK64, from_i64, words_from_bytes
from .mesh import DeviceMesh
from .pow_pallas_sharded import shard_tensors

register_program("sharded_search", cost=POW_TRIAL,
                 module="parallel/pow_sharded.py")
register_program("sharded_batch", cost=POW_TRIAL,
                 module="parallel/pow_sharded.py")


def _search_row(row, words, j: int, target: int, start: int, lanes: int,
                max_chunks: int):
    """One object's rounds over the shards of its row (``words[shard]``
    row ``j``): (found, nonce, chunks)."""
    ndev = len(row)
    for chunk in range(max_chunks):
        for d, shard in enumerate(row):
            with shard.scope():
                found, nonce, _ = pow_search(
                    words[shard.index][j], target,
                    (start + (chunk * ndev + d) * lanes) & MASK64, lanes, 1)
            if found:
                # shards in order: the first hit of the round is the
                # lowest nonce
                return True, from_i64(nonce), chunk + 1
    return False, 0, max_chunks


def make_sharded_search(mesh: DeviceMesh, *, lanes: int = 1 << 13,
                        max_chunks: int = 64):
    """Pod-wide search over ``mesh``: ``fn(words, target, start) ->
    (found, nonce, chunks)``, ``words`` each shard's (1, 8) initial-hash
    words (``shard_tensors``).  On a 2D mesh the first row searches."""
    row = [s for s in mesh.shards if s.obj == 0]

    def fn(words, target: int, start: int):
        return _search_row(row, words, 0, target, start, lanes, max_chunks)

    return fn


def make_sharded_batch_search(mesh: DeviceMesh, *, lanes: int = 1 << 13,
                              max_chunks: int = 64):
    """Pod-wide search over a BATCH on a 2D mesh: objects split over the
    rows, each object's nonce range over its row, every object until its
    own first hit or ``max_chunks``.  ``fn(words, targets, starts) ->
    (found, nonces, chunks)``, lists of B; ``words`` each shard's
    (B/obj_size, 8) words."""
    obj_size = mesh.shape[mesh.axis_names[0]]
    rows = [[s for s in mesh.shards if s.obj == o] for o in range(obj_size)]

    def fn(words, targets: list, starts: list):
        block = len(targets) // obj_size
        out = [_search_row(rows[i // block], words, i % block, t, s, lanes,
                           max_chunks)
               for i, (t, s) in enumerate(zip(targets, starts))]
        return tuple(list(col) for col in zip(*out))

    return fn


#: the JAX builders' cached names.  Building a callable here compiles
#: nothing, so there is no cache: a cache keyed by the mesh would keep
#: every mesh, and its CUDA streams, for the life of the process.
get_sharded_search = make_sharded_search
get_sharded_batch_search = make_sharded_batch_search


def sharded_solve_batch(items, mesh: DeviceMesh, *, lanes: int = 1 << 13,
                        chunks_per_call: int = 64,
                        should_stop: Callable[[], bool] | None = None):
    """Solve a batch on a 2D mesh, every object searched from nonce 0;
    ``[(nonce, trials), ...]`` aligned with ``items``.  The batch pads
    to a multiple of the object rows with always-hit dummies; a solved
    object's target flips to always-hit.  On a 1D mesh the objects run
    one after another through :func:`sharded_solve`."""
    n = len(items)
    if n == 0:
        return []
    if len(mesh.axis_names) < 2:
        return [sharded_solve(ih, t, mesh, lanes=lanes,
                              chunks_per_call=chunks_per_call,
                              should_stop=should_stop)
                for ih, t in items]
    obj_size = mesh.shape[mesh.axis_names[0]]
    nonce_size = mesh.shape[mesh.axis_names[-1]]
    padded = list(items) + [(b"\x00" * 64, MASK64)] * (-n % obj_size)
    total = len(padded)
    block = total // obj_size
    fn = make_sharded_batch_search(mesh, lanes=lanes,
                                   max_chunks=chunks_per_call)
    words = shard_tensors(mesh, [
        [words_from_bytes(ih) for ih, _ in padded[o * block:(o + 1) * block]]
        for o in range(obj_size)])
    targets = [t & MASK64 for _, t in padded]
    step = lanes * nonce_size            # trials per object per round
    ndev = mesh.devices.size
    bases = [0] * total
    trials = [0] * total
    nonces: list = [None] * total
    while any(x is None for x in nonces[:n]):
        if should_stop is not None and should_stop():
            raise PowInterrupted("batched PoW interrupted by shutdown")
        t0 = time.monotonic()
        found, n_found, chunks = fn(words, targets, bases)
        t1 = time.monotonic()
        record_launch("sharded_batch",
                      key=(mesh.devices.flat[0].type, lanes,
                           chunks_per_call, total),
                      dispatch_seconds=t1 - t0, span=(t0, t1),
                      items=sum(chunks) * step, bytes_out=16 * total,
                      devices=ndev)
        for i in range(total):
            if nonces[i] is not None:
                continue
            trials[i] += chunks[i] * step
            if found[i]:
                check_nonce(n_found[i], padded[i][0], targets[i])
                nonces[i] = n_found[i]
                targets[i] = MASK64
            else:
                bases[i] = (bases[i] + chunks[i] * step) & MASK64
    return [(nonces[i], trials[i]) for i in range(n)]


def sharded_solve(initial_hash: bytes, target: int, mesh: DeviceMesh, *,
                  start_nonce: int = 0, lanes: int = 1 << 13,
                  chunks_per_call: int = 64,
                  should_stop: Callable[[], bool] | None = None):
    """Host driver for the pod-wide search (same contract as
    ``ops.pow_search.solve``)."""
    ndev = mesh.devices.size
    fn = make_sharded_search(mesh, lanes=lanes, max_chunks=chunks_per_call)
    words = shard_tensors(mesh, [[words_from_bytes(initial_hash)]]
                          * mesh.shape[mesh.axis_names[0]])
    target &= MASK64

    def search_once(base):
        return fn(words, target, base)

    return _run_host_driver(
        search_once, initial_hash, target, start_nonce=start_nonce,
        trials_per_call_step=lanes * ndev, should_stop=should_stop,
        program="sharded_search",
        program_key=(mesh.devices.flat[0].type, lanes, chunks_per_call,
                     ndev),
        devices=ndev)
