"""Asynchronous double-buffered PoW pipeline (twin of ``pow/pipeline.py``).

Three levers keep the card busy on a batch of pending objects:

1. **Multi-object slab packing** (``cuda_packed_search``): a storm of
   small objects shares each launch, ``pack`` objects per tile, instead
   of paying a launch and a host sync per object.
2. **Dispatch-ahead double buffering** (:class:`_PipelineDriver`): slab
   N+1 is launched before slab N's results are read, so host-side
   verification hides behind device work.
3. **Early-exit cadence autotuning** (:class:`SlabAutotuner`): chunks per
   launch follow the measured slab latency.

:func:`plan_batch` chooses per batch between the packed kernel (many
small objects), the per-object batch kernel (objects at network
difficulty) and one synchronous launch (a single tiny object).

Whether a kernel or its plain version runs follows the device of the
call: on CUDA the kernels of ``ops.sha512_cuda``; on the CPU
:func:`_packed_search_ref`, with the same (B, 3)-row output contract, so
the planning and pipelining logic runs unchanged without a card.

Every stage reports through ``observability.REGISTRY`` (the JAX
pipeline's families: device-busy ratio, depth, dispatch-ahead, device
wait, pack size and occupancy, mode, slab seconds, autotuned chunks),
and every launch is attributed to its device-telemetry program
(``batch_search`` or ``packed_search``) at its harvest, or as abandoned
when the batch finished without reading it.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import math
import threading
import time
from collections import deque
from typing import Callable

import torch

from .. import resolve_device
from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..observability.devicetelemetry import record_launch
from ..observability.flightrec import record as _flight
from ..ops.pow_search import PowInterrupted
from ..ops.sha512 import trial_values
from ..ops.sha512_cuda import (BATCH_OBJS, BATCH_UNROLL, DEFAULT_ROWS,
                               LANE_COLS, HostCopy, check_nonce,
                               cuda_batch_search, cuda_packed_search,
                               upload)
from ..ops.u64 import ALWAYS_HIT, MASK64, le_u, to_i64, words_from_bytes
from ..resilience.chaos import inject
from ..resilience.watchdog import SlabStallError, note_stall

logger = logging.getLogger("pybitmessage_tpu_torch.pow")

DEVICE_BUSY = REGISTRY.gauge(
    "pow_pipeline_device_busy_ratio",
    "Fraction of the last pipelined solve's wall time the host spent "
    "blocked on device results — a lower bound on true device "
    "occupancy; the sync-path penalty shows up as this dropping")
PIPELINE_DEPTH = REGISTRY.gauge(
    "pow_pipeline_depth", "Slabs currently in flight (dispatch-ahead)")
DISPATCH_AHEAD = REGISTRY.histogram(
    "pow_pipeline_dispatch_ahead_size",
    "In-flight slab count sampled at each harvest",
    buckets=DEFAULT_SIZE_BUCKETS)
DEVICE_WAIT = REGISTRY.histogram(
    "pow_pipeline_device_wait_seconds",
    "Blocking wait for one slab's results at harvest time")
PACK_SIZE = REGISTRY.histogram(
    "pow_pack_size",
    "Live (non-pad, unsolved) objects sharing one packed slab launch",
    buckets=DEFAULT_SIZE_BUCKETS)
PACK_OCCUPANCY = REGISTRY.gauge(
    "pow_pack_occupancy_ratio",
    "Fraction of the last packed slab's lanes owned by live objects")
PIPELINE_MODE = REGISTRY.counter(
    "pow_pipeline_mode_total",
    "Pipelined solve launches by execution mode", ("mode",))
SLAB_SECONDS = REGISTRY.histogram(
    "pow_slab_seconds",
    "Wall latency of one device slab launch as seen by the pipeline "
    "(dispatch to harvested) — the autotuner's input", ("kind",))
AUTOTUNE_CHUNKS = REGISTRY.gauge(
    "pow_slab_autotune_chunks",
    "Chunks-per-launch the autotuner currently suggests", ("kind",))


class SlabAutotuner:
    """Derives slab size from measured latency (early-exit cadence).

    Tracks an EWMA of seconds per grid step per slab ``kind``
    (``record`` takes the launch's total grid steps, chunks times
    groups) and suggests the power-of-two chunk count whose expected
    slab latency is closest to ``target_seconds``.  A 10x outlier clamp
    keeps one slow slab (a first build, a stall) from cratering the
    suggestion.  Thread-safe.
    """

    MIN_CHUNKS = 4
    MAX_CHUNKS = 2048
    #: EWMA weight of the newest slab
    ALPHA = 0.4

    def __init__(self, *, target_seconds: float = 0.5):
        self.target_seconds = target_seconds
        self._per_chunk: dict[str, float] = {}
        self._lock = threading.Lock()

    def record(self, kind: str, units: int, seconds: float) -> None:
        """Feed one measured slab (dispatch -> harvest wall seconds)."""
        if units <= 0 or seconds <= 0:
            return
        per = seconds / units
        with self._lock:
            prev = self._per_chunk.get(kind)
            if prev is not None and per > 10 * prev:
                per = 10 * prev
            self._per_chunk[kind] = per if prev is None else (
                self.ALPHA * per + (1 - self.ALPHA) * prev)
        SLAB_SECONDS.labels(kind=kind).observe(seconds)

    def suggest(self, kind: str, default: int,
                lo: int | None = None, hi: int | None = None,
                groups: int = 1) -> int:
        """Chunk count targeting ``target_seconds`` per slab of
        ``groups`` grid groups, within [lo, hi]."""
        with self._lock:
            per = self._per_chunk.get(kind)
        if per is None or per <= 0:
            return default
        raw = self.target_seconds / (per * max(groups, 1))
        chunks = 1 << max(0, round(math.log2(max(raw, 1.0))))
        chunks = max(lo or self.MIN_CHUNKS, min(hi or self.MAX_CHUNKS, chunks))
        AUTOTUNE_CHUNKS.labels(kind=kind).set(chunks)
        return chunks

    def seconds_per_chunk(self, kind: str) -> float | None:
        """EWMA seconds per grid step (None until first record)."""
        with self._lock:
            return self._per_chunk.get(kind)


#: process-wide autotuner - solve paths share latency knowledge
AUTOTUNER = SlabAutotuner()


def expected_trials(target: int) -> float:
    """Mean trials to beat ``target`` (trial values uniform on u64)."""
    return 2.0 ** 64 / max(target & MASK64, 1)


def _packed_search_ref(ih_words: torch.Tensor, bases: torch.Tensor,
                       targets: torch.Tensor, lanes: int,
                       chunks: int) -> torch.Tensor:
    """Plain torch twin of the reference's ``_packed_search_xla``.

    Each object scans ``chunks`` chunks of ``lanes`` consecutive nonces
    from its base (``lanes`` = the object's per-step share), the ranges
    and winner order of the packed and batch kernels.  Returns int64
    (B, 3) rows ``[hit_step + 1, nonce_hi, nonce_lo]``; like the XLA
    stand-in, a row without a hit holds the object's base nonce after
    its 0 (the kernels write 0 there; no caller reads it).
    """
    rows = torch.zeros((ih_words.shape[0], 3), dtype=torch.int64)
    for b in range(ih_words.shape[0]):
        base = int(bases[b])
        start = base & MASK64
        rows[b] = torch.tensor([0, start >> 32, start & 0xFFFFFFFF])
        for step in range(chunks):
            values, nonces = trial_values(base, ih_words[b], lanes)
            ok = le_u(values, targets[b])
            if bool(ok.any()):
                nonce = int(nonces[torch.argmax(ok.to(torch.int8))]) & MASK64
                rows[b] = torch.tensor([step + 1, nonce >> 32,
                                        nonce & 0xFFFFFFFF])
                break
            base = to_i64(base + lanes)
    return rows.to(ih_words.device)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

#: pack-factor ladder
PACK_CHOICES = (16, 8, 4, 2)
#: chunk budget of one packed launch before autotuning moves it
DEFAULT_PACKED_CHUNKS = 64
#: per-object batch geometry (mirrors sha512_cuda.BATCH_*)
DEFAULT_BATCH_CHUNKS = 64
#: most groups of ``pack`` objects in one packed launch; group counts
#: round up to powers of two
PACKED_GROUPS_MAX = 64
#: a single object expected to finish inside this many full-tile grid
#: steps takes one synchronous launch (dispatch-ahead only adds latency)
SYNC_SINGLE_STEPS = 8


class BatchPlan:
    """Execution plan for one pipelined batch (see :func:`plan_batch`)."""

    __slots__ = ("mode", "pack", "chunks", "order")

    def __init__(self, mode: str, pack: int, chunks: int, order):
        self.mode = mode        # "packed" | "batched" | "single-sync"
        self.pack = pack        # objects per tile (packed mode)
        self.chunks = chunks    # grid steps per launch
        self.order = order      # item indices, difficulty-sorted

    def __repr__(self):  # pragma: no cover - debug aid
        return ("BatchPlan(mode=%r, pack=%d, chunks=%d, n=%d)"
                % (self.mode, self.pack, self.chunks, len(self.order)))


def plan_batch(items, *, rows: int = DEFAULT_ROWS,
               autotuner: SlabAutotuner | None = None) -> BatchPlan:
    """Choose packing and slab geometry from the batch's difficulty.

    Tiny (storm) objects pack up to 16 per tile, network-difficulty
    objects keep whole tiles (the batch kernel), and a single small
    object takes one synchronous launch.  Objects are difficulty-sorted
    so each packed group is homogeneous.
    """
    autotuner = autotuner or AUTOTUNER
    n = len(items)
    exp = [expected_trials(t) for _, t in items]
    tile_step = rows * LANE_COLS        # packed launches run one tile a step
    if n == 1 and exp[0] <= SYNC_SINGLE_STEPS * tile_step:
        chunks = autotuner.suggest("packed", SYNC_SINGLE_STEPS,
                                   lo=4, hi=SYNC_SINGLE_STEPS, groups=1)
        return BatchPlan("single-sync", 1, chunks, [0])
    order = sorted(range(n), key=lambda i: exp[i])
    med = sorted(exp)[n // 2]
    est_groups = _pow2_at_least(-(-n // PACK_CHOICES[0]),
                                PACKED_GROUPS_MAX)
    chunks = autotuner.suggest("packed", DEFAULT_PACKED_CHUNKS,
                               lo=DEFAULT_PACKED_CHUNKS // 2,
                               hi=DEFAULT_PACKED_CHUNKS * 2,
                               groups=est_groups)
    pack = 1
    for p in PACK_CHOICES:
        # the largest pack whose per-object share of one launch still
        # covers the median object's expected work
        if p <= n and med * p <= chunks * tile_step:
            pack = p
            break
    if pack == 1:
        return BatchPlan(
            "batched", 1,
            autotuner.suggest("batch", DEFAULT_BATCH_CHUNKS,
                              lo=DEFAULT_BATCH_CHUNKS // 2,
                              hi=DEFAULT_BATCH_CHUNKS * 2,
                              groups=BATCH_OBJS), order)
    return BatchPlan("packed", pack, chunks, order)


# ---------------------------------------------------------------------------
# dispatch-ahead driver
# ---------------------------------------------------------------------------


def _readback(copy: HostCopy):
    """The default harvest fetch: a failed or poisoned device-to-host
    transfer is the ``pow.readback`` chaos site."""
    inject("pow.readback")
    return copy.result()


class _PipelineDriver:
    """Keep up to ``DEPTH`` slabs in flight, harvesting the oldest while
    newer ones run on the device.

    ``next_launch()`` returns a (tag, in-flight result) pair or None when
    no work remains; ``harvest(tag, host_result)`` consumes one finished
    slab; ``abandon(tag)`` is told of each slab left unread once
    ``done()``; ``fetch`` turns an in-flight result into host arrays (by
    default ``HostCopy.result``: an event wait, never a stream sync,
    behind the ``pow.readback`` chaos site).
    ``last_wait`` is the wait of the slab being harvested.
    """

    #: slabs in flight: one harvested while the next runs
    DEPTH = 2

    def __init__(self, *, should_stop: Callable[[], bool] | None = None,
                 fetch=None, stall_timeout: float = 0.0):
        self.should_stop = should_stop
        self.fetch = fetch or _readback
        #: per-harvest stall deadline (0 disables the guard); a wedged
        #: fetch counts into ``pow_stall_total{site="pow.slab"}`` and
        #: raises the watchdog's SlabStallError out of run()
        self.stall_timeout = stall_timeout
        self._guard_pool = None
        self.wait_seconds = 0.0
        self.last_wait = 0.0
        self.wall_seconds = 0.0
        self.slabs = 0

    def _fetch(self, pending):
        if not self.stall_timeout or self.stall_timeout <= 0:
            return self.fetch(pending)
        if self._guard_pool is None:
            self._guard_pool = cf.ThreadPoolExecutor(
                1, thread_name_prefix="bmtpu-pow-slab-guard")
        fut = self._guard_pool.submit(self.fetch, pending)
        try:
            return fut.result(self.stall_timeout)
        except cf.TimeoutError:
            note_stall("pow.slab", self.stall_timeout)
            logger.error("pow.slab stalled: harvest exceeded %.1fs; "
                         "abandoning the launch", self.stall_timeout)
            # consume whatever the wedged worker eventually produces so
            # its late exception is not reported as never-retrieved
            fut.add_done_callback(lambda f: f.exception())
            self._guard_pool.shutdown(wait=False)
            self._guard_pool = None
            raise SlabStallError("pow.slab exceeded %.1fs stall deadline"
                                 % self.stall_timeout) from None

    def run(self, next_launch, harvest, done=None, abandon=None) -> None:
        inflight: deque = deque()
        t_start = time.monotonic()
        try:
            while True:
                if done is not None and done():
                    # every result is in: what is still in flight is
                    # speculation - abandon it unread
                    if abandon is not None:
                        for tag, _ in inflight:
                            abandon(tag)
                    inflight.clear()
                    break
                if self.should_stop is not None and self.should_stop():
                    # drain what is in flight: a pending slab may hold
                    # the answer the caller checkpoints on
                    while inflight:
                        tag, pending = inflight.popleft()
                        harvest(tag, self._fetch(pending))
                    raise PowInterrupted("pipelined PoW interrupted")
                while len(inflight) < self.DEPTH:
                    nxt = next_launch()
                    if nxt is None:
                        break
                    inflight.append(nxt)
                    self.slabs += 1
                    PIPELINE_DEPTH.set(len(inflight))
                    _flight("slab_launch", n=self.slabs,
                            inflight=len(inflight))
                if not inflight:
                    break
                DISPATCH_AHEAD.observe(len(inflight))
                tag, pending = inflight.popleft()
                t0 = time.monotonic()
                host = self._fetch(pending)
                self.last_wait = time.monotonic() - t0
                self.wait_seconds += self.last_wait
                DEVICE_WAIT.observe(self.last_wait)
                PIPELINE_DEPTH.set(len(inflight))
                _flight("slab_harvest", wait_ms=round(self.last_wait * 1e3, 2),
                        inflight=len(inflight))
                harvest(tag, host)
        finally:
            PIPELINE_DEPTH.set(0)
            if self._guard_pool is not None:
                self._guard_pool.shutdown(wait=False)
                self._guard_pool = None
            self.wall_seconds = max(time.monotonic() - t_start, 1e-9)
            DEVICE_BUSY.set(self.busy_ratio)

    @property
    def busy_ratio(self) -> float:
        """Share of the wall time the host spent waiting on results: a
        lower bound on device occupancy."""
        if self.wall_seconds <= 0:
            return 0.0
        return min(self.wait_seconds / self.wall_seconds, 1.0)


# ---------------------------------------------------------------------------
# the pipelined batch solve
# ---------------------------------------------------------------------------


class _LaunchGroup:
    """Host state for one launch-wide slab group (``width`` objects)."""

    __slots__ = ("idx", "ih_dev", "targets", "bases", "trials", "done",
                 "launches", "width")

    def __init__(self, items, idx, width, device, starts=None):
        pad = width - len(idx)
        ihs = [items[i][0] for i in idx] + [b"\x00" * 64] * pad
        self.ih_dev = upload([words_from_bytes(ih) for ih in ihs], device)
        self.targets = ([items[i][1] & MASK64 for i in idx]
                        + [ALWAYS_HIT] * pad)
        self.idx = list(idx)
        self.width = width
        # resumable PoW: each object starts at its checkpoint offset
        self.bases = ([(starts[i] if starts else 0) & MASK64 for i in idx]
                      + [0] * pad)
        self.trials = [0] * width
        self.done = [i >= len(idx) for i in range(width)]
        self.launches = 0

    @property
    def finished(self) -> bool:
        return all(self.done)

    def live(self) -> int:
        return sum(1 for d in self.done if not d)


def _pow2_at_least(n: int, cap: int) -> int:
    p = 1
    while p < n and p < cap:
        p *= 2
    return min(p, cap)


def solve_batch_pipelined(items, *, rows: int = DEFAULT_ROWS, device=None,
                          plan: BatchPlan | None = None,
                          stats: dict | None = None,
                          should_stop: Callable[[], bool] | None = None,
                          start_nonces=None, progress=None,
                          stall_timeout: float = 0.0):
    """Solve ``[(initial_hash, target), ...]`` through the dispatch-ahead
    pipeline.  Returns ``[(nonce, trials), ...]`` aligned with
    ``items``; raises :class:`PowInterrupted` on shutdown.

    Every returned nonce is the lowest valid one >= the object's start
    and is re-checked with hashlib.  ``stats`` (optional dict) receives
    executed-trials/launch/wall accounting: per-object ``trials`` credit
    only the object's own lanes, ``stats["executed_trials"]`` counts
    pad and straggler work too.  ``start_nonces`` resumes each object
    from a checkpoint; ``progress(i, next)`` gets the end of each slab
    proven miss-free for item ``i``; ``stall_timeout > 0`` bounds each
    harvest's wait.
    """
    n = len(items)
    if n == 0:
        return []
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    if plan is None:
        plan = plan_batch(items, rows=rows)
    PIPELINE_MODE.labels(mode=plan.mode).inc()

    if plan.mode == "single-sync":
        return [_solve_single_sync(
            items[0], rows=rows, chunks=plan.chunks, device=dev,
            should_stop=should_stop,
            start_nonce=(start_nonces[0] if start_nonces else 0),
            progress=(None if progress is None
                      else (lambda nxt: progress(0, nxt))))]

    if plan.mode == "packed":
        pack, unroll = plan.pack, 1
        n_groups = _pow2_at_least(-(-n // pack), PACKED_GROUPS_MAX)
        width = n_groups * pack
        step_trials = (rows // pack) * LANE_COLS
        kind = "packed"
    else:
        # the batch kernel runs BATCH_UNROLL tiles a grid step; the CPU
        # stand-in keeps one, as the reference's XLA stand-in does
        pack, unroll = 1, (BATCH_UNROLL if on_cuda else 1)
        width = BATCH_OBJS
        step_trials = rows * LANE_COLS * unroll
        kind = "batch"
    slab_trials = step_trials * plan.chunks     # per object per launch
    # device-telemetry attribution: the program this plan launches
    tele_prog = "packed_search" if plan.mode == "packed" else "batch_search"

    groups = [_LaunchGroup(items, plan.order[s:s + width], width, dev,
                           starts=start_nonces)
              for s in range(0, n, width)]
    results: list = [None] * n
    executed = {"trials": 0, "launches": 0}

    def search(g: _LaunchGroup) -> HostCopy:
        bases = upload([to_i64(b) for b in g.bases], dev)
        targets = upload([to_i64(t) for t in g.targets], dev)
        if not on_cuda:
            out = _packed_search_ref(g.ih_dev, bases, targets,
                                     lanes=step_trials, chunks=plan.chunks)
        elif plan.mode == "packed":
            out = cuda_packed_search(g.ih_dev, bases, targets, rows=rows,
                                     chunks=plan.chunks, pack=pack,
                                     unroll=unroll)
        else:
            out = cuda_batch_search(g.ih_dev, bases, targets, rows=rows,
                                    chunks=plan.chunks, unroll=unroll)
        return HostCopy(out)

    rr = {"i": 0}
    inflight_groups: set = set()

    def next_launch():
        cand = None
        # round-robin over unfinished groups without an in-flight slab
        for off in range(len(groups)):
            g = groups[(rr["i"] + off) % len(groups)]
            if not g.finished and id(g) not in inflight_groups:
                cand = g
                rr["i"] = (rr["i"] + off + 1) % len(groups)
                break
        if cand is None:
            # speculate one slab ahead on a group that already proved
            # it needs more than one launch
            for g in groups:
                if not g.finished and g.launches >= 1:
                    cand = g
                    break
        if cand is None:
            return None
        if plan.mode == "packed":
            # pack statistics describe lane sharing, which only the
            # packed kernel does
            live = cand.live()
            PACK_SIZE.observe(live)
            PACK_OCCUPANCY.set(live / cand.width)
        t0 = time.monotonic()
        pending = search(cand)
        t1 = time.monotonic()
        inflight_groups.add(id(cand))
        cand.launches += 1
        executed["launches"] += 1
        for k in range(cand.width):
            if not cand.done[k]:
                cand.bases[k] = (cand.bases[k] + slab_trials) & MASK64
        # each object's post-slab offset: the safe resume point once
        # THIS slab harvests miss-free (the live bases may already
        # include speculative launches)
        end_bases = list(cand.bases)
        return ((cand, t0, t1, end_bases), pending)

    def harvest(tag, host):
        g, t0, t1, end_bases = tag
        (out,) = host
        inflight_groups.discard(id(g))
        t_h = time.monotonic()
        AUTOTUNER.record(kind, plan.chunks * (g.width // pack), t_h - t0)
        before = executed["trials"]
        for k in range(g.width):
            if g.done[k]:
                # solved/pad slots still ran one always-hit step
                executed["trials"] += step_trials
                continue
            step1 = int(out[k, 0])
            if step1:
                g.trials[k] += step1 * step_trials
                executed["trials"] += step1 * step_trials
                nonce = (int(out[k, 1]) << 32) | int(out[k, 2])
                check_nonce(nonce, items[g.idx[k]][0], g.targets[k])
                results[g.idx[k]] = (nonce, g.trials[k])
                g.done[k] = True
                # pad semantics: always-hit next launch, then idle
                g.targets[k] = ALWAYS_HIT
            else:
                g.trials[k] += slab_trials
                executed["trials"] += slab_trials
                if progress is not None:
                    progress(g.idx[k], end_bases[k])
        record_launch(tele_prog, key=dev.type, dispatch_seconds=t1 - t0,
                      wait_seconds=driver.last_wait, span=(t0, t_h),
                      items=executed["trials"] - before,
                      bytes_in=16 * g.width, bytes_out=int(out.nbytes))

    def abandon(tag):
        g, t0, t1, _ = tag
        inflight_groups.discard(id(g))
        record_launch(tele_prog, key=dev.type, dispatch_seconds=t1 - t0,
                      bytes_in=16 * g.width)

    driver = _PipelineDriver(should_stop=should_stop,
                             stall_timeout=stall_timeout)
    try:
        driver.run(next_launch, harvest,
                   done=lambda: all(r is not None for r in results),
                   abandon=abandon)
    except PowInterrupted:
        if any(r is None for r in results):
            raise
    if stats is not None:
        stats.update(
            mode=plan.mode, pack=pack, width=width, chunks=plan.chunks,
            launches=executed["launches"],
            executed_trials=executed["trials"],
            credited_trials=sum(r[1] for r in results),
            wall_seconds=driver.wall_seconds,
            device_busy_ratio=driver.busy_ratio)
    return results


def _solve_single_sync(item, *, rows: int, chunks: int,
                       device: torch.device,
                       should_stop: Callable[[], bool] | None,
                       start_nonce: int = 0, progress=None):
    """One object, small synchronous launches of the packed kernel at
    pack 1, no speculative dispatch-ahead (an extra in-flight slab would
    only delay an answer expected inside the first launch)."""
    initial_hash, target = item
    target &= MASK64
    ih_dev = upload([words_from_bytes(initial_hash)], device)
    t_dev = upload([to_i64(target)], device)
    step_trials = rows * LANE_COLS
    slab_trials = step_trials * chunks

    base = start_nonce & MASK64
    trials = 0
    while True:
        if should_stop is not None and should_stop():
            raise PowInterrupted("pipelined PoW interrupted")
        b_dev = upload([to_i64(base)], device)
        t0 = time.monotonic()
        if device.type == "cuda":
            out = cuda_packed_search(ih_dev, b_dev, t_dev, rows=rows,
                                     chunks=chunks, pack=1)
        else:
            out = _packed_search_ref(ih_dev, b_dev, t_dev,
                                     lanes=step_trials, chunks=chunks)
        copy = HostCopy(out)
        t1 = time.monotonic()
        (out,) = _readback(copy)
        t2 = time.monotonic()
        AUTOTUNER.record("packed", chunks, t2 - t0)
        step1 = int(out[0, 0])
        record_launch("packed_search",
                      key=device.type,
                      dispatch_seconds=t1 - t0, wait_seconds=t2 - t1,
                      span=(t0, t2),
                      items=step1 * step_trials if step1 else slab_trials,
                      bytes_in=16, bytes_out=int(out.nbytes))
        if step1:
            trials += step1 * step_trials
            nonce = (int(out[0, 1]) << 32) | int(out[0, 2])
            check_nonce(nonce, initial_hash, target)
            return nonce, trials
        trials += slab_trials
        base = (base + slab_trials) & MASK64
        if progress is not None:
            progress(base)
