"""PoW solver of the port (twin of ``pow/dispatcher.py``): the farm rung
over the card tier.

On one device a single object runs :func:`ops.sha512_cuda.solve` (the
single-object kernel) and a batch runs the dispatch-ahead pipeline
(packed or batch kernel).  With more than one device (``_devices()``:
every card when the dispatcher's device is CUDA) the multi-device tier
takes over, as the JAX dispatcher routes: a single object runs
:func:`parallel.pallas_sharded_solve` (kernel 1 on every shard, backend
``cuda-sharded``), a batch of more than one object
:func:`parallel.pallas_sharded_solve_batch` (kernel 2 on an
(obj x nonce) mesh, ``cuda-sharded-batch``), and one object skips the
pipeline's single-sync path.  Meshes are built once per (device
count, object rows) shape, counted in ``pow_mesh_compiles_total``.  With
``device="cpu"`` the same host loops run the kernels' plain torch
versions (``torch``, ``torch-sharded``, ``torch-sharded-batch``).

An attached :class:`~pybitmessage_tpu_torch.powfarm.FarmSolverTier`
(``attach_farm``, the daemon's ``powfarmconnect``) leads: jobs are
delegated to a shared solver farm, and ANY farm failure (dial, admission
reject, expired deadline, a nonce failing the host check) opens the
farm's breaker, counts ``pow_fallback_total{from="farm",to="cuda"}``
(``"torch"`` on the CPU) and re-solves the batch on the card: an
unreachable farm degrades to exactly the node without one.

The card tier has no rung under it: without a card ``PowDispatcher()``
raises, and a kernel that fails to build or launch raises out of
:meth:`solve` / :meth:`solve_batch`, where ``PowService`` requeues the
batch and finally surfaces the error.  A card failure never falls
through to the native rung.

``PowDispatcher(use_card=False)`` is the JAX dispatcher's
``use_tpu=False`` mode: the caller turns the card tier off and the
native C++ solver (:class:`~.native.NativeSolver`, ``num_threads``
threads, built from ``native/pow/bitmsgpow.cpp`` at construction) is
the first tier under the farm, one object after another, behind the
JAX ``"cpp"`` breaker (3 failures, 60 s cooldown).  It needs no card and
launches no kernel; a failed build or self-test raises from the
constructor, and a failed solve raises like the card's.  The
multi-device tier has no rung under it either: a kernel failure in any
shard raises to ``PowService``, where the JAX dispatcher falls to its
XLA sharded tier.
``pow.device_launch`` is a chaos site at the entry of the card tier;
``stall_timeout`` (the daemon's ``powstalltimeout``) is the pipeline's
per-harvest stall deadline.  A stalled harvest raises the watchdog's
``SlabStallError`` out of the call; once the work ``PowService``
requeued completes, the dispatcher observes the time since the stall in
``pow_stall_recovery_seconds``, as the JAX dispatcher does.

Timing attributes:

``last_rate``
    trials/s over the wall time of the last call, host re-check
    included - what a caller experiences.
``last_solve_seconds`` / ``last_solve_rate``
    solve-only time and trials/s.
``last_verify_seconds``
    host double-SHA512 re-check of the last single solve's nonce.

Each call runs in a ``pow.solve`` / ``pow.solve_batch`` span and feeds
the JAX dispatcher's attempt, latency, host-verify, trial, fallback and
mesh families.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable

import logging

import torch

from .. import parallel, resolve_device
from ..observability import REGISTRY, trace
from ..observability.flightrec import record as _flight
from ..ops import sha512_cuda
from ..ops.pow_search import PowInterrupted
from ..resilience.chaos import inject
from ..resilience.policy import ERRORS, CircuitBreaker
from ..resilience.watchdog import STALL_RECOVERY_SECONDS, SlabStallError
from .pipeline import AUTOTUNER, plan_batch, solve_batch_pipelined

logger = logging.getLogger("pybitmessage_tpu_torch.pow")

#: default slab-stall deadline handed to the pipeline, seconds per
#: harvest; 0 disables the guard
DEFAULT_STALL_TIMEOUT = 120.0

SOLVE_SECONDS = REGISTRY.histogram(
    "pow_solve_seconds",
    "Solve-only latency of one PoW launch (single object or fused "
    "batch), excluding the dispatcher's host verification",
    ("backend",))
HOST_VERIFY_SECONDS = REGISTRY.histogram(
    "pow_host_verify_seconds",
    "Host-side double-SHA512 re-check of a winning nonce")
ATTEMPTS = REGISTRY.counter(
    "pow_attempts_total", "Solve attempts entering each ladder tier",
    ("backend",))
FALLBACKS = REGISTRY.counter(
    "pow_fallback_total",
    "Ladder fallthrough events (a tier failed and a slower one took "
    "over)", ("from", "to"))
TRIALS = REGISTRY.counter(
    "pow_trials_total", "Double-SHA512 trial hashes executed",
    ("backend",))
MESH_COMPILES = REGISTRY.counter(
    "pow_mesh_compiles_total",
    "Device mesh constructions, one per distinct (ndev, obj) shape",
    ("shape",))


def host_trial(nonce: int, initial_hash: bytes) -> int:
    """One double-SHA512 trial value - THE PoW formula."""
    sha512 = hashlib.sha512
    return int.from_bytes(sha512(sha512(
        nonce.to_bytes(8, "big") + initial_hash).digest()
    ).digest()[:8], "big")


def python_solve(initial_hash: bytes, target: int, *,
                 start_nonce: int = 0,
                 should_stop: Callable[[], bool] | None = None,
                 progress: Callable[[int], None] | None = None):
    """hashlib search, one nonce at a time: the lowest nonce >=
    ``start_nonce`` whose trial value is <= ``target``.  ``progress``
    gets a checkpoint every 4096 trials."""
    nonce = start_nonce
    trials = 0
    sha512 = hashlib.sha512
    while True:
        if should_stop is not None and trials % 4096 == 0 and should_stop():
            raise PowInterrupted("python PoW interrupted")
        if progress is not None and trials % 4096 == 0 and trials:
            progress(nonce)
        value = int.from_bytes(sha512(sha512(
            nonce.to_bytes(8, "big") + initial_hash).digest()
        ).digest()[:8], "big")
        trials += 1
        if value <= target:
            return nonce, trials
        nonce += 1


def _note_fallback(frm: str, to: str) -> None:
    """One fallthrough: counted and flight-recorded."""
    FALLBACKS.labels(**{"from": frm, "to": to}).inc()
    _flight("pow_fallback", frm=frm, to=to)


class PowDispatcher:
    """Callable solver for one device (``None`` = the CUDA device), or
    with ``use_card=False`` for the native C++ solver on the host."""

    def __init__(self, device=None, *,
                 stall_timeout: float = DEFAULT_STALL_TIMEOUT, farm=None,
                 use_card: bool = True, num_threads: int = 0):
        #: the card tier's device; None in the native mode
        self.device = resolve_device(device) if use_card else None
        #: the native rung of the card-off mode
        self.native = None
        self.breakers: dict[str, CircuitBreaker] = {}
        if not use_card:
            from .native import NativeSolver
            self.native = NativeSolver(num_threads)
            self.breakers["cpp"] = CircuitBreaker(
                "pow.tier.cpp", threshold=3, cooldown=60.0)
        #: per-harvest slab stall deadline for the pipelined path
        self.stall_timeout = stall_timeout
        #: optional FarmSolverTier leading the card tier (attach_farm)
        self.farm = farm
        self.last_backend = ""
        self.last_rate = 0.0
        self.last_solve_seconds = 0.0
        self.last_solve_rate = 0.0
        self.last_verify_seconds = 0.0
        #: monotonic time of the last slab stall; the recovery is
        #: observed when the next call completes
        self._stalled_at: float | None = None
        #: shard meshes by (device count, object rows)
        self._meshes: dict = {}

    # -- device topology -----------------------------------------------------

    def _devices(self) -> list[torch.device]:
        """The devices the card tier spreads over: every card when the
        dispatcher's device is CUDA, else the device alone."""
        if self.device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [self.device]

    def _mesh(self, ndev: int, batch: int):
        """(obj x nonce) mesh of the first ``ndev`` devices for ``batch``
        objects, 1D for one object: the JAX rule, object rows the
        largest divisor of ``ndev`` not above ``min(ndev, batch)``."""
        obj_size = 1
        if batch > 1:
            for d in range(min(ndev, batch), 0, -1):
                if ndev % d == 0:
                    obj_size = d
                    break
        key = (ndev, obj_size)
        if key not in self._meshes:
            MESH_COMPILES.labels(shape="%dx%d" % key).inc()
            devices = self._devices()
            if obj_size == 1:
                self._meshes[key] = parallel.make_mesh(ndev, devices=devices)
            else:
                self._meshes[key] = parallel.make_mesh(
                    ndev, obj_axis="obj", obj_size=obj_size, devices=devices)
        return self._meshes[key]

    def _record_recovery(self) -> None:
        """A solve completed after a slab stall: how long the rescued
        work took to land."""
        if self._stalled_at is not None:
            STALL_RECOVERY_SECONDS.observe(
                time.monotonic() - self._stalled_at)
            self._stalled_at = None

    @property
    def _backend(self) -> str:
        if self.native is not None:
            return "cpp"
        return "cuda" if self.device.type == "cuda" else "torch"

    def attach_farm(self, farm) -> None:
        """Register a FarmSolverTier as the top rung."""
        self.farm = farm

    def _try_farm(self, items, should_stop, starts):
        """The farm rung; ``None`` means the card solves the batch (the
        jobs the farm accepted are re-solved here, and the farm's
        dedupe makes any overlap benign)."""
        farm = self.farm
        if farm is None or not farm.breaker.allow():
            return None
        try:
            self.last_backend = "farm"
            ATTEMPTS.labels(backend="farm").inc()
            results = farm.solve_batch(items, should_stop=should_stop,
                                       start_nonces=starts)
            farm.breaker.record_success()
            return results
        except PowInterrupted:
            farm.breaker.release_probe()
            raise
        except Exception as exc:
            farm.breaker.record_failure()
            ERRORS.labels(site="pow.tier.farm").inc()
            logger.warning(
                "farm tier failed (%r); solving %d job(s) on the %s "
                "tier (breaker: %s)", exc, len(items), self._backend,
                farm.breaker.state)
            _note_fallback("farm", self._backend)
            return None

    def backends(self) -> list[str]:
        """The tiers this solver runs (clientStatus powBackends): the
        farm while its breaker lets jobs through, then the card (the
        native rung while its breaker does)."""
        out = []
        if self.farm is not None and self.farm.breaker.available():
            out.append("farm")
        if self.native is None or self.breakers["cpp"].available():
            out.append(self._backend)
        return out

    def __call__(self, initial_hash: bytes, target: int, *,
                 start_nonce: int = 0,
                 should_stop: Callable[[], bool] | None = None):
        with trace("pow.solve") as span:
            t0 = time.monotonic()
            farmed = self._try_farm([(initial_hash, target)], should_stop,
                                    [start_nonce])
            if farmed is not None:
                nonce, trials = farmed[0]
            else:
                nonce, trials = self._solve(initial_hash, target,
                                            start_nonce, should_stop)
            solve_dt = max(time.monotonic() - t0, 1e-9)
            v0 = time.monotonic()
            value = host_trial(nonce, initial_hash)
            verify_dt = time.monotonic() - v0
            if value > target:
                raise ArithmeticError(
                    "backend %s returned a nonce failing host "
                    "verification" % self.last_backend)
            span.attrs["backend"] = self.last_backend
            span.attrs["trials"] = trials
        self.last_solve_seconds = solve_dt
        self.last_solve_rate = trials / solve_dt
        self.last_verify_seconds = verify_dt
        self.last_rate = trials / (solve_dt + verify_dt)
        SOLVE_SECONDS.labels(backend=self.last_backend).observe(solve_dt)
        HOST_VERIFY_SECONDS.observe(verify_dt)
        TRIALS.labels(backend=self.last_backend).inc(trials)
        self._record_recovery()
        return nonce, trials

    # keep the explicit name too
    solve = __call__

    def solve_batch(self, items, *, should_stop=None, start_nonces=None,
                    progress=None):
        """Solve ``[(initial_hash, target), ...]`` -> ``[(nonce, trials)]``.

        On one device, more than one object, or one object small enough
        for a single synchronous launch, goes through the pipeline; on
        several, more than one object goes to the sharded batch tier.
        Otherwise the object takes the single-object route.
        ``start_nonces`` resumes
        each object from a checkpoint; ``progress(i, next)`` reports
        the highest offset known fully searched for item ``i``.
        """
        items = list(items)
        if not items:
            return []
        starts = list(start_nonces) if start_nonces else [0] * len(items)
        t0 = time.monotonic()
        with trace("pow.solve_batch", objects=len(items)) as span:
            # the farm rung leads; a farm failure falls through to the
            # card with nothing lost
            results = self._try_farm(items, should_stop, starts)
            if results is None:
                results = self._card_batch(items, should_stop, starts,
                                           progress)
            span.attrs["backend"] = self.last_backend
        dt = max(time.monotonic() - t0, 1e-9)
        trials = sum(r[1] for r in results)
        self.last_solve_seconds = dt
        self.last_solve_rate = trials / dt
        self.last_rate = trials / dt
        SOLVE_SECONDS.labels(backend=self.last_backend).observe(dt)
        TRIALS.labels(backend=self.last_backend).inc(trials)
        self._record_recovery()
        return results

    def _card_batch(self, items, should_stop, starts, progress):
        if self.native is not None:
            # one object after another, as the JAX ladder's native tier
            return [self._solve(ih, t, start, should_stop)
                    for (ih, t), start in zip(items, starts)]
        ndev = len(self._devices())
        if ndev > 1 and len(items) > 1:
            inject("pow.device_launch")
            self.last_backend = self._backend + "-sharded-batch"
            ATTEMPTS.labels(backend=self.last_backend).inc()
            return parallel.pallas_sharded_solve_batch(
                items, self._mesh(ndev, len(items)), should_stop=should_stop,
                start_nonces=starts, progress=progress)
        # one object on several devices takes the sharded single route
        if ndev == 1 and (len(items) > 1
                          or plan_batch(items).mode == "single-sync"):
            inject("pow.device_launch")
            self.last_backend = self._backend + "-batch"
            ATTEMPTS.labels(backend=self.last_backend).inc()
            try:
                return solve_batch_pipelined(
                    items, device=self.device, should_stop=should_stop,
                    start_nonces=starts, progress=progress,
                    stall_timeout=self.stall_timeout)
            except SlabStallError:
                if self._stalled_at is None:
                    self._stalled_at = time.monotonic()
                raise
        prog = None
        if progress is not None:
            prog = lambda n: progress(0, n)  # noqa: E731
        (ih, t), = items
        return [self._solve(ih, t, starts[0], should_stop, progress=prog)]

    def _solve(self, initial_hash, target, start_nonce, should_stop,
               progress=None):
        if self.native is not None:
            return self._native_solve(initial_hash, target, start_nonce,
                                      should_stop)
        inject("pow.device_launch")
        ndev = len(self._devices())
        if ndev > 1:
            self.last_backend = self._backend + "-sharded"
            ATTEMPTS.labels(backend=self.last_backend).inc()
            return parallel.pallas_sharded_solve(
                initial_hash, target, self._mesh(ndev, 1),
                start_nonce=start_nonce, should_stop=should_stop,
                progress=progress)
        self.last_backend = self._backend
        ATTEMPTS.labels(backend=self.last_backend).inc()
        return sha512_cuda.solve(
            initial_hash, target, start_nonce=start_nonce,
            should_stop=should_stop, tuner=AUTOTUNER, progress=progress,
            device=self.device)

    def _native_solve(self, initial_hash, target, start_nonce, should_stop):
        """The native rung behind its breaker; a failure raises."""
        cb = self.breakers["cpp"]
        if not cb.allow():
            raise RuntimeError("native PoW tier open after repeated "
                               "failures (breaker %s)" % cb.state)
        self.last_backend = "cpp"
        ATTEMPTS.labels(backend="cpp").inc()
        try:
            result = self.native.solve(initial_hash, target,
                                       start_nonce=start_nonce,
                                       should_stop=should_stop)
        except PowInterrupted:
            cb.release_probe()
            raise
        except Exception:
            cb.record_failure()
            ERRORS.labels(site="pow.tier.cpp").inc()
            raise
        cb.record_success()
        return result
