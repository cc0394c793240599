"""Coalescing batch dispatcher for receive-side crypto (twin of
``pybitmessage_tpu.crypto.batch``).

ECDSA checks and ECIES trial decryptions queue up; whatever accumulated
while the previous drain was in flight, across objects and connections,
becomes the next drain: one executor hop per drain and one backend call
per drain and op.  Each drain goes to one of three rungs, routed as the
JAX engine routes it by its effective fan (verify checks plus ECDH
candidate pairs):

1. **gpu** - a drain whose fan is at least ``gpu_batch_min``
   (``cryptotpubatchmin``, 64) runs on the card: ``CudaSecp``
   (``crypto/gpu.py``), single kernel launches, or any object speaking
   its drain ABI (``backend=``).  The ``crypto.tpu`` chaos site sits at
   its launch.  A failure here is a failed drain, logged, counted in
   ``failed_drains`` and settled conservatively (verify False, decrypt
   no-match), as a failed launch is: the card rung never walks down to
   the host, which would hide the kernel.  ``use_gpu=False``
   (``cryptotpu=off``) sends every drain to the host rungs.
2. **native** - smaller drains run in the native library
   (``crypto/native.py``, ``cryptonative``), under the ``crypto.native``
   breaker and chaos site.  A failed native drain re-runs on the pure
   tier, counted in ``crypto_native_fallback_total`` and logged, as in
   the JAX engine (host to host: no device is hidden).  A library that
   cannot be built or fails its self-test raises.
3. **pure** - the per-item Python checks (``crypto/signing.py``,
   ``crypto/ecies.py``) across a small thread pool, when the native rung
   is off, its breaker open or its drain failed.

The two batch rungs share the scalar work:

- **verify** - the s^-1 of a drain's signatures collapse into one
  modular inversion (Montgomery's trick); scalars u1 = e/s and u2 = r/s
  are prepared on the host; digests follow the per-pubkey hint table
  (``crypto/signing.py``): round 1 tries each item's preferred digest,
  only misses re-enter round 2 with the other one.
- **decrypt** - a transposed wavefront: the (still-unmatched objects x
  candidate keys) cross-product is flattened wavefront-major (candidate
  k of every live object before candidate k+1 of any) into drains of up
  to ``drain_max`` ECDH pairs, one backend call each.  Within an object
  the lowest candidate index that passes ECDH -> MAC -> unpad wins;
  matched objects prune their remaining pairs between drains.  AES runs
  only for the real match.

Drain sizes, seconds, items per rung (``crypto_batch_ops_total{path}``,
``crypto_rung_seconds_total{rung}``) and ECDH drain widths go to the JAX
engine's metric families under the rung names ``gpu``, ``native`` and
``pure``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..resilience import CircuitBreaker
from ..resilience.chaos import inject
from ..resilience.policy import ERRORS
from . import ecies, fallback
from .keys import priv_scalar32, pub_point64
from .signing import _HASHERS, digest_order, note_digest
from .signing import verify as pure_verify

logger = logging.getLogger("pybitmessage_tpu_torch.crypto")

BATCH_SIZE = REGISTRY.histogram(
    "crypto_batch_size",
    "Items per coalesced crypto drain (verify: signature checks; "
    "ecdh: candidate scalars across all trial-decrypt objects)",
    ("op",), buckets=DEFAULT_SIZE_BUCKETS)
BATCH_SECONDS = REGISTRY.histogram(
    "crypto_batch_seconds",
    "Wall time of one drain's work per op (native call + scalar prep "
    "+ MAC sweep), excluding coalesce wait — the batch-path analog of "
    "the per-call ingest_stage_seconds decrypt/sig_verify stages",
    ("op",))
BATCH_OPS = REGISTRY.counter(
    "crypto_batch_ops_total",
    "Batched crypto items by op and execution path", ("op", "path"))
RUNG_SECONDS = REGISTRY.counter(
    "crypto_rung_seconds_total",
    "Drain work seconds accumulated per crypto-ladder rung "
    "(tpu/native/pure) — the per-rung half of the costStatus "
    "attribution plane", ("rung",))
NATIVE_FALLBACKS = REGISTRY.counter(
    "crypto_native_fallback_total",
    "Drains whose native batch attempt failed and re-ran on the pure "
    "per-item tier (breaker-counted; no check is lost)")
SHUTDOWN_SETTLED = REGISTRY.counter(
    "crypto_batch_shutdown_settled_total",
    "Checks still pending at engine shutdown, settled deterministically "
    "(verify False / decrypt no-match) instead of leaking "
    "CancelledError into the ingest workers")
DRAIN_WIDTH = REGISTRY.histogram(
    "crypto_ecdh_drain_size",
    "ECDH pairs per transposed trial-decrypt drain (one backend call "
    "each; budget-capped by cryptodrainmax) — the shape that must "
    "clear cryptotpubatchmin for the tpu rung to earn its launch",
    buckets=DEFAULT_SIZE_BUCKETS)

#: the rungs, as their metric labels
RUNGS = ("gpu", "native", "pure")

_N = fallback.N


class _VerifyJob:
    __slots__ = ("data", "sig", "pub", "fut")

    def __init__(self, data, sig, pub, fut):
        self.data, self.sig, self.pub, self.fut = data, sig, pub, fut


class _DecryptJob:
    __slots__ = ("payload", "candidates", "fut", "tag", "epoch")

    def __init__(self, payload, candidates, fut, tag=None, epoch=0):
        self.payload, self.candidates, self.fut = payload, candidates, fut
        #: negative-screen key and the keyring epoch the sweep began
        #: under; tag None = the caller screens nothing
        self.tag, self.epoch = tag, epoch


class BatchCryptoEngine:
    """Coalesces verify / trial-decrypt calls into batch drains.

    ``device``: where the card rung runs (``None``: the CUDA card,
    raising without one; ``"cpu"``: the kernels' plain versions).
    ``backend`` replaces its ``CudaSecp`` (tests pass a recording stub).
    ``use_gpu`` and ``gpu_batch_min`` (``cryptotpu``,
    ``cryptotpubatchmin``) gate the card rung; ``use_native`` and
    ``num_threads`` (``cryptonative``, ``cryptonativethreads``) the
    native one; ``window`` (``cryptobatchwindow``) sleeps after a
    drain's first item to let it grow; ``drain_max`` caps the ECDH pairs
    of one trial-decrypt drain (``cryptodrainmax``).  ``screen``
    (optional) records genuinely completed no-match sweeps of tagged
    jobs: ``screen.insert(tag, epoch)``; conservative settlements never
    insert.
    """

    def __init__(self, device=None, *, drain_max: int = 4096,
                 backend=None, use_gpu: bool = True,
                 gpu_batch_min: int = 64, use_native: bool = True,
                 num_threads: int = 1, window: float = 0.0):
        if backend is None:
            from .gpu import CudaSecp
            backend = CudaSecp(device)
        self.backend = backend
        self.use_gpu = use_gpu
        self.gpu_batch_min = gpu_batch_min
        self.use_native = use_native
        self.num_threads = num_threads
        self.window = window
        self.drain_max = drain_max
        self.screen = None
        self.queue: asyncio.Queue = asyncio.Queue()
        self.breaker = CircuitBreaker("crypto.native", threshold=3,
                                      cooldown=60.0)
        self._native = None
        self._task: asyncio.Task | None = None
        self._exec: ThreadPoolExecutor | None = None
        self._fan: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()
        #: checks settled per rung, the rung of the last drain, each
        #: rung's drains and the least and most fan it took
        self.gpu_items = self.native_items = self.pure_items = 0
        self.last_path: str | None = None
        self.rung_drains = dict.fromkeys(RUNGS, 0)
        self.rung_fans: dict[str, list[int]] = {}
        #: trial-decrypt drains and their ECDH pairs, and drains settled
        #: conservatively after a failure
        self.drains = 0
        self.drain_pairs = 0
        self.failed_drains = 0

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    def start(self) -> asyncio.Task:
        self._task = asyncio.create_task(self._run())
        return self._task

    def native(self):
        """The native rung's library (built and self-tested at first
        use; raises when it cannot be)."""
        if self._native is None:
            from .native import NativeSecp
            self._native = NativeSecp(self.num_threads)
        self._native.num_threads = self.num_threads
        return self._native

    async def load_native(self) -> None:
        """Build and load the native library off the event loop, on the
        drain thread, before the first drain needs it (a no-op with the
        rung off)."""
        if self.use_native:
            await asyncio.get_running_loop().run_in_executor(
                self._executor(), self.native)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # still-queued checks resolve deterministically (verify False,
        # decrypt no-match), never as a CancelledError in their callers
        while not self.queue.empty():
            self._settle(self.queue.get_nowait(), shutdown=True)
        with self._lock:
            for pool in (self._exec, self._fan):
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
            self._exec = self._fan = None

    @staticmethod
    def _settle(job, *, shutdown: bool = False) -> None:
        """Resolve a pending check conservatively (verify False /
        decrypt no-match); settlements at shutdown are counted."""
        if not job.fut.done():
            if shutdown:
                SHUTDOWN_SETTLED.inc()
            job.fut.set_result(False if isinstance(job, _VerifyJob) else [])

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._exec is None:
                self._exec = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="bmtpu-cryptobatch")
            return self._exec

    def _fanout(self) -> ThreadPoolExecutor:
        """The small pool the pure tier fans per-item work across."""
        with self._lock:
            if self._fan is None:
                self._fan = ThreadPoolExecutor(
                    max_workers=max(2, min(8, os.cpu_count() or 2)),
                    thread_name_prefix="bmtpu-cryptofan")
            return self._fan

    def snapshot(self) -> dict:
        """The routing's state: the rung of the last drain, the card
        rung's threshold (None with the card rung off), the items each
        rung settled, and each rung's drains with the least and most fan
        it took (None before its first)."""
        return {"activeRung": self.last_path,
                "batchMin": self.gpu_batch_min if self.use_gpu else None,
                "native": self.use_native,
                "items": {rung: getattr(self, rung + "_items")
                          for rung in RUNGS},
                "rungs": {rung: {"drains": self.rung_drains[rung],
                                 "fan": self.rung_fans.get(rung)}
                          for rung in RUNGS}}

    # -- public API ----------------------------------------------------------

    async def verify(self, data: bytes, signature: bytes,
                     pubkey: bytes) -> bool:
        """One ECDSA acceptance check, coalesced (never raises)."""
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put(_VerifyJob(data, signature, pubkey, fut))
        return await fut

    async def try_decrypt(
            self, payload: bytes,
            candidates: Sequence[tuple[bytes, object]],
            *, tag: bytes | None = None, epoch: int = 0,
    ) -> list[tuple[bytes, object]]:
        """ECIES trial-decrypt one object against ``(privkey, handle)``
        candidates, coalesced with other objects' sweeps.  Returns the
        (0- or 1-element) ``(plaintext, handle)`` match list; the first
        matching candidate wins."""
        candidates = list(candidates)
        if not candidates:
            return []
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put(
            _DecryptJob(payload, candidates, fut, tag, epoch))
        return await fut

    # -- drain loop ----------------------------------------------------------

    async def _run(self) -> None:
        while True:
            batch: list = []
            try:
                batch.append(await self.queue.get())
                if self.window > 0:
                    await asyncio.sleep(self.window)
                while not self.queue.empty():
                    batch.append(self.queue.get_nowait())
                verifies = [j for j in batch if isinstance(j, _VerifyJob)]
                decrypts = [j for j in batch if isinstance(j, _DecryptJob)]
                loop = asyncio.get_running_loop()
                v_res, d_res = await loop.run_in_executor(
                    self._executor(), self._execute, verifies, decrypts)
                for job, ok in zip(verifies, v_res):
                    if not job.fut.done():
                        job.fut.set_result(ok)
                for job, matches in zip(decrypts, d_res):
                    if not job.fut.done():
                        job.fut.set_result(matches)
            except asyncio.CancelledError:
                for job in batch:
                    self._settle(job, shutdown=True)
                raise
            except Exception:
                # a drain must never wedge its callers: settle the whole
                # batch conservatively, count it, and keep draining
                self.failed_drains += 1
                ERRORS.labels(site="crypto.batch").inc()
                logger.exception("crypto batch drain failed; batch "
                                 "settled unverified/no-match")
                for job in batch:
                    self._settle(job)

    # -- execution (worker thread) -------------------------------------------

    def _execute(self, verifies, decrypts):
        """One drain's work on its rung; returns (verify bools, decrypt
        matches).  A card-rung failure propagates (a failed drain); a
        native failure re-runs the drain on the pure tier."""
        fan = len(verifies) + sum(len(j.candidates) for j in decrypts)
        if self.use_gpu and fan >= self.gpu_batch_min:
            try:
                inject("crypto.tpu")
                return self._run_rung("gpu", self.backend, verifies,
                                      decrypts, fan)
            except Exception:
                ERRORS.labels(site="crypto.tpu").inc()
                raise
        if self.use_native and self.breaker.allow():
            native = self.native()
            try:
                inject("crypto.native")
                out = self._run_rung("native", native, verifies,
                                     decrypts, fan)
                self.breaker.record_success()
                return out
            except Exception:
                self.breaker.record_failure()
                ERRORS.labels(site="crypto.native").inc()
                NATIVE_FALLBACKS.inc()
                logger.exception("native crypto batch failed; re-running "
                                 "the drain on the pure per-item tier")
        return self._run_rung("pure", None, verifies, decrypts, fan)

    def _run_rung(self, rung: str, backend, verifies, decrypts, fan: int):
        """The drain on ``backend`` (None: the pure tier), counted under
        ``rung``."""
        t0 = time.monotonic()
        if backend is None:             # the pure tier
            v_res = self._map(lambda j: pure_verify(j.data, j.sig, j.pub),
                              verifies)
            tv = time.monotonic()
            d_res = self._map(self._pure_sweep, decrypts)
        else:
            v_res = self._backend_verify(backend, verifies)
            tv = time.monotonic()
            d_res = self._backend_decrypt(backend, decrypts)
        if verifies:
            BATCH_SECONDS.labels(op="verify").observe(tv - t0)
            BATCH_SIZE.labels(op="verify").observe(len(verifies))
            BATCH_OPS.labels(op="verify", path=rung).inc(len(verifies))
        if decrypts:
            BATCH_SECONDS.labels(op="decrypt").observe(
                time.monotonic() - tv)
            BATCH_SIZE.labels(op="ecdh").observe(
                sum(len(j.candidates) for j in decrypts))
            BATCH_OPS.labels(op="decrypt", path=rung).inc(len(decrypts))
        RUNG_SECONDS.labels(rung=rung).inc(time.monotonic() - t0)
        self._screen_note(decrypts, d_res)
        setattr(self, rung + "_items", getattr(self, rung + "_items")
                + len(verifies) + len(decrypts))
        self.rung_drains[rung] += 1
        lo_hi = self.rung_fans.setdefault(rung, [fan, fan])
        lo_hi[0], lo_hi[1] = min(lo_hi[0], fan), max(lo_hi[1], fan)
        self.last_path = rung
        return v_res, d_res

    def _map(self, fn, items) -> list:
        """``fn`` over items on the pure tier's pool, in order."""
        if len(items) <= 1:
            return [fn(item) for item in items]
        return list(self._fanout().map(fn, items))

    @staticmethod
    def _pure_sweep(job) -> list:
        """One object's trial decrypt on the pure tier: the first
        candidate whose ECDH passes the MAC and unpads wins."""
        try:
            pp = ecies.parse_payload(job.payload)
        except ValueError:
            return []
        for priv, handle in job.candidates:
            try:
                key_e, key_m = ecies.kdf(
                    fallback.ecdh_x(priv, pp.ephem_pub))
                if not ecies.mac_ok(key_m, pp.macdata, pp.tag):
                    continue
                return [(ecies.finish_decrypt(key_e, pp), handle)]
            except ValueError:
                continue            # bad key or point: a miss
        return []

    def _screen_note(self, decrypts, d_res) -> None:
        """Record genuinely completed no-match sweeps in the negative
        screen (never from a conservative settlement)."""
        screen = self.screen
        if screen is None:
            return
        for job, matches in zip(decrypts, d_res):
            if job.tag is not None and not matches:
                screen.insert(job.tag, job.epoch)

    @staticmethod
    def _prep_sigs(verifies):
        """Digest-independent parse of every signature in the drain: per
        item (point64, r, s_inv) or None.  The s-inversions mod n
        collapse into ONE ``pow(-1)`` via the Montgomery product trick."""
        parsed: list = []
        for job in verifies:
            try:
                point = pub_point64(job.pub)
                r, s = fallback.der_decode_sig(job.sig)
            except ValueError:
                parsed.append(None)
                continue
            if not (0 < r < _N and 0 < s < _N):
                parsed.append(None)
                continue
            parsed.append((point, r, s))
        prefix, acc = [], 1
        for item in parsed:
            if item is None:
                continue
            prefix.append(acc)
            acc = (acc * item[2]) % _N
        if not prefix:
            return parsed
        inv = pow(acc, -1, _N)
        out: list = [None] * len(parsed)
        k = len(prefix) - 1
        for i in range(len(parsed) - 1, -1, -1):
            if parsed[i] is None:
                continue
            point, r, s = parsed[i]
            out[i] = (point, r, (inv * prefix[k]) % _N)
            inv = (inv * s) % _N
            k -= 1
        return out

    def _backend_verify(self, backend, verifies) -> list[bool]:
        """Batch ECDSA with hinted-digest rounds: round 1 tries each
        item's preferred digest; only misses re-enter round 2 with the
        alternate."""
        results = [False] * len(verifies)
        if not verifies:
            return results
        prepped = self._prep_sigs(verifies)
        orders = [digest_order(j.pub) for j in verifies]
        #: (item index, digest) still to attempt, per round
        live = [(i, 0) for i in range(len(verifies))
                if prepped[i] is not None]
        while live:
            u1s, u2s, pubs, rs, idx = [], [], [], [], []
            for i, d_i in live:
                point, r, s_inv = prepped[i]
                e = fallback.digest_to_scalar(
                    _HASHERS[orders[i][d_i]](verifies[i].data).digest())
                u1s.append(((e * s_inv) % _N).to_bytes(32, "big"))
                u2s.append(((r * s_inv) % _N).to_bytes(32, "big"))
                pubs.append(point)
                rs.append(r.to_bytes(32, "big"))
                idx.append((i, d_i))
            ok = backend.verify_prepared(
                len(idx), b"".join(u1s), b"".join(u2s), b"".join(pubs),
                b"".join(rs))
            nxt = []
            for (i, d_i), hit in zip(idx, ok):
                if hit:
                    results[i] = True
                    note_digest(verifies[i].pub, orders[i][d_i],
                                fallback=d_i > 0)
                elif d_i + 1 < len(orders[i]):
                    nxt.append((i, d_i + 1))
            live = nxt
        return results

    def _backend_decrypt(self, backend, decrypts):
        """Transposed wavefront trial decryption: drains of up to
        ``drain_max`` (object, candidate) pairs, planned wavefront-major
        over the live objects, one backend call each; settlement walks a
        drain in plan order so the lowest matching candidate index of an
        object wins; matched objects prune their remaining pairs."""
        results: list[list] = [[] for _ in decrypts]
        parsed: list = [None] * len(decrypts)
        #: next candidate index per object
        cursor = [0] * len(decrypts)
        live = []
        for i, job in enumerate(decrypts):
            try:
                parsed[i] = ecies.parse_payload(job.payload)
            except ValueError:
                continue
            live.append(i)
        drain_max = max(1, self.drain_max)
        while live:
            # plan one budget-capped drain: wavefront-major passes over
            # the live objects, one candidate each per pass
            pairs: list[tuple[int, int]] = []
            while len(pairs) < drain_max:
                progressed = False
                for i in live:
                    if len(pairs) >= drain_max:
                        break
                    if cursor[i] < len(decrypts[i].candidates):
                        pairs.append((i, cursor[i]))
                        cursor[i] += 1
                        progressed = True
                if not progressed:
                    break
            points, scalars, idx = [], [], []
            for i, j in pairs:
                priv, _handle = decrypts[i].candidates[j]
                try:
                    scalar = priv_scalar32(priv)
                except ValueError:
                    continue            # invalid key: a miss
                points.append(parsed[i].ephem_pub[1:])
                scalars.append(scalar)
                idx.append((i, j))
            if idx:
                DRAIN_WIDTH.observe(len(idx))
                self.drains += 1
                self.drain_pairs += len(idx)
                xs = backend.ecdh_batch(len(idx), b"".join(points),
                                        b"".join(scalars))
            else:
                xs = []
            for (i, j), x in zip(idx, xs):
                if x is None or results[i]:
                    continue            # bad point / already matched
                pp = parsed[i]
                key_e, key_m = ecies.kdf(x)
                if not ecies.mac_ok(key_m, pp.macdata, pp.tag):
                    continue
                try:
                    plain = ecies.finish_decrypt(key_e, pp)
                except ValueError:
                    continue            # MAC-approved but unpaddable
                results[i].append((plain, decrypts[i].candidates[j][1]))
            live = [i for i in live if not results[i]
                    and cursor[i] < len(decrypts[i].candidates)]
        return results
