"""Coalescing batch dispatcher for receive-side crypto (twin of
``pybitmessage_tpu.crypto.batch``, with one rung).

ECDSA checks and ECIES trial decryptions queue up; whatever accumulated
while the previous drain was in flight, across objects and connections,
becomes the next drain: one executor hop and one backend call per drain
and op.  The backend is ``CudaSecp`` (``crypto/gpu.py``), whose calls
are single kernel launches on the card, or any object speaking its drain
ABI (``backend=``).

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

A drain that raises is logged, counted in ``failed_drains`` and settled
conservatively (verify False, decrypt no-match), as the reference's
drain loop does; there is no lower rung to walk down to.  Drain sizes,
seconds, items and ECDH drain widths go to the JAX engine's metric
families under the rung name ``gpu``; its fallback families have
nothing to count here.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY
from ..resilience.policy import ERRORS
from . import ecies, fallback
from .keys import priv_scalar32, pub_point64
from .signing import _HASHERS, digest_order, note_digest

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

#: the engine's one rung, as its metric label
RUNG = "gpu"

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

    ``device``: where the default backend runs (``None``: the CUDA card,
    raising without one).  ``drain_max`` caps the ECDH pairs of one trial-decrypt drain
    (``cryptodrainmax``).  ``backend`` replaces ``CudaSecp`` (tests pass
    a recording stub).  ``screen`` (optional) records genuinely
    completed no-match sweeps of tagged jobs: ``screen.insert(tag,
    epoch)``; conservative settlements never insert.
    """

    def __init__(self, device=None, *, drain_max: int = 4096,
                 backend=None):
        if backend is None:
            from .gpu import CudaSecp
            backend = CudaSecp(device)
        self.backend = backend
        self.drain_max = drain_max
        self.screen = None
        self.queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._exec: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()
        #: checks settled by the backend, trial-decrypt drains and their
        #: ECDH pairs, and drains settled conservatively after a failure
        self.gpu_items = 0
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
            if self._exec is not None:
                self._exec.shutdown(wait=False, cancel_futures=True)
                self._exec = None

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
        """One drain's work; returns (verify bools, decrypt matches)."""
        t0 = time.monotonic()
        v_res = self._backend_verify(self.backend, verifies)
        tv = time.monotonic()
        d_res = self._backend_decrypt(self.backend, decrypts)
        if verifies:
            BATCH_SECONDS.labels(op="verify").observe(tv - t0)
            BATCH_SIZE.labels(op="verify").observe(len(verifies))
            BATCH_OPS.labels(op="verify", path=RUNG).inc(len(verifies))
        if decrypts:
            BATCH_SECONDS.labels(op="decrypt").observe(
                time.monotonic() - tv)
            BATCH_SIZE.labels(op="ecdh").observe(
                sum(len(j.candidates) for j in decrypts))
            BATCH_OPS.labels(op="decrypt", path=RUNG).inc(len(decrypts))
        RUNG_SECONDS.labels(rung=RUNG).inc(time.monotonic() - t0)
        self._screen_note(decrypts, d_res)
        self.gpu_items += len(verifies) + len(decrypts)
        return v_res, d_res

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
