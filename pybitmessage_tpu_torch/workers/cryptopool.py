"""Signature checks and trial decrypts of the ingest path, off the event
loop (copy of ``pybitmessage_tpu.workers.cryptopool``).

With a :class:`~..crypto.batch.BatchCryptoEngine` attached
(``self.batch``, as the node attaches one), :meth:`verify` and
:meth:`try_decrypt_many` go through it: checks
coalesce across objects into drains, one kernel launch each on the
card.  An attached engine that is not running is an error, never a
quiet turn to host threads.  Only a pool built without an engine (the
caller asked for host crypto) runs the pure-Python checks on a bounded
thread pool, with first-match early-cancel for trial decrypts.
Operations, fan-outs, outcomes and early cancels go to the JAX pool's
metric families.
"""

from __future__ import annotations

import asyncio
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

from ..crypto.ecies import decrypt
from ..crypto.signing import verify
from ..observability import DEFAULT_SIZE_BUCKETS, REGISTRY

#: worker count — crypto is CPU-bound, so more threads than cores only
#: adds contention
POOL_SIZE = max(1, min(8, (os.cpu_count() or 2)))

OPS = REGISTRY.counter(
    "crypto_pool_ops_total",
    "Crypto operations executed through the worker pool",
    ("op",))
DECRYPT_FANOUT = REGISTRY.histogram(
    "crypto_decrypt_fanout_size",
    "Candidate keys fanned out per trial-decrypt call",
    buckets=DEFAULT_SIZE_BUCKETS)
DECRYPT_RESULTS = REGISTRY.counter(
    "crypto_decrypt_total",
    "Trial-decrypt calls by outcome", ("result",))
EARLY_CANCELS = REGISTRY.counter(
    "crypto_decrypt_early_cancel_total",
    "Queued trial-decrypt attempts skipped because another key "
    "already matched (first-match early-cancel)")


class CryptoPool:
    """Bounded thread pool for host work of the ingest path, and the
    route of its crypto checks to the batch engine (``batch``)."""

    def __init__(self, *, batch=None):
        self._exec: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()
        #: worker threads (the health monitor's backlog denominator)
        self.size = POOL_SIZE
        #: the coalescing batch engine; its drain task is started and
        #: stopped by the owning ObjectProcessor
        self.batch = batch
        #: the negative screen (crypto/screen.py) the processor attaches,
        #: probed before any trial-decrypt sweep with an object tag
        self.screen = None
        #: checks that ran on host threads (no engine attached)
        self.host_verifies = 0
        self.host_decrypts = 0

    def _engine(self):
        """The attached engine, or None for a host-crypto pool; raises
        when an engine is attached but not running."""
        if self.batch is None:
            return None
        if not self.batch.running:
            raise RuntimeError("the crypto batch engine is not running")
        return self.batch

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._exec is None:
                self._exec = ThreadPoolExecutor(
                    max_workers=self.size,
                    thread_name_prefix="bmtpu-crypto")
            return self._exec

    def close(self) -> None:
        with self._lock:
            if self._exec is not None:
                self._exec.shutdown(wait=False, cancel_futures=True)
                self._exec = None

    # -- generic off-loop execution ------------------------------------------

    async def run(self, fn, *args):
        """Run ``fn(*args)`` off the event loop."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor(), fn, *args)

    # -- signatures ----------------------------------------------------------

    async def verify(self, data: bytes, signature: bytes,
                     pubkey: bytes) -> bool:
        """One ECDSA verification (never raises for a bad signature)."""
        OPS.labels(op="verify").inc()
        engine = self._engine()
        if engine is not None:
            return await engine.verify(data, signature, pubkey)
        self.host_verifies += 1
        return bool(await self.run(verify, data, signature, pubkey))

    # -- trial decrypt -------------------------------------------------------

    async def try_decrypt_many(self, payload: bytes,
                               keys: Iterable[tuple[bytes, object]],
                               *, tag: bytes | None = None,
                               ) -> list[tuple[bytes, object]]:
        """ECIES trial-decrypt ``payload`` against many candidate keys.

        ``keys``: iterable of ``(privkey_bytes, handle)``; the handle
        rides along so callers can map a hit back to its identity or
        subscription.  Returns the (usually 0- or 1-element) list of
        ``(plaintext, handle)`` matches.

        ``tag`` (the object's inventory hash) opts the sweep into the
        negative screen: a cached no-match for the current keyring epoch
        returns ``[]`` without a single ECDH, and a genuinely completed
        no-match sweep populates it.  The probe runs before ``keys`` is
        materialized, so a screened re-arrival stays O(1) in keyring
        size.
        """
        screen, epoch = self.screen, 0
        if screen is not None and tag is not None:
            # capture the epoch BEFORE probing: a key added after this
            # read voids any no-match proof this sweep could produce
            epoch = screen.epoch
            if screen.check(tag):
                DECRYPT_RESULTS.labels(result="screened").inc()
                return []
        else:
            tag = None          # no screen attached: record nothing
        keys = list(keys)
        if not keys:
            return []
        DECRYPT_FANOUT.observe(len(keys))
        OPS.labels(op="decrypt").inc(len(keys))
        engine = self._engine()
        if engine is not None:
            matches = await engine.try_decrypt(payload, keys, tag=tag,
                                               epoch=epoch)
            DECRYPT_RESULTS.labels(
                result="hit" if matches else "miss").inc()
            return matches
        self.host_decrypts += 1
        found = threading.Event()
        skipped = [0]

        def attempt(priv: bytes):
            if found.is_set():
                skipped[0] += 1
                return None     # another key already matched
            try:
                out = decrypt(payload, priv)
            except ValueError:
                return None     # DecryptionError: a miss, not an error
            found.set()
            return out

        loop = asyncio.get_running_loop()
        ex = self._executor()
        outs = await asyncio.gather(*[loop.run_in_executor(ex, attempt, priv)
                                      for priv, _ in keys])
        matches = [(out, handle) for out, (_, handle) in zip(outs, keys)
                   if out is not None]
        if skipped[0]:
            EARLY_CANCELS.inc(skipped[0])
        if tag is not None and not matches:
            # the sweep tried every key: a genuine no-match proof
            screen.insert(tag, epoch)
        DECRYPT_RESULTS.labels(result="hit" if matches else "miss").inc()
        return matches
