"""The ``role=client`` rung: a node that stores and forwards nothing
(twin of ``pybitmessage_tpu.roles.client``).

A light client keeps no inventory, opens no relay links and puts no
keyring on any edge: it connects to ONE edge's subscription plane
(``roles/subscription.py``), SUBSCRIBEs to the digest buckets its own
addresses hash into, and receives full payloads only for objects landing
in those buckets.  Relevance is decided locally: trial-decrypt runs on
the client's own keyring through its own ``BatchCryptoEngine`` (the
ECDH kernel on the card), and an engine that is not running is an error,
never a host fallback.  PoW is delegated through the edge to its farm
under the client's own tenant (:meth:`LightClient.delegate_pow`).

Convergence is digest-driven, so it survives drops without the edge
remembering anything: on every (re)connect the client re-SUBSCRIBEs its
full state and FETCHes its buckets; afterwards DIGEST_DELTA pushes are
compared against the client's local digest and any mismatched bucket is
re-FETCHed.  A SUB_ACK or DIGEST_DELTA carrying a different bucket count
makes the client re-derive its ids under the edge's count (bucket ids
are a pure function of (address tag, bucket count)).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from collections import OrderedDict

from ..models.constants import OBJECT_BROADCAST, OBJECT_MSG
from ..observability import REGISTRY
from ..resilience import inject
from ..resilience.policy import ERRORS
from ..sync.digest import DIGEST_BUCKETS, InventoryDigest, bucket_of
from . import subscription as wire

logger = logging.getLogger("pybitmessage_tpu_torch.roles")

RECONNECT_MIN = 0.2
RECONNECT_MAX = 5.0
#: bounded local object store (the client is not an inventory)
CLIENT_STORE_MAX = 1 << 16

OBJECTS = REGISTRY.counter(
    "light_client_objects_total",
    "Objects a light client received, by path", ("path",))
RECONNECTS = REGISTRY.counter(
    "light_client_reconnects_total",
    "Light-client reconnect attempts to the edge plane")
DECRYPTS = REGISTRY.counter(
    "light_client_decrypt_total",
    "Client-side trial-decrypt outcomes (the ECDH that no longer "
    "runs on the edge)", ("result",))
REBUCKETS = REGISTRY.counter(
    "light_client_rebuckets_total",
    "Bucket-count reassignments adopted from the edge")


def buckets_for_tags(tags, count: int = DIGEST_BUCKETS) -> tuple[int, ...]:
    """The bucket ids a client with these address tags subscribes to —
    a pure function of (tag, bucket count), recomputable under any
    count the edge announces."""
    return tuple(sorted({bucket_of(bytes(t), count) for t in tags}))


class LightClient:
    """One light client endpoint: reconnecting subscription session,
    local digest mirror, bounded object store, optional client-side
    trial-decrypt, and PoW delegation futures."""

    def __init__(self, connect: str, *, client_id: str,
                 tenant: str | None = None,
                 tags=(), extra_buckets=(), streams=(1,),
                 buckets: int = DIGEST_BUCKETS,
                 crypto=None, identities=(), subscriptions=()):
        host, _, port = str(connect).rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.client_id = client_id
        self.tenant = tenant or client_id
        #: address-derived tags relevance is predicted from
        self.tags = [bytes(t) for t in tags]
        #: explicit extra bucket ids (msg-coverage slices — msgs carry
        #: no tag, so clients wanting them subscribe bucket ranges)
        self.extra_buckets = tuple(extra_buckets)
        self.streams = tuple(streams)
        self.bucket_count = buckets
        self.crypto = crypto
        self.identities = list(identities)
        self.subscriptions = list(subscriptions)
        #: local digest mirror, bucketed like the edge's plane digest
        self.digest = InventoryDigest(buckets=buckets)
        #: hash -> (type, stream, expires, tag, payload), bounded
        self.objects: "OrderedDict[bytes, tuple]" = OrderedDict()
        self.decrypted: list[tuple[bytes, object, bytes]] = []
        self.epoch = 0
        self.accepted_buckets = 0
        self.synced = asyncio.Event()
        self._writer: asyncio.StreamWriter | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._refilter_task: asyncio.Task | None = None
        self._run_task: asyncio.Task | None = None
        self._send_lock = asyncio.Lock()
        self._job_refs = itertools.count(1)
        self._pow_futures: dict[int, asyncio.Future] = {}
        self._decrypt_tasks: set[asyncio.Task] = set()
        self.connects = 0
        self.pushes = 0
        self.fetch_repairs = 0

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._run_task = asyncio.create_task(self._run())

    def set_keys(self, identities=(), subscriptions=()) -> None:
        """Adopt the node's keyring: subscription and identity tags
        drive the bucket filter, the key objects arm trial-decrypt.
        Safe from any thread (KeyStore change listeners fire on the
        mutating thread); a live link re-subscribes and fetches what
        the newly covered buckets already hold."""
        self.identities = list(identities)
        self.subscriptions = list(subscriptions)
        tags = [bytes(s.tag) for s in self.subscriptions]
        tags += [bytes(i.tag) for i in self.identities]
        changed = set(tags) != set(self.tags)
        self.tags = tags
        if not changed or self._loop is None:
            return

        def _spawn() -> None:
            if self._writer is None:
                return      # the reconnect loop subscribes fresh tags
            if self._refilter_task is not None \
                    and not self._refilter_task.done():
                self._refilter_task.cancel()
            self._refilter_task = asyncio.create_task(self._refilter())
        self._loop.call_soon_threadsafe(_spawn)

    async def _refilter(self) -> None:
        try:
            await self._subscribe()
            await self._fetch_all()
        except (ConnectionError, OSError):
            pass    # link dropped; reconnect re-subscribes fresh tags

    async def stop(self) -> None:
        if self._refilter_task is not None:
            self._refilter_task.cancel()
        if self._run_task is not None:
            self._run_task.cancel()
            try:
                await self._run_task
            except asyncio.CancelledError:
                pass
        for task in list(self._decrypt_tasks):
            task.cancel()
        if self._decrypt_tasks:
            await asyncio.gather(*self._decrypt_tasks,
                                 return_exceptions=True)
        for fut in self._pow_futures.values():
            if not fut.done():
                fut.cancelled() or fut.set_exception(
                    ConnectionError("light client stopped"))
        self._pow_futures.clear()
        if self._writer is not None:
            try:
                self._writer.close()
            except OSError:
                pass    # already torn down

    async def _run(self) -> None:
        backoff = RECONNECT_MIN
        while True:
            try:
                reader, writer = await asyncio.open_connection(
                    self.host, self.port)
            except OSError:
                RECONNECTS.inc()
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, RECONNECT_MAX)
                continue
            backoff = RECONNECT_MIN
            self._writer = writer
            self.connects += 1
            try:
                await self._subscribe()
                while True:
                    msg_type, payload = await wire.read_frame(reader)
                    await self._dispatch(msg_type, payload)
            except asyncio.CancelledError:
                writer.close()
                raise
            except (asyncio.IncompleteReadError, ConnectionError,
                    OSError, wire.ClientProtocolError) as exc:
                ERRORS.labels(site="role.client").inc()
                logger.debug("light client %s link dropped: %r",
                             self.client_id, exc)
            finally:
                self.synced.clear()
                self._writer = None
                try:
                    writer.close()
                except OSError:
                    pass    # already torn down
                # in-flight delegations cannot complete on this link
                for ref, fut in list(self._pow_futures.items()):
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError("edge link dropped"))
                    self._pow_futures.pop(ref, None)
            RECONNECTS.inc()
            await asyncio.sleep(backoff)

    # -- tx ------------------------------------------------------------------

    async def _send(self, msg_type: int, payload: bytes) -> None:
        writer = self._writer
        if writer is None:
            raise ConnectionError("light client not connected")
        async with self._send_lock:
            inject("role.client")
            writer.write(wire.pack_frame(msg_type, payload))
            await writer.drain()

    def _bucket_entries(self):
        buckets = buckets_for_tags(self.tags, self.bucket_count)
        extra = tuple(b for b in self.extra_buckets
                      if 0 <= b < self.bucket_count)
        merged = tuple(sorted(set(buckets) | set(extra)))
        return [(s, merged) for s in self.streams]

    async def _subscribe(self) -> None:
        await self._send(wire.MSG_SUBSCRIBE, wire.encode_subscribe(
            self.client_id, self.tenant, self.bucket_count,
            self._bucket_entries()))

    async def _fetch_all(self) -> None:
        for stream, buckets in self._bucket_entries():
            if buckets:
                await self._send(wire.MSG_FETCH,
                                 wire.encode_fetch(stream, buckets))

    # -- rx ------------------------------------------------------------------

    async def _dispatch(self, msg_type: int, payload: bytes) -> None:
        if msg_type == wire.MSG_SUB_ACK:
            await self._on_sub_ack(payload)
        elif msg_type == wire.MSG_DIGEST_DELTA:
            await self._on_delta(payload)
        elif msg_type == wire.MSG_OBJECT_PUSH:
            await self._on_push(payload)
        elif msg_type == wire.MSG_POW_RESULT:
            self._on_pow_result(payload)
        elif msg_type == wire.MSG_PONG:
            pass
        else:
            logger.debug("light client: unexpected frame type %d",
                         msg_type)

    async def _on_sub_ack(self, payload: bytes) -> None:
        epoch, bucket_count, accepted = wire.decode_sub_ack(payload)
        self.epoch = epoch
        if bucket_count != self.bucket_count:
            # the edge's count is authoritative: re-derive and retry
            await self._adopt_bucket_count(bucket_count)
            return
        self.accepted_buckets = accepted
        await self._fetch_all()
        self.synced.set()

    async def _adopt_bucket_count(self, bucket_count: int) -> None:
        self.bucket_count = bucket_count
        self.digest.resize(bucket_count)
        REBUCKETS.inc()
        await self._subscribe()

    async def _on_delta(self, payload: bytes) -> None:
        epoch, bucket_count, stream, summaries = \
            wire.decode_digest_delta(payload)
        self.epoch = epoch
        if bucket_count != self.bucket_count:
            await self._adopt_bucket_count(bucket_count)
            return
        local = self.digest.summaries(stream)
        stale = [b for b, count, xor in summaries
                 if b < len(local) and local[b] != (count, xor)]
        if stale:
            self.fetch_repairs += 1
            await self._send(wire.MSG_FETCH,
                             wire.encode_fetch(stream, stale))

    async def _on_push(self, payload: bytes) -> None:
        seq, record = wire.decode_object_push(payload)
        h, type_, stream, expires, tag, body = record
        await self._send(wire.MSG_OBJECT_ACK,
                         wire.encode_object_ack(seq))
        if h in self.objects:
            OBJECTS.labels(path="duplicate").inc()
            return
        self.objects[h] = (type_, stream, expires, tag, body)
        while len(self.objects) > CLIENT_STORE_MAX:
            old, _ = self.objects.popitem(last=False)
            self.digest.discard(old)
        self.digest.add(h, stream, expires,
                        key=wire.routing_key(tag, h))
        self.pushes += 1
        OBJECTS.labels(path="push").inc()
        if self.crypto is not None:
            task = asyncio.create_task(
                self._trial_decrypt(h, type_, body))
            self._decrypt_tasks.add(task)
            task.add_done_callback(self._decrypt_done)

    def _decrypt_done(self, task: asyncio.Task) -> None:
        self._decrypt_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.error("light client %s: %s", self.client_id,
                         task.exception())

    async def _trial_decrypt(self, h: bytes, type_: int,
                             payload: bytes) -> None:
        """The ECDH that used to run on the edge, against the client's
        own keyring only (workers/processor.py candidate shapes).  An
        engine that is not running raises: no host fallback, and no
        wait on a queue nobody drains."""
        from ..models.objects import ObjectHeader
        if not self.crypto.running:
            DECRYPTS.labels(result="error").inc()
            raise RuntimeError("the light client's crypto engine is not "
                               "running")
        try:
            header = ObjectHeader.parse(payload)
            i = header.header_length
            if type_ == OBJECT_MSG:
                candidates = [(ident.priv_encryption, ident)
                              for ident in self.identities]
            elif type_ == OBJECT_BROADCAST and header.version == 5:
                tag = payload[i:i + 32]
                i += 32
                candidates = [(s.broadcast_key, s)
                              for s in self.subscriptions
                              if getattr(s, "tag", None) == tag]
            else:
                return
            if not candidates:
                DECRYPTS.labels(result="no_candidates").inc()
                return
            matches = await self.crypto.try_decrypt(
                payload[i:], candidates, tag=h)
            if matches:
                plaintext, handle = matches[0]
                self.decrypted.append((h, handle, plaintext))
                DECRYPTS.labels(result="match").inc()
            else:
                DECRYPTS.labels(result="miss").inc()
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            DECRYPTS.labels(result="error").inc()
            logger.debug("client trial-decrypt failed: %r", exc)

    # -- PoW delegation ------------------------------------------------------

    async def delegate_pow(self, initial_hash: bytes, target: int, *,
                           deadline_ms: int = 0,
                           timeout: float = 60.0) -> tuple[int, int]:
        """Delegate one PoW job through the edge to the farm; returns
        ``(nonce, trials)`` or raises.  CPU lands in
        ``farm_tenant_cpu_seconds_total`` under THIS client's tenant."""
        ref = next(self._job_refs)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pow_futures[ref] = fut
        try:
            await self._send(wire.MSG_POW_DELEGATE,
                             wire.encode_pow_delegate(
                                 ref, initial_hash, target, deadline_ms))
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pow_futures.pop(ref, None)

    def _on_pow_result(self, payload: bytes) -> None:
        job_ref, status, nonce, trials, detail = \
            wire.decode_pow_result(payload)
        fut = self._pow_futures.get(job_ref)
        if fut is None or fut.done():
            return
        if status == wire.POW_OK:
            fut.set_result((nonce, trials))
        else:
            fut.set_exception(RuntimeError(
                "delegated PoW failed: %s" % (detail or "error")))

    # -- observability -------------------------------------------------------

    async def wait_synced(self, timeout: float = 10.0) -> None:
        await asyncio.wait_for(self.synced.wait(), timeout)

    def snapshot(self) -> dict:
        return {
            "edge": "%s:%d" % (self.host, self.port),
            "connected": self._writer is not None,
            "connects": self.connects,
            "epoch": self.epoch,
            "bucketCount": self.bucket_count,
            "subscribedBuckets": self.accepted_buckets,
            "objects": len(self.objects),
            "pushes": self.pushes,
            "fetchRepairs": self.fetch_repairs,
            "decrypted": len(self.decrypted),
            "pendingPow": len(self._pow_futures),
        }
