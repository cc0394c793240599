"""Per-peer set-reconciliation sessions (copy of
``pybitmessage_tpu.sync.reconciler``).

Replaces most per-object inv flooding with periodic sketch exchanges:

- **Routing** (:meth:`Reconciler.route_announcement`): a new object
  still floods immediately to a small sqrt(n) subset of sync-capable
  peers (latency) and to every legacy peer; every other sync peer gets
  it queued in a per-connection *pending set* instead.
- **Rounds** (init -> sketch -> diff -> push): every ``interval``
  seconds (round-robin staggered, least-recently-reconciled first) a
  session with pending announcements opens a round — the initiator
  sends ``sketchreq`` (fresh session salt + capacity), the responder
  answers with its IBLT over its own pending set, the initiator
  subtracts its sketch, peels the difference, pushes the objects the
  responder lacks directly and sends ``recondiff`` with the short IDs
  it wants (the responder pushes those back).  Everything both sides
  were going to announce to each other cancels in the subtraction and
  costs zero wire bytes.
- **Fallback ladder**: a decode failure retries once with doubled
  capacity; repeats, round timeouts and failed sends degrade the
  round to classic inv flooding (the pending snapshot is requeued
  onto the connection tracker) and feed a per-peer circuit breaker;
  an open breaker keeps the peer on the flooding path until its
  cooldown probe reconciles successfully.  Protocol negotiation (the
  NODE_SYNC service bit) keeps old peers on flooding entirely.
- **Catch-up**: on establishment the outbound end sends its bucketed
  digest summaries (sync/digest.py); the responder sizes an IBLT over
  its whole unexpired inventory from the bucket deltas and one
  exchange converges both directions — replacing the big-inv full
  flood between synced nodes (which remains the fallback rung).

Dandelion stem routing is unchanged: stem-phase hashes never enter
pending sets or sketches (pool routing guards), so sketches leak
nothing the fluff phase would not.

Randomness (the round-robin stagger, the flood subset, the round and
catch-up salts) comes from one ``random.Random`` the caller may pass:
seeded, it makes a run repeatable draw for draw.  The module stays on
the host: short IDs and IBLT cells are unsigned 64-bit Python ints.
"""

from __future__ import annotations

import logging
import math
import random
import time

from ..models.constants import MAX_INV_COUNT
from ..network.messages import (RECONDIFF_DECODE_FAILED, RECONDIFF_OK,
                                SKETCH_KIND_DIGEST, SKETCH_KIND_IBLT,
                                decode_recondiff, decode_sketch,
                                decode_sketchreq, encode_recondiff,
                                encode_sketch, encode_sketchreq)
from ..observability import REGISTRY
from ..observability.flightrec import record as _flight
from ..observability.lifecycle import LIFECYCLE
from ..observability.metrics import peer_bucket_label
from ..observability.tracing import TRACE_CTX_LEN
from ..resilience import (ChaosError, CircuitBreaker, Deadline,
                          RetryPolicy, inject)
from ..resilience.policy import ERRORS
from .sketch import (Sketch, SketchDecodeError, capacity_for,
                     normalize_cells, short_id_map, short_ids)

logger = logging.getLogger("pybitmessage_tpu_torch.sync")

#: what a failed sketch decode may raise: the peel stalled, the wire
#: blob had the wrong shape or salt, or a chaos fault fired — the round
#: degrades, never the connection
_DECODE_FAULTS = (SketchDecodeError, ValueError, ChaosError)

SKETCH_BYTES = REGISTRY.counter(
    "sync_sketch_bytes_total",
    "Reconciliation control bytes (sketchreq/sketch/recondiff payloads)"
    " by direction", ("direction",))
DIFF_SIZE = REGISTRY.histogram(
    "sync_diff_size",
    "Decoded symmetric-difference size per successful round")
ROUNDS = REGISTRY.counter(
    "sync_rounds_total",
    "Reconciliation rounds initiated, by outcome "
    "(ok/decode_failed/timeout/send_failed)", ("outcome",))
FALLBACKS = REGISTRY.counter(
    "sync_fallback_total",
    "Rounds degraded to classic inv flooding (decode failure, timeout,"
    " open breaker flush) — announcements requeued, never lost")
BYTES_PER_OBJECT = REGISTRY.gauge(
    "sync_bytes_per_object",
    "Running control-bytes-on-wire per object learned through "
    "reconciliation (sketch+diff bytes / objects delivered)")
PENDING = REGISTRY.gauge(
    "sync_pending_announcements",
    "Announcements queued in reconciliation pending sets across peers")

#: frame overhead per packet (24-byte header) counted into the
#: bytes-on-wire figures so the flooding comparison is honest
FRAME_OVERHEAD = 24

IDLE = "idle"
AWAIT_SKETCH = "await-sketch"


class SyncSession:
    """Reconciliation state for one established connection."""

    __slots__ = ("conn", "pending", "state", "salt", "snapshot",
                 "deadline", "last_round", "ewma_diff", "ewma_dev",
                 "breaker", "failures", "next_due", "responder_rounds",
                 "known", "catchup_salt", "catchup_deadline")

    #: concurrently-outstanding responder rounds kept per session;
    #: beyond this the oldest is dropped (its recondiff, if it ever
    #: arrives, is treated as stale)
    MAX_RESPONDER_ROUNDS = 4

    #: per-session "peer demonstrably knows this hash" memory cap
    MAX_KNOWN = 1 << 16

    def __init__(self, conn, *, threshold: int = 3,
                 cooldown: float = 120.0):
        self.conn = conn
        #: hash -> queue time: what we owe this peer
        self.pending: dict[bytes, float] = {}
        self.state = IDLE
        self.salt = 0
        self.snapshot: dict[int, bytes] = {}
        self.deadline: Deadline | None = None
        self.last_round = 0.0
        #: EWMA of decoded diff sizes and of their absolute deviation
        #: (None until the first round measures something): capacity =
        #: ewma + 2*deviation — adaptively tracks both the level and
        #: the burstiness of this peer's symmetric difference
        self.ewma_diff: float | None = None
        self.ewma_dev = 0.0
        #: unregistered per-peer breaker; the metric label is the
        #: hashed peer BUCKET (``sync.reconcile/bNN``) — raw per-peer
        #: labels blow through MAX_LABEL_SETS at lab scale and collapse
        #: into the overflow child, one shared label hides which peer
        #: group is sick; buckets bound cardinality at sites x buckets
        self.breaker = CircuitBreaker(
            "sync:%s:%s" % (conn.host, conn.port),
            threshold=threshold, cooldown=cooldown,
            label=peer_bucket_label(
                "sync.reconcile", "%s:%s" % (conn.host, conn.port)),
            register=False)
        self.failures = 0
        self.next_due = 0.0
        #: responder-side round state keyed by round salt — we
        #: answered a sketchreq and wait for the recondiff verdict
        #: before clearing pending.  Keyed (not singular) because a
        #: gossip round and a catch-up can be in flight on the same
        #: connection at once: salt -> (snapshot, is_catchup, born)
        self.responder_rounds: dict[
            int, tuple[dict[int, bytes], bool, float]] = {}
        #: hashes this peer demonstrably has (it announced, pushed, or
        #: reconciled them) — never queue these back at it.  An
        #: insertion-ordered dict doubles as the FIFO eviction queue.
        self.known: dict[bytes, None] = {}
        #: in-flight initial-sync catch-up (full-inventory round)
        self.catchup_salt: int | None = None
        self.catchup_deadline: Deadline | None = None

    def add_responder_round(self, salt: int, snapshot: dict,
                            is_catchup: bool, now: float) -> None:
        while len(self.responder_rounds) >= self.MAX_RESPONDER_ROUNDS:
            self.responder_rounds.pop(next(iter(self.responder_rounds)))
        self.responder_rounds[salt] = (snapshot, is_catchup, now)

    def mark_known(self, h: bytes) -> None:
        self.known[h] = None
        while len(self.known) > self.MAX_KNOWN:
            self.known.pop(next(iter(self.known)))

    def estimate(self, set_size: int) -> float:
        """Expected symmetric difference for the next round.  No
        history yet: assume half the set is unshared (overshooting a
        first sketch costs bytes once; undershooting wastes the whole
        round AND a breaker count)."""
        if self.ewma_diff is None:
            # no history: a session's first rounds run before much has
            # cancelled, so the diff is close to the set itself —
            # overshoot once rather than fail-retry-flood
            return 0.75 * set_size + 12
        return self.ewma_diff + 2.5 * self.ewma_dev + 4

    def observe_diff(self, diff: int) -> None:
        if self.ewma_diff is None:
            self.ewma_diff = float(diff)
        else:
            self.ewma_dev = 0.75 * self.ewma_dev + \
                0.25 * abs(diff - self.ewma_diff)
            self.ewma_diff = 0.6 * self.ewma_diff + 0.4 * diff


class Reconciler:
    """All reconciliation sessions of one connection pool."""

    def __init__(self, pool, *, digest=None, interval: float = 10.0,
                 fanout: int | None = None, round_timeout: float = 30.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 120.0,
                 recent_window: float = 30.0,
                 clock=time.time, rng: random.Random | None = None):
        self.pool = pool
        #: every random draw of the reconciler comes from here
        self.rng = rng if rng is not None else random.Random()
        self.digest = digest
        self.interval = interval
        #: how long an arrival counts as "recent": a round's want-list
        #: is filtered against the recent window — an object that
        #: landed here after the snapshot froze would otherwise be
        #: requested (and its payload transferred) a second time
        self.recent_window = recent_window
        #: injectable time source (the simulated mesh runs on ticks)
        self.clock = clock
        #: immediate-flood subset size per new object: None = auto
        #: sqrt(reconciling peers), 0 = pure reconciliation (lowest
        #: bandwidth, delivery latency = round cadence), k = exactly k
        self.fanout = fanout
        self.round_timeout = round_timeout
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        #: rounds initiated per tick() call (round-robin stagger)
        self.rounds_per_tick = 1
        #: backoff between failed rounds on one peer
        self.retry_policy = RetryPolicy(attempts=8, base_delay=interval,
                                        max_delay=300.0, jitter=0.25)
        self.sessions: dict = {}
        #: recently-arrived inventory hashes -> arrival clock time
        self._recent: dict[bytes, float] = {}
        #: running totals behind the bytes-per-object gauge
        self._control_bytes = 0
        self._objects_delivered = 0

    MAX_RECENT = 8192

    def _note_recent(self, h: bytes) -> None:
        self._recent[h] = self.clock()
        while len(self._recent) > self.MAX_RECENT:
            self._recent.pop(next(iter(self._recent)))

    def _recent_hashes(self) -> list[bytes]:
        """Prune and return the recent-arrival window."""
        cutoff = self.clock() - self.recent_window
        stale = [h for h, t in self._recent.items() if t < cutoff]
        for h in stale:
            del self._recent[h]
        return list(self._recent)

    # -- lifecycle -----------------------------------------------------------

    def register(self, conn) -> SyncSession:
        s = self.sessions.get(conn)
        if s is None:
            s = self.sessions[conn] = SyncSession(
                conn, threshold=self.breaker_threshold,
                cooldown=self.breaker_cooldown)
            # desynchronize the round-robin phase: if every node's
            # rotation visited peers in the same order, all holders of
            # an object would reconcile with the same victim in the
            # same tick and push it to them in duplicate
            s.last_round = self.clock() - self.rng.uniform(0.0, 997.0)
        return s

    def unregister(self, conn) -> None:
        s = self.sessions.pop(conn, None)
        if s is not None:
            PENDING.dec(len(s.pending))

    def negotiated(self, conn) -> bool:
        return conn in self.sessions

    # -- announcement routing -------------------------------------------------

    def route_announcement(self, h: bytes, conns,
                           stream: int | None = None) -> None:
        """Route one new-object announcement: flood a sqrt(n) subset of
        reconciling peers (plus every legacy/broken-breaker peer),
        queue the rest into pending sets.

        Shard boundary: when the caller knows the
        object's stream and it is outside this node's subscribed
        shard, the hash must never enter a pending set — pending sets
        feed sketches, and a sketch must only ever summarize the
        shard's own streams.
        """
        if stream is not None and stream not in self.pool.ctx.streams:
            return
        now = self.clock()
        self._note_recent(h)
        recon = []
        for c in conns:
            s = self.sessions.get(c)
            if s is not None and h in s.known:
                continue  # the peer already has it — nothing to say
            if s is None or not s.breaker.available():
                # legacy peer, or one degraded to flooding mode
                c.tracker.we_should_announce(h)
            else:
                recon.append((c, s))
        if not recon:
            return
        k = self.fanout if self.fanout is not None \
            else max(1, math.isqrt(len(recon)))
        if k <= 0:
            flood_now = []
        elif k >= len(recon):
            flood_now = recon
            recon = []
        else:
            idx = self.rng.sample(range(len(recon)), k)
            chosen = set(idx)
            flood_now = [recon[i] for i in idx]
            recon = [cs for i, cs in enumerate(recon)
                     if i not in chosen]
        for c, _ in flood_now:
            c.tracker.we_should_announce(h)
        for _, s in recon:
            if h not in s.pending:
                PENDING.inc()
                s.pending[h] = now

    def peer_announced(self, conn, h: bytes) -> None:
        """The peer just announced ``h`` to us — it has the object, so
        announcing it back (by inv OR sketch) is pure waste."""
        s = self.sessions.get(conn)
        if s is None:
            return
        s.mark_known(h)
        if s.pending.pop(h, None) is not None:
            PENDING.dec()

    def pending_count(self) -> int:
        return sum(len(s.pending) for s in self.sessions.values())

    # -- the periodic driver --------------------------------------------------

    async def tick(self) -> None:
        """Run from the pool's inv loop: time out overdue rounds,
        flush flooding-mode peers, open new rounds that are due.

        At most ``rounds_per_tick`` sessions initiate per call, picked
        least-recently-reconciled first (Erlay's round-robin): if every
        peer holding object X reconciled with the same victim in the
        same tick, each would push X — staggering turns those
        duplicate deliveries into sketch cancellations instead."""
        now = self.clock()
        due: list[SyncSession] = []
        for conn, s in list(self.sessions.items()):
            try:
                if s.catchup_salt is not None and \
                        s.catchup_deadline is not None and \
                        s.catchup_deadline.expired:
                    # catch-up went unanswered: the peer must not stay
                    # an inventory island — big-inv it classically
                    s.catchup_salt = None
                    s.catchup_deadline = None
                    ROUNDS.labels(outcome="catchup_timeout").inc()
                    _flight("sync_round", peer=conn.host,
                            outcome="catchup_timeout")
                    FALLBACKS.inc()
                    await self._big_inv(conn)
                if s.state == AWAIT_SKETCH and s.deadline is not None \
                        and s.deadline.expired:
                    self._round_failed(s, "timeout")
                    continue
                # a responder round whose recondiff never arrived must
                # not strand its pending entries: flood them
                for salt in [k for k, (_, _, born)
                             in s.responder_rounds.items()
                             if now - born > self.round_timeout]:
                    snapshot, _, _ = s.responder_rounds.pop(salt)
                    self._flood_pending(s, list(snapshot.values()))
                if not s.breaker.available():
                    # degraded peer: classic flooding until the
                    # breaker's cooldown lets a probe round through
                    if s.pending:
                        self._flood_pending(s)
                    continue
                if s.state == IDLE and s.pending and now >= s.next_due \
                        and now - s.last_round >= self.interval:
                    due.append(s)
            except (ConnectionError, OSError) as exc:
                ERRORS.labels(site="net.send").inc()
                logger.debug("sync round to %s failed to send: %r",
                             conn.host, exc)
                self._round_failed(s, "send_failed", flood=False)
        due.sort(key=lambda s: s.last_round)
        for s in due[:self.rounds_per_tick]:
            try:
                await self._initiate(s)
            except (ConnectionError, OSError) as exc:
                ERRORS.labels(site="net.send").inc()
                logger.debug("sync round to %s failed to send: %r",
                             s.conn.host, exc)
                self._round_failed(s, "send_failed", flood=False)

    # -- initiator side -------------------------------------------------------

    async def _initiate(self, s: SyncSession) -> None:
        if not s.breaker.allow():
            return
        s.salt = self.rng.getrandbits(64)
        s.snapshot = short_id_map(s.pending.keys(), s.salt)
        capacity = capacity_for(s.estimate(len(s.snapshot)))
        payload = encode_sketchreq(SKETCH_KIND_IBLT, s.salt, capacity,
                                   len(s.snapshot))
        s.state = AWAIT_SKETCH
        s.deadline = Deadline(self.round_timeout)
        await self._send(s.conn, "sketchreq", payload)

    async def handle_sketch(self, conn, payload: bytes) -> None:
        """The responder's IBLT arrived: subtract, peel, push the diff.

        Decoded difference objects are pushed as ``object`` packets
        directly — both ends know *exactly* which objects the other
        lacks, so the classic announce->getdata round trip (and its 32
        bytes of hash per announcement) is pure overhead here."""
        self._count_rx(conn, payload)
        s = self.sessions.get(conn)
        if s is None:
            return
        kind, salt, set_size, cells, _summaries = decode_sketch(payload)
        if kind == SKETCH_KIND_IBLT and s.catchup_salt is not None \
                and salt == s.catchup_salt:
            await self._handle_catchup_sketch(conn, s, salt, cells)
            return
        if kind != SKETCH_KIND_IBLT or s.state != AWAIT_SKETCH \
                or salt != s.salt:
            logger.debug("stale/unexpected sketch from %s", conn.host)
            return
        try:
            if set_size == 0 and not cells:
                # responder-empty shortcut: the difference IS our set
                ours_only = set(s.snapshot.keys())
                theirs_only: set[int] = set()
            else:
                inject("sync.sketch_decode")
                remote = Sketch.from_bytes(cells, salt)
                local = Sketch(remote.cells, salt)
                local.insert_ids(s.snapshot.keys())
                ours_only, theirs_only = local.subtract(remote).decode()
        except _DECODE_FAULTS as exc:
            # SketchDecodeError, shape/salt ValueError, or a chaos
            # fault: the decode path must degrade, never crash the
            # connection
            logger.debug("sketch decode with %s failed: %r",
                         conn.host, exc)
            try:
                await self._send(conn, "recondiff", encode_recondiff(
                    RECONDIFF_DECODE_FAILED, salt, 0, [], []))
            except (ConnectionError, OSError):
                ERRORS.labels(site="net.send").inc()
            self._round_failed(s, "decode_failed")
            return
        theirs_hashes = [s.snapshot[i] for i in ours_only
                         if i in s.snapshot]
        if theirs_only:
            # drop ids whose objects arrived here after the snapshot
            # was taken — requesting them again would transfer the
            # payload in duplicate (the race window spans the whole
            # sketchreq -> sketch round trip)
            arrived = set(short_ids(self._recent_hashes(), salt))
            theirs_only -= arrived
        want = sorted(theirs_only)
        diff = len(ours_only) + len(theirs_only)
        # ask for what we lack (8-byte ids), then push what they lack;
        # objects that fell out of the inventory meanwhile degrade to a
        # 32-byte hash announcement in the recondiff instead
        pushable, unpushable = self._split_pushable(theirs_hashes)
        await self._send(conn, "recondiff", encode_recondiff(
            RECONDIFF_OK, salt, diff, unpushable, want))
        for h in unpushable:
            s.mark_known(h)
        await self._push_objects(s, pushable)
        # round complete: the snapshot is covered (delivered or known
        # shared); entries queued since the snapshot stay pending
        self._clear_snapshot(s)
        s.observe_diff(diff)
        s.failures = 0
        s.breaker.record_success()
        s.state = IDLE
        s.last_round = self.clock()
        s.next_due = 0.0
        DIFF_SIZE.observe(diff)
        ROUNDS.labels(outcome="ok").inc()
        _flight("sync_round", peer=conn.host, outcome="ok", diff=diff)
        self._delivered(len(want))

    # -- responder side -------------------------------------------------------

    async def handle_sketchreq(self, conn, payload: bytes) -> None:
        self._count_rx(conn, payload)
        s = self.sessions.get(conn)
        if s is None:
            return
        kind, salt, capacity, init_size, summaries = \
            decode_sketchreq(payload)
        if kind == SKETCH_KIND_DIGEST:
            await self._handle_digest_catchup(conn, salt, summaries or {})
            return
        if kind != SKETCH_KIND_IBLT:
            logger.debug("unknown sketchreq kind %d from %s", kind,
                         conn.host)
            return
        snapshot = short_id_map(s.pending.keys(), salt)
        if not snapshot:
            # empty-set shortcut: zero cells tell the initiator its
            # whole snapshot IS the difference — no table to peel
            await self._send(conn, "sketch", encode_sketch(
                SKETCH_KIND_IBLT, salt, 0, cells=b""))
            return
        s.add_responder_round(salt, snapshot, False, self.clock())
        # the difference is at least the size gap between the two sets,
        # and the responder carries its own history for this peer; an
        # undersized request is hopeless, so grow it (the initiator
        # sizes its table to whatever cell count actually arrives).
        # normalize_cells guards the wire-supplied value — the Sketch
        # constructor's invariant must not be remotely violable.
        mine = len(snapshot)
        floor = capacity_for(max(abs(mine - init_size) * 1.2 + 2,
                                 s.estimate(mine)))
        capacity = normalize_cells(max(capacity, floor))
        sk = Sketch(capacity, salt)
        sk.insert_ids(snapshot.keys())
        await self._send(conn, "sketch", encode_sketch(
            SKETCH_KIND_IBLT, salt, mine, cells=sk.to_bytes()))

    async def handle_recondiff(self, conn, payload: bytes) -> None:
        self._count_rx(conn, payload)
        s = self.sessions.get(conn)
        if s is None:
            return
        flags, salt, diff_size, missing, want = decode_recondiff(payload)
        if flags != RECONDIFF_OK:
            if s.catchup_salt is not None and salt == s.catchup_salt:
                # our catch-up request was refused (no digest / diff
                # too large to beat the flood): big-inv classically
                s.catchup_salt = None
                s.catchup_deadline = None
                FALLBACKS.inc()
                ROUNDS.labels(outcome="catchup_refused").inc()
                _flight("sync_round", peer=conn.host,
                        outcome="catchup_refused")
                await self._big_inv(conn)
                return
            # the initiator could not decode OUR round: it floods
            # classically; we flood our side too so nothing is lost
            entry = s.responder_rounds.pop(salt, None)
            if entry is not None:
                self._flood_pending(s, list(entry[0].values()))
            return
        entry = s.responder_rounds.pop(salt, None)
        if entry is None:
            logger.debug("stale recondiff from %s (salt %x)",
                         conn.host, salt)
            return
        snapshot, is_catchup, _born = entry
        learned = 0
        inventory = self.pool.ctx.inventory
        for h in missing:
            # hashes the initiator holds but could not push: fetch the
            # ones we lack through the normal download path, and never
            # announce them back
            s.mark_known(h)
            if s.pending.pop(h, None) is not None:
                PENDING.dec()
            if h not in inventory:
                learned += 1
            conn.tracker.peer_announced(h)
        wanted = [snapshot[i] for i in want if i in snapshot]
        pushable, unpushable = self._split_pushable(wanted)
        await self._push_objects(s, pushable)
        if unpushable:
            await self._announce_chunked(conn, unpushable)
        if not is_catchup:
            # catch-up diffs are whole-inventory scale; training the
            # steady-state estimator on them would balloon every
            # subsequent gossip sketch
            s.observe_diff(diff_size)
        self._settle_responder(s, snapshot)
        self._delivered(learned)

    # -- initial-sync catch-up (establishment) --------------------------------

    #: safety multiplier on the digest-derived difference bound
    CATCHUP_SLACK = 2.5

    async def start_catchup(self, conn) -> bool:
        """Open a full-inventory reconciliation instead of the big-inv
        flood: send our bucketed digest summaries; the responder sizes
        an IBLT over its whole unexpired inventory from the bucket
        deltas, and one sketch exchange converges BOTH directions.
        One side per connection initiates (the outbound end).

        With no digest attached we still send the request — with EMPTY
        summaries, which the responder necessarily refuses — because
        the refusal makes BOTH sides big-inv: the inbound end skipped
        its establishment flood on the promise that catch-up covers
        it, and a silent local fallback would leave its pre-existing
        inventory unadvertised forever."""
        s = self.sessions.get(conn)
        if s is None:
            return False
        s.catchup_salt = self.rng.getrandbits(64)
        s.catchup_deadline = Deadline(self.round_timeout)
        if self.digest is not None:
            summaries = {stream: self.digest.summaries(stream)
                         for stream in self.pool.ctx.streams}
            size = len(self.digest)
        else:
            summaries, size = {}, 0
        await self._send(conn, "sketchreq", encode_sketchreq(
            SKETCH_KIND_DIGEST, s.catchup_salt, 0, size,
            summaries=summaries))
        return True

    def _catchup_population(self) -> list[bytes]:
        dand = self.pool.ctx.dandelion
        return [h for stream in self.pool.ctx.streams
                for h in self._stream_hashes(stream)
                if dand is None or not dand.in_stem_phase(h)]

    def _stream_hashes(self, stream: int) -> list[bytes]:
        if self.digest is not None:
            return self.digest.hashes_by_stream(stream)
        return list(self.pool.ctx.inventory.unexpired_hashes_by_stream(
            stream))

    def _estimate_from_summaries(self, summaries) -> int:
        """Lower-bound the inventory symmetric difference from bucket
        count deltas — exact when the difference is one-sided (the
        rejoin case); the retry/fallback ladder absorbs the rest."""
        est = 0
        for stream in self.pool.ctx.streams:
            remote = summaries.get(stream, [])
            local = self.digest.summaries(stream)
            if len(remote) != len(local):
                est += max(len(self.digest), 1)  # incomparable
                continue
            for (lc, lx), (rc, rx) in zip(local, remote):
                if lc != rc or lx != rx:
                    est += max(abs(lc - rc), 1)
        return est

    async def _handle_digest_catchup(self, conn, salt: int,
                                     summaries) -> None:
        """Responder: answer a catch-up request with a full-inventory
        IBLT sized from the digest delta — or refuse the round when
        reconciliation cannot beat the classic flood (no digest, or
        the difference approaches the set size: an IBLT pays ~20 B per
        difference element vs the flood's 32 B per *set* element)."""
        s = self.sessions.get(conn)
        if s is None:
            return
        if self.digest is not None:
            population = self._catchup_population()
            est = int(self._estimate_from_summaries(summaries)
                      * self.CATCHUP_SLACK) + 16
        else:
            population, est = [], 1 << 30
        if est >= 0.8 * max(len(population), 24):
            await self._send(conn, "recondiff", encode_recondiff(
                RECONDIFF_DECODE_FAILED, salt, 0, [], []))
            FALLBACKS.inc()
            ROUNDS.labels(outcome="catchup_refused").inc()
            _flight("sync_round", peer=conn.host,
                    outcome="catchup_refused")
            await self._big_inv(conn)
            return
        snapshot = short_id_map(population, salt)
        s.add_responder_round(salt, snapshot, True, self.clock())
        sk = Sketch(capacity_for(est), salt)
        sk.insert_ids(snapshot.keys())
        await self._send(conn, "sketch", encode_sketch(
            SKETCH_KIND_IBLT, salt, len(population),
            cells=sk.to_bytes()))

    async def _handle_catchup_sketch(self, conn, s: SyncSession,
                                     salt: int, cells: bytes) -> None:
        """Initiator: the responder's full-inventory sketch arrived —
        decode and push/request the difference, or fall back to the
        classic big-inv exchange."""
        s.catchup_salt = None
        s.catchup_deadline = None
        snapshot = short_id_map(self._catchup_population(), salt)
        try:
            inject("sync.sketch_decode")
            remote = Sketch.from_bytes(cells, salt)
            local = Sketch(remote.cells, salt)
            local.insert_ids(snapshot.keys())
            ours_only, theirs_only = local.subtract(remote).decode()
        except _DECODE_FAULTS as exc:
            logger.debug("catch-up decode with %s failed: %r",
                         conn.host, exc)
            ROUNDS.labels(outcome="catchup_failed").inc()
            _flight("sync_round", peer=conn.host,
                    outcome="catchup_failed")
            FALLBACKS.inc()
            try:
                await self._send(conn, "recondiff", encode_recondiff(
                    RECONDIFF_DECODE_FAILED, salt, 0, [], []))
            except (ConnectionError, OSError):
                ERRORS.labels(site="net.send").inc()
            await self._big_inv(conn)
            return
        theirs_hashes = [snapshot[i] for i in ours_only if i in snapshot]
        diff = len(ours_only) + len(theirs_only)
        if theirs_only:
            # same duplicate-transfer guard as the gossip rounds:
            # objects that landed here during the round trip must not
            # be requested (and pushed back) again — at catch-up scale
            # that is whole payloads during the busiest window
            theirs_only -= set(short_ids(self._recent_hashes(), salt))
        want = sorted(theirs_only)
        pushable, unpushable = self._split_pushable(theirs_hashes)
        await self._send(conn, "recondiff", encode_recondiff(
            RECONDIFF_OK, salt, diff, unpushable, want))
        await self._push_objects(s, pushable)
        ROUNDS.labels(outcome="catchup_ok").inc()
        _flight("sync_round", peer=conn.host, outcome="catchup_ok",
                diff=diff)
        DIFF_SIZE.observe(diff)
        self._delivered(len(want))

    async def _big_inv(self, conn) -> None:
        """The classic establishment flood — catch-up's last-resort
        rung: advertise the whole unexpired inventory as plain invs."""
        dand = self.pool.ctx.dandelion
        for stream in self.pool.ctx.streams:
            hashes = [h for h in self._stream_hashes(stream)
                      if dand is None or not dand.in_stem_phase(h)]
            await self._announce_chunked(conn, hashes)

    # -- failure ladder -------------------------------------------------------

    def _round_failed(self, s: SyncSession, outcome: str,
                      flood: bool = True) -> None:
        """A round died: retry once with more headroom, else requeue
        its snapshot (flooded classically or ridden into the next
        round), open the breaker ladder, back off."""
        ROUNDS.labels(outcome=outcome).inc()
        _flight("sync_round", peer=s.conn.host, outcome=outcome,
                failures=s.failures + 1)
        s.failures += 1
        base = s.ewma_diff if s.ewma_diff is not None else 8.0
        grown = min(max(base * 2 + 8, len(s.snapshot) * 0.75),
                    float(1 << 14))
        if outcome == "decode_failed" and s.failures <= 2:
            # an isolated decode failure just means the diff outran
            # the estimate — retry immediately with doubled headroom
            # (entries stay pending); only repeats degrade the peer
            s.ewma_diff = grown
            s.snapshot = {}
            s.state = IDLE
            s.deadline = None
            s.next_due = 0.0
            return
        s.breaker.record_failure()
        if flood:
            self._flood_pending(s, list(s.snapshot.values()))
            # undersized capacity is the most likely decode killer:
            # grow the estimate so the probe round has headroom (the
            # true diff was unknowable, but it was at most the union)
            s.ewma_diff = grown
        # flood=False (send failure): snapshot entries stay pending and
        # simply ride the next round
        s.snapshot = {}
        s.state = IDLE
        s.deadline = None
        s.last_round = self.clock()
        s.next_due = s.last_round + self.retry_policy.delay(
            min(s.failures - 1, self.retry_policy.attempts - 1))

    def _flood_pending(self, s: SyncSession, hashes=None) -> None:
        """Degrade to classic inv flooding: push hashes back onto the
        connection tracker (the inv loop delivers next tick)."""
        hashes = list(hashes if hashes is not None else s.pending.keys())
        if not hashes:
            return
        FALLBACKS.inc(len(hashes))
        for h in hashes:
            s.conn.tracker.we_should_announce(h)
            if s.pending.pop(h, None) is not None:
                PENDING.dec()

    # -- small helpers --------------------------------------------------------

    def _clear_snapshot(self, s: SyncSession) -> None:
        """Success path only: after a decoded round, every snapshot
        entry is covered — the peer either shared it (cancelled in the
        subtraction) or was just pushed it.  Either way it now knows
        the object."""
        for h in s.snapshot.values():
            s.mark_known(h)
            if s.pending.pop(h, None) is not None:
                PENDING.dec()
        s.snapshot = {}
        s.deadline = None

    def _settle_responder(self, s: SyncSession,
                          snapshot: dict[int, bytes]) -> None:
        for h in snapshot.values():
            s.mark_known(h)
            if s.pending.pop(h, None) is not None:
                PENDING.dec()
        # this pair just reconciled (we were the responder): rotating
        # our own initiator onto it right away would reconcile an
        # already-settled pair while fresher ones wait
        s.last_round = self.clock()

    async def _announce_chunked(self, conn, hashes: list[bytes]) -> None:
        for i in range(0, len(hashes), MAX_INV_COUNT):
            await conn.announce(hashes[i:i + MAX_INV_COUNT])

    def _split_pushable(self, hashes: list[bytes]
                        ) -> tuple[list[tuple[bytes, bytes]], list[bytes]]:
        """Partition diff hashes into (hash, payload) pairs we can push
        directly and hashes that fell out of the inventory (cleaned /
        expired mid-round) — those degrade to hash announcements."""
        inventory = self.pool.ctx.inventory
        pushable, unpushable = [], []
        for h in hashes:
            try:
                item = inventory[h]
            except KeyError:
                unpushable.append(h)
                continue
            pushable.append((h, getattr(item, "payload", item)))
        return pushable, unpushable

    async def _push_objects(self, s: SyncSession,
                            items: list[tuple[bytes, bytes]]) -> None:
        """Deliver diff objects as direct ``object`` packets: after a
        decoded round both ends know exactly what the other lacks, so
        the inv+getdata round trip would only add bytes and latency.

        Items the peer demonstrably obtained since the round's
        snapshot froze — it announced them, or an overlapping round
        already pushed them — are skipped, not re-transferred."""
        send_object = getattr(s.conn, "send_object", None)
        for h, payload in items:
            if h in s.known:
                continue
            s.mark_known(h)
            LIFECYCLE.record(h, "sync_pushed")
            if send_object is not None:
                # NODE_TRACE peers receive `tobject` (trace-context-
                # prefixed) so their timeline joins this object's trace
                await send_object(h, payload)
            else:
                await s.conn.send_packet("object", payload)

    async def _send(self, conn, command: str, payload: bytes) -> None:
        # NODE_TRACE peers get the 32-byte trace trailer appended
        # (clock-skew + cross-node round stitching); simulated/legacy
        # connections lack the hook and send the classic bytes
        attach = getattr(conn, "attach_trace", None)
        if attach is not None:
            payload = attach(command, payload)
        SKETCH_BYTES.labels(direction="tx").inc(
            len(payload) + FRAME_OVERHEAD)
        self._control_bytes += len(payload) + FRAME_OVERHEAD
        await conn.send_packet(command, payload)

    def _count_rx(self, conn, payload: bytes) -> None:
        # the connection strips the 32-byte trace trailer before the
        # reconciler sees the payload; count it back in so tx and rx
        # agree on what actually crossed the wire
        n = len(payload) + FRAME_OVERHEAD
        if getattr(conn, "trace_negotiated", False):
            n += TRACE_CTX_LEN
        SKETCH_BYTES.labels(direction="rx").inc(n)
        self._control_bytes += n

    def _delivered(self, n: int) -> None:
        if n <= 0:
            return
        self._objects_delivered += n
        BYTES_PER_OBJECT.set(
            self._control_bytes / max(self._objects_delivered, 1))

    def snapshot_state(self) -> dict:
        """clientStatus-style introspection block."""
        return {
            "sessions": len(self.sessions),
            "pending": self.pending_count(),
            "controlBytes": self._control_bytes,
            "objectsDelivered": self._objects_delivered,
            "breakersOpen": sum(
                1 for s in self.sessions.values()
                if not s.breaker.available()),
        }
