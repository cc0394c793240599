"""In-process simulated peer mesh driving the REAL sync stack (copy of
``pybitmessage_tpu.sync.mesh``).

A sync storm and the chaos checks measure bytes-on-wire per propagated
object across many peers without paying for real sockets, PoW, or
payload crypto.  This harness wires N simulated nodes into a mesh where
every link carries actual framed protocol payloads
(``encode_inv``/``encode_sketchreq``/…) through the actual
:class:`~.reconciler.Reconciler` and
:class:`~..network.tracker.ConnectionTracker` state machines — only the
transport (an in-memory queue) and the object payloads (opaque blobs)
are simulated.  Byte accounting includes the
24-byte frame header per packet, so the flooding/reconciliation
comparison is honest about overheads.

Every random draw of a mesh (the trackers' announce buckets and
download picks, the reconcilers' staggers, subsets and salts) comes
from the one ``random.Random`` it is given, so a seeded mesh repeats
itself packet for packet.
"""

from __future__ import annotations

import random
import time
from collections import deque

from ..network.messages import decode_inv, encode_inv
from ..network.tracker import ConnectionTracker, GlobalTracker
from ..observability.federation import Aggregator, FederationPublisher
from ..observability.lifecycle import LifecycleTracer
from ..observability.metrics import Registry
from .digest import InventoryDigest
from .reconciler import FRAME_OVERHEAD, Reconciler

#: simulated object payload size (constant: identical in both modes,
#: so it never biases the announcement-layer comparison)
SIM_OBJECT_SIZE = 256
#: commands that form the announcement layer (the quantity sync is
#: built to shrink); getdata/object transfer is identical in both modes
ANNOUNCE_COMMANDS = ("inv", "sketchreq", "sketch", "recondiff")

#: tick-resolution buckets for the per-node propagation histogram the
#: federation path merges (one mesh tick == one simulated second)
TICK_BUCKETS = tuple(float(b) for b in (
    1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 96, 128,
    192, 256))


class MeshStats:
    def __init__(self):
        self.bytes_by_command: dict[str, int] = {}
        self.packets = 0
        self.deliveries = 0

    def count(self, command: str, payload: bytes) -> None:
        self.packets += 1
        self.bytes_by_command[command] = \
            self.bytes_by_command.get(command, 0) + \
            len(payload) + FRAME_OVERHEAD

    @property
    def announce_bytes(self) -> int:
        return sum(self.bytes_by_command.get(c, 0)
                   for c in ANNOUNCE_COMMANDS)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_command.values())


class _SimInventory(dict):
    """hash -> payload store with the one Inventory query the
    reconciler's digestless big-inv fallback needs."""

    def unexpired_hashes_by_stream(self, stream: int):
        return list(self)


class _SimCtx:
    """The slice of NodeContext the reconciler/tracker paths touch."""

    def __init__(self, inventory):
        self.inventory = inventory
        self.streams = (1,)
        self.dandelion = None


class _SimPool:
    def __init__(self, node: "SimNode"):
        self._node = node
        self.ctx = _SimCtx(node.inventory)
        self.reconciler = None

    def established(self):
        return list(self._node.conns.values())


class SimConn:
    """One direction of a link: node -> peer.  Duck-types the slice of
    BMConnection the reconciler and inv paths use."""

    def __init__(self, node: "SimNode", peer: "SimNode", mesh: "Mesh"):
        self.node = node
        self.peer = peer
        self.mesh = mesh
        self.tracker = ConnectionTracker(buckets=mesh.buckets, rng=mesh.rng)
        # the download anonymization window is real-time (60 s pending
        # timeout, 10 in-flight) — the simulation runs hundreds of
        # fake-time ticks in milliseconds, so it would deadlock the
        # downloader; widen it (identical in both modes)
        self.tracker.objects_new_to_me.max_pending = 1 << 20
        self.tracker.objects_new_to_me.pending_timeout = 0.0
        self.host = "sim-%d" % peer.index
        self.port = peer.index
        self.fully_established = True

    async def send_packet(self, command: str, payload: bytes = b"") -> None:
        self.mesh.stats.count(command, payload)
        if self.node._announce_bytes is not None and \
                command in ANNOUNCE_COMMANDS:
            self.node._announce_bytes.inc(len(payload) + FRAME_OVERHEAD)
        self.mesh.queue.append((self.peer, self.node, command, payload))

    async def announce(self, hashes, stem: bool = False) -> None:
        if hashes:
            await self.send_packet("inv", encode_inv(list(hashes)))


class SimNode:
    def __init__(self, index: int, mesh: "Mesh"):
        self.index = index
        self.mesh = mesh
        self.inventory: dict[bytes, bytes] = _SimInventory()
        self.pool = _SimPool(self)
        self.conns: dict[int, SimConn] = {}
        self.global_tracker = GlobalTracker()
        self.reconciler: Reconciler | None = None
        self.digest: InventoryDigest | None = None
        #: per-node telemetry (federation mode): a PRIVATE registry —
        #: this node's propagation/byte/delivery series, pushed to the
        #: mesh aggregator through the real FederationPublisher path
        self.registry: Registry | None = None
        self.publisher: FederationPublisher | None = None
        self._prop_hist = None
        self._announce_bytes = None
        self._delivered = None

    def enable_federation(self, aggregator: Aggregator) -> None:
        """Give this node its own registry + lifecycle tracer and a
        real publisher into the mesh aggregator — the same snapshot
        push/merge machinery a multi-process deployment runs, driven
        in-process."""
        self.registry = Registry()
        self._prop_hist = self.registry.histogram(
            "mesh_propagation_seconds",
            "Origin-to-this-node delivery latency (simulated ticks)",
            buckets=TICK_BUCKETS)
        self._announce_bytes = self.registry.counter(
            "mesh_announce_bytes_total",
            "Announcement-layer bytes this node sent")
        self._delivered = self.registry.counter(
            "mesh_delivered_objects_total",
            "Objects delivered to this node from a peer")
        self.publisher = FederationPublisher(
            "sim-%d" % self.index, self.registry,
            transport=aggregator.ingest, count_bytes=False,
            health=lambda: {"mesh": {"status": "ok",
                                     "inventory": len(self.inventory)}})

    def enable_sync(self, **kwargs) -> Reconciler:
        kwargs.setdefault("clock", lambda: float(self.mesh._tick_no))
        kwargs.setdefault("rng", self.mesh.rng)
        self.digest = InventoryDigest()
        for h in self.inventory:
            self.digest.add(h, 1, 1 << 60)
        kwargs.setdefault("digest", self.digest)
        self.reconciler = Reconciler(self.pool, **kwargs)
        self.pool.reconciler = self.reconciler
        for conn in self.conns.values():
            self.reconciler.register(conn)
        return self.reconciler

    # -- object routing (mirrors pool.object_received/announce_object) -------

    def add_object(self, h: bytes, payload: bytes, source: SimConn | None
                   ) -> None:
        if h in self.inventory:
            return
        self.inventory[h] = payload
        if self.digest is not None:
            self.digest.add(h, 1, 1 << 60)
        if source is not None:
            self.mesh.stats.deliveries += 1
            self.mesh.lifecycle.observe_propagation(h)
            if self._delivered is not None:
                # per-node telemetry (federation mode): this node's own
                # series — delivery count + origin-to-here latency
                # against the object's origin stamp (the simulated
                # stand-in for the wire trace context; every simulated
                # node shares one tick clock, so no skew term)
                self._delivered.inc()
                origin = self.mesh.origin_tick.get(h)
                if origin is not None and self._prop_hist is not None:
                    self._prop_hist.observe(
                        float(self.mesh._tick_no - origin))
        targets = [c for c in self.conns.values() if c is not source]
        if self.reconciler is not None:
            self.reconciler.route_announcement(h, targets)
        else:
            for c in targets:
                c.tracker.we_should_announce(h)

    # -- inbound dispatch (mirrors BMConnection.cmd_*) ------------------------

    async def dispatch(self, conn: SimConn, command: str,
                       payload: bytes) -> None:
        if command == "inv":
            for h in decode_inv(payload):
                self._handle_announcement(conn, h)
        elif command == "getdata":
            for h in decode_inv(payload):
                item = self.inventory.get(h)
                if item is not None:
                    await conn.send_packet("object", item)
        elif command == "object":
            h = payload[:32]
            self.global_tracker.received(h)
            conn.tracker.object_received(h)
            self.add_object(h, payload, source=conn)
        elif command == "sketchreq" and self.reconciler is not None:
            await self.reconciler.handle_sketchreq(conn, payload)
        elif command == "sketch" and self.reconciler is not None:
            await self.reconciler.handle_sketch(conn, payload)
        elif command == "recondiff" and self.reconciler is not None:
            await self.reconciler.handle_recondiff(conn, payload)

    def _handle_announcement(self, conn: SimConn, h: bytes) -> None:
        conn.tracker.peer_announced(h)
        if self.reconciler is not None:
            self.reconciler.peer_announced(conn, h)
        if h in self.inventory:
            conn.tracker.object_received(h)

    # -- periodic loops (mirrors _inv_once / request_objects) -----------------

    async def inv_tick(self, reconcile: bool = True) -> None:
        for conn in self.conns.values():
            chunk = conn.tracker.take_announcements()
            if chunk:
                await conn.announce(chunk)
        if reconcile and self.reconciler is not None:
            await self.reconciler.tick()

    async def download_tick(self) -> None:
        for conn in self.conns.values():
            wanted = []
            for h in conn.tracker.request_batch(1000):
                if h in self.inventory:
                    conn.tracker.object_received(h)
                elif not self.global_tracker.was_requested(h):
                    wanted.append(h)
            if wanted:
                self.global_tracker.mark_requested(wanted)
                await conn.send_packet("getdata", encode_inv(wanted))


class Mesh:
    """A fully-connected (or custom-edged) mesh of simulated nodes."""

    def __init__(self, n: int, *, edges=None, sync: bool = False,
                 fanout: int = 0, sync_every: int = 1,
                 buckets: int = 2, federation: bool = False,
                 federate_every: int = 8, rng: random.Random | None = None):
        #: the one generator every tracker and reconciler draws from
        self.rng = rng if rng is not None else random.Random()
        self.stats = MeshStats()
        self.queue: deque = deque()
        #: federation mode (distributed observability plane): every
        #: node runs its own registry + a real FederationPublisher
        #: pushing delta snapshots into one Aggregator every
        #: ``federate_every`` ticks — the same code path a
        #: multi-process deployment runs, so the merged propagation /
        #: bytes-per-object figures come from FEDERATED snapshots, not
        #: mesh-global bookkeeping
        self.aggregator: Aggregator | None = None
        self.federate_every = max(1, federate_every)
        #: wall seconds spent inside the federation path (snapshot
        #: build + push + ingest) — the direct overhead measurement
        self.federation_seconds = 0.0
        #: origin tick per injected object (the sim's stand-in for the
        #: wire trace context's origin stamp; one shared tick clock)
        self.origin_tick: dict[bytes, int] = {}
        #: reconciler.tick() runs every Nth mesh tick.  The reconciler
        #: itself staggers rounds (one least-recently-reconciled peer
        #: per tick), which sets the real per-pair cadence — the gap
        #: between a pair's rounds is what lets bilateral pendings form
        #: and cancel in the sketch subtraction.
        self.sync_every = max(1, sync_every)
        #: announcement jitter buckets (tracker decorrelation), applied
        #: to BOTH modes so the flooding baseline keeps its own
        #: echo-suppression window
        self.buckets = max(1, buckets)
        self._tick_no = 0
        #: cross-node propagation tracing: one tracer per mesh on the
        #: simulated tick clock — inject() stamps the origin event,
        #: every delivery at another node observes the tick delta.  The
        #: tracer is mesh-local so flood/sync comparison runs don't
        #: contaminate each other; the process-wide histogram
        #: ``object_propagation_seconds`` still accumulates.
        self.lifecycle = LifecycleTracer(
            maxlen=1 << 16, clock=lambda: float(self._tick_no),
            update_gauge=False)
        self.nodes = [SimNode(i, self) for i in range(n)]
        if edges is None:
            edges = [(a, b) for a in range(n) for b in range(a + 1, n)]
        self.edges = list(edges)
        for a, b in self.edges:
            na, nb = self.nodes[a], self.nodes[b]
            na.conns[b] = SimConn(na, nb, self)
            nb.conns[a] = SimConn(nb, na, self)
        if sync:
            for node in self.nodes:
                # interval=0: sync_every already paces rounds in sim
                # ticks; generous timeout (sim delivery is lossless);
                # short REAL-time breaker cooldown — the production
                # 120 s would pin a tripped breaker open for the whole
                # milliseconds-long simulated run
                node.enable_sync(interval=0.0, fanout=fanout,
                                 round_timeout=300.0,
                                 breaker_cooldown=0.2,
                                 recent_window=8.0)
        if federation:
            self.aggregator = Aggregator(max_nodes=max(n + 1, 4096))
            for node in self.nodes:
                node.enable_federation(self.aggregator)

    def inject(self, origin: int, h: bytes,
               payload: bytes | None = None) -> None:
        """A new object appears at ``origin`` (locally generated)."""
        if payload is None:
            payload = h + b"\xAA" * max(0, SIM_OBJECT_SIZE - 32)
        self.lifecycle.record(h, "received")
        self.origin_tick[h] = self._tick_no
        self.nodes[origin].add_object(h, payload, source=None)

    def seed(self, node: int, hashes) -> None:
        """Pre-existing inventory (held before the mesh 'connected'):
        no announcements are queued — establishment sync covers it."""
        n = self.nodes[node]
        for h in hashes:
            payload = h + b"\xAA" * max(0, SIM_OBJECT_SIZE - 32)
            n.inventory[h] = payload
            if n.digest is not None:
                n.digest.add(h, 1, 1 << 60)

    async def establish(self, links_per_tick: int = 1) -> None:
        """Run the connection-establishment inventory exchange,
        ``links_per_tick`` links per tick (a dial loop connects peers
        sequentially, it does not spring a full mesh into existence at
        once; at lab scale — hundreds of nodes — serial establishment
        would dominate the run, so links come up in small batches):
        IBLT catch-up in sync mode (initiated by the lower-index
        'outbound' end, converges both directions), the reference
        big-inv flood — every pair, BOTH directions — otherwise."""
        links_per_tick = max(1, links_per_tick)
        for i, (a, b) in enumerate(self.edges):
            na, nb = self.nodes[a], self.nodes[b]
            if na.reconciler is not None:
                await na.reconciler.start_catchup(na.conns[b])
            else:
                await na.conns[b].announce(list(na.inventory))
                await nb.conns[a].announce(list(nb.inventory))
            if (i + 1) % links_per_tick == 0 or \
                    i + 1 == len(self.edges):
                await self.tick()

    async def drain(self) -> None:
        """Deliver every queued packet (and the packets those spawn)."""
        guard = 0
        while self.queue:
            guard += 1
            if guard > 5_000_000:
                raise RuntimeError("mesh dispatch did not settle")
            dst, src, command, payload = self.queue.popleft()
            conn = dst.conns[src.index]
            await dst.dispatch(conn, command, payload)

    async def tick(self) -> None:
        """One simulated second: flush announcements, run
        reconciliation rounds on their slower cadence, request
        downloads, settle the wire, push federation snapshots on
        their own cadence."""
        self._tick_no += 1
        reconcile = self._tick_no % self.sync_every == 0
        await self.drain()
        for node in self.nodes:
            await node.inv_tick(reconcile=reconcile)
        await self.drain()
        for node in self.nodes:
            await node.download_tick()
        await self.drain()
        if self.aggregator is not None and \
                self._tick_no % self.federate_every == 0:
            self.federate_once()

    def federate_once(self) -> None:
        """Every node pushes one delta snapshot through the real
        publisher/aggregator path; the wall time spent is accumulated
        as the federation overhead measurement."""
        if self.aggregator is None:
            return
        t0 = time.perf_counter()
        for node in self.nodes:
            if node.publisher is not None:
                node.publisher.push_once()
        self.federation_seconds += time.perf_counter() - t0

    def federated_propagation_percentiles(self) -> dict | None:
        """p50/p90/p99 of origin-to-delivery latency (ticks) from the
        MERGED per-node histograms — the cross-node view a fleet
        operator would scrape from the aggregator, not mesh-global
        bookkeeping."""
        if self.aggregator is None:
            return None
        count = self.aggregator.merged_value("mesh_propagation_seconds")
        if not count:
            return None
        return {"count": int(count),
                "p50": round(self.aggregator.merged_percentile(
                    "mesh_propagation_seconds", 0.50), 2),
                "p90": round(self.aggregator.merged_percentile(
                    "mesh_propagation_seconds", 0.90), 2),
                "p99": round(self.aggregator.merged_percentile(
                    "mesh_propagation_seconds", 0.99), 2)}

    def federated_bytes_per_delivered(self) -> float | None:
        """Announcement-layer bytes per delivered object from merged
        per-node counters."""
        if self.aggregator is None:
            return None
        delivered = self.aggregator.merged_value(
            "mesh_delivered_objects_total")
        if not delivered:
            return None
        return self.aggregator.merged_value(
            "mesh_announce_bytes_total") / delivered

    def converged(self) -> bool:
        union: set[bytes] = set()
        for node in self.nodes:
            union |= node.inventory.keys()
        return all(node.inventory.keys() == union for node in self.nodes)

    async def run_until_converged(self, max_ticks: int = 200) -> int:
        """Tick until every node holds the full object set; returns the
        tick count.  Raises when the mesh fails to converge — an object
        was lost, which no mode is ever allowed to do."""
        for i in range(max_ticks):
            await self.tick()
            if self.converged() and not self.queue:
                # a couple of settle ticks: pending reconciliation
                # rounds may still be exchanging (empty) diffs
                return i + 1
        raise AssertionError(
            "mesh did not converge within %d ticks (inventories: %s)"
            % (max_ticks, [len(n.inventory) for n in self.nodes]))

    def pending_total(self) -> int:
        return sum(n.reconciler.pending_count() for n in self.nodes
                   if n.reconciler is not None)
