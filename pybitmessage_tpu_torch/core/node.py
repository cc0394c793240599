"""The Node application object: storage + network + workers, wired to
the card (copy of ``pybitmessage_tpu.core.node``, with the JAX node's
three inventory backends and the ``all``, ``edge``, ``relay`` and
``client`` roles).

Startup order mirrors the reference (bitmessagemain.py:85-287): storage
first, key caches, workers, then networking; shutdown unwinds in
reverse with an inventory flush and knownnodes persistence
(shutdown.py:19-91).

Every device service is built for ``device`` (``None``: the CUDA card,
raising without one; ``"cpu"``: the kernels' plain torch versions):
``PowService(PowDispatcher)`` for every PoW the sender needs,
``BatchVerifier`` for every received object's PoW, and the
``BatchCryptoEngine`` for every trial decrypt and signature check of the
ingest path; identities are ground through ``priv_to_pub_many``.
``crypto_batch=False`` asks for host threads for the secp work instead.

Objects enter from peers over TCP (``network.pool.ConnectionPool``:
listen on ``port``, ``pool.connect_to``), or through
``network.connection.accept_object(node.ctx, node.pool, payload)`` for
a caller without a socket.  UI events go out on ``node.ui`` (a
``UISignaler``); the ``Cleaner`` runs with the node.  The daemon
(``python -m pybitmessage_tpu_torch``) sets ``node.settings`` and serves
the API over it.  The node runs the health probes (``self.health``:
loop lag, saturation gauges, the ``clientStatus`` health block), names
itself in the flight recorder and logs a metrics snapshot a minute.

Every solve goes through the crash-safe PoW journal (``pow_journal``:
``powjournal.dat`` in the data directory, in memory without one), so a
node killed mid-solve resumes from the checkpoint.  ``farm_connect``
("host:port") puts a ``FarmSolverTier`` in front of the card in the
dispatcher (this node's PoW is delegated to a shared farm);
``farm_listen`` serves PoW-as-a-service to other nodes (``FarmServer``
over the node's dispatcher, its journal ``farmjournal.dat``).
``role`` splits the node (``roles/``): an ``edge`` keeps an
``EdgeCache`` in place of the inventory, checks every received object's
PoW on its ``BatchVerifier`` and hands it over role IPC
(``role_ipc_connect``: "host:port,...") to the relay owning its stream;
a ``relay`` serves role IPC on ``role_ipc_listen``, does not listen for
P2P, and stores, processes and sends for its streams
(``role_streams``, the fused node's too; default ``(stream,)``).
``client_listen`` ("host:port") serves the light-client plane
(``roles/subscription.py`` ``ClientPlane``, ``client_buckets`` digest
buckets), fed from the ingest pump, the sender's publishes and, on an
edge, the relay's pushes; ``role="client"`` is a light client
(``roles/client.py`` ``LightClient``) of the plane at ``client_connect``,
trial-decrypting on its own ``BatchCryptoEngine``.  ``start`` tells the
sampling profiler which thread runs the event loop.

Three network-plane features run by default, as in the JAX node:
``sync_enabled`` advertises NODE_SYNC and attaches a ``Reconciler``
(``sync/``) over an ``InventoryDigest`` the inventory keeps current (a
relay's digest covers only its own streams; edges do not reconcile);
``wiretrace_enabled`` advertises NODE_TRACE, so object pushes and sync
rounds carry trace contexts to peers that advertise it too; and
``federation_enabled`` runs a metrics ``Aggregator`` with this node's
own ``FederationPublisher`` pushing into it (``GET
/metrics/federated``, ``federatedStatus``).  ``mean_skew`` (the mean of
the connections' clock-offset estimates) feeds the pushes and the
flight recorder's dumps.

``tls_enabled`` (on by default, as in the JAX node) writes a self-signed
certificate (``data_dir/tls``, or a temporary directory) and advertises
NODE_SSL, so connections to peers that advertise it too upgrade to TLS
after the veracks.  ``udp_enabled`` (off by default, as in the JAX node;
the daemon turns it on from ``udp``) runs LAN discovery
(``network/udp.py``) on the listening port.  Before the engine's first
drain, ``start`` builds and loads its native rung's library off the
event loop.  A SOCKS proxy is ``ctx.proxy``; UPnP is the daemon's.  An
identity registered with an email gateway operator
(``set_email_gateway``) sends its commands (``email_gateway_command``)
and email (``send_email``) as ordinary messages to the operator's
service addresses; the SMTP server and deliverer
(``gateways/``) are the daemon's, held in ``smtp_gateway`` and
``smtp_deliverer``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
from pathlib import Path

from .. import resolve_device
from ..crypto.keys import priv_to_pub_many
from ..gateways.email_account import (EmailGatewayAccount,
                                      spec_for_identity)
from ..models.constants import NODE_SYNC, NODE_TRACE
from ..models.payloads import gen_ack_payload
from ..network.dandelion import Dandelion
from ..network.pool import ConnectionPool, NodeContext
from ..observability import (FLIGHT_RECORDER, PROFILER, Aggregator,
                             FederationPublisher, HealthMonitor,
                             log_snapshot_task)
from ..pow.dispatcher import PowDispatcher
from ..pow.service import PowService
from ..pow.verify_service import BatchVerifier
from ..powfarm import FarmJournal, FarmServer, FarmSolverTier
from ..resilience.journal import PowJournal
from ..roles import get_role
from ..storage.db import Database
from ..storage.fs_inventory import FilesystemInventory
from ..storage.inventory import Inventory
from ..storage.knownnodes import KnownNodes
from ..storage.messages import MessageStore
from ..storage.slabstore import SlabStore
from ..sync import InventoryDigest, Reconciler
from ..utils.addresses import decode_address
from ..workers.cleaner import Cleaner
from ..workers.cryptopool import CryptoPool
from ..workers.keystore import KeyStore
from ..workers.processor import ObjectProcessor
from ..workers.sender import SendWorker
from .uisignal import UISignaler

logger = logging.getLogger("pybitmessage_tpu_torch.node")


class Node:
    """A Bitmessage node on one device.

    ``data_dir=None`` keeps everything in memory (tests); a directory
    holds ``keys.dat``, ``messages.dat`` and ``knownnodes.json`` in the
    JAX package's formats.  ``port`` is the TCP port it listens on
    (0: any free one; ``pool.listen_port`` says which) when ``listen``;
    ``allow_private_peers`` lets addr gossip add loopback and private
    hosts to the known nodes.  ``test_mode`` divides the consensus
    difficulty by 100 and shrinks the announce jitter to 2 s;
    ``pow_window`` is the PowService coalescing window.  ``farm_listen``
    and ``farm_connect`` ("host:port", port 0 for any free one when
    listening) serve a PoW farm and delegate to one, under
    ``farm_tenant`` signed with ``farm_secret``.  ``role``,
    ``role_streams``, ``role_ipc_listen`` and ``role_ipc_connect`` make
    it an edge or a relay.  ``client_listen`` serves the light-client
    plane over ``client_buckets`` buckets; ``role="client"`` needs
    ``client_connect``, the ``host:port`` of an edge's plane.
    ``sync_enabled``, ``wiretrace_enabled`` and ``federation_enabled``
    (all on by default) run set-reconciliation sync, the wire trace and
    the metrics federation aggregator; ``tls_enabled`` (on) NODE_SSL and
    ``udp_enabled`` (off) LAN discovery.

    ``inventory_backend`` chooses the inventory of a role that owns
    storage, as the JAX node does: ``"sqlite"`` (``messages.dat``),
    ``"filesystem"`` (one file per object under ``inventory/``; SQLite
    without a ``data_dir``, said in one log line) or ``"slab"`` (the
    slab store under ``slabs/``, in RAM without a ``data_dir``; tuned
    by ``slab_max_bytes``, ``slab_hot_bytes`` and
    ``slab_bucket_seconds``).  The sync digest is attached only to a
    backend that keeps one (``attach_digest``): a node on
    ``filesystem`` reconciles without a digest, as in the JAX package.
    """

    def __init__(self, data_dir: str | None = None, *,
                 port: int = 0, listen: bool = True,
                 dandelion_enabled: bool = True,
                 allow_private_peers: bool = False,
                 stream: int = 1, test_mode: bool = False,
                 tls_enabled: bool = True, udp_enabled: bool = False,
                 pow_window: float | None = None, device=None,
                 sync_enabled: bool = True,
                 wiretrace_enabled: bool = True,
                 federation_enabled: bool = True,
                 crypto_batch: bool = True, farm_listen: str | None = None,
                 farm_connect: str | None = None,
                 farm_tenant: str = "default", farm_secret: str = "",
                 role: str = "all",
                 role_streams: tuple[int, ...] | None = None,
                 role_ipc_listen: str | None = None,
                 role_ipc_connect: str | None = None,
                 client_listen: str | None = None,
                 client_connect: str | None = None,
                 client_buckets: int = 64,
                 inventory_backend: str = "sqlite",
                 slab_max_bytes: int = 4 << 20,
                 slab_hot_bytes: int = 8 << 20,
                 slab_bucket_seconds: int = 3600):
        self.role = role
        self.role_spec = spec = get_role(role)
        if role == "client" and not client_connect:
            raise ValueError(
                "client role needs clientconnect (host:port of an edge's "
                "clientplanelisten)")
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir) if data_dir else None
        if self.data_dir:
            self.data_dir.mkdir(parents=True, exist_ok=True)
        db_path = str(self.data_dir / "messages.dat") if self.data_dir \
            else ":memory:"
        keys_path = self.data_dir / "keys.dat" if self.data_dir else None
        nodes_path = self.data_dir / "knownnodes.json" if self.data_dir \
            else None

        # test mode divides the consensus difficulty by 100
        # (reference bitmessagemain.py:167-172)
        min_ntpb = 1000 // 100 if test_mode else 1000
        min_extra = 1000 // 100 if test_mode else 1000

        self.shutdown = asyncio.Event()
        self.db = Database(db_path)
        self.store = MessageStore(self.db)
        if inventory_backend not in ("sqlite", "filesystem", "slab"):
            raise ValueError("inventory backend %r: not sqlite, "
                             "filesystem or slab" % (inventory_backend,))
        if not spec.owns_storage:
            # edge: a bounded dedupe/serve cache; the shard's relay owns
            # the inventory
            from ..roles.edge import EdgeCache
            self.inventory = EdgeCache()
        elif inventory_backend == "filesystem" and self.data_dir:
            self.inventory = FilesystemInventory(self.data_dir / "inventory")
        elif inventory_backend == "slab":
            # memory-resident without a data_dir
            self.inventory = SlabStore(
                self.data_dir / "slabs" if self.data_dir else None,
                slab_max_bytes=slab_max_bytes, hot_bytes=slab_hot_bytes,
                bucket_seconds=slab_bucket_seconds)
        else:
            if inventory_backend == "filesystem":
                logger.info("inventory: filesystem needs a data "
                            "directory; using SQLite in memory")
            self.inventory = Inventory(self.db)
        derive = None
        if crypto_batch:
            def derive(privkeys, _device=self.device):
                return priv_to_pub_many(privkeys, _device)
        self.keystore = KeyStore(keys_path, derive=derive)
        self.knownnodes = KnownNodes(nodes_path)
        self.dandelion = Dandelion(enabled=dandelion_enabled)
        #: incoming-object PoW checks batched onto the device
        self.pow_verifier = BatchVerifier(
            self.device, ntpb=min_ntpb, extra=min_extra, clamp=False)
        self.ctx = NodeContext(
            inventory=self.inventory, pow_verifier=self.pow_verifier,
            knownnodes=self.knownnodes, dandelion=self.dandelion,
            streams=tuple(role_streams) if role_streams else (stream,),
            port=port,
            allow_private_peers=allow_private_peers,
            # test mode keeps the announce jitter but shrinks it so
            # multi-hop flows stay inside test timeouts
            announce_buckets=2 if test_mode else None)
        self.pool = ConnectionPool(self.ctx)
        self.pool.reuse_port = spec.reuse_port
        self.listen = listen and spec.listens_p2p
        #: set-reconciliation sync: sketch exchanges replace most
        #: per-object inv flooding for NODE_SYNC peers.  Edges don't
        #: reconcile — sync is shard (relay) authority.
        self.reconciler = None
        self.sync_digest = None
        if sync_enabled and spec.runs_sync:
            # a sharded relay's digest is restricted to its own streams
            # — the shard boundary
            if hasattr(self.inventory, "attach_digest"):
                self.sync_digest = InventoryDigest(
                    streams=set(self.ctx.streams) if role == "relay"
                    else None)
                self.inventory.attach_digest(self.sync_digest)
            self.reconciler = Reconciler(self.pool, digest=self.sync_digest)
            self.pool.reconciler = self.reconciler
            self.ctx.services |= NODE_SYNC
        if wiretrace_enabled:
            # NODE_TRACE: sync rounds and object pushes carry trace
            # contexts to negotiating peers; legacy peers see nothing
            self.ctx.services |= NODE_TRACE
        if tls_enabled:
            # opportunistic NODE_SSL: an ephemeral, unverified
            # certificate — confidentiality only
            self.ctx.enable_tls(
                self.data_dir / "tls" if self.data_dir else None)
        self.udp = None
        if udp_enabled and self.listen:
            # a node that does not listen has nothing to announce
            from ..network.udp import UDPDiscovery
            self.udp = UDPDiscovery(self.pool)
        self.solver = PowDispatcher(self.device)
        #: crash-safe PoW job journal: queued and in-flight solves
        #: survive a restart and resume from their checkpointed offset
        self.pow_journal = PowJournal(
            str(self.data_dir / "powjournal.dat") if self.data_dir
            else ":memory:")
        pending = self.pow_journal.pending_count()
        if pending:
            logger.info("PoW journal: %d job(s) survived restart and "
                        "will resume from their checkpoints", pending)
        self.pow_service = PowService(self.solver, shutdown=self.shutdown,
                                      window=pow_window,
                                      journal=self.pow_journal)
        #: the PoW solver farm: delegate this node's PoW to a shared
        #: farm (the dispatcher's top rung) and/or serve other nodes
        self.farm_client = None
        if farm_connect:
            fhost, _, fport = str(farm_connect).rpartition(":")
            self.farm_client = FarmSolverTier(
                fhost or "127.0.0.1", int(fport), tenant=farm_tenant,
                secret=farm_secret.encode("utf-8") if farm_secret else b"")
            self.solver.attach_farm(self.farm_client)
        self.farm_server = None
        self.farm_journal = None
        if farm_listen:
            fhost, _, fport = str(farm_listen).rpartition(":")
            self.farm_journal = FarmJournal(
                str(self.data_dir / "farmjournal.dat") if self.data_dir
                else ":memory:")
            self.farm_server = FarmServer(
                self.solver, journal=self.farm_journal,
                host=fhost or "127.0.0.1", port=int(fport))
        #: the ingest path's crypto route, shared by the sender's pubkey
        #: lookups and the processor
        self.crypto = CryptoPool()
        if crypto_batch:
            from ..crypto.batch import BatchCryptoEngine
            self.crypto.batch = BatchCryptoEngine(self.device)
        self.ui = UISignaler()
        self.sender = SendWorker(
            keystore=self.keystore, store=self.store,
            inventory=self.inventory, pool=self.pool,
            pow_service=self.pow_service, crypto=self.crypto,
            shutdown=self.shutdown, min_ntpb=min_ntpb, min_extra=min_extra,
            ui_signal=self.ui.emit)
        self.processor = ObjectProcessor(
            keystore=self.keystore, store=self.store,
            inventory=self.inventory, sender=self.sender, pool=self.pool,
            shutdown=self.shutdown, min_ntpb=min_ntpb, min_extra=min_extra,
            crypto=self.crypto, ui_signal=self.ui.emit,
            knownnodes=self.knownnodes)
        self.cleaner = Cleaner(
            inventory=self.inventory, store=self.store,
            knownnodes=self.knownnodes, sender=self.sender, pool=self.pool,
            shutdown=self.shutdown)
        #: the daemon's ``core.config.Settings`` (None outside it)
        self.settings = None
        #: the daemon's SMTP server and deliverer (``smtpdenabled``,
        #: ``smtpdeliver``; None outside it or when off)
        self.smtp_gateway = None
        self.smtp_deliverer = None
        self._pump_task: asyncio.Task | None = None
        self._metrics_task: asyncio.Task | None = None
        #: always-on runtime health probes: event-loop lag sampler,
        #: saturation gauges and the clientStatus health block
        self.health = HealthMonitor(self)
        #: this node's identity in flight-recorder dumps and role IPC
        self.node_id = self.ctx.nonce.hex()
        FLIGHT_RECORDER.node_id = self.node_id
        #: fleet aggregator + this node's own snapshot publisher: the
        #: aggregator merges pushes from other processes (POST
        #: /federation/push) and this process publishes itself into it
        #: in-process, so ``GET /metrics/federated`` and
        #: ``federatedStatus`` always include the local node
        self.federation = None
        self.federation_publisher = None
        if federation_enabled:
            self.federation = Aggregator()
            self.federation_publisher = FederationPublisher(
                self.node_id, transport=self.federation.ingest,
                health=self.health.health_block, skew=self.mean_skew,
                # in-process transport: no wire bytes to account for
                count_bytes=False)
            FLIGHT_RECORDER.skew_provider = self.mean_skew
        #: an edge's relay links or a relay's IPC server; None fused
        self.role_runtime = None
        if spec.forwards_ingest:
            from ..roles.edge import EdgeRuntime
            self.role_runtime = EdgeRuntime(self, role_ipc_connect or "")
        elif spec.serves_ipc:
            if not role_ipc_listen:
                raise ValueError(
                    "relay role needs roleipclisten (port or host:port)")
            from ..roles.relay import RelayRuntime
            self.role_runtime = RelayRuntime(self, role_ipc_listen)
        #: the light-client tier: an edge's plane serving store-nothing
        #: clients, or this node's own client of one edge's plane
        self.client_plane = None
        self.light_client = None
        self.client_crypto = None
        if client_listen:
            from ..roles.subscription import ClientPlane
            self.client_plane = ClientPlane(
                self, client_listen, buckets=client_buckets)
            self.sender.on_publish = self.client_plane.on_record
        if role == "client":
            from ..crypto.batch import BatchCryptoEngine
            from ..roles.client import LightClient
            self.client_crypto = BatchCryptoEngine(self.device)
            self.light_client = LightClient(
                client_connect,
                client_id=self.ctx.nonce.hex()[:16],
                tenant=farm_tenant if farm_tenant != "default" else None,
                streams=self.ctx.streams, buckets=client_buckets,
                crypto=self.client_crypto)

            def _sync_client_keys() -> None:
                self.light_client.set_keys(
                    identities=self.keystore.identities.values(),
                    subscriptions=self.keystore.active_subscriptions())
            self.keystore.add_change_listener(_sync_client_keys)
            _sync_client_keys()

    def set_streams(self, streams) -> None:
        """Adopt a new shard map mid-session (a relay's live acquire or
        shed): the streams this node accepts, stores and announces.
        The sync digest is re-scoped and re-seeded from the inventory,
        so an acquired stream's stored objects enter the announce view
        and a shed stream's leave it."""
        self.ctx.streams = tuple(sorted(set(streams)))
        # a sync digest exists only over a backend that keeps one
        if self.sync_digest is not None:
            self.sync_digest.streams = set(self.ctx.streams)
            self.inventory.attach_digest(self.sync_digest)

    def mean_skew(self) -> float:
        """This node's clock-offset estimate vs its peers: the mean of
        the per-connection wire-trace skew estimators (0.0 without
        samples) — recorded in snapshot pushes and flight dumps so
        multi-node telemetry normalizes onto one clock."""
        offsets = [c.skew.offset() for c in self.pool.established()
                   if c.skew.samples]
        return sum(offsets) / len(offsets) if offsets else 0.0

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        # the sampling profiler's event_loop thread class and the loop
        # lag probe's culprit key off the thread that runs the loop
        PROFILER.note_loop_thread()
        self.pow_service.start()
        self.pow_verifier.start()
        self.sender.start()
        self.processor.start()
        self.cleaner.start()
        for engine in (self.crypto.batch, self.client_crypto):
            if engine is not None:
                await engine.load_native()
        await self.pool.start(listen=self.listen)
        if self.role_runtime is not None:
            await self.role_runtime.start()
        if self.udp is not None:
            # discovery shares the port the pool listens on
            self.udp.port = self.pool.listen_port
            await self.udp.start()
        self._pump_task = asyncio.create_task(self._pump_objects())
        # one structured log line a minute with the metrics that changed
        self._metrics_task = asyncio.create_task(log_snapshot_task(60.0))
        self.health.start()
        if self.federation_publisher is not None:
            self.federation_publisher.start()
        if self.farm_server is not None:
            await self.farm_server.start()
        if self.client_plane is not None:
            await self.client_plane.start()
        if self.light_client is not None:
            self.client_crypto.start()
            await self.light_client.start()
        logger.info("node started on %s (port %s)", self.device,
                    self.pool.listen_port if self.listen else "-")

    async def _pump_objects(self) -> None:
        """Forward validated objects to the processor, or on an edge
        over role IPC to the stream's relay (the hand-off awaits outbox
        headroom, so a relay's backpressure reaches the watermarked
        object queue and pauses connection reads)."""
        forwards = self.role_spec.forwards_ingest
        while not self.shutdown.is_set():
            h, header, payload = await self.ctx.object_queue.get()
            if self.client_plane is not None:
                # one index probe and a fan-out to the matched clients
                self.client_plane.on_object(h, header, payload)
            if forwards:
                await self.role_runtime.handoff(h, header, payload)
            else:
                await self.processor.queue.put(payload)

    async def stop(self) -> None:
        """Orderly shutdown (reference shutdown.py:19-91).  The
        connections close first; the processor persists what it has
        not processed, for the next node on this ``data_dir``; objects
        still between acceptance and the processor go with them.  An
        edge flushes its outbox to its relays (bounded); a relay stops
        serving role IPC before the processor drains."""
        self.shutdown.set()
        if self.light_client is not None:
            await self.light_client.stop()
            await self.client_crypto.stop()
        if self.client_plane is not None:
            await self.client_plane.stop()
        if self.federation_publisher is not None:
            await self.federation_publisher.stop()
        await self.health.stop()
        for task in (self._pump_task, self._metrics_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._pump_task = self._metrics_task = None
        if self.udp is not None:
            await self.udp.stop()
        await self.pool.stop()
        if self.role_runtime is not None:
            await self.role_runtime.stop()
        while not self.ctx.object_queue.empty():
            _, _, payload = self.ctx.object_queue.get_nowait()
            self.processor.queue.put_nowait(payload)
        await self.sender.stop()
        await self.processor.stop()
        await self.cleaner.stop()
        if self.farm_server is not None:
            await self.farm_server.stop()
        if self.farm_client is not None:
            self.farm_client.close()
        await self.pow_service.stop()
        await self.pow_verifier.stop()
        self.inventory.flush()
        self.knownnodes.save()
        if self.farm_journal is not None:
            self.farm_journal.close()
        self.pow_journal.close()
        self.db.close()
        if self.data_dir is None and self.ctx.tls_files is not None:
            # the certificate of a node without a data directory lives
            # in a temporary directory of its own
            shutil.rmtree(os.path.dirname(self.ctx.tls_files[0]),
                          ignore_errors=True)
        logger.info("node stopped")

    # -- high-level API ------------------------------------------------------

    def create_identity(self, label: str = "", *, deterministic: bytes | None
                        = None, chan: bool = False):
        if deterministic is not None:
            return self.keystore.create_deterministic(
                deterministic, label, chan=chan)
        return self.keystore.create_random(label)

    async def send_message(self, to_address: str, from_address: str,
                           subject: str, body: str, *,
                           ttl: int = 4 * 24 * 3600,
                           encoding: int = 2) -> bytes:
        """Queue a message; returns its ackdata handle."""
        to = decode_address(to_address)  # validates
        ack = gen_ack_payload(to.stream, 0)
        self.store.queue_sent(
            msgid=os.urandom(16), toaddress=to_address, toripe=to.ripe,
            fromaddress=from_address, subject=subject, message=body,
            ackdata=ack, ttl=ttl, encoding=encoding)
        await self.sender.queue.put(("sendmessage",))
        return ack

    async def send_broadcast(self, from_address: str, subject: str,
                             body: str, *, ttl: int = 4 * 24 * 3600,
                             encoding: int = 2) -> bytes:
        return self.sender.queue_broadcast(from_address, subject, body,
                                           ttl=ttl, encoding=encoding)

    def message_status(self, ackdata: bytes) -> str:
        m = self.store.sent_by_ackdata(ackdata)
        return m.status if m else "notfound"

    # -- email gateway (reference bitmessageqt/account.py:185-345) -----------

    def set_email_gateway(self, address: str, gateway: str, *,
                          registration: str = "", unregistration: str = "",
                          relay: str = "") -> None:
        """Mark one of our identities as registered with an email
        gateway operator (the reference's per-address 'gateway' config
        key); empty ``gateway`` clears it."""
        ident = self.keystore.get(address)
        if ident is None:
            raise KeyError("unknown identity %s" % address)
        ident.gateway = gateway
        ident.gateway_registration = registration
        ident.gateway_unregistration = unregistration
        ident.gateway_relay = relay
        self.keystore.save()

    def _gateway_account(self, address: str) -> EmailGatewayAccount:
        ident = self.keystore.get(address)
        if ident is None:
            raise KeyError("unknown identity %s" % address)
        spec = spec_for_identity(ident)
        if spec is None:
            raise KeyError("%s is not registered with an email gateway"
                           % address)
        return EmailGatewayAccount(address, spec)

    async def email_gateway_command(self, address: str, action: str,
                                    email: str = "") -> bytes:
        """Send a register/unregister/status/settings command message
        to the identity's gateway; returns the ackdata handle."""
        acct = self._gateway_account(address)
        try:
            cmd = {"register": lambda: acct.register(email),
                   "unregister": acct.unregister,
                   "status": acct.status,
                   "settings": acct.settings}[action]()
        except KeyError:
            raise ValueError("unknown gateway action %r" % action)
        return await self.send_message(cmd.to_address, address,
                                       cmd.subject, cmd.body,
                                       ttl=cmd.ttl)

    async def send_email(self, from_address: str, to_email: str,
                         subject: str, body: str) -> bytes:
        """Send an email through the registered gateway's relay."""
        acct = self._gateway_account(from_address)
        cmd = acct.compose_email(to_email, subject, body)
        return await self.send_message(cmd.to_address, from_address,
                                       cmd.subject, cmd.body,
                                       ttl=cmd.ttl)
