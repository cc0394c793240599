"""Daemon entry point: ``python -m pybitmessage_tpu_torch`` (copy of
``pybitmessage_tpu.__main__``: the fused ``all`` node, an ``edge`` or a
``relay``).

Reference: src/bitmessagemain.py Main.start() — single process, clean
shutdown on SIGINT/SIGTERM, optional test mode (-t) and trusted peer;
configuration layered as defaults <- settings.dat <- CLI flags
(reference bmconfigparser + helper_startup.loadConfig).

The node runs on the CUDA device unless ``--device cpu`` asks for the
kernels' plain torch versions; without a card and without that flag the
daemon exits 1.  A setting that turns on a subsystem this package does
not have (``REFUSED``) stops the start with exit 1, as does a ``chaos``
spec naming an injection site outside the JAX catalog; a subsystem the
JAX package runs by default and this one does not would be named in one
warning line at startup (``NOT_RUN``, empty: every JAX default runs).
The rest of the network is applied as the JAX daemon applies it:
opportunistic TLS (``tls``), UDP LAN discovery (``udp``; ``--no-udp``
and ``--no-listen`` turn it off), SOCKS5 and SOCKS4a dials
(``sockstype``, ``sockshostname``, ``socksport``, ``socksusername``,
``sockspassword``), a ``sockstype`` naming a proxyconfig plugin (the
shipped ``stem``: adopt or launch a Tor, ``sockslisten``,
``torcontrolport`` and ``onionservicekey*`` for its hidden service; a
plugin that fails exits 1 before anything starts, since proxied traffic
must never go out unproxied), the onion endpoint the sender announces
as an ONIONPEER object (``onionhostname``, lowercased, ``onionport``,
after the plugin) and the UPnP mapping of the listening port (``upnp``,
deleted at stop; a gateway that does not answer costs a warning).  So
are the email gateway's SMTP server (``smtpdenabled``, ``smtpdport``,
``smtpdusername``, ``smtpdpassword``) and deliverer (``smtpdeliver``),
the new-message sound (``notifysound``, ``notifysoundfile``) and
``--populate-test-data``.  So are the receive-side crypto rungs:
``cryptotpu`` (``auto`` and ``on`` run the card rung on the node's
device, ``off`` never) for drains of at least ``cryptotpubatchmin``
checks and ECDH pairs, ``cryptonative`` and ``cryptonativethreads``
(the native library, built at start) for smaller ones, and the
coalescing window ``cryptobatchwindow``.  The PoW farm
(``powfarmlisten``, ``powfarmconnect`` and their knobs), ``powmaxretries``
and ``powstalltimeout``, the ingest knobs (``cryptoworkers``,
``cryptodrainmax``, ``ingestqueuehigh``) and the sampling profiler
(``profiling``, ``profilehz``) are applied as the JAX daemon applies
them, and so are the roles (``role=edge|relay|client``, ``rolestreams``,
``roleipclisten``, ``roleipcconnect``; ``edgeprocs`` above 1 shares the
P2P port through ``SO_REUSEPORT``), the inventory backend
(``inventorystorage=sqlite|filesystem|slab``, ``slabmaxbytes``,
``slabhotbytes``, ``slabbucketseconds``), the light-client tier
(``clientplanelisten`` on an edge, ``clientconnect`` on a client,
``clientbuckets``) and the network plane the JAX daemon runs by
default: set-reconciliation sync (``syncenabled``, ``syncinterval``,
``syncfanout``; the sync breakers take ``breakerfailures`` and
``breakercooldown``), the wire trace (``wiretrace``) and metrics
federation (``federation``, ``federationinterval``, and
``federationpush``: this node's snapshots pushed to a parent's API as
well as to its own aggregator).  A split deployment on one host::

    python -m pybitmessage_tpu_torch -d R1 --set role=relay \
        --set rolestreams=1,2 --set roleipclisten=127.0.0.1:8460 ...
    python -m pybitmessage_tpu_torch -d E1 -p 8444 --set role=edge \
        --set edgeprocs=2 --set rolestreams=1,2 \
        --set roleipcconnect=127.0.0.1:8460 \
        --set clientplanelisten=127.0.0.1:8470 ...   (E2 the same)
    python -m pybitmessage_tpu_torch -d C --set role=client \
        --set clientconnect=127.0.0.1:8470 ...

Every key of the JAX package's ``DEFAULTS`` is in this package's
``core.config.DEFAULTS``, in :data:`REFUSED`, in :data:`NOT_RUN`, in
:data:`IGNORED_WHILE_OFF` or in :data:`FRONTEND_ONLY`.

At its stop the daemon logs one ``kernel launches at stop:`` line, a
JSON object with its kernel wrappers' launch counts beside the device
telemetry's ``device_launches_total`` of each program, so a caller can
hold the two to each other for the whole life of the process.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import sys
from pathlib import Path


def _changed(default: str):
    """Set to anything but the JAX package's default."""
    return lambda value: value != default


#: option -> (the JAX package's default, "turns on a subsystem the port
#: lacks"): any of these set so refuses the start, since running
#: without the subsystem would not be what the setting asked for.  Left:
#: the JAX XLA tier's slab shape, which has nothing to set on the card
REFUSED = {
    "powlanes": ("131072", _changed("131072")),
    "powchunks": ("32", _changed("32")),
}

#: option -> (the JAX package's default, "on"): subsystems the JAX
#: package runs by default and this package does not run (none left)
NOT_RUN: dict = {}

#: option -> the switch (a key of :data:`REFUSED` or :data:`NOT_RUN`)
#: of the subsystem it tunes: that subsystem does not run here, so the
#: option has nothing to tune and, set alone, neither refuses the start
#: nor warns (the switch does either).  None left: the knobs of the
#: proxy plugin, the SMTP server and the sound are applied
IGNORED_WHILE_OFF: dict = {}

#: the JAX package's settings that no daemon code of it reads: the
#: front-ends' (``ttl``, ``userlocale``) and the reference settings
#: dialog's, kept in ``settings.dat`` for them
FRONTEND_ONLY = (
    "ttl", "userlocale", "stopresendingafterxdays",
    "stopresendingafterxmonths", "apiinterface", "apivariant",
    "minimizeonclose", "replybelow", "timeformat", "socksauthentication",
    "namecoinrpctype", "namecoinrpchost", "namecoinrpcport",
    "namecoinrpcuser", "namecoinrpcpassword",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pybitmessage_tpu_torch",
        description="Bitmessage node on an NVIDIA GPU (PyTorch + CUDA)")
    p.add_argument("-d", "--data-dir", default=None,
                   help="data directory (default: in-memory; "
                        "--appdata uses ~/.config/pybitmessage-tpu "
                        "or $BITMESSAGE_HOME)")
    p.add_argument("--appdata", action="store_true",
                   help="persist to the standard appdata directory")
    p.add_argument("--daemon", action="store_true",
                   help="detach from the terminal (double fork)")
    p.add_argument("--device", default=None,
                   help="torch device of the node (default: the CUDA "
                        "device; 'cpu' runs the kernels' plain torch "
                        "versions)")
    p.add_argument("-p", "--port", type=int, default=None,
                   help="P2P listen port (default from settings: 8444)")
    p.add_argument("--no-listen", action="store_true",
                   help="outbound connections only")
    p.add_argument("--api-port", type=int, default=None)
    p.add_argument("--no-api", action="store_true")
    p.add_argument("--api-user", default="")
    p.add_argument("--api-password", default="")
    p.add_argument("-t", "--test-mode", action="store_true",
                   help="divide PoW difficulty by 100 (reference -t)")
    p.add_argument("--trusted-peer", default=None, metavar="HOST:PORT",
                   help="connect only to this peer")
    p.add_argument("--no-dandelion", action="store_true")
    p.add_argument("--no-udp", action="store_true",
                   help="disable UDP LAN discovery")
    p.add_argument("--populate-test-data", action="store_true",
                   help="seed a deterministic identity + sample inbox "
                        "message (reference testmode_init role)")
    p.add_argument("--seed-defaults", action="store_true",
                   help="seed the bootstrap nodes into knownnodes")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE", dest="set_options",
                   help="persist a settings option and continue")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def load_settings(args):
    """defaults <- settings.dat <- --set <- per-flag CLI overrides."""
    from .core.config import Settings

    path = Path(args.data_dir) / "settings.dat" if args.data_dir else None
    settings = Settings(path)
    for kv in args.set_options:
        key, _, value = kv.partition("=")
        settings.set(key.strip(), value.strip())
    if args.set_options:
        settings.save()
    if args.port is not None:
        settings.set_temp("port", args.port)
    if args.api_port is not None:
        settings.set_temp("apiport", args.api_port)
    if args.api_user:
        settings.set_temp("apiusername", args.api_user)
    if args.api_password:
        settings.set_temp("apipassword", args.api_password)
    if args.api_user and args.api_password and not args.no_api:
        settings.set_temp("apienabled", True)
    if args.no_dandelion:
        settings.set_temp("dandelion", 0)
    if args.no_udp or args.no_listen:
        settings.set_temp("udp", False)
    return settings


def refused_options(settings) -> list[str]:
    """``key=value`` of every set option in :data:`REFUSED`."""
    out = []
    for key, (default, turns_on) in REFUSED.items():
        value = settings.get(key, default)
        if turns_on(value):
            out.append("%s=%s" % (key, value))
    return out


def not_run_options(settings) -> list[str]:
    """The options of :data:`NOT_RUN` that are on."""
    return [key for key, (default, on) in NOT_RUN.items()
            if on(settings.get(key, default))]


def launch_record() -> dict:
    """The kernel wrappers' ``LAUNCHES`` (zeros for a wrapper never
    imported) beside the registry's ``device_launches_total`` of each
    program and the PoW verifier's device batches."""
    from .observability import REGISTRY
    wrappers = {}
    for module, names in (
            ("pybitmessage_tpu_torch.ops.sha512_cuda",
             ("search", "batch_search", "packed_search")),
            ("pybitmessage_tpu_torch.ops.secp256k1_cuda",
             ("secp_verify", "secp_ecdh"))):
        mod = sys.modules.get(module)
        for name in names:
            wrappers[name] = mod.LAUNCHES[name] if mod is not None else 0
    registry = {p: int(REGISTRY.sample("device_launches_total",
                                       {"program": p}))
                for p in ("pallas_slab", "batch_search", "packed_search",
                          "secp_verify", "secp_ecdh", "pow_verify")}
    return {"wrappers": wrappers, "registry": registry,
            "verifyBatches": int(REGISTRY.sample(
                "pow_verify_batches_total"))}


async def run(args) -> int:
    from . import resolve_device
    from .api import APIServer
    from .core import Node
    from .core.config import parse_tenant_table
    from .observability import (FLIGHT_RECORDER, PROFILER, http_transport,
                                set_peer_buckets)
    from .powfarm import TenantConfig
    from .resilience.chaos import CHAOS, unplanted
    from .storage.knownnodes import Peer

    settings = load_settings(args)
    refused = refused_options(settings)
    if refused:
        logging.error("refusing to start: %s turns on a subsystem this "
                      "package does not have", ", ".join(refused))
        return 1
    # fault injection is opt-in per node; a site this package does not
    # plant would arm nothing, which is not what the spec asked for
    if settings.get("chaos"):
        missing = unplanted(settings.get("chaos"))
        if missing:
            logging.error("refusing to start: chaos names %s, a site this "
                          "package does not plant", ", ".join(missing))
            return 1
        CHAOS.configure(settings.get("chaos"),
                        seed=settings.getint("chaosseed"))
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        logging.error("%s (--device cpu)", exc)
        return 1
    sockstype = settings.get("sockstype")
    if sockstype not in ("none", "SOCKS5", "SOCKS4a"):
        # a plugin name (e.g. "stem"): let it launch/adopt a proxy and
        # rewrite the socks settings (reference start_proxyconfig).
        # FAIL CLOSED: the user asked for proxied traffic; starting up
        # unproxied after a plugin failure would deanonymize them
        from .core.plugins import start_proxyconfig
        if not start_proxyconfig(settings):
            logging.error(
                "proxy configuration %r failed; refusing to start "
                "unproxied", sockstype)
            return 1
    not_run = not_run_options(settings)
    if not_run:
        logging.warning("not run by this package yet, on in the JAX "
                        "package's defaults: %s", ", ".join(not_run))
    from .roles import parse_role_streams
    node = Node(args.data_dir,
                port=settings.getint("port"),
                listen=not args.no_listen,
                test_mode=args.test_mode,
                dandelion_enabled=settings.getint("dandelion") > 0,
                tls_enabled=settings.getbool("tls"),
                udp_enabled=settings.getbool("udp"),
                pow_window=settings.getfloat("powbatchwindow"),
                device=device,
                sync_enabled=settings.getbool("syncenabled"),
                wiretrace_enabled=settings.getbool("wiretrace"),
                federation_enabled=settings.get("federation") != "off",
                crypto_batch=settings.getbool("cryptobatch"),
                farm_listen=settings.get("powfarmlisten") or None,
                farm_connect=settings.get("powfarmconnect") or None,
                farm_tenant=settings.get("powfarmtenant"),
                farm_secret=settings.get("powfarmsecret"),
                role=settings.get("role"),
                role_streams=parse_role_streams(
                    settings.get("rolestreams")) or None,
                role_ipc_listen=settings.get("roleipclisten") or None,
                role_ipc_connect=settings.get("roleipcconnect") or None,
                client_listen=settings.get("clientplanelisten") or None,
                client_connect=settings.get("clientconnect") or None,
                client_buckets=settings.getint("clientbuckets"),
                inventory_backend=settings.get("inventorystorage"),
                slab_max_bytes=settings.getint("slabmaxbytes"),
                slab_hot_bytes=settings.getint("slabhotbytes"),
                slab_bucket_seconds=settings.getint("slabbucketseconds"))
    node.settings = settings
    # edgeprocs > 1: the listener shares its port via SO_REUSEPORT so
    # sibling edge processes can bind beside it
    if settings.getint("edgeprocs") > 1:
        node.pool.reuse_port = True
    # the PoW solver farm's server and client knobs
    if node.farm_server is not None:
        srv = node.farm_server
        srv.auth_required = settings.getbool("powfarmauth")
        srv.batch_max = settings.getint("powfarmbatch")
        srv.window = settings.getfloat("powfarmwindow")
        srv.max_attempts = settings.getint("powmaxretries")
        srv.scheduler.max_wait = settings.getfloat("powfarmmaxwait")
        srv.scheduler.max_tenants = settings.getint("powfarmmaxtenants")
        srv.scheduler.default_config = TenantConfig(
            quota=settings.getint("powfarmquota"),
            rate=settings.getfloat("powfarmrate"),
            burst=settings.getfloat("powfarmburst"))
        # the operator's tenant table; with powfarmauth=true this is the
        # whole admission roster
        for name, secret, weight in parse_tenant_table(
                settings.get("powfarmtenants")):
            srv.register_tenant(name, TenantConfig(
                weight=weight,
                quota=settings.getint("powfarmquota"),
                rate=settings.getfloat("powfarmrate"),
                burst=settings.getfloat("powfarmburst"),
                secret=secret.encode("utf-8")))
    if node.farm_client is not None:
        node.farm_client.deadline = settings.getfloat("powfarmdeadline")
        node.farm_client.client.timeout = \
            settings.getfloat("powfarmdeadline")
        node.farm_client.bulk_threshold = \
            settings.getint("powfarmbulkthreshold")
    # the PoW retry budget and the pipeline's stall deadline
    node.solver.stall_timeout = settings.getfloat("powstalltimeout")
    node.pow_service.max_attempts = settings.getint("powmaxretries")
    node.dandelion.stem_probability = settings.getint("dandelion")
    # observability knobs
    FLIGHT_RECORDER.resize(settings.getint("flightrecsize"))
    node.health.sample_interval = settings.getfloat("healthinterval")
    node.health.probe.interval = settings.getfloat("looplaginterval")
    set_peer_buckets(settings.getint("peerlabelbuckets"))
    # metrics federation: the snapshot push cadence and the optional
    # parent aggregator this node federates its own registry up to
    if node.federation_publisher is not None:
        node.federation_publisher.interval = \
            settings.getfloat("federationinterval")
        if settings.get("federationpush"):
            host, _, port = settings.get("federationpush").rpartition(":")
            parent = http_transport(
                host or "127.0.0.1", int(port),
                username=settings.get("apiusername"),
                password=settings.get("apipassword"))
            # tee: the push still lands in the LOCAL aggregator (this
            # node's own /metrics/federated must keep including the
            # local node) while the PARENT's ack drives the
            # delta/resync bookkeeping.  Both see the same seq stream
            # from seq 1, so their stored state cannot diverge.
            local_ingest = (node.federation.ingest
                            if node.federation is not None else None)

            async def tee(push, _parent=parent, _local=local_ingest):
                if _local is not None:
                    _local(push)
                return await _parent(push)

            node.federation_publisher.transport = tee
            node.federation_publisher.count_bytes = True  # real wire
    # the sampling profiler: costStatus, profileDump, GET /debug/profile,
    # the loop-lag culprit and the flight recorder's stacks
    if settings.getbool("profiling"):
        PROFILER.hz = settings.getfloat("profilehz")
        PROFILER.start()
    node.processor.list_mode = settings.get("blackwhitelist")
    # applied before start() spawns the processor's workers and the
    # engine's drain task
    node.processor.concurrency = settings.getint("ingestworkers")
    if settings.getint("cryptoworkers"):
        node.crypto.size = settings.getint("cryptoworkers")
    # the receive-side crypto rungs of every engine (the ingest path's
    # and a light client's)
    for engine in (node.crypto.batch, node.client_crypto):
        if engine is None:
            continue
        engine.drain_max = settings.getint("cryptodrainmax")
        engine.use_gpu = settings.get("cryptotpu").lower() not in (
            "off", "false", "0", "no")
        engine.gpu_batch_min = settings.getint("cryptotpubatchmin")
        engine.use_native = settings.getbool("cryptonative")
        engine.num_threads = settings.getint("cryptonativethreads")
        engine.window = settings.getfloat("cryptobatchwindow")
    queue = node.ctx.object_queue
    queue.high = settings.getint("ingestqueuehigh")
    queue.low = max(1, queue.high // 4)
    if not settings.getbool("cryptoscreen"):
        node.crypto.screen = None
        if node.crypto.batch is not None:
            node.crypto.batch.screen = None
    # kB/s global throttles (reference maxdownloadrate/maxuploadrate)
    node.ctx.download_bucket.rate = settings.getint("maxdownloadrate") * 1024
    node.ctx.upload_bucket.rate = settings.getint("maxuploadrate") * 1024
    node.pool.max_outbound = settings.getint("maxoutboundconnections")
    node.pool.max_total = settings.getint("maxtotalconnections")
    node.pool.dial_timeout = settings.getfloat("connecttimeout")
    node.pool.handshake_timeout = settings.getfloat("handshaketimeout")
    node.pool.dial_breaker_threshold = settings.getint("breakerfailures")
    node.pool.dial_breaker_cooldown = settings.getfloat("breakercooldown")
    # set-reconciliation sync knobs
    if node.reconciler is not None:
        node.reconciler.interval = settings.getfloat("syncinterval")
        fanout = settings.getint("syncfanout")
        node.reconciler.fanout = None if fanout < 0 else fanout
        node.reconciler.breaker_threshold = \
            settings.getint("breakerfailures")
        node.reconciler.breaker_cooldown = \
            settings.getfloat("breakercooldown")
    node.sender.max_acceptable_ntpb = settings.getint(
        "maxacceptablenoncetrialsperbyte")
    node.sender.max_acceptable_extra = settings.getint(
        "maxacceptablepayloadlengthextrabytes")
    # the plugin rewrote the settings to the protocol it set up
    sockstype = settings.get("sockstype")
    if sockstype in ("SOCKS5", "SOCKS4a"):
        node.ctx.proxy = {
            "type": sockstype,
            "host": settings.get("sockshostname"),
            "port": settings.getint("socksport"),
            "username": settings.get("socksusername"),
            "password": settings.get("sockspassword"),
        }
    # AFTER proxyconfig: a plugin may have just created the hidden
    # service and set onionhostname.  Publish our endpoint as an
    # ONIONPEER object at worker startup (reference sendOnionPeerObj);
    # lowercase because the wire codec round-trips onion hosts in
    # lowercase and the self-recognition check compares exactly
    if settings.get("onionhostname"):
        node.sender.onion_peer = (settings.get("onionhostname").lower(),
                                  settings.getint("onionport"))
    # the email gateway's SMTP server and deliverer, started after the
    # API (a bad smtpdeliver URL raises here, before the node starts)
    if settings.getbool("smtpdenabled"):
        from .gateways import SMTPGateway
        node.smtp_gateway = SMTPGateway(
            node, port=settings.getint("smtpdport"),
            username=settings.get("smtpdusername", ""),
            password=settings.get("smtpdpassword", ""))
    if settings.get("smtpdeliver"):
        from .gateways import SMTPDeliverer
        node.smtp_deliverer = SMTPDeliverer(node, settings.get("smtpdeliver"))
    if settings.getbool("notifysound"):
        # new-message sound through the notification.sound plugin group
        # (reference sound_* plugins driven from the UISignal stream)
        from .core.plugins import get_plugin
        sound = get_plugin("notification.sound")
        if sound is not None:
            soundfile = settings.get("notifysoundfile", "")
            node.ui.subscribe(
                lambda cmd, data: sound(soundfile)
                if cmd == "displayNewInboxMessage" else None)
    if args.trusted_peer:
        host, _, port = args.trusted_peer.rpartition(":")
        node.pool.trusted_peer = Peer(host, int(port))
    if args.seed_defaults:
        node.knownnodes.seed_defaults()

    try:
        await node.start()
    except BaseException:
        PROFILER.stop()
        raise

    if args.populate_test_data:
        from .core.testdata import populate
        populate(node)

    upnp_client = None
    if settings.getbool("upnp") and not args.no_listen:
        from .network.upnp import UPnPClient
        upnp_client = UPnPClient()
        try:
            await upnp_client.discover(timeout=5)
            await upnp_client.add_port_mapping(node.pool.listen_port)
        except Exception as exc:
            logging.warning("UPnP port mapping unavailable: %r", exc)
            upnp_client = None

    notifier = None
    if settings.get("apinotifypath"):
        from .core.notify import ApiNotifier
        notifier = ApiNotifier(node, settings.get("apinotifypath"))
        notifier.start()

    api = None
    # The API is powerful (reads inboxes, sends messages); match the
    # reference's default-off-with-mandatory-auth posture: refuse to
    # serve without credentials except in explicit test mode
    # (reference bmconfigparser 'apienabled' + apiusername/apipassword).
    want_api = not args.no_api and (settings.getbool("apienabled")
                                    or args.test_mode)
    has_creds = settings.get("apiusername") and settings.get("apipassword")
    if want_api and not has_creds and not args.test_mode:
        logging.warning(
            "API disabled: set apiusername/apipassword (or --api-user/"
            "--api-password, or run with -t for test mode)")
        want_api = False
    if want_api:
        api = APIServer(node, port=settings.getint("apiport"),
                        username=settings.get("apiusername"),
                        password=settings.get("apipassword"))
        await api.start()
        logging.info("API listening on 127.0.0.1:%d", api.listen_port)
        if notifier is not None:
            notifier.notify("apiEnabled")

    if node.smtp_gateway is not None:
        await node.smtp_gateway.start()
        logging.info("SMTP gateway on 127.0.0.1:%d",
                     node.smtp_gateway.listen_port)
    if node.smtp_deliverer is not None:
        node.smtp_deliverer.start()

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover (non-unix)
            pass
    await stop.wait()
    logging.info("shutting down...")
    if notifier is not None:
        notifier.stop()
    if node.smtp_deliverer is not None:
        node.smtp_deliverer.stop()
    if node.smtp_gateway is not None:
        await node.smtp_gateway.stop()
    if api is not None:
        await api.stop()
    if upnp_client is not None:
        try:
            await upnp_client.delete_port_mapping()
        except Exception as exc:
            logging.warning("UPnP unmap failed: %r", exc)
    await node.stop()
    PROFILER.stop()
    logging.info("kernel launches at stop: %s",
                 json.dumps(launch_record(), sort_keys=True))
    settings.save()
    return 0


def _setup_logging(args) -> None:
    """Reference debug.py: a logging.dat fileConfig override wins;
    otherwise console + rotating debug.log (2 MiB x 1) in the data
    directory."""
    level = logging.DEBUG if args.verbose else logging.INFO
    if args.data_dir:
        logging_dat = Path(args.data_dir) / "logging.dat"
        if logging_dat.exists():
            # aliased import: a bare `import logging.config` would bind
            # the name `logging` function-locally and shadow the module
            import logging.config as logging_config
            try:
                logging_config.fileConfig(
                    logging_dat, disable_existing_loggers=False)
                return
            except Exception as exc:
                # fall through to the default config, but say so
                print("logging.dat ignored: %r" % exc, file=sys.stderr)
    handlers: list = [logging.StreamHandler()]
    if args.data_dir:
        from logging.handlers import RotatingFileHandler
        Path(args.data_dir).mkdir(parents=True, exist_ok=True)
        handlers.append(RotatingFileHandler(
            Path(args.data_dir) / "debug.log",
            maxBytes=2 * 1024 * 1024, backupCount=1))
    logging.basicConfig(
        level=level, handlers=handlers,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _setup_logging(args)
    from .core.appenv import (SingleInstance, SingleInstanceError,
                              appdata_dir, daemonize)
    if args.appdata and not args.data_dir:
        args.data_dir = str(appdata_dir())
    if args.daemon:  # pragma: no cover - forks away from test runners
        daemonize()
    lock = None
    if args.data_dir:
        lock = SingleInstance(args.data_dir)
        try:
            lock.acquire()
        except SingleInstanceError as exc:
            logging.error("%s", exc)
            return 1
    try:
        return asyncio.run(run(args))
    except KeyboardInterrupt:  # pragma: no cover
        return 0
    except Exception:
        # fatal: the flight recorder's ring holds the seconds before
        # the failure
        from .observability import FLIGHT_RECORDER
        FLIGHT_RECORDER.dump("fatal")
        raise
    finally:
        if lock is not None:
            lock.release()


if __name__ == "__main__":
    sys.exit(main())
