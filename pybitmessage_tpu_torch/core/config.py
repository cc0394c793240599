"""Layered persisted settings with defaults, validators and migrations
(copy of ``pybitmessage_tpu.core.config``: ``Settings``, ``SECTION``,
``SETTINGS_VERSION``, the migration chain and ``parse_tenant_table``,
with ``DEFAULTS`` and ``VALIDATORS`` trimmed to the options the port
applies).

Role model: the reference's ``BMConfigParser`` layered over
``default.ini`` with per-option validators, a non-persisted ``setTemp``
overlay, timestamped ``.bak`` on save, and a versioned upgrade chain
(src/bmconfigparser.py:106-158, src/default.ini,
src/helper_startup.py:39-260).  The file is the JAX package's
``settings.dat``: an option the port does not know is kept as it was
read and written back on save, so one file serves both packages.
"""

from __future__ import annotations

import configparser
import logging
import os
import time
from pathlib import Path
from typing import Callable

logger = logging.getLogger("pybitmessage_tpu_torch.config")

SECTION = "bitmessagesettings"

#: current settings schema version — bump with each migration
SETTINGS_VERSION = 2

#: defaults of the options the port applies, with the JAX package's
#: values (reference default.ini + helper_startup first-run defaults)
DEFAULTS: dict[str, str] = {
    "settingsversion": str(SETTINGS_VERSION),
    "port": "8444",
    "maxoutboundconnections": "8",
    "maxtotalconnections": "200",
    "maxdownloadrate": "0",          # kB/s, 0 = unlimited
    "maxuploadrate": "0",
    "dandelion": "90",               # stem probability %
    "apienabled": "false",
    "apiport": "8442",
    "apiusername": "",
    "apipassword": "",
    "apinotifypath": "",
    "smtpdeliver": "",               # smtp://host:port?to=rcpt
    "smtpdenabled": "false",         # the SMTP submission server
    "smtpdport": "8425",
    "smtpdusername": "",
    "smtpdpassword": "",
    "udp": "true",                   # LAN discovery
    "upnp": "false",                 # map the P2P port on the gateway
    "tls": "true",                   # opportunistic NODE_SSL
    "sockstype": "none",             # none | SOCKS5 | SOCKS4a | plugin
                                     # name (e.g. "stem" = private Tor)
    "sockshostname": "",
    "socksport": "9050",
    "socksusername": "",
    "sockspassword": "",
    "sockslisten": "false",          # the stem plugin's hidden service
    "onionhostname": "",             # our onion endpoint, announced as
    "onionport": "8444",             # an ONIONPEER object
    "torcontrolport": "0",           # adopted-tor control port (0 = none)
    "onionservicekey": "",           # persisted ephemeral-service key
    "onionservicekeytype": "",
    "powbatchwindow": "0.05",        # PoW coalescing window, seconds
                                     # (0 = launch immediately)
    "ingestworkers": "8",            # concurrent objects in the
                                     # processor pipeline
    "cryptoworkers": "0",            # crypto pool threads (0 = auto:
                                     # min(8, cores))
    "ingestqueuehigh": "512",        # object-queue high watermark
                                     # pausing connection reads (the
                                     # low one is a quarter of it)
    "cryptobatch": "true",           # decrypts and signature checks
                                     # through the batch engine on the
                                     # device (off = host threads)
    "cryptonative": "true",          # the native secp256k1 rung for
                                     # drains under cryptotpubatchmin
                                     # (off = the pure per-item tier)
    "cryptobatchwindow": "0.0",      # batch coalescing window, seconds
                                     # (0 = drain immediately; batching
                                     # emerges from load)
    "cryptonativethreads": "1",      # std::thread fan-out inside each
                                     # native batch call (0 = all
                                     # hardware threads)
    "cryptotpu": "auto",             # the card rung: auto and on run it
                                     # on the node's device, off never
    "cryptotpubatchmin": "64",       # min effective drain fan (checks
                                     # + ECDH candidate pairs) worth a
                                     # launch; smaller drains run on
                                     # the native rung
    "cryptodrainmax": "4096",        # ECDH pair budget per
                                     # trial-decrypt drain
    "cryptoscreen": "true",          # object-keyed negative cache in
                                     # front of the trial-decrypt sweep
    "inventorystorage": "sqlite",    # sqlite | filesystem | slab
    # -- the slab store --
    "slabmaxbytes": "4194304",       # slab seal threshold, bytes
    "slabhotbytes": "8388608",       # pinned hot-set payload budget,
                                     # bytes (fresh objects served
                                     # without disk reads)
    "slabbucketseconds": "3600",     # expiry bucket width: TTL purge
                                     # drops whole buckets of slabs
    # -- set-reconciliation sync --
    "syncenabled": "true",           # sketch-based inventory sync
                                     # (negotiated; old peers keep
                                     # classic inv flooding)
    "syncinterval": "10",            # min seconds between
                                     # reconciliation rounds per peer
    "syncfanout": "-1",              # peers flooded immediately per
                                     # new object: -1 = auto sqrt(n),
                                     # 0 = pure reconciliation
    "breakerfailures": "3",          # consecutive failures opening the
                                     # dial and sync breakers
    "breakercooldown": "60",         # seconds before a half-open probe
    "connecttimeout": "10",          # outbound dial budget, seconds
    "handshaketimeout": "30",        # version/verack must finish in this
    "blackwhitelist": "black",       # inbound sender policy
    "flightrecsize": "512",          # flight-recorder ring capacity
                                     # (events)
    "healthinterval": "5",           # health-gauge sampling cadence,
                                     # seconds
    "looplaginterval": "0.25",       # event-loop lag probe cadence,
                                     # seconds
    # -- distributed observability plane --
    "wiretrace": "true",             # advertise NODE_TRACE: carry
                                     # trace contexts on sync rounds +
                                     # object pushes (legacy peers see
                                     # nothing)
    "federation": "aggregator",      # off | aggregator (merge pushed
                                     # snapshots, serve the fleet view)
    "federationinterval": "10",      # self/child snapshot push
                                     # cadence, seconds
    "federationpush": "",            # parent aggregator "host:port" to
                                     # push this node's snapshots to
                                     # (basic auth from apiusername/
                                     # apipassword; empty = no parent)
    "peerlabelbuckets": "16",        # hashed peer-bucket count for
                                     # per-peer metric labels
    "profiling": "true",             # continuous sampling profiler
                                     # (costStatus / profileDump /
                                     # GET /debug/profile)
    "profilehz": "19",               # profiler sampling rate, Hz
    "notifysound": "false",          # ring/play on new inbox message
    "notifysoundfile": "",           # optional file for the sound plugin
    # ceilings on recipient-demanded PoW; 0 = unlimited (reference
    # helper_startup sanity cap: ridiculousDifficulty x network default)
    "maxacceptablenoncetrialsperbyte": "20000000000",
    "maxacceptablepayloadlengthextrabytes": "20000000000",
    # -- PoW solver farm --
    "powfarmlisten": "",             # serve PoW-as-a-service on this
                                     # "port" or "host:port" (empty =
                                     # no farm daemon)
    "powfarmconnect": "",            # delegate this node's PoW to a
                                     # farm at "host:port" (empty =
                                     # solve on the card)
    "powfarmtenant": "default",      # tenant id for farm submissions
    "powfarmsecret": "",             # shared HMAC secret for signed
                                     # submissions (empty = unsigned)
    "powfarmauth": "false",          # farm side: require signed
                                     # submissions from pre-registered
                                     # tenants only
    "powfarmtenants": "",            # farm-side tenant table:
                                     # "name:secret[:weight]" comma
                                     # list (empty secret = unsigned;
                                     # quota/rate/burst come from the
                                     # powfarm* defaults)
    "powfarmdeadline": "60",         # client per-job wall ceiling,
                                     # seconds (a tighter propagated
                                     # Deadline wins)
    "powfarmbulkthreshold": "2",     # batches above this size ride
                                     # the bulk lane
    "powfarmbatch": "32",            # max jobs per farm dispatch
    "powfarmwindow": "0.01",         # farm drain coalescing window, s
    "powfarmmaxwait": "30",          # admission ceiling on projected
                                     # queue wait, seconds (reject
                                     # with retry-after beyond it)
    "powfarmquota": "256",           # default per-tenant queued-job
                                     # quota
    "powfarmrate": "0",              # default per-tenant token-bucket
                                     # jobs/s (0 = unlimited)
    "powfarmburst": "32",            # token-bucket burst capacity
    "powfarmmaxtenants": "64",       # open-mode tenant auto-
                                     # registration cap (tenant ids
                                     # are metric label values)
    # -- node roles --
    "role": "all",                   # all (fused single process) |
                                     # edge (sockets/framing/PoW
                                     # verify, hand-off over role IPC)
                                     # | relay (storage/processing
                                     # authority for a stream shard)
    "rolestreams": "",               # comma list of stream numbers
                                     # this process subscribes to
                                     # (empty = stream 1)
    "edgeprocs": "1",                # edge processes sharing the P2P
                                     # listen port via SO_REUSEPORT
                                     # (>1 also arms reuse_port on a
                                     # fused node for rolling splits)
    "roleipclisten": "",             # relay: serve role IPC on this
                                     # "port" or "host:port"
    "roleipcconnect": "",            # edge: relay endpoints, comma
                                     # list of "host:port" (shard
                                     # ownership learned from
                                     # HELLO_ACK)
    "clientplanelisten": "",         # edge: serve the light-client
                                     # subscription plane on this
                                     # "port" or "host:port" (empty =
                                     # no client plane)
    "clientconnect": "",             # client role: one edge's client
                                     # plane at "host:port"
    "clientbuckets": "64",           # filter-digest bucket count the
                                     # plane serves
    # -- resilience --
    "powstalltimeout": "120",        # per-harvest slab stall deadline,
                                     # seconds (0 = watchdog off)
    "powmaxretries": "3",            # solve attempts before a queued
                                     # object surfaces its error
    "chaos": "",                     # fault-injection spec, e.g.
                                     # "pow.device_launch:0.5,db.write:1x3"
                                     # (sites this package plants only)
    "chaosseed": "0",                # deterministic chaos seed
}


def _validate_int_range(lo: int, hi: int) -> Callable[[str], bool]:
    def check(value: str) -> bool:
        try:
            return lo <= int(value) <= hi
        except ValueError:
            return False
    return check


def _validate_bool(value: str) -> bool:
    return value.lower() in ("true", "false", "0", "1", "yes", "no")


def _validate_float_range(lo: float, hi: float) -> Callable[[str], bool]:
    def check(value: str) -> bool:
        try:
            return lo <= float(value) <= hi
        except ValueError:
            return False
    return check


def parse_tenant_table(spec: str) -> list[tuple[str, str, float]]:
    """Parse the ``powfarmtenants`` value: a comma list of
    ``name:secret[:weight]`` entries -> ``[(name, secret, weight)]``.
    Raises ``ValueError`` on a malformed entry."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise ValueError("tenant entry %r is not "
                             "name:secret[:weight]" % entry)
        name, secret = parts[0], parts[1]
        if not 1 <= len(name) <= 64:
            raise ValueError("tenant name %r out of range" % name)
        weight = 1.0
        if len(parts) == 3:
            weight = float(parts[2])    # ValueError on junk
            if not 0.0 < weight <= 1000.0:
                raise ValueError("tenant weight %r out of range"
                                 % parts[2])
        out.append((name, secret, weight))
    return out


def _validate_tenant_table(value: str) -> bool:
    try:
        parse_tenant_table(value)
        return True
    except ValueError:
        return False


def _validate_role_streams(value: str) -> bool:
    from ..roles.registry import parse_role_streams
    try:
        parse_role_streams(value)
        return True
    except ValueError:
        return False


def _validate_endpoint_list(value: str) -> bool:
    """Comma list of ``host:port`` (or bare ``port``) endpoints."""
    for entry in value.split(","):
        entry = entry.strip()
        if not entry:
            continue
        port = entry.rpartition(":")[2]
        if not port.isdigit() or not 1 <= int(port) <= 65535:
            return False
    return True


#: per-option validators (reference validate_<section>_<option>,
#: bmconfigparser.py:142-158 — notably maxoutbound <= 8)
VALIDATORS: dict[str, Callable[[str], bool]] = {
    "maxoutboundconnections": _validate_int_range(0, 8),
    "maxtotalconnections": _validate_int_range(0, 10000),
    "maxdownloadrate": _validate_int_range(0, 2**31),
    "maxuploadrate": _validate_int_range(0, 2**31),
    "dandelion": _validate_int_range(0, 100),
    "port": _validate_int_range(0, 65535),
    "apiport": _validate_int_range(1, 65535),
    "smtpdport": _validate_int_range(1, 65535),
    "smtpdenabled": _validate_bool,
    "notifysound": _validate_bool,
    "powbatchwindow": _validate_float_range(0.0, 10.0),
    "ingestworkers": _validate_int_range(1, 256),
    "cryptoworkers": _validate_int_range(0, 256),
    "ingestqueuehigh": _validate_int_range(0, 1 << 20),
    "cryptodrainmax": _validate_int_range(1, 1 << 20),
    "cryptobatch": _validate_bool,
    "cryptonative": _validate_bool,
    "cryptobatchwindow": _validate_float_range(0.0, 10.0),
    "cryptonativethreads": _validate_int_range(0, 256),
    "cryptotpu": lambda v: v.lower() in ("auto", "on", "off", "true",
                                         "false", "0", "1", "yes",
                                         "no"),
    "cryptotpubatchmin": _validate_int_range(1, 1 << 20),
    "udp": _validate_bool,
    "upnp": _validate_bool,
    "tls": _validate_bool,
    "socksport": _validate_int_range(1, 65535),
    # besides the literal protocols, any identifier names a proxyconfig
    # plugin (reference socksproxytype convention, e.g. "stem")
    "sockstype": lambda v: v.replace("_", "").isalnum() or v == "none",
    "cryptoscreen": _validate_bool,
    "inventorystorage": lambda v: v in ("sqlite", "filesystem", "slab"),
    "slabmaxbytes": _validate_int_range(1 << 12, 1 << 30),
    "slabhotbytes": _validate_int_range(0, 1 << 32),
    "slabbucketseconds": _validate_int_range(1, 28 * 24 * 3600),
    "syncenabled": _validate_bool,
    "syncinterval": _validate_float_range(0.5, 3600.0),
    "syncfanout": _validate_int_range(-1, 1000),
    "wiretrace": _validate_bool,
    "federation": lambda v: v in ("off", "aggregator"),
    "federationinterval": _validate_float_range(0.5, 3600.0),
    "federationpush": lambda v: v == "" or (
        v.rpartition(":")[2].isdigit()
        and 1 <= int(v.rpartition(":")[2]) <= 65535),
    "breakerfailures": _validate_int_range(1, 1000),
    "breakercooldown": _validate_float_range(0.0, 86400.0),
    "connecttimeout": _validate_float_range(1.0, 300.0),
    "handshaketimeout": _validate_float_range(1.0, 3600.0),
    "apienabled": _validate_bool,
    "blackwhitelist": lambda v: v in ("black", "white"),
    "flightrecsize": _validate_int_range(16, 1 << 20),
    "healthinterval": _validate_float_range(0.1, 3600.0),
    "looplaginterval": _validate_float_range(0.01, 60.0),
    "peerlabelbuckets": _validate_int_range(1, 512),
    "profiling": _validate_bool,
    "profilehz": _validate_float_range(0.1, 1000.0),
    "powfarmlisten": lambda v: v == "" or (
        v.rpartition(":")[2].isdigit()
        and 0 <= int(v.rpartition(":")[2]) <= 65535),
    "powfarmconnect": lambda v: v == "" or (
        v.rpartition(":")[2].isdigit()
        and 1 <= int(v.rpartition(":")[2]) <= 65535),
    "powfarmtenant": lambda v: 1 <= len(v) <= 64,
    "powfarmauth": _validate_bool,
    "powfarmtenants": _validate_tenant_table,
    "powfarmdeadline": _validate_float_range(0.1, 86400.0),
    "powfarmbulkthreshold": _validate_int_range(1, 4096),
    "powfarmbatch": _validate_int_range(1, 4096),
    "powfarmwindow": _validate_float_range(0.0, 10.0),
    "powfarmmaxwait": _validate_float_range(0.1, 86400.0),
    "powfarmquota": _validate_int_range(1, 1 << 20),
    "powfarmrate": _validate_float_range(0.0, 1e9),
    "powfarmburst": _validate_float_range(1.0, 1e9),
    "powfarmmaxtenants": _validate_int_range(1, 512),
    "role": lambda v: v in ("all", "edge", "relay", "client"),
    "rolestreams": _validate_role_streams,
    "edgeprocs": _validate_int_range(1, 64),
    "roleipclisten": lambda v: v == "" or (
        v.rpartition(":")[2].isdigit()
        and 0 <= int(v.rpartition(":")[2]) <= 65535),
    "roleipcconnect": _validate_endpoint_list,
    "clientplanelisten": lambda v: v == "" or (
        v.rpartition(":")[2].isdigit()
        and 0 <= int(v.rpartition(":")[2]) <= 65535),
    "clientconnect": lambda v: v == "" or (
        v.rpartition(":")[2].isdigit()
        and 1 <= int(v.rpartition(":")[2]) <= 65535),
    "clientbuckets": _validate_int_range(1, 65535),
    "powstalltimeout": _validate_float_range(0.0, 86400.0),
    "powmaxretries": _validate_int_range(1, 100),
    "chaosseed": _validate_int_range(0, 2**63 - 1),
}


class SettingsError(ValueError):
    """Rejected by a validator."""


class Settings:
    """Persisted node settings: defaults <- file <- temp overlay."""

    def __init__(self, path: str | os.PathLike | None = None):
        self._path = Path(path) if path else None
        self._file: dict[str, str] = {}
        self._temp: dict[str, str] = {}
        if self._path is not None and self._path.exists():
            self.load()
        self._migrate()

    # -- accessors -----------------------------------------------------------

    def get(self, option: str, default: str | None = None) -> str:
        if option in self._temp:
            return self._temp[option]
        if option in self._file:
            return self._file[option]
        if option in DEFAULTS:
            return DEFAULTS[option]
        if default is not None:
            return default
        raise KeyError(option)

    def getint(self, option: str) -> int:
        return int(self.get(option))

    def getfloat(self, option: str) -> float:
        return float(self.get(option))

    def getbool(self, option: str) -> bool:
        return self.get(option).lower() in ("true", "1", "yes")

    def set(self, option: str, value) -> None:
        """Set a persisted option (validated); call :meth:`save` to write."""
        value = self._check(option, value)
        self._file[option] = value
        self._temp.pop(option, None)

    def set_temp(self, option: str, value) -> None:
        """Non-persisted overlay (reference setTemp) — CLI flags land here."""
        self._temp[option] = self._check(option, value)

    def _check(self, option: str, value) -> str:
        if isinstance(value, bool):
            value = "true" if value else "false"
        value = str(value)
        validator = VALIDATORS.get(option)
        if validator is not None and not validator(value):
            raise SettingsError("invalid value %r for option %r"
                                % (value, option))
        return value

    def is_set(self, option: str) -> bool:
        """True when the option was explicitly configured (file or
        temp), as opposed to falling through to the default."""
        return option in self._temp or option in self._file

    def options(self) -> dict[str, str]:
        """Effective settings (defaults overlaid by file and temp)."""
        out = dict(DEFAULTS)
        out.update(self._file)
        out.update(self._temp)
        return out

    # -- persistence ---------------------------------------------------------

    def load(self) -> None:
        cfg = configparser.ConfigParser()
        cfg.read(self._path)
        if cfg.has_section(SECTION):
            self._file = dict(cfg[SECTION])

    def save(self) -> None:
        """Atomic write with a timestamped .bak of the previous file
        (reference bmconfigparser.py:120-140)."""
        if self._path is None:
            return
        self._path.parent.mkdir(parents=True, exist_ok=True)
        cfg = configparser.ConfigParser()
        # Always persist settingsversion (reference always stamps it) so
        # a fresh install's file re-enters the migration chain correctly.
        cfg[SECTION] = {"settingsversion": str(SETTINGS_VERSION),
                        **self._file}
        if self._path.exists():
            bak = self._path.with_name(
                self._path.name + "." + time.strftime("%Y%m%d-%H%M%S")
                + ".bak")
            try:
                bak.write_bytes(self._path.read_bytes())
            except OSError:
                logger.warning("could not write settings backup %s", bak)
        tmp = self._path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            cfg.write(f)
        tmp.replace(self._path)

    # -- migrations ----------------------------------------------------------

    def _migrate(self) -> None:
        """Versioned upgrade chain (reference helper_startup.updateConfig)."""
        stamped = "settingsversion" in self._file
        if self._file and not stamped:
            # A non-empty file lacking the key predates version stamping:
            # enter the chain at 1 so no migration is silently skipped.
            version = 1
        else:
            try:
                version = int(self._file.get("settingsversion",
                                             str(SETTINGS_VERSION)))
            except ValueError:
                version = 1
        dirty = False
        if version < 2:
            # v1 -> v2: dandelion option introduced; explicitly-stamped
            # v1 installs ran with stem routing off, so preserve that.
            # Unstamped files may simply predate stamping (older save()
            # never wrote the key) and always had the default (90) in
            # effect — forcing 0 on them would regress behavior.
            if stamped:
                self._file.setdefault("dandelion", "0")
            version = 2
            dirty = True
        if dirty:
            self._file["settingsversion"] = str(version)
            if self._path is not None:
                self.save()
