"""The port's inventory backends against the JAX package's, on the CPU.

One seeded sequence of ``add``, ``flush``, ``clean`` and reopen, its
clock injected (the slab store's ``clock``; the ``time`` the SQLite and
filesystem backends read, patched in both packages' modules), runs
through each backend of both packages: ``sqlite``, ``filesystem`` and
``slab``.  After every step the contents, ``len``, ``by_type_and_tag``,
``unexpired_hashes_by_stream``, ``export_buckets`` (the slab store's)
and the attached sync digest's summaries must be equal.  The slab
store's files are byte-equal after each ``flush``, and a slab directory
written by either package opens in the other with every record.  Slab
specifics: a torn tail replayed alike, 100% ``storage.slab_io`` chaos
losing nothing, whole-bucket TTL drops.  A node on ``filesystem`` runs
with no sync digest, as the JAX node does; a relay on the slab store
sheds a stream in as many buckets as the JAX relay, and its receiver's
store holds the drained records when it acks the drain's end (the JAX
receiver's does not: ROADMAP §3, fault 3.9).

Inputs come from seeded numpy; nothing of JAX is imported at module
level.
"""

import asyncio
import hashlib
import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.models.constants import EXPIRES_GRACE
from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.resilience.chaos import CHAOS
from pybitmessage_tpu_torch.storage import (Database, FilesystemInventory,
                                            Inventory, SlabStore)
from pybitmessage_tpu_torch.sync.digest import InventoryDigest

#: the clock every sequence starts from (seconds since the epoch)
T0 = 1_700_000_000
BUCKET = 3600
TYPES = (0, 1, 2, 3, 42)
#: seconds a relay deployment may take to reach a state
WAIT = 15.0


def _jax(name: str):
    import jax
    jax.config.update("jax_platforms", "cpu")
    return importlib.import_module("pybitmessage_tpu." + name)


def _packages():
    """Per package: the storage classes and the digest, by name."""
    jdb, jinv, jfs, jslab, jdig = (_jax("storage.db"),
                                   _jax("storage.inventory"),
                                   _jax("storage.fs_inventory"),
                                   _jax("storage.slabstore"),
                                   _jax("sync.digest"))
    return {
        "jax": SimpleNamespace(
            Database=jdb.Database, Inventory=jinv.Inventory,
            FilesystemInventory=jfs.FilesystemInventory,
            SlabStore=jslab.SlabStore, Digest=jdig.InventoryDigest,
            time_modules=(jinv, jfs)),
        "port": SimpleNamespace(
            Database=Database, Inventory=Inventory,
            FilesystemInventory=FilesystemInventory, SlabStore=SlabStore,
            Digest=InventoryDigest,
            time_modules=(importlib.import_module(
                "pybitmessage_tpu_torch.storage.inventory"),
                importlib.import_module(
                    "pybitmessage_tpu_torch.storage.fs_inventory"))),
    }


def _h(payload: bytes) -> bytes:
    return hashlib.sha512(hashlib.sha512(payload).digest()).digest()[:32]


def _draw(rng, n: int, now: int) -> list:
    """``n`` objects ``(hash, type, stream, payload, expires, tag)``:
    expiries from past the purge grace to four buckets ahead, tags on
    the tagged types."""
    out = []
    for _ in range(n):
        type_ = int(rng.choice(TYPES))
        payload = rng.bytes(int(rng.integers(20, 400)))
        tag = rng.bytes(32) if type_ in (1, 3) else b""
        expires = now + int(rng.integers(-EXPIRES_GRACE - 2 * BUCKET,
                                         4 * BUCKET))
        out.append((_h(payload), type_, int(rng.integers(1, 3)), payload,
                    expires, tag))
    return out


class _Run:
    """One backend of one package driven by the shared sequence."""

    def __init__(self, pkg, backend: str, root, clock: list):
        self.pkg, self.backend, self.root = pkg, backend, root
        self.clock = clock
        self.db = None
        self.digested = backend != "filesystem"
        root.mkdir(parents=True, exist_ok=True)
        self.open()

    def open(self) -> None:
        pkg = self.pkg
        if self.backend == "sqlite":
            self.db = pkg.Database(str(self.root / "messages.dat"))
            self.inv = pkg.Inventory(self.db)
        elif self.backend == "filesystem":
            self.inv = pkg.FilesystemInventory(self.root / "inventory")
        else:
            self.inv = pkg.SlabStore(
                self.root / "slabs", slab_max_bytes=1 << 12,
                bucket_seconds=BUCKET, hot_bytes=2048,
                clock=lambda: self.clock[0])
        self.digest = None
        if self.digested:
            self.digest = pkg.Digest()
            self.inv.attach_digest(self.digest)

    def reopen(self) -> None:
        self.inv.flush()
        if self.db is not None:
            self.db.close()
        self.open()

    def close(self) -> None:
        if self.db is not None:
            self.db.close()

    def state(self) -> dict:
        inv = self.inv
        item = lambda i: (i.type, i.stream, bytes(i.payload),  # noqa: E731
                          i.expires, bytes(i.tag))
        hashes = sorted(bytes(h) for h in inv.hashes())
        tags = sorted({item(inv[h])[4] for h in hashes} - {b""})[:3]
        out = {
            "len": len(inv),
            "items": [(h, item(inv[h])) for h in hashes],
            "by_type": {t: sorted(item(i) for i in inv.by_type_and_tag(t))
                        for t in TYPES},
            "by_tag": {(t, g): sorted(item(i) for i in
                                      inv.by_type_and_tag(t, g))
                       for t in (1, 3) for g in tags},
            "unexpired": {s: sorted(inv.unexpired_hashes_by_stream(s))
                          for s in (1, 2)},
            "buckets": {s: [(b, sorted(hs)) for b, hs in
                            inv.export_buckets(s)] for s in (1, 2)}
            if hasattr(inv, "export_buckets") else None,
        }
        if self.digest is not None:
            out["digest"] = (len(self.digest), {
                s: self.digest.summaries(s) for s in (1, 2)})
        return out


def _sequence(runs: list, rng, clock: list, check) -> None:
    """add, flush, clean and reopen through every run, ``check`` after
    each step."""
    def step(objs):
        for run in runs:
            for h, t, s, p, e, g in objs:
                run.inv.add(h, t, s, p, e, g)
    step(_draw(rng, 300, clock[0]))
    check("add")
    for run in runs:
        run.inv.flush()
    check("flush")
    clock[0] += 2 * BUCKET
    step(_draw(rng, 40, clock[0]))
    for run in runs:
        run.inv.clean()
    check("clean")
    for run in runs:
        run.reopen()
    check("reopen")
    clock[0] += EXPIRES_GRACE + 2 * BUCKET
    for run in runs:
        run.inv.clean()
    step(_draw(rng, 20, clock[0]))
    for run in runs:
        run.inv.flush()
    check("clean after the grace")


def _patched_time(monkeypatch, pkgs, clock):
    fake = SimpleNamespace(time=lambda: clock[0])
    for pkg in pkgs.values():
        for module in pkg.time_modules:
            monkeypatch.setattr(module, "time", fake)


def _files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("backend", ["sqlite", "filesystem", "slab"])
def test_one_sequence_through_both_packages_backends(tmp_path, monkeypatch,
                                                     backend):
    pkgs = _packages()
    clock = [T0]
    _patched_time(monkeypatch, pkgs, clock)
    runs = [_Run(pkgs[name], backend, tmp_path / name, clock)
            for name in ("jax", "port")]
    rng = np.random.default_rng([13, len(backend)])
    seen = []

    def check(what):
        jax_state, port_state = (run.state() for run in runs)
        assert port_state == jax_state, what
        seen.append((what, port_state["len"]))
    try:
        _sequence(runs, rng, clock, check)
    finally:
        for run in runs:
            run.close()
    # the sequence held objects at each step and the cleans dropped some
    assert all(n > 0 for _, n in seen)
    assert seen[-1][1] < 300 + 40 + 20


def test_slab_files_are_byte_equal_after_each_flush(tmp_path):
    pkgs = _packages()
    clock = [T0]
    runs = [_Run(pkgs[name], "slab", tmp_path / name, clock)
            for name in ("jax", "port")]
    compared = []

    def check(what):
        if what in ("flush", "reopen", "clean after the grace"):
            jax_files = _files(tmp_path / "jax" / "slabs")
            assert _files(tmp_path / "port" / "slabs") == jax_files, what
            compared.append({name.rsplit(".", 1)[1] for name in jax_files})
    _sequence(runs, np.random.default_rng([13, 5]), clock, check)
    # sealed slabs with their sidecars, and open slabs
    assert len(compared) == 3
    assert compared[0] == {"slab", "idx", "open"}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_slab_directory_opens_in_the_other_package(tmp_path, writer,
                                                     reader):
    pkgs = _packages()
    rng = np.random.default_rng([13, 7])
    objs = _draw(rng, 300, T0)
    store = pkgs[writer].SlabStore(tmp_path / "s", slab_max_bytes=1 << 12,
                                   clock=lambda: T0)
    for h, t, s, p, e, g in objs:
        store.add(h, t, s, p, e, g)
    store.flush()
    other = pkgs[reader].SlabStore(tmp_path / "s", slab_max_bytes=1 << 12,
                                   hot_bytes=0, clock=lambda: T0)
    assert other.recovery["sealed_indexed"] >= 3
    assert other.recovery["torn_bytes"] == 0
    assert len(other) == len(objs)
    for h, t, s, p, e, g in objs:
        item = other[h]
        assert (item.type, item.stream, item.payload, item.expires,
                item.tag) == (t, s, p, e, g)


def test_a_torn_tail_replays_as_in_the_jax_store(tmp_path):
    pkgs = _packages()
    rng = np.random.default_rng([13, 8])
    objs = _draw(rng, 10, T0)
    out = {}
    for name, pkg in pkgs.items():
        root = tmp_path / name
        store = pkg.SlabStore(root, slab_max_bytes=1 << 20,
                              clock=lambda: T0)
        for h, t, s, p, e, g in objs:
            store.add(h, t, s, p, e, g)
        store.flush()
        for f in sorted(root.rglob("*.open"))[:1]:
            with open(f, "ab") as fh:
                fh.write(b"\x00" * 17)       # a partial record
        again = pkg.SlabStore(root, slab_max_bytes=1 << 20,
                              clock=lambda: T0)
        # the torn bytes are cut: appends after them stay readable
        again.add(_h(b"after"), 2, 1, b"after", T0 + 900, b"")
        again.flush()
        third = pkg.SlabStore(root, slab_max_bytes=1 << 20,
                              clock=lambda: T0)
        out[name] = (again.recovery, len(again), sorted(third.hashes()),
                     third[_h(b"after")].payload, _files(root))
    assert out["port"] == out["jax"]
    assert out["port"][0]["torn_bytes"] == 17
    assert out["port"][1] == len(objs) + 1


def test_full_slab_io_chaos_loses_nothing(tmp_path):
    """Every drain and seal fails under 100% ``storage.slab_io``: every
    record stays readable from RAM, no slab is sealed, and once the
    fault clears a flush puts every record on disk."""
    rng = np.random.default_rng([13, 9])
    objs = _draw(rng, 200, T0)
    store = SlabStore(tmp_path / "s", slab_max_bytes=1 << 12,
                      drain_bytes=1 << 12, clock=lambda: T0)
    failures = REGISTRY.sample("slab_store_io_failures_total")
    errors = REGISTRY.sample("resilience_errors_total",
                             {"site": "storage.slab_io"})
    CHAOS.arm("storage.slab_io", probability=1.0)
    try:
        for h, t, s, p, e, g in objs:
            store.add(h, t, s, p, e, g)
        store.flush()
        assert len(store) == len(objs)
        assert all(store[h].payload == p for h, _, _, p, _, _ in objs)
        assert not list((tmp_path / "s").rglob("*.slab"))
        fired = CHAOS.active()["storage.slab_io"]["fired"]
    finally:
        CHAOS.disarm("storage.slab_io")
    assert fired > 0
    assert REGISTRY.sample("slab_store_io_failures_total") - failures \
        == fired
    assert REGISTRY.sample("resilience_errors_total",
                           {"site": "storage.slab_io"}) - errors == fired
    store.flush()
    again = SlabStore(tmp_path / "s", slab_max_bytes=1 << 12,
                      clock=lambda: T0)
    assert again.recovery["sealed_indexed"] > 0
    assert sorted(again.hashes()) == sorted(h for h, *_ in objs)
    assert all(again[h].payload == p for h, _, _, p, _, _ in objs)


def test_a_whole_bucket_drops_as_in_the_jax_store(tmp_path):
    pkgs = _packages()
    out = {}
    for name, pkg in pkgs.items():
        root = tmp_path / name
        store = pkg.SlabStore(root, bucket_seconds=60, clock=lambda: T0)
        dead = T0 - EXPIRES_GRACE - 7200
        for i in range(40):
            store.add(_h(b"%d" % i), 2, 1, b"obj %d" % i,
                      dead if i < 20 else T0 + 600, b"")
        store.flush()
        dropped = REGISTRY.sample("slab_store_dropped_slabs_total") \
            if name == "port" else 0
        assert (root / str(dead // 60)).exists()
        store.clean()
        out[name] = (len(store), sorted(store.hashes()), _files(root),
                     (root / str(dead // 60)).exists())
        if name == "port":
            assert REGISTRY.sample("slab_store_dropped_slabs_total") \
                == dropped + 1
    assert out["port"] == out["jax"]
    assert out["port"][0] == 20 and not out["port"][3]


@pytest.mark.parametrize("backend", ["sqlite", "filesystem", "slab"])
async def test_a_node_attaches_a_digest_where_the_jax_node_does(tmp_path,
                                                                backend):
    """The node's backend and its sync digest follow the JAX node's
    choice; the port node runs (starts, reconciles, stops) with no
    digest on ``filesystem``."""
    JaxNode = _jax("core.node").Node
    jnode = JaxNode(str(tmp_path / "jax"), listen=False, test_mode=True,
                    inventory_backend=backend, tls_enabled=False,
                    federation_enabled=False, wiretrace_enabled=False)
    try:
        want = (type(jnode.inventory).__name__,
                jnode.sync_digest is None, jnode.reconciler is not None)
    finally:
        jnode.pow_journal.close()
        jnode.db.close()
    node = Node(str(tmp_path / "port"), device="cpu", crypto_batch=False,
                listen=False, test_mode=True, inventory_backend=backend,
                federation_enabled=False)
    assert (type(node.inventory).__name__, node.sync_digest is None,
            node.reconciler is not None) == want
    assert node.reconciler.digest is node.sync_digest
    await node.start()
    try:
        node.inventory.add(_h(b"x"), 42, 1, b"x" * 64, 2_000_000_000, b"")
        assert _h(b"x") in node.inventory
    finally:
        await asyncio.wait_for(node.stop(), WAIT)
    assert (backend == "filesystem") == (node.sync_digest is None)


async def _wait(predicate, what: str) -> None:
    for _ in range(int(WAIT / 0.03)):
        if predicate():
            return
        await asyncio.sleep(0.03)
    raise AssertionError("timed out waiting for %s" % what)


async def _shed(make, tmp_path, objs) -> tuple:
    """Relay A (streams 1, 2) holding ``objs`` sheds stream 2 to relay B
    (stream 3), both on the slab store: the shed's reply and the hashes
    B's slab directory holds, reopened, at that moment."""
    ra = make(tmp_path / "a", (1, 2))
    rb = make(tmp_path / "b", (3,))
    await ra.start()
    await rb.start()
    try:
        for h, t, s, p, e, g in objs:
            ra.inventory.add(h, t, s, p, e, g)
        target = "127.0.0.1:%d" % rb.role_runtime.listen_port
        res = await asyncio.wait_for(
            ra.role_runtime.shed_stream(2, target), WAIT)
        durable = SlabStore(tmp_path / "b" / "slabs", hot_bytes=0)
        held = set(durable.hashes())
        await _wait(lambda: all(h in rb.inventory for h, _, s, *_ in objs
                                if s == 2), "the receiver's records")
    finally:
        for node in (ra, rb):
            await asyncio.wait_for(node.stop(), WAIT)
    return res, held


async def test_a_relay_on_slab_sheds_in_the_jax_relays_buckets(tmp_path):
    """Both packages' relays walk the slab store's expiry buckets on a
    shed, so the reply counts the stream's distinct buckets.  The port
    receiver flushes before it acks the drain's end: its slab files hold
    every drained record at once, where the JAX receiver's hold none of
    them yet (its write-behind tail is under the drain threshold)."""
    JaxNode = _jax("core.node").Node
    now = int(time.time())
    rng = np.random.default_rng([13, 11])
    objs = []
    for i in range(60):
        payload = rng.bytes(80)
        objs.append((_h(payload), 42, 1 + i % 2, payload,
                     now + 600 + (i % 5) * 3600, b""))
    buckets = len({e // 3600 for _, _, s, _, e, _ in objs if s == 2})
    drained = {h for h, _, s, *_ in objs if s == 2}

    def port_relay(root, streams):
        return Node(str(root), device="cpu", crypto_batch=False,
                    listen=False, test_mode=True, role="relay",
                    role_ipc_listen="127.0.0.1:0", role_streams=streams,
                    inventory_backend="slab", federation_enabled=False)

    def jax_relay(root, streams):
        return JaxNode(str(root), listen=False, test_mode=True,
                       role="relay", role_ipc_listen="127.0.0.1:0",
                       role_streams=streams, inventory_backend="slab",
                       tls_enabled=False, sync_enabled=False,
                       wiretrace_enabled=False, federation_enabled=False)

    port_res, port_held = await _shed(port_relay, tmp_path / "port", objs)
    jax_res, jax_held = await _shed(jax_relay, tmp_path / "jax", objs)
    assert buckets == 5
    for res in (port_res, jax_res):
        assert res["buckets"] == buckets
        assert res["objectsDrained"] == len(drained)
    assert {k: v for k, v in port_res.items() if k != "target"} == \
        {k: v for k, v in jax_res.items() if k != "target"}
    assert drained <= port_held
    assert not drained & jax_held
