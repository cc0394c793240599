"""The port's set-reconciliation sync against the JAX package's, on the CPU.

Held against ``pybitmessage_tpu.network.messages`` (the sync codecs),
``pybitmessage_tpu.sync.sketch``, ``.reconciler`` and ``.mesh``, and
``pybitmessage_tpu.storage.inventory``'s digest hooks:

- ``sketchreq`` / ``sketch`` / ``recondiff`` over seeded inputs are
  byte-equal, each package decodes the other's, and truncated or
  over-bound payloads are refused alike;
- ``short_ids`` (numpy sweep and scalar loop, wraparound included),
  ``normalize_cells``, ``capacity_for`` and ``Sketch`` cells are equal
  for the same hashes, salt and size; ``subtract`` + ``decode`` recover
  the same two sets, and an overflowed table raises in both;
- an ``Inventory`` with a digest attached keeps the same summaries as
  the JAX one through adds and a clean, with no rescan;
- ``Reconciler.route_announcement`` splits flood and pending alike
  under the same seed;
- the 24-node seeded mesh (160 base objects, 48 live, degree 3) at
  fanout 0 and 1 converges to equal inventories with equal bytes per
  command, and ``sync.sketch_decode`` chaos degrades to flooding with 0
  lost in both packages; with federation on, the merged per-node
  counters agree;
- both packages' ``Node``s advertise NODE_SYNC and NODE_TRACE, attach a
  digest and a reconciler (a relay's digest its own streams only, none
  on an edge) and run an aggregator by default, each switch turns its
  part off, and a stream change re-scopes the digest alike.

The JAX side draws from the global ``random`` seeded with ``s``; the
port side from one ``random.Random(s)`` it is handed, so the draws come
in the same order.  Everything compared is exact.  Nothing of JAX is
imported at module level; each async test runs under its own limit.
"""

import asyncio
import functools
import random
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch.network import messages as port_msgs
from pybitmessage_tpu_torch.resilience import CHAOS as PORT_CHAOS
from pybitmessage_tpu_torch.storage.db import Database
from pybitmessage_tpu_torch.storage.inventory import Inventory
from pybitmessage_tpu_torch.sync import digest as port_digest
from pybitmessage_tpu_torch.sync import mesh as port_mesh
from pybitmessage_tpu_torch.sync import reconciler as port_recon
from pybitmessage_tpu_torch.sync import sketch as port_sketch
from pybitmessage_tpu_torch.utils.varint import encode_varint

#: the limit of each async test, seconds
LIMIT = 30.0


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.network import messages
    from pybitmessage_tpu.resilience import CHAOS
    from pybitmessage_tpu.storage import Database, Inventory
    from pybitmessage_tpu.sync import digest, mesh, reconciler, sketch
    return SimpleNamespace(msgs=messages, sketch=sketch, digest=digest,
                           recon=reconciler, mesh=mesh, chaos=CHAOS,
                           Database=Database, Inventory=Inventory)


def limited(fn):
    """Run an async test body under ``asyncio.wait_for(LIMIT)``."""
    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), LIMIT)
    return wrapper


def _hashes(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [bytes(r) for r in rng.integers(0, 256, (n, 32), dtype=np.uint8)]


def _summaries(rng) -> dict:
    out = {}
    for stream in sorted(set(int(s) for s in rng.integers(1, 9, 3))):
        n = int(rng.integers(0, 40))
        out[stream] = [(int(c), int(x)) for c, x in zip(
            rng.integers(0, 5000, n),
            rng.integers(0, 2 ** 63, n, dtype=np.uint64) * 2 + 1)]
    return out


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def test_codec_constants_agree():
    j = _jax().msgs
    for name in ("SKETCH_KIND_IBLT", "SKETCH_KIND_DIGEST", "RECONDIFF_OK",
                 "RECONDIFF_DECODE_FAILED", "MAX_SKETCH_CELLS",
                 "MAX_DIGEST_BUCKETS", "_SKETCH_CELL_BYTES"):
        assert getattr(port_msgs, name) == getattr(j, name), name


@pytest.mark.parametrize("seed", range(4))
def test_sketchreq_is_byte_equal(seed):
    j = _jax().msgs
    rng = np.random.default_rng([seed, 1])
    salt = int(rng.integers(0, 2 ** 63, dtype=np.uint64)) * 2 + 1
    cap, size = int(rng.integers(0, 1 << 16)), int(rng.integers(0, 1 << 20))
    summ = _summaries(rng)
    for kind, s in ((j.SKETCH_KIND_IBLT, None),
                    (j.SKETCH_KIND_DIGEST, summ)):
        mine = port_msgs.encode_sketchreq(kind, salt, cap, size,
                                          summaries=s)
        theirs = j.encode_sketchreq(kind, salt, cap, size, summaries=s)
        assert mine == theirs
        assert port_msgs.decode_sketchreq(theirs) == \
            j.decode_sketchreq(mine) == (kind, salt, cap, size, s)


@pytest.mark.parametrize("seed", range(4))
def test_sketch_is_byte_equal(seed):
    j = _jax().msgs
    rng = np.random.default_rng([seed, 2])
    salt = int(rng.integers(0, 2 ** 63, dtype=np.uint64))
    cells = rng.bytes(13 * int(rng.integers(0, 300)))
    summ = _summaries(rng)
    for kind, kw in ((j.SKETCH_KIND_IBLT, {"cells": cells}),
                     (j.SKETCH_KIND_DIGEST, {"summaries": summ})):
        mine = port_msgs.encode_sketch(kind, salt, 77, **kw)
        theirs = j.encode_sketch(kind, salt, 77, **kw)
        assert mine == theirs
        assert port_msgs.decode_sketch(theirs) == j.decode_sketch(mine)


@pytest.mark.parametrize("seed", range(4))
def test_recondiff_is_byte_equal(seed):
    j = _jax().msgs
    rng = np.random.default_rng([seed, 3])
    missing = _hashes(int(rng.integers(0, 30)), seed)
    want = [int(w) for w in rng.integers(0, 2 ** 63, int(rng.integers(0, 60)),
                                         dtype=np.uint64) * 2 + 1]
    args = (int(rng.integers(0, 2)), int(rng.integers(0, 2 ** 62)),
            int(rng.integers(0, 1000)), missing, want)
    mine, theirs = port_msgs.encode_recondiff(*args), j.encode_recondiff(*args)
    assert mine == theirs
    assert port_msgs.decode_recondiff(theirs) == j.decode_recondiff(mine) \
        == args


def _bad(case: str) -> tuple:
    """(decoder name, payload) of a malformed or over-bound payload."""
    salt = struct.pack(">Q", 5)
    return {
        "sketchreq-short-salt": ("decode_sketchreq", b"\x00\x01\x02"),
        "sketchreq-capacity": ("decode_sketchreq", b"\x00" + salt
                               + encode_varint((1 << 16) + 1) + b"\x00"),
        "sketchreq-streams": ("decode_sketchreq", b"\x01" + salt
                              + b"\x00\x00" + encode_varint(257)),
        "sketchreq-buckets": ("decode_sketchreq", b"\x01" + salt
                              + b"\x00\x00\x01\x01" + encode_varint(4097)),
        "sketchreq-summary": ("decode_sketchreq", b"\x01" + salt
                              + b"\x00\x00\x01\x01\x01\x05\x00\x00"),
        "sketch-short-salt": ("decode_sketch", b"\x00\x00"),
        "sketch-cells": ("decode_sketch", b"\x00" + salt + b"\x00"
                         + encode_varint((1 << 16) + 1)),
        "sketch-truncated": ("decode_sketch", b"\x00" + salt + b"\x00"
                             + b"\x02" + b"\x00" * 20),
        "recondiff-short-salt": ("decode_recondiff", b"\x00\x00\x00"),
        "recondiff-hashes": ("decode_recondiff", b"\x00" + salt + b"\x00"
                             + encode_varint(50001)),
        "recondiff-truncated": ("decode_recondiff", b"\x00" + salt + b"\x00"
                                + b"\x02" + b"\x11" * 40),
        "recondiff-ids": ("decode_recondiff", b"\x00" + salt + b"\x00\x00"
                          + encode_varint(50001)),
        "recondiff-short-ids": ("decode_recondiff", b"\x00" + salt
                                + b"\x00\x00\x02" + b"\x00" * 9),
    }[case]


@pytest.mark.parametrize("case", [
    "sketchreq-short-salt", "sketchreq-capacity", "sketchreq-streams",
    "sketchreq-buckets", "sketchreq-summary", "sketch-short-salt",
    "sketch-cells", "sketch-truncated", "recondiff-short-salt",
    "recondiff-hashes", "recondiff-truncated", "recondiff-ids",
    "recondiff-short-ids"])
def test_sync_refusals_agree(case):
    j = _jax().msgs
    name, payload = _bad(case)
    with pytest.raises(j.MessageError) as theirs:
        getattr(j, name)(payload)
    with pytest.raises(port_msgs.MessageError) as mine:
        getattr(port_msgs, name)(payload)
    assert str(mine.value) == str(theirs.value)


def test_unaligned_cells_are_refused_alike():
    j = _jax().msgs
    with pytest.raises(j.MessageError) as theirs:
        j.encode_sketch(j.SKETCH_KIND_IBLT, 1, 1, cells=b"\x00" * 5)
    with pytest.raises(port_msgs.MessageError) as mine:
        port_msgs.encode_sketch(port_msgs.SKETCH_KIND_IBLT, 1, 1,
                                cells=b"\x00" * 5)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# the sketch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 16, 300])
def test_short_ids_agree_with_both_paths(n):
    """The numpy sweep (16 hashes and up), the scalar loop and the JAX
    module give the same IDs bit for bit, wraparound included: salts
    at both ends of the 64-bit range and hashes of all-ones words."""
    sk = _jax().sketch
    hs = _hashes(n, n) + [b"\xff" * 32, b"\x00" * 32]
    for salt in (0, 1, 2 ** 64 - 1, 0x9E3779B97F4A7C15, -1):
        mine = port_sketch.short_ids(hs, salt)
        assert mine == [port_sketch.short_id(h, salt) for h in hs]
        assert mine == sk.short_ids(hs, salt)
        assert port_sketch.short_id_map(hs, salt) == \
            sk.short_id_map(hs, salt)


def test_cell_sizing_agrees():
    sk = _jax().sketch
    for cells in list(range(-3, 40)) + [1 << 16, (1 << 16) + 5, 10 ** 9]:
        assert port_sketch.normalize_cells(cells) == \
            sk.normalize_cells(cells)
    for diff in (0, 0.5, 1, 7.3, 100, 4000, 1e6):
        assert port_sketch.capacity_for(diff) == sk.capacity_for(diff)


@pytest.mark.parametrize("n,cells", [(10, 15), (63, 30), (64, 30),
                                     (500, 300)])
def test_sketch_cells_are_byte_equal(n, cells):
    sk = _jax().sketch
    hs = _hashes(n, 100 + n)
    mine = port_sketch.Sketch.encode(hs, 0xC0FFEE, cells)
    theirs = sk.Sketch.encode(hs, 0xC0FFEE, cells)
    assert mine.to_bytes() == theirs.to_bytes()
    back = port_sketch.Sketch.from_bytes(theirs.to_bytes(), 0xC0FFEE)
    assert back.to_bytes() == theirs.to_bytes()


@pytest.mark.parametrize("seed", range(3))
def test_subtract_and_decode_recover_the_same_sets(seed):
    sk = _jax().sketch
    hs = _hashes(400, seed)
    ours, theirs_ = hs[:380], hs[20:]
    salt = 1000 + seed
    cells = sk.capacity_for(60)
    got = []
    for mod in (port_sketch, sk):
        a = mod.Sketch.encode(ours, salt, cells)
        b = mod.Sketch.encode(theirs_, salt, cells)
        got.append(a.subtract(b).decode())
    assert got[0] == got[1]
    assert got[0][0] == set(port_sketch.short_ids(hs[:20], salt))
    assert got[0][1] == set(port_sketch.short_ids(hs[380:], salt))


def test_overflow_raises_in_both():
    sk = _jax().sketch
    hs = _hashes(200, 9)
    for mod in (port_sketch, sk):
        table = mod.Sketch.encode(hs, 3, 15)
        with pytest.raises(mod.SketchDecodeError):
            table.subtract(mod.Sketch(15, 3)).decode()
        with pytest.raises(ValueError):
            table.subtract(mod.Sketch(18, 3))
        with pytest.raises(ValueError):
            mod.Sketch.from_bytes(b"\x00" * 14, 3)


# ---------------------------------------------------------------------------
# the inventory's digest
# ---------------------------------------------------------------------------


def test_inventory_digest_is_kept_alike_without_a_rescan():
    j = _jax()
    now = int(time.time())
    rng = np.random.default_rng(5)
    hs = _hashes(120, 5)
    streams = [int(s) for s in rng.integers(1, 3, len(hs))]
    pairs = []
    for db_cls, inv_cls, dig_mod in ((Database, Inventory, port_digest),
                                     (j.Database, j.Inventory, j.digest)):
        inv = inv_cls(db_cls(":memory:"))
        for h, s in zip(hs[:60], streams):
            inv.add(h, 2, s, b"x" + h, now + 600)
        inv.flush()
        digest = dig_mod.InventoryDigest()
        inv.attach_digest(digest)
        for h, s in zip(hs[60:], streams[60:]):
            inv.add(h, 2, s, b"y" + h, now + (600 if s == 1 else -10))
        inv.clean()
        pairs.append((digest, inv))
    (mine, _), (theirs, _) = pairs
    for stream in (1, 2):
        assert mine.summaries(stream) == theirs.summaries(stream)
        assert sorted(mine.hashes_by_stream(stream)) == \
            sorted(theirs.hashes_by_stream(stream))
    assert len(mine) == len(theirs)
    # one scan at attach, every later change folded in incrementally
    assert mine.incremental_updates == theirs.incremental_updates > 0


# ---------------------------------------------------------------------------
# announcement routing
# ---------------------------------------------------------------------------


class _Tracker:
    def __init__(self):
        self.announced = []

    def we_should_announce(self, h):
        self.announced.append(h)


class _Conn:
    def __init__(self, i):
        self.tracker = _Tracker()
        self.host, self.port = "10.0.0.%d" % i, 8444


def _route(recon_mod, rng, fanout):
    pool = SimpleNamespace(ctx=SimpleNamespace(streams=(1,)))
    rec = recon_mod.Reconciler(pool, fanout=fanout,
                               clock=lambda: 100.0, **rng)
    conns = [_Conn(i) for i in range(9)]
    for c in conns:
        rec.register(c)
    for h in _hashes(40, 8):
        rec.route_announcement(h, conns)
    rec.route_announcement(b"\x01" * 32, conns, stream=2)
    return ([c.tracker.announced for c in conns],
            [sorted(rec.sessions[c].pending) for c in conns],
            [rec.sessions[c].last_round for c in conns])


@pytest.mark.parametrize("fanout", [None, 0, 2, 20])
def test_route_announcement_splits_alike(fanout):
    j = _jax().recon
    random.seed(17)
    theirs = _route(j, {}, fanout)
    mine = _route(port_recon, {"rng": random.Random(17)}, fanout)
    assert mine == theirs


async def _overdue(recon_mod, rng, kind: str):
    """One session whose round (or catch-up) is past its deadline, then
    one tick: what the tick settled."""
    pool = SimpleNamespace(ctx=SimpleNamespace(streams=(1,),
                                               dandelion=None))
    rec = recon_mod.Reconciler(pool, clock=lambda: 100.0, **rng)
    conn = _Conn(1)
    s = rec.register(conn)
    big_invs = []

    async def big_inv(c):
        big_invs.append(c.host)
    rec._big_inv = big_inv
    hashes = _hashes(6, 11)
    if kind == "round":
        s.state = recon_mod.AWAIT_SKETCH
        s.snapshot = {i: h for i, h in enumerate(hashes)}
        s.deadline = recon_mod.Deadline(-1.0)
    else:
        s.catchup_salt = 7
        s.catchup_deadline = recon_mod.Deadline(-1.0)
    await rec.tick()
    return (s.state, s.failures, s.deadline is None, s.catchup_salt,
            s.catchup_deadline is None, conn.tracker.announced, big_invs)


@pytest.mark.parametrize("kind", ["round", "catchup"])
async def test_an_overdue_round_or_catchup_is_settled_alike(kind):
    """A round awaiting its sketch past its deadline fails as
    ``timeout`` (its snapshot flooded), and an unanswered catch-up
    falls back to the big inv, in both packages: the port's tick once
    raised on the deadline it read (ROADMAP fault 3.10)."""
    j = _jax().recon
    random.seed(5)
    theirs = await _overdue(j, {}, kind)
    mine = await _overdue(port_recon, {"rng": random.Random(5)}, kind)
    assert mine == theirs
    if kind == "round":
        assert mine[1] == 1 and len(mine[5]) == 6
    else:
        assert mine[3] is None and mine[6] == ["10.0.0.1"]


# ---------------------------------------------------------------------------
# the simulated mesh
# ---------------------------------------------------------------------------


def _edges(nodes: int, degree: int, seed: int) -> list:
    """A ring plus seeded chords, ``nodes * degree`` links (the JAX
    bench's federated-mesh topology)."""
    rng = random.Random(seed)
    edges = {tuple(sorted((i, (i + 1) % nodes))) for i in range(nodes)}
    while len(edges) < nodes * degree:
        a, b = rng.randrange(nodes), rng.randrange(nodes)
        if a != b:
            edges.add(tuple(sorted((a, b))))
    return sorted(edges)


async def _storm(mesh_mod, *, fanout, mesh_rng=None, federation=False,
                 nodes=24, base_n=160, live=48, degree=3, seed=11):
    kw = {} if mesh_rng is None else {"rng": mesh_rng}
    mesh = mesh_mod.Mesh(nodes, edges=_edges(nodes, degree, seed),
                         sync=True, fanout=fanout, federation=federation,
                         federate_every=16, **kw)
    base = _hashes(base_n, seed)
    seed_rng = random.Random(seed + 2)
    for i in range(nodes):
        missing = set(seed_rng.sample(range(base_n), max(base_n // 50, 1)))
        mesh.seed(i, [h for k, h in enumerate(base) if k not in missing])
    await mesh.establish(links_per_tick=max(len(mesh.edges) // 20, 1))
    fresh = _hashes(live, seed + 3)
    inj_rng = random.Random(seed + 4)
    for k, h in enumerate(fresh):
        mesh.inject(inj_rng.randrange(nodes), h)
        if k % 2:
            await mesh.tick()
    ticks = await mesh.run_until_converged(max_ticks=600)
    if federation:
        mesh.federate_once()
    for node in mesh.nodes:
        assert len(node.inventory) == base_n + live
    return mesh, ticks


@pytest.mark.parametrize("fanout", [0, 1])
@limited
async def test_seeded_mesh_converges_with_equal_bytes(fanout):
    j = _jax().mesh
    random.seed(23)
    theirs, t_ticks = await _storm(j, fanout=fanout)
    mine, m_ticks = await _storm(port_mesh, fanout=fanout,
                                 mesh_rng=random.Random(23))
    assert m_ticks == t_ticks
    assert [sorted(n.inventory) for n in mine.nodes] == \
        [sorted(n.inventory) for n in theirs.nodes]
    assert mine.stats.bytes_by_command == theirs.stats.bytes_by_command
    assert mine.stats.deliveries == theirs.stats.deliveries
    assert mine.stats.bytes_by_command["sketch"] > 0


@limited
async def test_sketch_decode_chaos_degrades_to_flooding_in_both():
    """Every sketch decode fails: each round and catch-up falls back
    (doubled capacity, then a flood requeue or a big inv) and every
    node still converges, in both packages."""
    j = _jax()
    fallbacks = []
    for mesh_mod, chaos, recon in ((j.mesh, j.chaos, j.recon),
                                   (port_mesh, PORT_CHAOS, port_recon)):
        chaos.arm("sync.sketch_decode", probability=1.0)
        try:
            before = recon.FALLBACKS.value
            mesh, _ = await _storm(mesh_mod, fanout=1, nodes=12,
                                   base_n=80, live=24,
                                   mesh_rng=None if mesh_mod is j.mesh
                                   else random.Random(3))
            fallbacks.append(recon.FALLBACKS.value - before)
            assert mesh.stats.bytes_by_command.get("inv", 0) > 0
        finally:
            chaos.disarm("sync.sketch_decode")
    assert all(f > 0 for f in fallbacks)


@limited
async def test_federated_mesh_merges_alike():
    """With federation on, every simulated node pushes its own registry
    through a real publisher into the mesh aggregator: the merged
    counters and propagation percentiles agree across the packages."""
    j = _jax().mesh
    random.seed(29)
    theirs, _ = await _storm(j, fanout=1, federation=True)
    mine, _ = await _storm(port_mesh, fanout=1, federation=True,
                           mesh_rng=random.Random(29))
    for name in ("mesh_delivered_objects_total",
                 "mesh_announce_bytes_total",
                 "mesh_propagation_seconds"):
        assert mine.aggregator.merged_value(name) == \
            theirs.aggregator.merged_value(name) > 0, name
    assert mine.federated_propagation_percentiles() == \
        theirs.federated_propagation_percentiles()
    assert mine.aggregator.status()["fleet"] == \
        theirs.aggregator.status()["fleet"]


# ---------------------------------------------------------------------------
# the node's defaults
# ---------------------------------------------------------------------------


def _nodes(**kw):
    """A port and a JAX ``Node`` built alike (in memory, not started)."""
    from pybitmessage_tpu.core.node import Node as JaxNode
    from pybitmessage_tpu.pow.dispatcher import python_solve
    from pybitmessage_tpu_torch.core import Node
    port = Node(device="cpu", listen=False, crypto_batch=False,
                test_mode=True, **kw)
    jax = JaxNode(None, listen=False, test_mode=True,
                  solver=lambda ih, t, should_stop=None: python_solve(ih, t),
                  **kw)
    return port, jax


def _close(*nodes):
    for node in nodes:
        node.pow_journal.close()
        node.db.close()


@pytest.mark.parametrize("role", ["all", "relay", "edge"])
def test_nodes_run_the_network_plane_by_default_alike(role):
    """Both packages' nodes advertise NODE_SYNC and NODE_TRACE and run a
    reconciler over an attached digest (a relay's covering only its own
    streams; an edge reconciles nothing) and a federation aggregator
    with the node's own publisher."""
    _jax()
    kw = {"role": role, "role_streams": (1, 2)}
    if role == "relay":
        kw["role_ipc_listen"] = "127.0.0.1:0"
    if role == "edge":
        kw["role_ipc_connect"] = "127.0.0.1:9"     # never dialed here
    port, jax = _nodes(**kw)
    try:
        assert port.ctx.services == jax.ctx.services
        # an edge traces but does not advertise sync
        assert bool(port.ctx.services & 16) == (role != "edge")
        assert port.ctx.services & 32
        for node in (port, jax):
            runs = role != "edge"
            assert (node.reconciler is not None) == runs
            assert node.pool.reconciler is node.reconciler
            assert (node.sync_digest is not None) == runs
            if runs:
                assert node.inventory._digest is node.sync_digest
                assert node.reconciler.digest is node.sync_digest
                assert node.sync_digest.streams == (
                    {1, 2} if role == "relay" else None)
            assert node.federation is not None
            assert node.federation_publisher.transport == \
                node.federation.ingest
    finally:
        _close(port, jax)


def test_a_stream_change_rescopes_the_digest_alike():
    """``set_streams`` re-seeds the relay's digest from the inventory:
    an acquired stream's stored objects enter it, a shed stream's
    leave."""
    _jax()
    kw = {"role": "relay", "role_streams": (1,),
          "role_ipc_listen": "127.0.0.1:0"}
    port, jax = _nodes(**kw)
    try:
        now = int(time.time())
        hs = _hashes(12, 31)
        for node in (port, jax):
            for i, h in enumerate(hs):
                node.inventory.add(h, 42, 1 + i % 3, b"z" + h, now + 600)
        sizes = []
        for streams in ((1, 3), (3,)):
            for node in (port, jax):
                node.set_streams(streams)
            sizes.append((len(port.sync_digest), len(jax.sync_digest)))
            for s in (1, 2, 3):
                assert port.sync_digest.summaries(s) == \
                    jax.sync_digest.summaries(s)
        assert sizes == [(8, 8), (4, 4)]
    finally:
        _close(port, jax)


@pytest.mark.parametrize("switch", ["sync_enabled", "wiretrace_enabled",
                                    "federation_enabled"])
def test_each_switch_turns_its_part_off_alike(switch):
    _jax()
    port, jax = _nodes(**{switch: False})
    try:
        assert port.ctx.services == jax.ctx.services
        for node in (port, jax):
            assert (node.reconciler is None) == (switch == "sync_enabled")
            assert bool(node.ctx.services & 32) == \
                (switch != "wiretrace_enabled")
            assert (node.federation is None) == \
                (switch == "federation_enabled")
    finally:
        _close(port, jax)
