"""The port's edge and relay roles against the JAX package's, on the CPU.

Pure parts, on inputs drawn from seeded numpy: the role registry,
``parse_role_streams``, the stream mapper over 1,000 ripes,
``shard_owner``/``shard_members``, every role-IPC frame byte-equal in
both directions (each package decodes the other's) with junk and
truncations rejected alike, the ``EdgeCache`` under one op sequence,
the role settings' validators and the roles' metric families.

Deployments over loopback TCP (``Node(device="cpu")``, SQLite on both
sides): a port edge in front of a JAX relay and a JAX edge in front of a
port relay, 24 objects each way, redelivery deduped; the port-only
twins of ``tests/test_roles.py`` (two sharded relays, replica failover
after a primary's stop, a live shard handoff with forwarding, the
mid-drain shadow forward, stale-epoch frames, a relay's push and an
edge's fetch serving a getdata); ``roleStatus``, ``shardStatus`` and
``shardShed`` against the JAX commands on the same deployment; the
relay's ``stop`` returning with an edge and a peer relay connected
(the JAX relay's waits for the peer, ROADMAP §3); and zero objects lost
under ``role.ipc`` faults and a relay's restart.

Objects are test-mode msgs (ntpb = extra = 10) built once per module by
the JAX tests' ``build_msg_objects``; no sleep is longer than 0.3 s.
Nothing of JAX is imported at module level.
"""

import asyncio
import dataclasses
import importlib
import inspect
import ast
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch.api.commands import CommandHandler
from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.core import config as port_config
from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.roles import (ROLES, edge as port_edge,
                                          get_role, ipc as port_ipc,
                                          parse_role_streams,
                                          registry as port_registry,
                                          streams as port_streams)

TESTS = os.path.dirname(os.path.abspath(__file__))
#: seconds a deployment may take to reach a state
WAIT = 15.0


def _jax(name: str):
    import jax
    jax.config.update("jax_platforms", "cpu")
    return importlib.import_module("pybitmessage_tpu." + name)


def _helpers():
    """The JAX role tests' wire client and ``build_msg_objects``."""
    _jax("roles")
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    import test_roles
    return test_roles


@pytest.fixture(scope="module")
def objs():
    """Test-mode msg objects: 24 on stream 1, 8 on stream 2, 12 more on
    stream 1, 2 more on stream 2."""
    build = _helpers().build_msg_objects
    return SimpleNamespace(s1=build(24), s2=build(8, stream=2),
                           more=build(12), late=build(2, stream=2))


def _hash(payload: bytes) -> bytes:
    from pybitmessage_tpu_torch.utils.hashes import inventory_hash
    return inventory_hash(payload)


async def wait_for(predicate, timeout: float = WAIT, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        await asyncio.sleep(0.03)
    raise AssertionError("timed out waiting for %s" % what)


def port_relay(streams=None, listen="127.0.0.1:0"):
    return Node(None, device="cpu", crypto_batch=False, listen=False,
                test_mode=True, role="relay", role_ipc_listen=listen,
                role_streams=streams)


def port_edge_node(ipc_ports, streams=None):
    return Node(None, device="cpu", crypto_batch=False, test_mode=True,
                role="edge", role_streams=streams,
                role_ipc_connect=",".join("127.0.0.1:%d" % p
                                          for p in ipc_ports))


def _jax_node(**kw):
    JaxNode = _jax("core.node").Node
    return JaxNode(None, port=0, test_mode=True, tls_enabled=False,
                   sync_enabled=False, wiretrace_enabled=False,
                   federation_enabled=False, inventory_backend="sqlite",
                   **kw)


def jax_relay(streams=None):
    return _jax_node(listen=False, role="relay",
                     role_ipc_listen="127.0.0.1:0", role_streams=streams)


def jax_edge(ipc_ports, streams=None):
    return _jax_node(listen=True, role="edge", role_streams=streams,
                     role_ipc_connect=",".join("127.0.0.1:%d" % p
                                               for p in ipc_ports))


async def stop_all(*nodes):
    for node in nodes:
        if node is not None:
            await asyncio.wait_for(node.stop(), WAIT)


# ---------------------------------------------------------------------------
# registry, settings, stream mapper
# ---------------------------------------------------------------------------


def test_the_registry_is_the_jax_registry():
    jax_reg = _jax("roles.registry")
    assert list(ROLES) == list(jax_reg.ROLES)
    for name, spec in ROLES.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(jax_reg.ROLES[name])
        assert get_role(name) == spec
    for module in (port_registry, jax_reg):
        with pytest.raises(ValueError) as err:
            module.get_role("solver9000")
        assert str(err.value) == \
            "unknown node role 'solver9000' (one of all/client/edge/relay)"


def test_parse_role_streams_answers_as_jax():
    jax_reg = _jax("roles.registry")
    rng = np.random.default_rng(10)
    specs = ["", " , ", "1", "3, 1,2,3", "1,banana", "0", "4294967295",
             "4294967296", "-2", "1,,2", " 7 "]
    for _ in range(200):
        values = rng.integers(0, 12, size=int(rng.integers(0, 6)))
        specs.append(",".join(" " * int(rng.integers(0, 2)) + str(v)
                              for v in values))
    for spec in specs:
        want = got = None
        try:
            want = jax_reg.parse_role_streams(spec)
        except ValueError as exc:
            want = ("ValueError", str(exc))
        try:
            got = parse_role_streams(spec)
        except ValueError as exc:
            got = ("ValueError", str(exc))
        assert got == want, spec


@pytest.mark.parametrize("nstreams", [1, 2, 3, 8])
def test_stream_mapper_over_seeded_ripes(nstreams):
    jax_streams = _jax("roles.streams")
    from pybitmessage_tpu_torch.utils.addresses import encode_address
    rng = np.random.default_rng([10, nstreams])
    ripes = [rng.bytes(20) for _ in range(1000)]
    got = [port_streams.stream_for_ripe(r, nstreams) for r in ripes]
    assert got == [jax_streams.stream_for_ripe(r, nstreams) for r in ripes]
    assert set(got) == set(range(1, nstreams + 1))
    for ripe in ripes[:20]:
        address = encode_address(4, 1, ripe)
        assert port_streams.stream_for_address(address, nstreams) == \
            jax_streams.stream_for_address(address, nstreams)


def test_shard_owner_and_members_as_jax():
    jax_streams = _jax("roles.streams")
    rng = np.random.default_rng(11)
    for _ in range(300):
        table = {}
        for owner in "abcde"[:int(rng.integers(0, 6))]:
            n = int(rng.integers(0, 3))
            table[owner] = tuple(int(s) for s in rng.integers(1, 5, size=n))
        for stream in range(1, 6):
            assert port_streams.shard_owner(stream, table) == \
                jax_streams.shard_owner(stream, table)
            assert port_streams.shard_members(stream, table) == \
                jax_streams.shard_members(stream, table)


def test_role_settings_validate_and_persist_as_jax(tmp_path):
    config = _jax("core.config")
    samples = ["", "all", "edge", "relay", "client", "spaghetti", "1",
               "1,2,3", "3, 1", "1,zebra", "0", "4", "64", "65",
               "8460", "127.0.0.1:8460", "127.0.0.1:0", "host:port",
               "127.0.0.1:8460,10.0.0.2:8461", "127.0.0.1:notaport",
               "127.0.0.1:65536"]
    for key in ("role", "rolestreams", "edgeprocs", "roleipclisten",
                "roleipcconnect"):
        assert port_config.DEFAULTS[key] == config.DEFAULTS[key]
        for value in samples:
            assert port_config.VALIDATORS[key](value) == \
                config.VALIDATORS[key](value), (key, value)
    path = tmp_path / "settings.dat"
    s = port_config.Settings(path)
    s.set("role", "relay")
    s.set("rolestreams", "2,4")
    s.set("edgeprocs", 8)
    s.set("roleipclisten", "127.0.0.1:8460")
    s.set("roleipcconnect", "127.0.0.1:8460,127.0.0.1:8461")
    s.save()
    back = config.Settings(path)
    assert back.get("role") == "relay"
    assert parse_role_streams(back.get("rolestreams")) == (2, 4)
    assert back.getint("edgeprocs") == 8
    assert back.get("roleipcconnect") == "127.0.0.1:8460,127.0.0.1:8461"


def test_node_role_arguments_refuse_as_jax():
    with pytest.raises(ValueError, match="roleipcconnect"):
        Node(None, device="cpu", crypto_batch=False, listen=False,
             role="edge")
    with pytest.raises(ValueError, match="roleipclisten"):
        Node(None, device="cpu", crypto_batch=False, listen=False,
             role="relay")
    with pytest.raises(ValueError, match="client role"):
        Node(None, device="cpu", crypto_batch=False, listen=False,
             role="client")
    with pytest.raises(ValueError, match="unknown node role"):
        Node(None, device="cpu", crypto_batch=False, listen=False,
             role="solver")


# ---------------------------------------------------------------------------
# role IPC frames
# ---------------------------------------------------------------------------


def _record_args(rng, stream=None):
    return (rng.bytes(32), int(rng.integers(0, 4)),
            stream or int(rng.integers(1, 1 << 32)),
            int(rng.integers(-(1 << 40), 1 << 40)),
            rng.bytes(int(rng.integers(0, 65))),
            rng.bytes(int(rng.integers(0, 2000))))


def _frames(ipc, rng):
    """Every message kind -> (type, payload) built by module ``ipc``
    from ``rng``'s draws."""
    def streams():
        return tuple(int(s) for s in
                     rng.integers(1, 1 << 32, size=int(rng.integers(0, 6))))
    role = ["edge", "relay"][int(rng.integers(0, 2))]
    node_id = rng.bytes(8).hex()
    records = [ipc.encode_record(*_record_args(rng))
               for _ in range(int(rng.integers(0, 5)))]
    return {
        "hello": (ipc.MSG_HELLO, ipc.encode_hello(role, node_id, streams())),
        "hello_ack": (ipc.MSG_HELLO_ACK, ipc.encode_hello(
            "relay", node_id, streams(), int(rng.integers(0, 1 << 62)))),
        "objects": (ipc.MSG_OBJECTS, ipc.encode_objects(
            int(rng.integers(0, 1 << 62)), records)),
        "objects_ack": (ipc.MSG_OBJECTS_ACK, ipc.encode_objects_ack(
            *(int(v) for v in rng.integers(0, 1 << 31, size=4)))),
        "inv": (ipc.MSG_INV, ipc.encode_inv([
            (int(rng.integers(1, 1 << 32)), int(rng.integers(0, 1 << 40)),
             rng.bytes(32)) for _ in range(int(rng.integers(0, 6)))])),
        "object_push": (ipc.MSG_OBJECT_PUSH,
                        ipc.encode_record(*_record_args(rng))),
        "fetch": (ipc.MSG_FETCH, ipc.encode_fetch(
            rng.bytes(int(rng.integers(20, 40))))),
        "ping": (ipc.MSG_PING, b""),
        "pong": (ipc.MSG_PONG, b""),
        "shard_update": (ipc.MSG_SHARD_UPDATE, ipc.encode_shard_update(
            int(rng.integers(0, 1 << 62)), streams())),
        "handoff": (ipc.MSG_HANDOFF, ipc.encode_handoff(
            int(rng.integers(0, 3)), int(rng.integers(1, 1 << 32)),
            int(rng.integers(0, 1 << 62)),
            int(rng.integers(-1, 1 << 40)))),
    }


def _decode(ipc, kind, payload):
    return {
        "hello": ipc.decode_hello, "hello_ack": ipc.decode_hello,
        "objects": ipc.decode_objects,
        "objects_ack": ipc.decode_objects_ack, "inv": ipc.decode_inv,
        "object_push": lambda p: ipc.decode_record(p),
        "fetch": ipc.decode_fetch, "ping": bytes, "pong": bytes,
        "shard_update": ipc.decode_shard_update,
        "handoff": ipc.decode_handoff,
    }[kind](payload)


async def _read(ipc, frame: bytes):
    reader = asyncio.StreamReader()
    reader.feed_data(frame)
    reader.feed_eof()
    return await ipc.read_frame(reader)


KINDS = ("hello", "hello_ack", "objects", "objects_ack", "inv",
         "object_push", "fetch", "ping", "pong", "shard_update", "handoff")


@pytest.mark.parametrize("kind", KINDS)
async def test_ipc_frames_are_byte_equal_both_ways(kind):
    jax_ipc = _jax("roles.ipc")
    assert len(KINDS) == len(port_ipc.FRAME_NAMES) == 11
    assert (port_ipc.MAGIC, port_ipc.VERSION, port_ipc.MAX_FRAME) == \
        (jax_ipc.MAGIC, jax_ipc.VERSION, jax_ipc.MAX_FRAME)
    for draw in range(8):
        mine = _frames(port_ipc, np.random.default_rng([12, draw]))[kind]
        theirs = _frames(jax_ipc, np.random.default_rng([12, draw]))[kind]
        assert mine == theirs
        msg_type, payload = mine
        frame = port_ipc.pack_frame(msg_type, payload)
        assert frame == jax_ipc.pack_frame(msg_type, payload)
        # each package reads the other's frame and decodes its payload
        assert await _read(port_ipc, jax_ipc.pack_frame(msg_type, payload)) \
            == await _read(jax_ipc, frame) == (msg_type, payload)
        assert _decode(port_ipc, kind, payload) == \
            _decode(jax_ipc, kind, payload)
    if kind == "hello_ack":
        # a HELLO without the trailing epoch decodes with epoch 0
        assert port_ipc.decode_hello(payload[:-8])[3] == \
            jax_ipc.decode_hello(payload[:-8])[3] == 0
    if kind == "object_push":
        assert port_ipc.record_stream(payload) == \
            jax_ipc.record_stream(payload)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # the kind of refusal is what is compared
        return (type(exc).__name__, str(exc))


def test_ipc_junk_and_truncations_are_rejected_alike():
    jax_ipc = _jax("roles.ipc")
    rng = np.random.default_rng(13)
    seen = set()
    for draw in range(6):
        frames = _frames(port_ipc, np.random.default_rng([13, draw]))
        for kind, (msg_type, payload) in frames.items():
            cuts = sorted({int(c) for c in
                           rng.integers(0, len(payload) + 1, size=6)})
            for cut in cuts:
                got = _outcome(_decode, port_ipc, kind, payload[:cut])
                want = _outcome(_decode, jax_ipc, kind, payload[:cut])
                assert got == want, (kind, cut)
                seen.add(got[0])
    assert {"ok", "IPCError"} <= seen
    headers = [b"\x00\x00\x01\x03\x00\x00\x00\x00",
               port_ipc.HEADER.pack(port_ipc.MAGIC, 99, 1, 0),
               port_ipc.HEADER.pack(port_ipc.MAGIC, 1, 3,
                                    port_ipc.MAX_FRAME + 1),
               port_ipc.HEADER.pack(port_ipc.MAGIC, 1, 200, 5)]
    headers += [rng.bytes(8) for _ in range(50)]
    for header in headers:
        assert _outcome(port_ipc.parse_header, header) == \
            _outcome(jax_ipc.parse_header, header)
    for ipc in (port_ipc, jax_ipc):
        with pytest.raises(ipc.IPCError):
            ipc.pack_frame(ipc.MSG_PING, b"\x00" * (ipc.MAX_FRAME + 1))
        with pytest.raises(ipc.IPCError):
            ipc.encode_hello("edge", "x" * 65, ())


# ---------------------------------------------------------------------------
# EdgeCache
# ---------------------------------------------------------------------------


def _cache_state(cache, hashes, now):
    return ([(h in cache, cache.is_known_uncached(h), cache.known_stream(h))
             for h in hashes],
            len(cache),
            [sorted(cache.unexpired_hashes_by_stream(s)) for s in (1, 2, 3)],
            sorted(i.payload for i in cache.by_type_and_tag(2, b"t" * 32)))


def test_edge_cache_follows_the_jax_cache(monkeypatch):
    jax_edge_mod = _jax("roles.edge")
    rng = np.random.default_rng(14)
    now = 1_700_000_000
    monkeypatch.setattr(time, "time", lambda: float(now))
    caches = [port_edge.EdgeCache(max_bytes=2000, max_known=24),
              jax_edge_mod.EdgeCache(max_bytes=2000, max_known=24)]
    hashes = [bytes([i]) * 32 for i in range(40)]
    for step in range(400):
        op = int(rng.integers(0, 10))
        h = hashes[int(rng.integers(0, len(hashes)))]
        stream = int(rng.integers(1, 4))
        expires = now + int(rng.integers(-50, 500))
        results = []
        for cache in caches:
            if op < 6:
                size = int(rng.integers(0, 600)) if cache is caches[0] \
                    else size
                tag = b"t" * 32 if op % 2 else b""
                results.append(cache.add(h, 2, stream, b"p" * size,
                                         expires, tag))
            elif op < 9:
                results.append(cache.note_known(h, stream, expires))
            else:
                results.append(cache.clean(now + 100))
            if op < 9:
                try:
                    results.append(cache[h].payload)
                except KeyError:
                    results.append(KeyError)
        assert results[:len(results) // 2] == results[len(results) // 2:]
        assert _cache_state(caches[0], hashes, now) == \
            _cache_state(caches[1], hashes, now), step
    caches[0].flush()


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------


def _defined_families(module) -> dict:
    tree = ast.parse(inspect.getsource(module))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                isinstance(node.value.func, ast.Attribute) and \
                isinstance(node.value.func.value, ast.Name) and \
                node.value.func.value.id == "REGISTRY":
            fam = getattr(module, node.targets[0].id)
            out[fam.name] = (fam.kind, fam.help, fam.labelnames)
    return out


@pytest.mark.parametrize("name", ["roles.ipc", "roles.replica",
                                  "roles.edge", "roles.relay"])
def test_role_metric_families_are_the_jax_ones(name):
    port = _defined_families(
        importlib.import_module("pybitmessage_tpu_torch." + name))
    assert port and port == _defined_families(_jax(name))


# ---------------------------------------------------------------------------
# the two packages on one deployment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("edge_side", ["port", "jax"])
async def test_objects_cross_the_packages(objs, edge_side):
    """A port edge in front of a JAX relay, and the reverse: 24 objects
    over TCP through the edge's framing and PoW check, over role IPC
    into the relay; redelivery is deduped at the edge and the relay."""
    client_cls = _helpers().WireClient
    make_relay, make_edge = (jax_relay, port_edge_node) \
        if edge_side == "port" else (port_relay, jax_edge)
    relay = make_relay()
    await relay.start()
    edge = make_edge([relay.role_runtime.listen_port])
    await edge.start()
    client = None
    try:
        await wait_for(lambda: edge.role_runtime.links[0].connected,
                       what="edge link")
        client = await client_cls().connect(edge.pool.listen_port)
        await client.send_objects(objs.s1)
        await wait_for(lambda: len(relay.inventory) == len(objs.s1),
                       what="relay ingest")
        link = edge.role_runtime.links[0]
        await wait_for(lambda: link.acked_objects == len(objs.s1),
                       what="acks")
        await client.send_objects(objs.s1[:8])
        await asyncio.sleep(0.3)
        assert len(relay.inventory) == len(objs.s1)
        assert sorted(relay.inventory.unexpired_hashes_by_stream(1)) == \
            sorted(_hash(p) for p in objs.s1)
        assert (link.acked_objects, link.duplicate_objects,
                link.rejected_objects) == (len(objs.s1), 0, 0)
        snap = relay.role_runtime.snapshot()
        assert (snap["accepted"], snap["duplicates"], snap["rejected"]) \
            == (len(objs.s1), 0, 0)
        assert relay.role_runtime.edges[0].edge_id == edge.node_id
    finally:
        if client is not None:
            await client.close()
        await stop_all(edge, relay)


def _masked(doc):
    """Identities, ports and clock readings masked."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in ("relayId", "edgeId", "relay", "listen", "target",
                     "rttMs", "ackLagS"):
                out[k] = "<masked>"
            elif k in ("shardEpochs", "forwarding", "draining"):
                out[k] = sorted(v.values()) if k == "shardEpochs" \
                    else sorted(v)
            else:
                out[k] = _masked(v)
        return out
    if isinstance(doc, list):
        return [_masked(v) for v in doc]
    return doc


async def _deployment(make_relay, make_edge, client_cls, objs):
    """Relay A (streams 1, 2), relay B (3), an edge before both, the
    objects of streams 1 and 2 ingested through a wire client."""
    a, b = make_relay((1, 2)), make_relay((3,))
    await a.start()
    await b.start()
    edge = make_edge([a.role_runtime.listen_port,
                      b.role_runtime.listen_port], (1, 2, 3))
    await edge.start()
    await wait_for(lambda: all(lk.connected
                               for lk in edge.role_runtime.links),
                   what="edge links")
    client = await client_cls().connect(edge.pool.listen_port,
                                        streams=(1, 2))
    await client.send_objects(objs.s1 + objs.s2)
    await wait_for(lambda: len(a.inventory) == len(objs.s1) + len(objs.s2),
                   what="ingest")
    await wait_for(lambda: edge.role_runtime.links[0].acked_objects
                   == len(objs.s1) + len(objs.s2), what="acks")
    return a, b, edge, client


async def test_role_commands_answer_as_jax(objs):
    """``roleStatus``, ``shardStatus`` and ``shardShed`` on a port
    deployment and on a JAX one holding the same objects: the same
    keys and values, identities, ports and clock readings masked."""
    helpers = _helpers()
    JaxHandler = _jax("api.commands").CommandHandler
    sides = {}
    for name, make_relay, make_edge, handler in (
            ("jax", jax_relay, jax_edge, JaxHandler),
            ("port", port_relay, port_edge_node, CommandHandler)):
        a, b, edge, client = await _deployment(
            make_relay, make_edge, helpers.WireClient, objs)
        try:
            answers = {}
            for node, who in ((a, "a"), (b, "b"), (edge, "edge")):
                for method in ("roleStatus", "shardStatus"):
                    answers[(who, method)] = json.loads(
                        await handler(node).dispatch(method, []))
            target = "127.0.0.1:%d" % b.role_runtime.listen_port
            answers["shed"] = json.loads(await handler(a).dispatch(
                "shardShed", [2, target]))
            await wait_for(lambda: all(lk.epoch == 1 for lk in
                                       edge.role_runtime.links),
                           what="shard updates")
            for node, who in ((a, "a"), (edge, "edge")):
                answers[(who, "after")] = json.loads(
                    await handler(node).dispatch("shardStatus", []))
            for params in ([2, target], ["x", target], [5, target]):
                try:
                    await handler(a).dispatch("shardShed", params)
                except Exception as exc:  # compared below
                    answers[("refused",) + tuple(map(str, params[:1]))] = \
                        (exc.code, str(exc).replace(target, "<target>"))
            try:
                await handler(edge).dispatch("shardShed", [1, target])
            except Exception as exc:
                answers["edge shed"] = (exc.code, str(exc))
            sides[name] = answers
        finally:
            await client.close()
            await stop_all(edge, a, b)
    jax_side, port_side = sides["jax"], sides["port"]
    assert set(port_side) == set(jax_side)
    for key in jax_side:
        assert _masked(port_side[key]) == _masked(jax_side[key]), key
    assert port_side["shed"]["objectsDrained"] == len(objs.s2)
    assert port_side[("a", "after")]["streams"] == [1]


# ---------------------------------------------------------------------------
# the port's deployments (twins of tests/test_roles.py)
# ---------------------------------------------------------------------------


async def test_two_sharded_relays(objs):
    """Relays owning streams {1} and {2}: the edge routes by the
    object's stream, learned from HELLO_ACK; nothing crosses shards, and
    a mis-routed record is refused."""
    client_cls = _helpers().WireClient
    ra, rb = port_relay((1,)), port_relay((2,))
    await ra.start()
    await rb.start()
    edge = port_edge_node([ra.role_runtime.listen_port,
                           rb.role_runtime.listen_port], (1, 2))
    await edge.start()
    client = None
    try:
        rt = edge.role_runtime
        await wait_for(lambda: all(lk.connected for lk in rt.links),
                       what="edge links")
        assert rt.link_for(1).relay_streams == (1,)
        assert rt.link_for(2).relay_streams == (2,)
        client = await client_cls().connect(edge.pool.listen_port,
                                            streams=(1, 2))
        await client.send_objects(objs.s1[:6] + objs.s2[:5])
        await wait_for(lambda: len(ra.inventory) == 6
                       and len(rb.inventory) == 5, what="sharded ingest")
        assert ra.inventory.unexpired_hashes_by_stream(2) == []
        assert rb.inventory.unexpired_hashes_by_stream(1) == []
        rec = port_ipc.decode_record(port_ipc.encode_record(
            b"\x78" * 32, 2, 1, int(time.time()) + 500, b"", b"x"))[0]
        assert rb.role_runtime._accept_record(rec, None) == "rejected"
        assert b"\x78" * 32 not in rb.inventory
    finally:
        if client is not None:
            await client.close()
        await stop_all(edge, ra, rb)


async def test_replica_failover_after_the_primary_stops(objs):
    """Two relays on stream 1 form its replica set: every record lands
    on both; after one stops its link goes down, new records land on the
    survivor with none lost, the edge stays ``ok``, and a second edge
    that knows a hash only from INV deltas serves a getdata through the
    survivor."""
    helpers = _helpers()
    from pybitmessage_tpu.network.messages import encode_inv
    ra, rb = port_relay((1,)), port_relay((1,))
    await ra.start()
    await rb.start()
    a_port = ra.role_runtime.listen_port
    ports = [a_port, rb.role_runtime.listen_port]
    edge1, edge2 = port_edge_node(ports), port_edge_node(ports)
    await edge1.start()
    await edge2.start()
    c1 = c2 = None
    try:
        rt = edge1.role_runtime
        await wait_for(lambda: all(lk.connected for lk in rt.links)
                       and all(lk.connected
                               for lk in edge2.role_runtime.links),
                       what="edge links")
        assert set(rt.replica_sets) == {1}
        assert len(rt.replica_sets[1].members) == 2
        first, extra = objs.s1[:12], objs.more[:8]
        c1 = await helpers.WireClient().connect(edge1.pool.listen_port)
        await c1.send_objects(first)
        await wait_for(lambda: len(ra.inventory) == len(first)
                       and len(rb.inventory) == len(first),
                       what="replica convergence")
        hashes = [_hash(p) for p in first]
        await wait_for(lambda: all(h in edge2.inventory for h in hashes),
                       what="inv deltas reach edge2")
        await ra.stop()
        await c1.send_objects(extra)
        await wait_for(lambda: len(rb.inventory) == len(first) + len(extra),
                       what="failover absorb")
        dead = [lk for lk in rt.links if lk.port == a_port][0]
        await wait_for(lambda: dead.health() == 0, what="dead member")
        block = edge1.health.health_block()["role"]
        assert block["status"] == "ok" and block["uncoveredStreams"] == []
        dead2 = [lk for lk in edge2.role_runtime.links
                 if lk.port == a_port][0]
        await wait_for(lambda: dead2.health() == 0,
                       what="edge2 sees the dead member")
        edge2.role_runtime.fetch_retry = 0.5
        c2 = await helpers.WireClient().connect(edge2.pool.listen_port)
        await c2.send_packet("getdata", encode_inv([hashes[0]]))
        assert bytes(await c2.expect("object", timeout=WAIT)) == first[0]
    finally:
        for c in (c1, c2):
            if c is not None:
                await c.close()
        await stop_all(edge1, edge2, rb)


async def test_live_shard_handoff_sheds_and_forwards(objs):
    """Relay A sheds stream 2 to relay B: the records move in one
    pseudo-bucket, both epochs bump, the edge re-learns both maps and
    routes new stream-2 traffic to B, and a late record that lands on A
    is stored there and forwarded to B."""
    client_cls = _helpers().WireClient
    ra, rb = port_relay((1, 2)), port_relay((3,))
    await ra.start()
    await rb.start()
    edge = port_edge_node([ra.role_runtime.listen_port,
                           rb.role_runtime.listen_port], (1, 2, 3))
    await edge.start()
    client = None
    try:
        await wait_for(lambda: all(lk.connected
                                   for lk in edge.role_runtime.links),
                       what="edge links")
        client = await client_cls().connect(edge.pool.listen_port,
                                            streams=(1, 2))
        s1, s2 = objs.s1[:4], objs.s2[:6]
        await client.send_objects(s1 + s2)
        await wait_for(lambda: len(ra.inventory) == len(s1) + len(s2),
                       what="pre-split ingest")
        target = "127.0.0.1:%d" % rb.role_runtime.listen_port
        res = await ra.role_runtime.shed_stream(2, target)
        assert res == {"stream": 2, "target": target,
                       "objectsDrained": len(s2), "buckets": 1,
                       "epoch": 1}
        assert tuple(ra.ctx.streams) == (1,)
        assert 2 in rb.ctx.streams and rb.role_runtime.epoch == 1
        assert all(_hash(p) in rb.inventory for p in s2)
        link_a, link_b = edge.role_runtime.links
        await wait_for(lambda: link_a.relay_streams == (1,)
                       and 2 in link_b.relay_streams,
                       what="edge shard update")
        fresh = objs.s2[6]
        await client.send_objects([fresh])
        await wait_for(lambda: _hash(fresh) in rb.inventory,
                       what="post-split routing")
        assert _hash(fresh) not in ra.inventory
        late = objs.late[0]
        lh = _hash(late)
        rec = port_ipc.decode_record(port_ipc.encode_record(
            lh, 2, 2, int.from_bytes(late[8:16], "big"), b"", late))[0]
        assert ra.role_runtime._accept_record(rec, None) == "forwarded"
        assert lh in ra.inventory
        await wait_for(lambda: lh in rb.inventory, what="late forward")
        assert ra.role_runtime.snapshot()["forwarding"] == {"2": target}
        with pytest.raises(ValueError, match="last owned stream"):
            await ra.role_runtime.shed_stream(1, target)
    finally:
        if client is not None:
            await client.close()
        await stop_all(edge, ra, rb)


async def test_mid_drain_arrival_is_shadow_forwarded(objs):
    """A record accepted while the drain walks the stream may miss the
    walk: it is shadow-forwarded to the acquiring relay as it is
    stored."""
    ra, rb = port_relay((1, 2)), port_relay((3,))
    await ra.start()
    await rb.start()
    rt = ra.role_runtime
    target = "127.0.0.1:%d" % rb.role_runtime.listen_port
    expires = int(time.time()) + 900
    for i in range(8):
        ra.inventory.add(_hash(b"seed %d" % i), 2, 2, b"seed %d" % i,
                         expires, b"")
    late = objs.late[1]
    lh = _hash(late)
    rec = port_ipc.decode_record(port_ipc.encode_record(
        lh, 2, 2, int.from_bytes(late[8:16], "big"), b"", late))[0]
    real_export = rt._export_stream

    def export_with_arrival(stream):
        for bucket, hashes in real_export(stream):
            yield bucket, hashes
            assert rt._accept_record(rec, None) == "accepted"
            assert rt.snapshot()["draining"] == {"2": target}

    rt._export_stream = export_with_arrival
    try:
        res = await rt.shed_stream(2, target)
        assert res["objectsDrained"] == 8 and res["buckets"] == 1
        assert lh in ra.inventory
        await wait_for(lambda: lh in rb.inventory,
                       what="shadow-forwarded record")
        assert rt.snapshot()["draining"] == {}
    finally:
        await stop_all(ra, rb)


async def test_stale_epoch_frames_are_ignored():
    """A link ignores SHARD_UPDATEs at or below its epoch and a
    HELLO_ACK below it: a delayed frame never rolls the map back."""
    node = SimpleNamespace(ctx=SimpleNamespace(streams=(1, 2)),
                           node_id="edge0000")
    rt = port_edge.EdgeRuntime(node, "127.0.0.1:9")
    link = rt.links[0]
    link.epoch = 5
    link.relay_streams = (1,)
    rt.on_shard_change(link)
    before = REGISTRY.sample("role_edge_stale_map_total")
    reader = asyncio.StreamReader()
    for epoch, streams in ((5, (9,)), (4, (8,)), (6, (2,))):
        reader.feed_data(port_ipc.pack_frame(
            port_ipc.MSG_SHARD_UPDATE,
            port_ipc.encode_shard_update(epoch, streams)))
    reader.feed_eof()
    with pytest.raises(asyncio.IncompleteReadError):
        await link._recv_loop(reader)
    assert (link.epoch, link.relay_streams) == (6, (2,))

    class _W:
        def write(self, data):
            pass

        async def drain(self):
            pass

    reader2 = asyncio.StreamReader()
    reader2.feed_data(port_ipc.pack_frame(
        port_ipc.MSG_HELLO_ACK,
        port_ipc.encode_hello("relay", "old-rely", (9,), epoch=3)))
    await link._handshake(reader2, _W())
    assert (link.epoch, link.relay_streams) == (6, (2,))
    assert REGISTRY.sample("role_edge_stale_map_total") == before + 3
    assert set(rt.replica_sets) == {1, 2}


async def test_relay_push_and_edge_fetch_serve_getdata(objs):
    """An edge that knows a hash only from an INV delta FETCHes it and
    serves a peer's getdata; what the relay's own workers announce (the
    sender's objects and the processor's acks alike) is pushed with its
    payload to every edge, which announces and serves it."""
    helpers = _helpers()
    from pybitmessage_tpu.network.messages import decode_inv, encode_inv
    relay = port_relay()
    await relay.start()
    port = relay.role_runtime.listen_port
    edge1, edge2 = port_edge_node([port]), port_edge_node([port])
    await edge1.start()
    await edge2.start()
    c1 = c2 = None
    try:
        await wait_for(lambda: edge1.role_runtime.links[0].connected
                       and edge2.role_runtime.links[0].connected,
                       what="edge links")
        payloads = objs.s1[:3]
        hashes = [_hash(p) for p in payloads]
        c1 = await helpers.WireClient().connect(edge1.pool.listen_port)
        await c1.send_objects(payloads)
        await wait_for(lambda: all(h in edge2.inventory for h in hashes),
                       what="inv delta reaches edge2")
        assert edge2.inventory.is_known_uncached(hashes[0])
        c2 = await helpers.WireClient().connect(edge2.pool.listen_port)
        await c2.send_packet("getdata", encode_inv([hashes[0]]))
        assert bytes(await c2.expect("object", timeout=WAIT)) == payloads[0]
        for local, payload in ((True, objs.more[0]), (False, objs.more[1])):
            lh = _hash(payload)
            relay.inventory.add(lh, 2, 1, payload,
                                int(time.time()) + 900, b"")
            relay.pool.announce_object(lh, 1, local=False)
            relay.role_runtime._on_announce(lh, 1, local)
            await wait_for(lambda: lh in edge1.inventory
                           and not edge1.inventory.is_known_uncached(lh),
                           what="object push (local=%s)" % local)
            seen = set()
            while lh not in seen:
                seen |= set(decode_inv(await c1.expect("inv",
                                                       timeout=WAIT)))
            await c1.send_packet("getdata", encode_inv([lh]))
            assert bytes(await c1.expect("object", timeout=WAIT)) == payload
    finally:
        for c in (c1, c2):
            if c is not None:
                await c.close()
        await stop_all(edge1, edge2, relay)


async def test_relay_stop_returns_with_an_edge_and_a_peer_relay_connected():
    """Python 3.12's ``Server.wait_closed`` waits for every served
    connection; the relay closes its peer relays' connections as well as
    its edges' before it waits, so ``stop`` returns.  The edge then
    reconnects to nothing and stops too."""
    relay, peer = port_relay((1, 2)), port_relay((3,))
    await relay.start()
    await peer.start()
    edge = port_edge_node([relay.role_runtime.listen_port])
    await edge.start()
    writer = None
    try:
        await wait_for(lambda: edge.role_runtime.links[0].connected,
                       what="edge link")
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", relay.role_runtime.listen_port)
        await peer.role_runtime._relay_hello(reader, writer)
        await wait_for(lambda: len(relay.role_runtime._conns) == 2,
                       what="both served")
        assert len(relay.role_runtime.edges) == 1
        t0 = time.monotonic()
        await asyncio.wait_for(relay.stop(), 5.0)
        assert time.monotonic() - t0 < 5.0
        assert relay.role_runtime._conns == set()
        with pytest.raises((asyncio.IncompleteReadError, ConnectionError)):
            await asyncio.wait_for(port_ipc.read_frame(reader), 5.0)
    finally:
        if writer is not None:
            writer.close()
        await stop_all(edge, peer)


async def test_no_object_lost_under_role_ipc_faults(objs):
    """The twin of the JAX chaos suite's ``role.ipc`` case: every frame
    send on the hop fails for the first 10 fires (edge sends and relay
    acks alike), and every accepted object is redelivered once the site
    stops firing; then a relay stopped mid-flood and restarted on its
    port receives what the edge banked meanwhile.  Zero objects lost."""
    from pybitmessage_tpu_torch.models.objects import ObjectHeader
    from pybitmessage_tpu_torch.resilience import CHAOS
    payloads = objs.s1[:18]
    relay = port_relay()
    await relay.start()
    ipc_port = relay.role_runtime.listen_port
    edge = port_edge_node([ipc_port])
    await edge.start()
    relay2 = None

    def feed(batch):
        for p in batch:
            hdr = ObjectHeader.parse(p)
            h = _hash(p)
            edge.inventory.add(h, hdr.object_type, hdr.stream, p,
                               hdr.expires, b"")
            edge.pool.object_received(h, hdr, p, source=None)
    try:
        await wait_for(lambda: edge.role_runtime.links[0].connected,
                       what="edge link")
        link = edge.role_runtime.links[0]
        link.breaker.cooldown = 0.2
        link.reconnect_max = 0.3
        resends = REGISTRY.sample("role_edge_resend_total")
        fired = REGISTRY.sample("chaos_injected_total", {"site": "role.ipc"})
        CHAOS.seed(20)
        CHAOS.arm("role.ipc", probability=1.0, count=10)
        try:
            feed(payloads[:9])
            await wait_for(lambda: len(relay.inventory) == 9, timeout=30.0,
                           what="redelivery after the faults")
        finally:
            CHAOS.disarm()
        assert REGISTRY.sample("chaos_injected_total",
                               {"site": "role.ipc"}) == fired + 10
        assert REGISTRY.sample("role_edge_resend_total") > resends
        assert relay.role_runtime.snapshot()["rejected"] == 0
        first = relay.inventory.unexpired_hashes_by_stream(1)
        await relay.stop()
        feed(payloads[9:])
        await asyncio.sleep(0.3)
        assert link.depth() > 0
        relay2 = port_relay(listen="127.0.0.1:%d" % ipc_port)
        await relay2.start()
        await wait_for(lambda: len(relay2.inventory) == 9, timeout=30.0,
                       what="drain into the restarted relay")
        await wait_for(lambda: link.depth() == 0, what="outbox empty")
        assert sorted(first + relay2.inventory.unexpired_hashes_by_stream(
            1)) == sorted(_hash(p) for p in payloads)
    finally:
        CHAOS.disarm()
        await stop_all(edge, relay2)


def test_launch_record_counts_the_wrappers_and_the_registry():
    """The daemon's stop line: the wrappers' counts and the registry's
    per-program launches side by side."""
    from pybitmessage_tpu_torch import __main__ as daemon
    rec = daemon.launch_record()
    assert set(rec) == {"wrappers", "registry", "verifyBatches"}
    assert set(rec["wrappers"]) == {"search", "batch_search",
                                    "packed_search", "secp_verify",
                                    "secp_ecdh"}
    assert set(rec["registry"]) == {"pallas_slab", "batch_search",
                                    "packed_search", "secp_verify",
                                    "secp_ecdh", "pow_verify"}
    assert all(isinstance(v, int) for v in
               [*rec["wrappers"].values(), *rec["registry"].values(),
                rec["verifyBatches"]])
