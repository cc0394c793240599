"""The port's metrics federation against the JAX package's, on the CPU.

Held against ``pybitmessage_tpu.observability.federation`` and the JAX
API's ``POST /federation/push``, ``GET /metrics/federated`` and
``federatedStatus``:

- two registries fed one seeded sequence of counter, gauge and
  histogram updates give equal ``mergeable_snapshot`` and
  ``delta_snapshot`` documents, and ``_merged_percentile`` agrees over
  seeded bucket counts;
- a port ``FederationPublisher``'s pushes are accepted by a JAX
  ``Aggregator`` and a JAX publisher's by a port one, and the two
  aggregators' merged views, Prometheus renderings and fleet statuses
  are equal;
- both refuse alike: a version mismatch, a node over capacity, a delta
  for an unknown node or after a gap (resync), mismatched histogram
  buckets (the series, not the push) and a malformed push; a refused
  publisher resyncs with a full push;
- over HTTP, each package's ``http_transport`` pushes into the other
  package's API server, whose ``GET /metrics/federated`` and
  ``federatedStatus`` then list both nodes.

Everything compared is exact.  Nothing of JAX is imported at module
level; each async test runs under its own limit.
"""

import asyncio
import base64
import contextlib
import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch.observability import federation as port_fed
from pybitmessage_tpu_torch.observability import metrics as port_metrics

#: the limit of each async test, seconds
LIMIT = 30.0
USER, PASS = "feduser", "fedpass"
BUCKETS = (0.01, 0.1, 1.0, 10.0)


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.observability import federation, metrics
    return SimpleNamespace(fed=federation, metrics=metrics)


def limited(fn):
    """Run an async test body under ``asyncio.wait_for(LIMIT)``."""
    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), LIMIT)
    return wrapper


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _registry(metrics_mod):
    reg = metrics_mod.Registry()
    fams = SimpleNamespace(
        objects=reg.counter("objects_received_total", "objects",
                            ("stream",)),
        peers=reg.gauge("peers", "connected peers"),
        lat=reg.histogram("solve_seconds", "solve latency",
                          ("backend",), buckets=BUCKETS))
    return reg, fams


def _feed(fams, rng, steps: int) -> None:
    for _ in range(steps):
        op = int(rng.integers(0, 3))
        if op == 0:
            fams.objects.labels(stream=str(int(rng.integers(1, 4)))).inc(
                int(rng.integers(1, 9)))
        elif op == 1:
            fams.peers.set(int(rng.integers(0, 40)))
        else:
            fams.lat.labels(backend=str(rng.choice(["cuda", "host"]))) \
                .observe(float(rng.exponential(0.8)))


def _pair(seed: int):
    """A port and a JAX registry fed the same seeded updates."""
    j = _jax()
    out = []
    for mod in (port_metrics, j.metrics):
        reg, fams = _registry(mod)
        _feed(fams, np.random.default_rng(seed), 60)
        out.append((reg, fams))
    return out


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_snapshots_and_deltas_are_equal(seed):
    j = _jax()
    (preg, pfams), (jreg, jfams) = _pair(seed)
    mine, theirs = port_fed.mergeable_snapshot(preg), \
        j.fed.mergeable_snapshot(jreg)
    assert mine == theirs
    rng_p, rng_j = (np.random.default_rng([seed, 1]) for _ in range(2))
    _feed(pfams, rng_p, 10)
    _feed(jfams, rng_j, 10)
    assert port_fed.delta_snapshot(port_fed.mergeable_snapshot(preg), mine) \
        == j.fed.delta_snapshot(j.fed.mergeable_snapshot(jreg), theirs)
    assert port_fed.delta_snapshot(mine, None) == mine
    assert port_fed.FEDERATION_VERSION == j.fed.FEDERATION_VERSION == 1


def test_merged_percentiles_agree():
    j = _jax()
    rng = np.random.default_rng(4)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        bounds = sorted(float(b) for b in rng.random(n) * 10)
        counts = [int(c) for c in rng.integers(0, 30, n + 1)]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert port_fed._merged_percentile(bounds, counts, q) == \
                j.fed._merged_percentile(bounds, counts, q)
    assert port_fed._merged_percentile([], [0], 0.5) == \
        j.fed._merged_percentile([], [0], 0.5) == 0.0


# ---------------------------------------------------------------------------
# publishers and aggregators across the packages
# ---------------------------------------------------------------------------


def _views(agg) -> tuple:
    return agg.merged(), agg.render(), agg.status()


@pytest.mark.parametrize("seed", range(2))
def test_each_publisher_is_accepted_by_the_other_aggregator(seed):
    j = _jax()
    (preg, pfams), (jreg, jfams) = _pair(seed)
    clocks = (_Clock(), _Clock())
    aggs = (port_fed.Aggregator(clock=clocks[0]),
            j.fed.Aggregator(clock=clocks[1]))

    def both(push):
        acks = [agg.ingest(json.loads(json.dumps(push))) for agg in aggs]
        assert acks[0] == acks[1]
        return acks[0]
    pubs = [port_fed.FederationPublisher("port-node", preg, transport=both,
                                         skew=lambda: 0.25),
            j.fed.FederationPublisher("jax-node", jreg, transport=both,
                                      health=lambda: {"pow": {
                                          "status": "degraded"}})]
    rng_p, rng_j = (np.random.default_rng([seed, 2]) for _ in range(2))
    for step in range(4):
        if step:
            _feed(pfams, rng_p, 8)
            _feed(jfams, rng_j, 8)
        for pub in pubs:
            ack = pub.push_once()
            assert ack["ok"] and ack["seq"] == step + 1
            assert ack["rejected_series"] == 0
        for c in clocks:
            c.t += 5.0
    assert pubs[0].seq == pubs[1].seq == 4
    assert _views(aggs[0]) == _views(aggs[1])
    status = aggs[0].status()
    assert set(status["nodes"]) == {"port-node", "jax-node"}
    assert status["nodes"]["port-node"]["skewSeconds"] == 0.25
    assert status["fleet"] == {"nodes": 2, "degraded": 1, "stale": 0,
                               "ok": 1}
    # the merged counter is the sum of both registries' own values
    for stream in ("1", "2", "3"):
        own = sum(reg.sample("objects_received_total", {"stream": stream})
                  for reg in (preg, jreg))
        assert aggs[0].merged_value("objects_received_total",
                                    {"stream": stream}) == own
    for agg in aggs:
        assert agg.merged_percentile("solve_seconds", 0.5,
                                     {"backend": "cuda"}) == \
            aggs[1].merged_percentile("solve_seconds", 0.5,
                                      {"backend": "cuda"})
    clocks[0].t += 100.0
    clocks[1].t += 100.0
    assert aggs[0].status() == aggs[1].status()
    assert aggs[0].status()["fleet"]["stale"] == 2


def _refusals(fed) -> list:
    """One sequence of bad pushes; the acks it draws."""
    clock = _Clock()
    agg = fed.Aggregator(max_nodes=2, clock=clock, expiry=10.0)
    full = {"v": 1, "node": "a", "seq": 1, "t": 0.0, "full": True,
            "metrics": {"h": {"type": "histogram", "labels": [],
                              "buckets": [1.0, 2.0],
                              "series": [{"l": {}, "c": [1, 0, 0],
                                          "s": 0.5, "n": 1}]}}}
    acks = [agg.ingest(dict(full, v=2)),                     # version
            agg.ingest({"v": 1, "node": "", "seq": 1}),      # no node
            agg.ingest(dict(full, node="b", full=False)),    # unknown delta
            agg.ingest(full),
            agg.ingest(dict(full, seq=3, full=False)),       # gap
            agg.ingest(dict(full, node="c")),
            agg.ingest(dict(full, node="d")),                # capacity
            agg.ingest(dict(full, seq=2, full=False, metrics={"h": dict(
                full["metrics"]["h"], buckets=[1.0, 3.0])})),
            agg.ingest("not a push"),
            agg.ingest(dict(full, seq="x"))]                 # malformed
    clock.t += 200.0
    acks.append(agg.ingest(dict(full, node="e")))   # a and c evicted
    acks.append(sorted(agg.status()["nodes"]))
    return acks


def test_refusals_agree():
    mine, theirs = _refusals(port_fed), _refusals(_jax().fed)
    assert mine == theirs
    reasons = [a.get("reason") for a in mine[:-1]]
    assert reasons == ["version", "malformed", "resync", None, "resync",
                       None, "capacity", None, "version", "malformed",
                       None]
    assert mine[7]["rejected_series"] == 1     # buckets: the series only
    assert mine[-1] == ["e"]


def test_a_refused_publisher_resyncs_with_a_full_push():
    j = _jax()
    for fed, metrics in ((port_fed, port_metrics), (j.fed, j.metrics)):
        reg, fams = _registry(metrics)
        fams.peers.set(3)
        agg = fed.Aggregator()
        pub = fed.FederationPublisher("n", reg, transport=agg.ingest)
        assert pub.push_once()["ok"]
        agg.forget("n")
        fams.peers.set(4)
        ack = pub.push_once()
        assert ack == {"ok": False, "reason": "resync"}
        push, _ = pub.build_push()
        assert push["full"] and push["seq"] == 3
        pub.seq = 2
        assert pub.push_once()["ok"]
        assert agg.merged_value("peers") == 4


# ---------------------------------------------------------------------------
# over HTTP, into the other package's API server
# ---------------------------------------------------------------------------


def _port_node():
    from pybitmessage_tpu_torch.core import Node
    return Node(device="cpu", listen=False, test_mode=True,
                crypto_batch=False)


def _jax_node():
    j = _jax()
    from pybitmessage_tpu.core import Node
    from pybitmessage_tpu.pow import dispatcher
    del j

    def solver(ih, target, should_stop=None):
        return dispatcher.python_solve(ih, target, should_stop=should_stop)
    return Node(None, listen=False, solver=solver, test_mode=True,
                dandelion_enabled=False, tls_enabled=False)


@contextlib.asynccontextmanager
async def _served(node, server_cls):
    await node.start()
    server = server_cls(node, port=0, username=USER, password=PASS)
    await server.start()
    try:
        yield server.listen_port
    finally:
        await server.stop()
        await node.stop()


async def _get(port: int, path: str) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    auth = base64.b64encode(("%s:%s" % (USER, PASS)).encode()).decode()
    writer.write(("GET %s HTTP/1.1\r\nAuthorization: Basic %s\r\n"
                  "Connection: close\r\n\r\n" % (path, auth)).encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


async def _rpc(port: int, method: str, *params):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"method": method, "params": list(params),
                       "id": 1}).encode()
    auth = base64.b64encode(("%s:%s" % (USER, PASS)).encode()).decode()
    writer.write(("POST / HTTP/1.1\r\nAuthorization: Basic %s\r\n"
                  "Content-Type: application/json\r\nContent-Length: %d\r\n"
                  "Connection: close\r\n\r\n" % (auth, len(body))).encode()
                 + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.partition(b"\r\n\r\n")[2])["result"]


@pytest.mark.parametrize("server", ["port", "jax"])
@limited
async def test_http_push_into_the_other_packages_api(server):
    from pybitmessage_tpu.api.server import APIServer as JaxAPIServer
    from pybitmessage_tpu_torch.api import APIServer
    j = _jax()
    if server == "port":
        node, server_cls, fed, metrics = _port_node(), APIServer, j.fed, \
            j.metrics
    else:
        node, server_cls, fed, metrics = _jax_node(), JaxAPIServer, \
            port_fed, port_metrics
    reg, fams = _registry(metrics)
    fams.objects.labels(stream="1").inc(7)
    async with _served(node, server_cls) as api_port:
        node.federation_publisher.push_once()     # the local node
        pub = fed.FederationPublisher(
            "child", reg, transport=fed.http_transport(
                "127.0.0.1", api_port, username=USER, password=PASS))
        ack = await pub.push_once_async()
        assert ack["ok"] and ack["seq"] == 1
        fams.objects.labels(stream="1").inc(5)
        assert (await pub.push_once_async())["ok"]
        status, body = await _get(api_port, "/metrics/federated")
        assert status == 200
        assert b'objects_received_total{stream="1"} 12' in body
        fleet = json.loads(await _rpc(api_port, "federatedStatus"))
        assert fleet["enabled"] is True
        assert set(fleet["nodes"]) == {"child", node.node_id}
        assert fleet["nodes"]["child"]["verdict"] == "ok"
        bad = fed.FederationPublisher(
            "wrong", reg, transport=fed.http_transport(
                "127.0.0.1", api_port, username=USER, password="nope"))
        # a refused push is settled as not acknowledged: the next one
        # is full again
        assert await bad.push_once_async() == {"error": "unauthorized"}
        assert bad.build_push()[0]["full"]


@limited
async def test_federation_off_answers_404_and_disabled():
    from pybitmessage_tpu_torch.api import APIServer
    from pybitmessage_tpu_torch.core import Node
    node = Node(device="cpu", listen=False, test_mode=True,
                crypto_batch=False, federation_enabled=False)
    assert node.federation is None and node.federation_publisher is None
    async with _served(node, APIServer) as api_port:
        status, body = await _get(api_port, "/metrics/federated")
        assert (status, json.loads(body)) == \
            (404, {"error": "federation disabled"})
        assert json.loads(await _rpc(api_port, "federatedStatus")) == \
            {"enabled": False}
