"""The port daemon's telemetry surface, on the CPU: ``metrics``,
``deviceStatus``, ``profileDevice``, ``dumpFlightRecorder``,
``objectTimeline`` and ``clientStatus``'s ``device`` and ``health``
blocks over JSON-RPC, and ``GET /metrics``, ``/metrics/federated`` and
``/debug/device`` under basic auth.

One daemon (``python -m pybitmessage_tpu_torch --device cpu``, started
as ``tests/test_torch_daemon.py`` starts one) serves the whole module;
error answers are held to the JAX package's ``CommandHandler`` in this
process.  Every subprocess, poll and request runs under its own timeout.
"""

import base64
import http.client
import json
import re
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
USER, PASS = "teleuser", "telepass"
START_TIMEOUT = 60.0
REQUEST_TIMEOUT = 30.0

#: families whose samples move between two reads of a quiet daemon: the
#: RPC that rendered one body, and the loop-lag probe's 0.25 s ticks
VOLATILE = ("api_request", "event_loop_lag")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _Daemon:
    def __init__(self, port: int):
        self.port = port

    def request(self, method: str, path: str, body: bytes = b"",
                auth: bool = True):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=REQUEST_TIMEOUT)
        headers = {"Content-Type": "application/json"}
        if auth:
            headers["Authorization"] = "Basic " + base64.b64encode(
                ("%s:%s" % (USER, PASS)).encode()).decode()
        try:
            conn.request(method, path, body, headers)
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()

    def call(self, method: str, *params) -> dict:
        status, _, body = self.request("POST", "/", json.dumps(
            {"method": method, "params": list(params), "id": 1}).encode())
        assert status == 200
        return json.loads(body)

    def result(self, method: str, *params):
        resp = self.call(method, *params)
        assert not resp.get("error"), resp
        return resp["result"]


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("teled")
    marker, hook = tmp / "events.log", tmp / "hook.sh"
    hook.write_text("#!/bin/sh\necho \"$1\" >> %s\n" % marker)
    hook.chmod(0o755)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pybitmessage_tpu_torch", "-d",
         str(tmp / "home"), "--device", "cpu", "-t", "-p", "0", "--no-udp",
         "--api-port", str(port), "--api-user", USER,
         "--api-password", PASS, "--set", "apinotifypath=%s" % hook,
         "--set", "cryptobatch=false", "--set", "federation=off"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + START_TIMEOUT
        while not (marker.exists() and "apiEnabled" in marker.read_text()):
            assert proc.poll() is None, "the daemon died at start"
            assert time.monotonic() < deadline, "no apiEnabled"
            time.sleep(0.1)
        yield _Daemon(port)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=REQUEST_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=REQUEST_TIMEOUT)


def _jax_handler():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.api.commands import CommandHandler
    return CommandHandler(node=None)


async def _jax_error(method: str, *params):
    with pytest.raises(Exception) as err:
        await _jax_handler().dispatch(method, list(params))
    return err.value.code, str(err.value)


def _samples(text: str) -> dict:
    """Prometheus text -> {sample line name+labels: value}, every
    non-comment line checked against the exposition grammar."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            assert re.match(r"# (HELP|TYPE) [a-z_][a-z0-9_]* ", line), line
            continue
        m = re.match(r'^([a-z_][a-z0-9_]*(\{.*\})?) (\S+)$', line)
        assert m, line
        out[m.group(1)] = m.group(3)
    return out


def test_metrics_rpc_is_the_get_metrics_body(daemon):
    status, ctype, _ = daemon.request("GET", "/metrics", auth=False)
    assert status == 401
    rpc_body = daemon.result("metrics")
    status, ctype, body = daemon.request("GET", "/metrics")
    assert status == 200
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    rpc, get = ({k: v for k, v in _samples(text).items()
                 if not k.startswith(VOLATILE)}
                for text in (rpc_body, body.decode()))
    assert rpc == get
    assert any(k.startswith("api_requests_total")
               for k in _samples(body.decode()))
    for family in ("device_launches_total", "pow_queue_depth",
                   "network_connections", "flightrec_events_total",
                   "inventory_items", "event_loop_lag_seconds"):
        assert "# TYPE %s " % family in rpc_body, family


def test_get_endpoints_need_auth_and_federation_is_off(daemon):
    for path in ("/metrics", "/metrics/federated", "/debug/device"):
        assert daemon.request("GET", path, auth=False)[0] == 401
    status, _, body = daemon.request("GET", "/metrics/federated")
    assert status == 404 and json.loads(body) == {
        "error": "federation disabled"}
    assert daemon.request("GET", "/nothing")[0] == 404
    status, ctype, body = daemon.request("GET", "/debug/device")
    assert status == 200 and ctype == "application/json"
    assert set(json.loads(body)) == {"devices", "env", "programs",
                                     "dropped"}
    assert daemon.request("GET", "/debug/device?seconds=x")[0] == 400


def test_device_status_says_no_cuda_context(daemon):
    doc = json.loads(daemon.result("deviceStatus"))
    assert doc["devices"] == []
    assert doc["env"]["cudaContext"] is False
    assert doc["env"]["note"] == "no CUDA context: the card was never " \
                                 "touched"
    assert doc["env"]["kernels"] == {"built": False, "loaded": False,
                                     "nvccSeconds": 0.0}
    # the secp programs register when their driver is imported, which a
    # daemon with cryptobatch=false never does; the dispatcher brings the
    # multi-device tier's
    assert set(doc["programs"]) == {"pallas_slab", "batch_search",
                                    "packed_search", "pow_verify",
                                    "pod_slab", "pod_batch",
                                    "sharded_search", "sharded_batch"}


def test_profile_device_returns_a_cpu_trace(daemon):
    doc = json.loads(daemon.result("profileDevice", 0.2))
    assert doc["ok"] is True and doc["activities"] == ["CPU"]
    assert [f["path"] for f in doc["files"]] == ["trace.json"]
    with open(Path(doc["traceDir"]) / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


async def test_bad_profile_and_timeline_calls_answer_as_the_jax_ones(
        daemon):
    for method, params in (("profileDevice", (61,)),
                           ("profileDevice", ("soon",)),
                           ("objectTimeline", ("ab",))):
        err = daemon.call(method, *params)["error"]
        assert (err["code"], err["message"]) == \
            await _jax_error(method, *params), method
    unknown = "00" * 32
    assert json.loads(daemon.result("objectTimeline", unknown)) == \
        json.loads(_jax_handler().cmd_objectTimeline(unknown)) == {
            "timeline": []}


def test_flight_recorder_and_client_status_blocks(daemon):
    from pybitmessage_tpu.observability import HealthMonitor
    # a pubkey PoW: a counted launch and a flight-recorder event
    daemon.result("createRandomAddress", base64.b64encode(b"t").decode())
    deadline = time.monotonic() + REQUEST_TIMEOUT
    while True:
        st = json.loads(daemon.result("clientStatus"))
        if st["device"]["programs"] or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert set(st["device"]) == {"programs", "env", "dropped"}
    assert st["device"]["programs"]["pallas_slab"]["launches"] >= 1
    for row in st["device"]["programs"].values():
        assert set(row) == {"launches", "compiles", "cacheHits",
                            "hashrateHps", "mfu"}
    # the daemon runs set-reconciliation sync by default: the JAX
    # block of a node with a reconciler carries its ``sync`` verdict
    recon = types.SimpleNamespace(snapshot_state=lambda: {
        "sessions": 0, "pending": 0, "controlBytes": 0,
        "objectsDelivered": 0, "breakersOpen": 0})
    node = types.SimpleNamespace(
        reconciler=recon,
        processor=types.SimpleNamespace(
            concurrency=8, active=0,
            crypto=types.SimpleNamespace(size=1, _exec=None),
            _wb=types.SimpleNamespace(max_rows=512,
                                      pending_rows=lambda: 0)),
        ctx=types.SimpleNamespace(
            streams=(1,), object_queue=types.SimpleNamespace(
                paused=False, qsize=lambda: 0)))
    jax_block = HealthMonitor(node).health_block()
    assert st["health"].keys() == jax_block.keys()
    for name, verdict in jax_block.items():
        assert st["health"][name].keys() == verdict.keys(), name
    assert st["health"]["role"]["name"] == "all"
    dump = json.loads(daemon.result("dumpFlightRecorder"))
    assert set(dump) == {"node", "skew", "events"}
    assert len(dump["node"]) == 16 and dump["skew"] == 0.0
    assert any(e["kind"] == "slab_harvest" for e in dump["events"])
    only = json.loads(daemon.result("dumpFlightRecorder", "slab_harvest"))
    assert {e["kind"] for e in only["events"]} == {"slab_harvest"}
