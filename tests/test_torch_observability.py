"""The port's observability plane against the JAX package's, on the CPU.

The same seeded operations go through both packages and must come out
the same: a fresh ``Registry`` renders byte-identical Prometheus text
and an equal ``snapshot``; every metric family a ported JAX module
defines exists in its twin with the same name, type, help, labels and
buckets (the exceptions are written out in ``CATALOG_EXCEPTIONS``, each
with its reason); nested spans link the same parents and feed the same
histogram counts; the flight recorder and the lifecycle tracer dump the
same events and timelines (timestamps masked); ``DeviceTelemetry`` fed
one seeded ``record_launch`` sequence with overlapping spans gives equal
``device_status()`` rows but for ``mfu`` and ``flopsPerItem``, which
are the port's own model and are held to it; ``HealthMonitor`` gives
the same verdicts on the same stub node.  A pipelined solve, a verifier
drain and a crypto-engine drain through the port are attributed to
their programs, and no telemetry call touches CUDA on the CPU.
"""

import ast
import asyncio
import importlib
import inspect
import re
import types

import numpy as np
import pytest
import torch

from pybitmessage_tpu_torch.observability import devicetelemetry as port_dt
from pybitmessage_tpu_torch.observability import export as port_export
from pybitmessage_tpu_torch.observability import flightrec as port_fr
from pybitmessage_tpu_torch.observability import health as port_health
from pybitmessage_tpu_torch.observability import lifecycle as port_lc
from pybitmessage_tpu_torch.observability import metrics as port_metrics
from pybitmessage_tpu_torch.observability import tracing as port_tracing
from pybitmessage_tpu_torch.observability import REGISTRY as PORT_REGISTRY


def _jax(name: str):
    import jax
    jax.config.update("jax_platforms", "cpu")
    return importlib.import_module("pybitmessage_tpu." + name)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _registry_ops(metrics, seed: int):
    """One seeded sequence of registry operations, replayed on
    ``metrics`` (either package's module); returns the registry."""
    rng = np.random.default_rng(seed)
    reg = metrics.Registry()
    c = reg.counter("t_events_total", 'Events "quoted"\nand a\\slash',
                    ("kind",))
    g = reg.gauge("t_depth", "Depth")
    h = reg.histogram("t_wait_seconds", "Waits", ("site",))
    s = reg.histogram("t_batch_size", "Sizes",
                      buckets=metrics.DEFAULT_SIZE_BUCKETS)
    u = reg.counter("t_plain_total", "Unlabelled")
    for _ in range(200):
        op = int(rng.integers(5))
        if op == 0:
            c.labels(kind="k%d" % rng.integers(6)).inc(
                float(rng.integers(1, 5)))
        elif op == 1:
            g.set(float(rng.normal()))
        elif op == 2:
            h.labels(site='s"%d\n' % rng.integers(3)).observe(
                float(rng.exponential(0.01)))
        elif op == 3:
            s.observe(float(rng.integers(0, 3000)))
        else:
            u.inc()
    # past the cardinality guard: the overflow is dropped, not rendered
    for i in range(metrics.MAX_LABEL_SETS + 20):
        c.labels(kind="x%d" % i).inc()
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_renders_byte_identical(seed):
    metrics = _jax("observability.metrics")
    export = _jax("observability.export")
    jax_reg = _registry_ops(metrics, seed)
    port_reg = _registry_ops(port_metrics, seed)
    assert port_export.render_prometheus(port_reg) == \
        export.render_prometheus(jax_reg)
    assert port_export.snapshot(port_reg) == export.snapshot(jax_reg)
    assert port_export.snapshot(port_reg, include_buckets=True) == \
        export.snapshot(jax_reg, include_buckets=True)


def test_registry_constants_and_peer_buckets():
    metrics = _jax("observability.metrics")
    for name in ("DEFAULT_LATENCY_BUCKETS", "DEFAULT_SIZE_BUCKETS",
                 "MAX_LABEL_SETS", "DEFAULT_PEER_BUCKETS"):
        assert getattr(port_metrics, name) == getattr(metrics, name), name
    for peer in ("127.0.0.1:8444", "[::1]:1", "example.onion:8444"):
        for n in (1, 7, 16, 512):
            assert port_metrics.peer_bucket(peer, n) == \
                metrics.peer_bucket(peer, n)
            assert port_metrics.peer_bucket_label("net.dial", peer, n) == \
                metrics.peer_bucket_label("net.dial", peer, n)


# ---------------------------------------------------------------------------
# the metric-family catalog
# ---------------------------------------------------------------------------

#: JAX module -> its twin in the port, for every ported module that
#: defines metric families
TWINS = [
    "observability.metrics", "observability.flightrec",
    "observability.lifecycle", "observability.health",
    "observability.devicetelemetry", "observability.tracing",
    "pow.service", "pow.dispatcher", "pow.pipeline", "pow.verify_service",
    "crypto.batch", "crypto.screen", "crypto.signing",
    "workers.sender", "workers.processor", "workers.cryptopool",
    "storage.inventory", "storage.writebehind", "utils.queues",
    "resilience.policy", "network.connection", "network.pool",
    "network.bufpool", "network.ratelimit", "api.server",
    "resilience.chaos", "resilience.journal", "powfarm.scheduler",
    "powfarm.server", "powfarm.client", "sync.reconciler",
    "observability.federation", "storage.slabstore", "resilience.watchdog",
]

#: families a JAX twin defines that the port leaves out or words apart
CATALOG_EXCEPTIONS = {
    "pow_mesh_compiles_total": "help differs: a mesh construction is no "
                               "XLA compile in the port",
    "crypto_tpu_fallback_total": "a failed card drain is settled, never "
                                 "re-run on the host rungs",
    "device_mfu_ratio": "help differs: the port's ratio is the share of "
                        "the card's bound, not flops over a TPU peak",
    "device_memory_bytes": "help differs: read from torch.cuda, not a "
                           "backend's memory_stats()",
}


def _defined_families(module) -> dict:
    """Families assigned at module level as ``X = REGISTRY.<kind>(``."""
    tree = ast.parse(inspect.getsource(module))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                isinstance(node.value.func, ast.Attribute) and \
                isinstance(node.value.func.value, ast.Name) and \
                node.value.func.value.id == "REGISTRY":
            fam = getattr(module, node.targets[0].id)
            out[fam.name] = fam
    return out


def _describe(fam) -> tuple:
    return (fam.kind, fam.help, fam.labelnames,
            getattr(fam, "_bounds", None))


@pytest.mark.parametrize("name", TWINS)
def test_catalog_matches_the_jax_module(name):
    jax_fams = _defined_families(_jax(name))
    port_fams = _defined_families(
        importlib.import_module("pybitmessage_tpu_torch." + name))
    for fam_name, fam in jax_fams.items():
        if fam_name in CATALOG_EXCEPTIONS:
            continue
        assert fam_name in port_fams, "%s lacks %s" % (name, fam_name)
        assert _describe(port_fams[fam_name]) == _describe(fam), fam_name
    for fam_name, fam in port_fams.items():
        assert fam_name in jax_fams, "%s: %s is not the JAX's" % (
            name, fam_name)
        if fam_name in CATALOG_EXCEPTIONS:
            # worded apart, typed and labelled the same
            assert _describe(fam)[::2] == _describe(jax_fams[fam_name])[::2]


def test_catalog_exceptions_are_all_used():
    jax_names = set()
    for name in TWINS:
        jax_names |= set(_defined_families(_jax(name)))
    assert set(CATALOG_EXCEPTIONS) <= jax_names
    assert PORT_REGISTRY.get("device_launches_total") is not None


# ---------------------------------------------------------------------------
# spans, flight recorder, lifecycle
# ---------------------------------------------------------------------------


def _spans(tracing, metrics, seed: int):
    rng = np.random.default_rng(seed)
    tracer = tracing.Tracer()
    hist = metrics.Registry().histogram("t_span_seconds", "span")

    def nest(depth):
        with tracing.trace("s%d" % depth, tracer=tracer, histogram=hist,
                           depth=depth):
            for _ in range(int(rng.integers(0, 3)) if depth < 3 else 0):
                nest(depth + 1)

    for _ in range(5):
        nest(0)
    try:
        with tracing.trace("boom", tracer=tracer):
            raise KeyError("x")
    except KeyError:
        pass
    ids = {s.span_id: i for i, s in enumerate(tracer.recent(1000))}
    shape = [(s.name, ids.get(s.parent_id), dict(s.attrs))
             for s in tracer.recent(1000)]
    return shape, hist.count


@pytest.mark.parametrize("seed", [3, 4])
def test_spans_link_the_same_parents(seed):
    tracing = _jax("observability.tracing")
    metrics = _jax("observability.metrics")
    assert _spans(port_tracing, port_metrics, seed) == \
        _spans(tracing, metrics, seed)
    port_tracing.enable_profiler_annotations(True)
    try:
        assert port_tracing.profiler_annotations_enabled()
        with port_tracing.trace("bridged") as span:
            assert port_tracing.current_span() is span
    finally:
        port_tracing.enable_profiler_annotations(False)
    assert port_tracing.current_span() is None
    assert len(port_tracing.new_trace_id()) == 16


def _flight(flightrec, seed: int):
    rng = np.random.default_rng(seed)
    rec = flightrec.FlightRecorder(maxlen=40)
    rec.node_id = "n%d" % seed
    for i in range(60):
        rec.record("k%d" % rng.integers(4), i=i, v=float(rng.random()))
    rec.resize(25)
    dump = rec.dump_record("api")
    for e in dump["events"]:
        e["t"] = 0
    return (dump, [e["i"] for e in rec.events(n=5, kind="k1")],
            len(rec.events()))


def test_flight_recorder_dumps_the_same_events():
    flightrec = _jax("observability.flightrec")
    assert _flight(port_fr, 5) == _flight(flightrec, 5)
    assert port_fr.DEFAULT_CAPACITY == flightrec.DEFAULT_CAPACITY


def _timelines(lifecycle, metrics, seed: int):
    rng = np.random.default_rng(seed)
    reg = metrics.Registry()
    stage = reg.histogram("t_stage_seconds", "s", ("from", "to"))
    prop = reg.histogram("t_prop_seconds", "p")
    clock = iter(range(10 ** 6))
    lc = lifecycle.LifecycleTracer(maxlen=8, clock=lambda: next(clock),
                                   stage_histogram=stage,
                                   propagation_histogram=prop,
                                   update_gauge=False)
    hashes = [bytes([i]) * 32 for i in range(12)]
    for _ in range(150):
        h = hashes[int(rng.integers(len(hashes)))]
        lc.record(h, lifecycle.STAGES[int(rng.integers(
            len(lifecycle.STAGES)))])
        if rng.random() < 0.1:
            lc.observe_propagation(h)
    lc.discard(hashes[0])
    return ({h: lc.timeline(h) for h in hashes}, lc.snapshot(),
            port_export.snapshot(reg) if lifecycle is port_lc
            else _jax("observability.export").snapshot(reg),
            lc.trace_meta(hashes[3]))


def test_lifecycle_timelines_are_the_same():
    lifecycle = _jax("observability.lifecycle")
    metrics = _jax("observability.metrics")
    assert port_lc.STAGES == lifecycle.STAGES
    assert port_lc.LifecycleTracer.MAX_EVENTS == \
        lifecycle.LifecycleTracer.MAX_EVENTS
    port = _timelines(port_lc, port_metrics, 6)
    jax_side = _timelines(lifecycle, metrics, 6)
    assert port == jax_side
    # the port has no wire trace: no stitching metadata, as a JAX
    # object that never crossed a traced link
    assert port[3] is None


# ---------------------------------------------------------------------------
# device telemetry
# ---------------------------------------------------------------------------

#: row fields equal between the packages (mfu and flopsPerItem are each
#: package's own model: flops over a v5e peak there, the share of the
#: card's bound here)
ROW_FIELDS = ("launches", "compiles", "cacheHits", "compileSeconds",
              "dispatchSeconds", "executeWaitSeconds", "busySeconds",
              "h2dBytes", "d2hBytes", "donatedBytes", "donationRate",
              "workItems", "hashrateHps")


def _launches(seed: int, programs) -> list:
    """A seeded record_launch sequence: repeated keys, overlapping
    (double-buffered) spans, gaps, donation, and one bad call."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000.0
    for i in range(60):
        t += float(rng.uniform(0.0, 0.02))
        dur = float(rng.uniform(0.001, 0.05))
        out.append((programs[int(rng.integers(len(programs)))], dict(
            key=("k", int(rng.integers(3))),
            dispatch_seconds=float(rng.uniform(0, 0.002)),
            wait_seconds=float(rng.uniform(0, 0.01)),
            span=(t, t + dur) if i % 7 else None,
            items=int(rng.integers(0, 5000)),
            bytes_in=int(rng.integers(0, 512)),
            bytes_out=int(rng.integers(0, 64)),
            bytes_donated=int(rng.integers(0, 2)) * 16)))
    out.append((programs[0], dict(items="not a number")))
    return out


def test_device_status_rows_equal_for_one_launch_sequence():
    jax_dt = _jax("observability.devicetelemetry")
    programs = ["parity_a", "parity_b"]
    for name in programs:
        jax_dt.register_program(name, flops_per_item=1.0,
                                module="tests/parity")
        port_dt.register_program(name, module="tests/parity")
    jax_drop0 = jax_dt.REGISTRY.sample("device_telemetry_dropped_total")
    port_drop0 = PORT_REGISTRY.sample("device_telemetry_dropped_total")
    for program, kw in _launches(7, programs):
        jax_dt.record_launch(program, **kw)
        port_dt.record_launch(program, **kw)
    jax_rows = jax_dt.device_status()["programs"]
    status = port_dt.device_status()
    for name in programs:
        for field in ROW_FIELDS:
            assert status["programs"][name][field] == \
                jax_rows[name][field], (name, field)
        assert status["programs"][name]["module"] == "tests/parity"
        # no cost model registered and no card: no ratio
        assert status["programs"][name]["flopsPerItem"] is None
        assert status["programs"][name]["mfu"] == 0.0
    assert jax_dt.REGISTRY.sample("device_telemetry_dropped_total") - \
        jax_drop0 == PORT_REGISTRY.sample(
            "device_telemetry_dropped_total") - port_drop0 == 1
    assert not torch.cuda.is_initialized()


def test_utilization_is_the_share_of_the_cards_bound(monkeypatch):
    """``device_mfu_ratio`` = the least seconds of all credited work
    over the busy seconds (``ops/bounds.py`` per item), read only with a
    CUDA context; here a card of 132 SMs at 1.98 GHz stands in."""
    from pybitmessage_tpu_torch.ops import bounds
    monkeypatch.setattr(port_dt, "_live_cuda", lambda: torch)
    monkeypatch.setattr(port_dt, "_CARD", [(132, 1.98e9)])
    tele = port_dt.DeviceTelemetry()
    tele.register_program("util_pow", cost=bounds.POW_TRIAL)
    tele.register_program("util_ecdh", cost=bounds.SECP_ECDH_LANE)
    trial = bounds.trial_seconds(132, 1.98e9)
    lane = bounds.average_lane_slots("secp_ecdh") / (64 * 132 * 1.98e9)
    # two overlapping slabs: 2e9 trials over the 1.5 s union
    tele.record_launch("util_pow", span=(0.0, 1.0), items=1e9)
    tele.record_launch("util_pow", span=(0.5, 1.5), items=1e9)
    tele.record_launch("util_ecdh", span=(2.0, 2.01), items=4096)
    got = {p: PORT_REGISTRY.sample("device_mfu_ratio", {"program": p})
           for p in ("util_pow", "util_ecdh")}
    assert got["util_pow"] == pytest.approx(2e9 * trial / 1.5)
    assert got["util_ecdh"] == pytest.approx(4096 * lane / 0.01)
    assert bounds.POW_TRIAL.instructions() == sum(bounds.ops_per_trial())
    # the same counts chip_smoke's bound column reads
    assert bounds.trial_seconds_bound(
        {"sms": 132, "clock_mhz": 1980.0,
         "ops_per_trial": bounds.ops_per_trial()}) == trial


def test_no_tpu_constant_in_the_port():
    from pathlib import Path
    root = Path(port_dt.__file__).resolve().parents[1]
    for path in sorted(root.rglob("*.py")):
        text = path.read_text()
        for constant in ("6.1e12", "21152", "3.6e6", "2.4e6",
                         "DEVICE_PEAK_OPS", "POW_FLOPS_PER_HASH"):
            assert constant not in text, (path.name, constant)


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------


def _stub_node(queue_paused: bool, pending: int, active: int):
    class Queue:
        paused = queue_paused

        @staticmethod
        def qsize():
            return 7

    class WB:
        max_rows = 512

        @staticmethod
        def pending_rows():
            return pending

    pool = types.SimpleNamespace(size=4, _exec=None)
    return types.SimpleNamespace(
        processor=types.SimpleNamespace(concurrency=8, active=active,
                                        crypto=pool, _wb=WB()),
        ctx=types.SimpleNamespace(streams=(1,), object_queue=Queue()))


@pytest.mark.parametrize("case", [
    dict(queue_paused=False, pending=3, active=2, breaker_open=False),
    dict(queue_paused=True, pending=600, active=8, breaker_open=False),
    dict(queue_paused=False, pending=0, active=0, breaker_open=True),
])
def test_health_block_gives_the_same_verdicts(case, monkeypatch):
    health = _jax("observability.health")
    jax_policy = _jax("resilience.policy")
    from pybitmessage_tpu_torch.pow import service as port_service
    from pybitmessage_tpu_torch.resilience import policy as port_policy
    jax_service = _jax("pow.service")
    blocks = []
    for mod, policy, service in ((health, jax_policy, jax_service),
                                 (port_health, port_policy, port_service)):
        monkeypatch.setattr(policy, "BREAKERS", {})
        breaker = policy.CircuitBreaker("parity.breaker", threshold=1,
                                        cooldown=3600.0)
        if case["breaker_open"]:
            breaker.record_failure()
        service.QUEUE_DEPTH.set(5)
        node = _stub_node(case["queue_paused"], case["pending"],
                          case["active"])
        monitor = mod.HealthMonitor(node)
        monitor.sample()
        for lag in (0.001, 0.002, 0.2 if case["queue_paused"] else 0.003):
            monitor.probe.recent.append(lag)
        blocks.append(monitor.health_block())
    assert blocks[1] == blocks[0]
    assert port_health.HealthMonitor(None).health_block().keys() == \
        health.HealthMonitor(None).health_block().keys() == {"loop"}


# ---------------------------------------------------------------------------
# a path through the port's drivers
# ---------------------------------------------------------------------------


def _launch_counts():
    return {p: PORT_REGISTRY.sample("device_launches_total", {"program": p})
            for p in ("batch_search", "packed_search", "pow_verify",
                      "secp_verify", "secp_ecdh")}


def _wait_count(registry):
    return registry.sample("pow_pipeline_device_wait_seconds")


def test_pipeline_launches_are_attributed_as_the_jax_driver_does():
    """The CPU pipeline is the twin of the JAX driver's XLA path
    (``packed_search_xla``); the port records under the plan's program.
    The JAX driver records the slabs it harvests; the port records every
    launch, the abandoned speculation too, since the kernels' wrappers
    count those (chip_smoke.py holds the two counts equal on the card)."""
    import hashlib
    jax_pipeline = _jax("pow.pipeline")
    from pybitmessage_tpu_torch.pow import pipeline
    items = [(hashlib.sha512(b"path %d" % i).digest(), (1 << 64) // 3000)
             for i in range(4)]
    before, wait0 = _launch_counts(), _wait_count(PORT_REGISTRY)
    jax_before = jax_pipeline.REGISTRY.sample(
        "device_launches_total", {"program": "packed_search_xla"})
    jax_wait0 = _wait_count(jax_pipeline.REGISTRY)
    port_stats, jax_stats = {}, {}
    got = pipeline.solve_batch_pipelined(
        items, rows=16, device="cpu", stats=port_stats,
        plan=pipeline.BatchPlan("packed", 2, 2, list(range(4))))
    want = jax_pipeline.solve_batch_pipelined(
        items, rows=16, impl="xla", stats=jax_stats,
        plan=jax_pipeline.BatchPlan("packed", 2, 2, list(range(4))))
    assert got == want
    delta = _launch_counts()["packed_search"] - before["packed_search"]
    jax_delta = jax_pipeline.REGISTRY.sample(
        "device_launches_total", {"program": "packed_search_xla"}) - \
        jax_before
    assert delta == port_stats["launches"] == jax_stats["launches"]
    assert _wait_count(PORT_REGISTRY) - wait0 == jax_delta == \
        _wait_count(jax_pipeline.REGISTRY) - jax_wait0
    assert not torch.cuda.is_initialized()


async def test_verifier_and_engine_drains_are_attributed():
    """One ``BatchVerifier`` device drain is one ``pow_verify`` launch,
    as ``ops/pow_search.py:246`` records it; each engine drain is one
    ``secp_verify`` / ``secp_ecdh`` launch, as ``crypto/tpu.py:280,307``
    records each backend call (the JAX engine itself is not run here:
    its XLA programs compile for ~37 s on the CPU)."""
    from pybitmessage_tpu_torch.crypto import fallback
    from pybitmessage_tpu_torch.crypto.batch import BatchCryptoEngine
    from pybitmessage_tpu_torch.crypto.ecies import encrypt
    from pybitmessage_tpu_torch.crypto.signing import sign
    from pybitmessage_tpu_torch.pow.verify_service import BatchVerifier
    before = _launch_counts()
    batches0 = PORT_REGISTRY.sample("pow_verify_batches_total")
    verifier = BatchVerifier("cpu", ntpb=10, extra=10, clamp=False)
    verifier.start()
    try:
        objects = [bytes(8) + (10 ** 10).to_bytes(8, "big") + bytes([i]) * 30
                   for i in range(5)]
        got = await asyncio.gather(*(verifier.check(ob) for ob in objects))
    finally:
        await verifier.stop()
    assert len(got) == 5 and verifier.device_batches == 1
    priv = (12345).to_bytes(32, "big")
    pub = fallback.priv_to_pub(priv)
    engine = BatchCryptoEngine("cpu", gpu_batch_min=1)   # the card rung
    engine.start()
    try:
        ok = await engine.verify(b"data", sign(b"data", priv), pub)
        blob = encrypt(b"hello", pub)
        matches = await engine.try_decrypt(blob, [(priv, "me")])
    finally:
        await engine.stop()
    assert ok is True and matches == [(b"hello", "me")]
    delta = {k: v - before[k] for k, v in _launch_counts().items()}
    assert delta["pow_verify"] == 1 == \
        PORT_REGISTRY.sample("pow_verify_batches_total") - batches0
    assert delta["secp_verify"] == engine.backend.calls["verify"] == 1
    assert delta["secp_ecdh"] == engine.backend.calls["ecdh"] == 1
    assert not torch.cuda.is_initialized()


def test_no_telemetry_call_touches_cuda(tmp_path):
    status = port_dt.device_status()
    assert status["devices"] == []
    assert status["env"]["cudaContext"] is False
    assert "no CUDA context" in status["env"]["note"]
    doc = port_dt.capture_device_trace(0.2, out_dir=str(tmp_path))
    assert doc["ok"] and doc["activities"] == ["CPU"]
    assert [f["path"] for f in doc["files"]] == ["trace.json"]
    with pytest.raises(ValueError):
        port_dt.capture_device_trace(61)
    with pytest.raises(ValueError):
        port_dt.capture_device_trace(0)
    assert not torch.cuda.is_initialized()


def test_a_second_capture_answers_not_ok():
    with port_dt.DeviceTrace():
        doc = port_dt.capture_device_trace(0.1)
    assert doc["ok"] is False and "already running" in doc["error"]


def test_catalog_docstring_lists_every_registered_program():
    import pybitmessage_tpu_torch.crypto.gpu  # noqa: F401  (registers)
    import pybitmessage_tpu_torch.ops.pow_search  # noqa: F401
    import pybitmessage_tpu_torch.ops.sha512_cuda  # noqa: F401
    import pybitmessage_tpu_torch.parallel  # noqa: F401
    doc = port_dt.__doc__
    catalog = {p for p in port_dt.DEVICE_TELEMETRY.programs()
               if not p.startswith(("parity_", "util_"))}
    assert catalog == {"pallas_slab", "batch_search", "packed_search",
                       "pow_verify", "secp_verify", "secp_ecdh",
                       "pod_slab", "pod_batch", "sharded_search",
                       "sharded_batch"}
    for program in catalog:
        assert re.search(r"``%s`` - " % program, doc), program
    for left_out in ("pow_slab", "packed_search_xla"):
        assert "``%s``" % left_out in doc, left_out
