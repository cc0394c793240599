"""The port's sampling profiler against the JAX package's, on the CPU.

Held against ``pybitmessage_tpu.observability.profiling``:

- one seeded sequence of synthetic stacks, rooted in each package's own
  directory, through each package's ``SamplingProfiler.sample_once``
  (``sys._current_frames`` and ``threading.enumerate`` replaced for the
  call): equal collapsed stacks, ring entries, ``cpu_samples_total``
  counts and ``speedscope_doc``;
- thread-class and subsystem decisions site for site, with the package
  marker: in one process a frame of ``/pybitmessage_tpu/`` is no
  subsystem of the port's, and a frame of ``/pybitmessage_tpu_torch/``
  none of the JAX package's; the same holds for real threads running
  each package's code under both running samplers;
- ``cost_status`` and ``dump`` keys, and the profiler's metric
  families;
- the port's wiring: the loop-lag probe naming the port function that
  held the event loop (``lastSlowCallback``), the flight recorder's
  ``profile`` block, and ``costStatus``, ``profileDump`` and ``GET
  /debug/profile`` against the JAX API's answers (a JAX node and a port
  node behind their API servers, node ids masked).

Everything compared is exact; no tolerance.  Samplers started here run
at a high rate for well under a second and are stopped.
"""

import asyncio
import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch.observability import FLIGHT_RECORDER
from pybitmessage_tpu_torch.observability import health as port_health
from pybitmessage_tpu_torch.observability import metrics as port_metrics
from pybitmessage_tpu_torch.observability import profiling as port_prof
from pybitmessage_tpu_torch.sync import digest as port_digest
from pybitmessage_tpu_torch.sync import sketch as port_sketch

TESTS = Path(__file__).resolve().parent


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.observability import metrics, profiling
    return profiling, metrics


#: (module directory, file, function) of synthetic frames; "" is the
#: package root
SITES = [
    ("pow", "dispatcher.py", "solve_batch"), ("pow", "service.py", "_run"),
    ("powfarm", "server.py", "_dispatch"), ("crypto", "batch.py", "_run"),
    ("network", "connection.py", "read_loop"),
    ("roles", "subscription.py", "on_record"),
    ("storage", "db.py", "execute"), ("sync", "digest.py", "add"),
    ("observability", "health.py", "run"), ("", "__main__.py", "run"),
    ("bufpool", "x.py", "acquire"),
]
#: frames outside either package: stdlib waits and the asyncio loop
FOREIGN = [
    ("/usr/lib/python3.12/threading.py", "wait"),
    ("/usr/lib/python3.12/selectors.py", "select"),
    ("/usr/lib/python3.12/asyncio/base_events.py", "_run_once"),
    ("/usr/lib/python3.12/queue.py", "get"),
    ("/usr/lib/python3.12/json/encoder.py", "encode"),
]
THREADS = ["bmtpu-crypto-0", "bmtpu-pow-guard", "bmtpu-farm-dispatch",
           "bmtpu-profiler", "bmtpu-edge-link", "asyncio_0",
           "ThreadPoolExecutor-0_1", "MainThread", ""]


def _frame(filename: str, name: str, back=None):
    return SimpleNamespace(f_code=SimpleNamespace(co_filename=filename,
                                                  co_name=name),
                           f_back=back)


def _stacks(seed: int, root: str):
    """One tick's ``{ident: leaf frame}`` and ``{ident: name}`` over the
    package directory ``root``; the same draws for either root."""
    rng = np.random.default_rng(seed)
    frames, names = {}, {}
    for ident in range(100, 100 + int(rng.integers(3, 9))):
        depth = int(rng.integers(1, 60))
        frame = None
        for _ in range(depth):       # outermost first
            if rng.random() < 0.6:
                sub, fname, func = SITES[int(rng.integers(0, len(SITES)))]
                path = "/".join(p for p in (root, sub, fname) if p)
            else:
                path, func = FOREIGN[int(rng.integers(0, len(FOREIGN)))]
            frame = _frame(path, func, frame)
        frames[ident] = frame
        names[ident] = THREADS[int(rng.integers(0, len(THREADS)))]
    return frames, names


def _sample(prof_mod, metrics_mod, root: str, monkeypatch, ticks: int = 40):
    registry = metrics_mod.Registry()
    counter = registry.counter("cpu_samples_total", "x",
                               ("subsystem", "thread_class"))
    prof = prof_mod.SamplingProfiler(max_nodes=400, counter=counter)
    prof.note_loop_thread(101)
    for tick in range(ticks):
        frames, names = _stacks(tick, root)
        threads = [SimpleNamespace(ident=i, name=n) for i, n in names.items()]
        monkeypatch.setattr(sys, "_current_frames", lambda f=frames: f)
        monkeypatch.setattr(threading, "enumerate", lambda t=threads: t)
        prof.sample_once()
    monkeypatch.undo()
    ring = [e[1:] for e in prof.ring]
    counts = {values: child.value for values, child in counter.children()}
    return prof, ring, counts


def test_one_synthetic_stack_sequence_gives_equal_profiles(monkeypatch):
    jax_prof, jax_metrics = _jax()
    results = [
        _sample(jax_prof, jax_metrics, "/srv/app/pybitmessage_tpu",
                monkeypatch),
        _sample(port_prof, port_metrics, "/srv/app/pybitmessage_tpu_torch",
                monkeypatch)]
    (jp, jring, jcounts), (pp, pring, pcounts) = results
    assert pring == jring
    assert pcounts == jcounts
    assert pp.samples == jp.samples > 0 and pp.ticks == jp.ticks == 40
    assert pp.collapsed() == jp.collapsed()
    assert pp.trie.nodes == jp.trie.nodes == 400     # bounded
    assert pp.trie.samples == jp.trie.samples
    assert port_prof.speedscope_doc(pp.collapsed(), name="n") == \
        jax_prof.speedscope_doc(jp.collapsed(), name="n")
    assert pp.window_collapsed(1e9) == jp.window_collapsed(1e9)
    assert pp.loop_culprit(1e9) == jp.loop_culprit(1e9)
    subsystems = {values[0] for values in pcounts}
    assert {"pow", "idle", "other"} <= subsystems
    jdump, pdump = jp.dump(1e9, node_id="n"), pp.dump(1e9, node_id="n")
    for doc in (jdump, pdump):
        doc.pop("overhead_frac")
    assert pdump == jdump


def test_speedscope_doc_of_junk_lines_is_the_jax_one():
    jax_prof, _ = _jax()
    lines = ["a;b;c 3", "a;b 1", "", "x;y notanumber", ";a;;b 2", "z 0.5"]
    assert port_prof.speedscope_doc(lines) == jax_prof.speedscope_doc(lines)


@pytest.mark.parametrize("sub,fname,func", SITES)
def test_thread_and_subsystem_decisions_site_for_site(sub, fname, func):
    """Each package classifies its own frames alike, and neither counts
    the other's frames as one of its subsystems."""
    jax_prof, _ = _jax()
    port_root = "/r/pybitmessage_tpu_torch"
    jax_root = "/r/pybitmessage_tpu"

    def path(root):
        return "/".join(p for p in (root, sub, fname) if p)
    for leaf_name in (func, "wait", "select"):
        own = [mod._frame_site(_frame(path(root), leaf_name))
               for mod, root in ((jax_prof, jax_root),
                                 (port_prof, port_root))]
        assert own[0] == own[1] and own[1][1] is True
        # the other package's frame is foreign to each
        assert port_prof._frame_site(
            _frame(path(jax_root), leaf_name)) == \
            (fname + ":" + leaf_name, False)
        assert jax_prof._frame_site(
            _frame(path(port_root), leaf_name)) == \
            (fname + ":" + leaf_name, False)
        site = own[1][0]
        assert port_prof._subsystem_of(site) == jax_prof._subsystem_of(site)
        for cls in ("event_loop", "crypto_pool", "other"):
            for in_pkg in (True, False):
                for pkg_site in (site, ""):
                    args = (cls, leaf_name, pkg_site, in_pkg)
                    assert port_prof.SamplingProfiler()._classify_sample(
                        *args) == jax_prof.SamplingProfiler() \
                        ._classify_sample(*args)
    for name in THREADS:
        profs = [m.SamplingProfiler() for m in (jax_prof, port_prof)]
        for p in profs:
            p.note_loop_thread(7)
        assert profs[1]._classify_thread(1, name) == \
            profs[0]._classify_thread(1, name)
        assert profs[1]._classify_thread(7, name) == "event_loop"
    assert port_prof.THREAD_CLASSES == jax_prof.THREAD_CLASSES
    assert port_prof.SUBSYSTEMS == jax_prof.SUBSYSTEMS
    assert port_prof.IDLE_LEAVES == jax_prof.IDLE_LEAVES
    assert port_prof.LOOP_IDLE_LEAVES == jax_prof.LOOP_IDLE_LEAVES
    assert (port_prof.DEFAULT_HZ, port_prof.DEFAULT_RING,
            port_prof.DEFAULT_TRIE_NODES, port_prof.MAX_STACK_DEPTH,
            port_prof.MAX_WALK_FRAMES) == \
        (jax_prof.DEFAULT_HZ, jax_prof.DEFAULT_RING,
         jax_prof.DEFAULT_TRIE_NODES, jax_prof.MAX_STACK_DEPTH,
         jax_prof.MAX_WALK_FRAMES)


def test_real_threads_of_both_packages_under_both_samplers():
    """Two ``bmtpu-`` threads hash in a loop, one through the JAX
    package's ``short_id`` and one through the port's, while both
    packages' samplers run: each names only its own package's frames
    ``sync``."""
    jax_prof, jax_metrics = _jax()
    from pybitmessage_tpu.sync import sketch as jax_sketch
    stop = threading.Event()

    def spin(fn):
        h = bytes(range(32))
        while not stop.is_set():
            for _ in range(200):
                fn(h, 5)
    threads = [threading.Thread(target=spin, args=(fn,), daemon=True,
                                name="bmtpu-crypto-" + tag)
               for fn, tag in ((jax_sketch.short_id, "jax"),
                               (port_sketch.short_id, "port"))]
    profs = []
    for mod, metrics in ((jax_prof, jax_metrics),
                         (port_prof, port_metrics)):
        counter = metrics.Registry().counter(
            "cpu_samples_total", "x", ("subsystem", "thread_class"))
        profs.append(mod.SamplingProfiler(hz=200, counter=counter))
    for t in threads:
        t.start()
    try:
        for p in profs:
            p.start()
        time.sleep(0.6)
    finally:
        for p in profs:
            p.stop()
        stop.set()
        for t in threads:
            t.join(5)
    assert threads[0].ident != threads[1].ident
    jax_subs, port_subs = set(), set()
    for prof, seen in zip(profs, (jax_subs, port_subs)):
        for _, cls, sub, leaf, _ in prof.ring:
            if cls == "crypto_pool":
                seen.add((sub, leaf.startswith("sync/sketch.py")))
    # each sampler sees both threads; only its own package's is "sync"
    assert ("sync", True) in port_subs and ("sync", True) in jax_subs
    assert all(sub == "sync" for sub, own in port_subs if own)
    assert all(sub != "sync" for sub, own in port_subs if not own)
    assert all(sub != "sync" for sub, own in jax_subs if not own)
    assert len(port_subs) == len(jax_subs) == 2


def test_cost_status_and_dump_keys_are_the_jax_ones():
    jax_prof, _ = _jax()
    node = SimpleNamespace(node_id="n", role="edge")
    jdoc = jax_prof.cost_status(node, profiler=jax_prof.SamplingProfiler())
    pdoc = port_prof.cost_status(node, profiler=port_prof.SamplingProfiler())
    assert list(pdoc) == list(jdoc)
    for key in ("sampler", "cpu"):
        assert list(pdoc[key]) == list(jdoc[key])
    assert list(pdoc["device"]) == list(jdoc["device"])
    assert pdoc["sampler"] == jdoc["sampler"]
    assert (pdoc["node"], pdoc["role"]) == (jdoc["node"], jdoc["role"])
    assert list(port_prof.cost_status()) == list(jax_prof.cost_status())
    fresh = [m.SamplingProfiler() for m in (jax_prof, port_prof)]
    for seconds in (None, 5.0):
        docs = [p.dump(seconds, node_id="n") for p in fresh]
        assert docs[1] == docs[0]
    assert fresh[1].flight_profile() == fresh[0].flight_profile()


def test_profiler_metric_families_are_the_jax_ones():
    jax_prof, _ = _jax()

    def families(mod):
        return {v.name: (v.kind, v.help, v.labelnames)
                for k, v in vars(mod).items()
                if k.isupper() and hasattr(v, "labelnames")}
    assert families(port_prof) == families(jax_prof)
    assert set(families(port_prof)) == {
        "cpu_samples_total", "profile_sampler_overhead_ratio",
        "profile_sampler_errors_total", "event_loop_slow_callback_total"}


async def test_the_loop_lag_probe_names_the_port_function_that_held_it():
    """A coroutine re-buckets a port ``InventoryDigest`` of 50,000
    hashes on the event loop for 0.3 s while the global sampler runs:
    the probe's next tick is late, and the health block names
    ``sync/digest.py``."""
    digest = port_digest.InventoryDigest()
    for i in range(50_000):
        digest.add(i.to_bytes(32, "little"), 1, 0)
    prof = port_prof.PROFILER
    assert not prof.running
    prof.hz = 200.0
    prof.note_loop_thread()
    monitor = port_health.HealthMonitor(None, lag_interval=0.02)
    prof.start()
    monitor.start()
    try:
        assert FLIGHT_RECORDER.profile_provider == prof.flight_profile
        await asyncio.sleep(0.1)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.3:
            digest.resize(digest.buckets % 97 + 1)
        await asyncio.sleep(0.1)
        block = monitor.health_block()
        assert block["loop"]["lastSlowCallback"]
        assert monitor.probe.recent_culprit()[1] >= 0.05
        # the spike of the busy window named the port function (a later
        # spike of a loaded machine may name another site since)
        sites = [e["site"] for e in FLIGHT_RECORDER.dump("test")
                 if e.get("kind") == "slow_callback"]
        [site] = {s for s in sites if s.startswith("sync/digest.py:")}
        assert port_metrics.REGISTRY.sample(
            "event_loop_slow_callback_total", {"site": site}) >= 1
        assert FLIGHT_RECORDER.profile()["samples"] > 0
        status = port_prof.cost_status()
        assert status["sampler"]["running"] is True
        assert status["sampler"]["samples"] > 0
        assert "sync" in status["cpu"]["subsystems"]
    finally:
        await monitor.stop()
        prof.stop()
        prof.hz = port_prof.DEFAULT_HZ
    assert FLIGHT_RECORDER.profile_provider is None


async def test_cost_status_profile_dump_and_get_answer_as_the_jax_api(
        monkeypatch):
    """``costStatus``, ``profileDump`` (window and whole run, with and
    without speedscope) and ``GET /debug/profile`` on a JAX node and a
    port node behind their API servers: the same documents with the
    node ids masked (each process-wide sampler replaced by a fresh one
    that is not running)."""
    sys.path.insert(0, str(TESTS))
    from test_torch_api import pair
    import pybitmessage_tpu.observability as jax_obs
    from pybitmessage_tpu_torch.api import commands, server
    jax_prof, _ = _jax()
    monkeypatch.setattr(jax_obs, "PROFILER", jax_prof.SamplingProfiler())
    monkeypatch.setattr(jax_prof, "PROFILER", jax_obs.PROFILER)
    fresh = port_prof.SamplingProfiler()
    for mod in (port_prof, commands, server):
        monkeypatch.setattr(mod, "PROFILER", fresh)

    def shape(value):
        if isinstance(value, dict):
            return {k: shape(v) for k, v in value.items()}
        if isinstance(value, list):
            return [shape(v) for v in value]
        return type(value).__name__

    def masked(doc):
        doc = json.loads(doc) if isinstance(doc, str) else doc
        if "node" in doc:
            doc["node"] = "<node>"
        if "speedscope" in doc:
            doc["speedscope"]["name"] = "<node>"
            doc["speedscope"]["profiles"][0]["name"] = "<node>"
        return doc
    assert not port_prof.PROFILER.running
    assert not jax_prof.PROFILER.running
    async with pair() as p:
        jr, pr = await p.each("costStatus", (), ())
        jdoc, pdoc = json.loads(jr["result"]), json.loads(pr["result"])
        assert shape(pdoc).keys() == shape(jdoc).keys()
        assert pdoc["sampler"]["running"] is jdoc["sampler"]["running"] \
            is False
        assert pdoc["role"] == jdoc["role"] == "all"
        assert pdoc["node"] == p.port_node.node_id
        for params in ((), (5,), (0, "collapsed"), ("2.5", "")):
            jr, pr = await p.each("profileDump", params, params)
            assert masked(pr["result"]) == masked(jr["result"]), params
        assert await p.error_code("profileDump", "soon") == 0
        auth = "Authorization: Basic %s\r\n" % p.port.auth
        for query in ("", "?seconds=3"):
            head = "GET /debug/profile%s HTTP/1.1\r\n%s\r\n" % (query, auth)
            (js, jbody), (ps, pbody) = await asyncio.gather(
                p.jax.raw(head), p.port.raw(head))
            assert js == ps == 200
            assert masked(json.loads(pbody)) == masked(json.loads(jbody))
        head = "GET /debug/profile HTTP/1.1\r\n\r\n"
        assert (await p.port.raw(head))[0] == \
            (await p.jax.raw(head))[0] == 401
        head = "GET /debug/profile?seconds=x HTTP/1.1\r\n%s\r\n" % auth
        assert (await p.port.raw(head))[0] == \
            (await p.jax.raw(head))[0] == 400
