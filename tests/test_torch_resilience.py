"""The rest of the port's resilience against the JAX package's, on the CPU.

The five chaos sites this package now plants (``db.write`` in the
database's write retry, ``pow.readback`` in the pipeline's fetch and the
single-sync readback, ``net.dial`` in ``ConnectionPool.connect_to``,
``net.send`` in ``BMConnection.send_packet``, ``api.dispatch`` in the API
server's ``_call``) and ``storage.slab_io`` at the slab store's drain and
seal writes: each fires in the same module and function as in the JAX
package (a probe exception records where it was raised) and, armed with
its defaults, ends as the JAX site ends (the same exception class, the
same absorbed outcome, the same counters).  ``SITES`` is the JAX
catalog, the two batch-crypto rungs included, and ``unplanted`` names
only sites outside it.  The watchdog: ``StallGuard`` counts as the JAX
guard does, the pipeline's guard over a fetch held by the test counts into
``pow_stall_total{site="pow.slab"}`` and raises the watchdog's
``SlabStallError``, and ``PowService`` over the dispatcher returns the
lowest nonce after a readback fault and after a stall, with the
recovery observed once.  ``clientStatus``'s ``resilience`` block has the
JAX keys.

Nothing of JAX is imported at module level.
"""

import asyncio
import functools
import hashlib
import importlib
import inspect
import re
import sys
import threading
import traceback
import xmlrpc.client
from pathlib import Path
from types import SimpleNamespace

import pytest

from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.pow import dispatcher as port_dispatcher
from pybitmessage_tpu_torch.pow import pipeline as port_pipeline
from pybitmessage_tpu_torch.pow.dispatcher import PowDispatcher, python_solve
from pybitmessage_tpu_torch.pow.service import PowService
from pybitmessage_tpu_torch.resilience import chaos as port_chaos
from pybitmessage_tpu_torch.resilience import watchdog as port_watchdog

#: a target nearly every nonce meets: a solve ends in its first slab
EASY = 1 << 60


def _jax(name: str):
    import jax
    jax.config.update("jax_platforms", "cpu")
    return importlib.import_module("pybitmessage_tpu." + name)


def _pkg(which: str):
    prefix = "pybitmessage_tpu" if which == "jax" else \
        "pybitmessage_tpu_torch"
    if which == "jax":
        _jax("resilience")

    def mod(name):
        return importlib.import_module(prefix + "." + name)
    return SimpleNamespace(name=prefix, mod=mod,
                           chaos=mod("resilience.chaos"),
                           registry=mod("observability").REGISTRY)


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    port_chaos.CHAOS.disarm()
    if "pybitmessage_tpu.resilience.chaos" in sys.modules:
        sys.modules["pybitmessage_tpu.resilience.chaos"].CHAOS.disarm()


class _Probe(Exception):
    """Raised by an armed site: remembers the frames it was raised in."""

    def __init__(self, *args):
        super().__init__(*args)
        self.stack = traceback.extract_stack()


# ---------------------------------------------------------------------------
# each site driven once, in either package
# ---------------------------------------------------------------------------


async def _db_write(pkg, tmp_path):
    db = pkg.mod("storage.db").Database()
    try:
        db.execute("INSERT INTO settings VALUES ('chaos', 'probe')")
    finally:
        db.close()


async def _net_dial(pkg, tmp_path):
    pool_mod = pkg.mod("network.pool")
    known = pkg.mod("storage.knownnodes")
    if pkg.name == "pybitmessage_tpu":
        ctx = pool_mod.NodeContext(inventory={},
                                   knownnodes=known.KnownNodes())
    else:
        ctx = pool_mod.NodeContext(inventory={}, pow_verifier=None)
    return await pool_mod.ConnectionPool(ctx).connect_to(
        known.Peer("127.0.0.1", 9))


async def _net_send(pkg, tmp_path):
    conn_cls = pkg.mod("network.connection").BMConnection
    await object.__new__(conn_cls).send_packet("ping")


async def _api_dispatch(pkg, tmp_path):
    server = pkg.mod("api.server").APIServer(SimpleNamespace())
    return await server._call("helloWorld", ["a", "b"])


async def _pow_readback(pkg, tmp_path):
    pipe = pkg.mod("pow.pipeline")._PipelineDriver()
    if pkg.name == "pybitmessage_tpu":
        import numpy as np
        return pipe._fetch(np.zeros(3, dtype=np.uint32))
    import torch
    return pipe._fetch(port_pipeline.HostCopy(torch.zeros(3)))


async def _slab_drain(pkg, tmp_path):
    store = pkg.mod("storage.slabstore").SlabStore(tmp_path / pkg.name)
    store.add(hashlib.sha512(b"one").digest()[:32], 2, 1, b"x" * 64,
              2_000_000_000, b"")
    store.flush()
    return store


async def _slab_seal(pkg, tmp_path):
    """A crash between a seal and its finalize (``.open`` files left,
    no sidecar), reopened: ``flush`` finalizes on this thread."""
    slab_mod = pkg.mod("storage.slabstore")
    root = tmp_path / (pkg.name + "-seal")
    store = slab_mod.SlabStore(root, slab_max_bytes=1 << 12)
    for i in range(80):
        store.add(hashlib.sha512(b"%d" % i).digest()[:32], 2, 1,
                  b"payload %d " % i * 10, 2_000_000_000, b"")
    store.flush()
    for idx in root.rglob("*.idx"):
        idx.unlink()
    for slab in root.rglob("*.slab"):
        slab.rename(slab.with_suffix(".open"))
    return slab_mod.SlabStore(root, slab_max_bytes=1 << 12)


#: site -> (the call that reaches it, the module and function where it
#: must fire)
SITES = {
    "db.write": (_db_write, "storage/db.py", "_write_retry"),
    "net.dial": (_net_dial, "network/pool.py", "connect_to"),
    "net.send": (_net_send, "network/connection.py", "send_packet"),
    "api.dispatch": (_api_dispatch, "api/server.py", "_call"),
    "pow.readback": (_pow_readback, "pow/pipeline.py", "_fetch"),
    "storage.slab_io": (_slab_drain, "storage/slabstore.py",
                        "_drain_slab"),
}


def _where(exc: _Probe, pkg) -> list:
    """(module path in the package, function) of the probe's frames in
    ``pkg``, outermost first."""
    root = pkg.name + "/"
    out = []
    for frame in exc.stack:
        path = Path(frame.filename).as_posix()
        if "/" + root in path:
            out.append((path.rsplit("/" + root, 1)[1], frame.name))
    return out


@pytest.mark.parametrize("site", sorted(SITES))
async def test_a_new_site_fires_at_the_jax_spot(tmp_path, site):
    drive, module, function = SITES[site]
    for which in ("jax", "port"):
        pkg = _pkg(which)
        pkg.chaos.CHAOS.arm(site, 1.0, count=1, exc=_Probe)
        with pytest.raises(_Probe) as err:
            await drive(pkg, tmp_path)
        frames = _where(err.value, pkg)
        assert (module, function) in frames, (which, frames)
        # the chaos registry's own frames are the innermost ones
        assert frames[-1][0] == "resilience/chaos.py"
        pkg.chaos.CHAOS.disarm()


async def test_the_slab_stores_seal_write_is_the_site_too(tmp_path):
    for which in ("jax", "port"):
        pkg = _pkg(which)
        store = await _slab_seal(pkg, tmp_path)
        assert store.recovery["replayed"] >= 2
        pkg.chaos.CHAOS.arm("storage.slab_io", 1.0, count=1, exc=_Probe)
        with pytest.raises(_Probe) as err:
            store.flush()
        assert ("storage/slabstore.py", "_finalize_seal") in \
            _where(err.value, pkg)
        assert ("storage/slabstore.py", "_drain_slab") not in \
            _where(err.value, pkg)
        pkg.chaos.CHAOS.disarm()


def _outcome(pkg, site, result, exc) -> tuple:
    """What an armed site leaves behind, in terms both packages share."""
    reg = pkg.registry
    counters = {
        "db.write": [("resilience_errors_total", {"site": "db.write"})],
        "net.dial": [("network_dial_total", {"result": "failed"}),
                     ("resilience_errors_total", {"site": "net.dial"})],
        "net.send": [],
        "api.dispatch": [("api_requests_total", {"outcome": "error"})],
        "pow.readback": [],
        "storage.slab_io": [
            ("slab_store_io_failures_total", None),
            ("resilience_errors_total", {"site": "storage.slab_io"})],
    }[site]
    return (type(exc).__name__ if exc is not None else None,
            result is None, tuple(reg.sample(n, labels) or 0
                                  for n, labels in counters))


@pytest.mark.parametrize("site", sorted(SITES))
async def test_a_new_site_ends_as_the_jax_site_ends(tmp_path, site):
    """Armed with its defaults (probability 1, three fires: every
    attempt of the database's bounded retry), each site raises the JAX
    default exception class or is absorbed where the JAX one is, and
    moves the same counters by the same amounts."""
    drive = SITES[site][0]
    outcomes = {}
    for which in ("jax", "port"):
        pkg = _pkg(which)
        before = _outcome(pkg, site, None, None)[2]
        pkg.chaos.CHAOS.arm(site, 1.0, count=3)
        result = exc = None
        try:
            result = await drive(pkg, tmp_path)
        except Exception as caught:   # noqa: BLE001 (the outcome compared)
            exc = caught
        name, none, after = _outcome(pkg, site, result, exc)
        outcomes[which] = (name, none,
                           tuple(a - b for a, b in zip(after, before)),
                           pkg.chaos.CHAOS.active()[site]["fired"])
        pkg.chaos.CHAOS.disarm()
    assert outcomes["port"] == outcomes["jax"]
    default = _jax("resilience.chaos")._DEFAULT_EXC.get(site)
    if outcomes["port"][0] is not None:
        assert outcomes["port"][0] == (default or port_chaos.ChaosError
                                       ).__name__


async def test_an_api_dispatch_fault_answers_the_jax_xml_fault():
    """A fault at ``api.dispatch`` behind XML-RPC answers the same
    Fault bytes in both packages; the JSON-RPC path raises it out of
    ``_dispatch`` in both."""
    body = xmlrpc.client.dumps(("a", "b"), "helloWorld").encode()
    out = {}
    for which in ("jax", "port"):
        pkg = _pkg(which)
        server = pkg.mod("api.server").APIServer(SimpleNamespace())
        pkg.chaos.CHAOS.arm("api.dispatch", 1.0, count=2)
        fault = await server._dispatch_xml(body)
        with pytest.raises(pkg.chaos.ChaosError):
            await server._dispatch({"method": "helloWorld",
                                    "params": ["a", "b"], "id": 1})
        ok = await server._dispatch_xml(body)
        out[which] = (fault, ok)
        pkg.chaos.CHAOS.disarm()
    assert out["port"] == out["jax"]
    assert b"ChaosError" in out["port"][0] and b"a-b" in out["port"][1]


def test_the_single_sync_readback_is_the_site():
    """The single-object path's readback (the packed kernel at pack 1)
    fires ``pow.readback`` too; disarmed, it returns the lowest nonce."""
    ih = hashlib.sha512(b"single").digest()
    port_chaos.CHAOS.arm("pow.readback", 1.0, count=1, exc=_Probe)
    with pytest.raises(_Probe) as err:
        port_pipeline._solve_single_sync(
            (ih, EASY), rows=8, chunks=1, device=port_pipeline.torch.device(
                "cpu"), should_stop=None)
    assert ("pow/pipeline.py", "_solve_single_sync") in \
        _where(err.value, _pkg("port"))
    nonce, _ = port_pipeline._solve_single_sync(
        (ih, EASY), rows=8, chunks=1,
        device=port_pipeline.torch.device("cpu"), should_stop=None)
    assert nonce == python_solve(ih, EASY)[0]


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------


def _jax_catalog() -> list:
    doc = inspect.getdoc(_jax("resilience.chaos"))
    return re.findall(r"^``([a-z_.]+)``", doc, re.M)


def test_sites_are_the_jax_catalog_less_the_crypto_rungs():
    """The port's sites are the JAX catalog whole: ``crypto.native`` and
    ``crypto.tpu`` are planted in ``crypto/batch.py``."""
    catalog = _jax_catalog()
    assert len(catalog) == 17
    assert sorted(port_chaos.SITES) == sorted(catalog)
    assert port_chaos.unplanted(",".join(catalog)) == []
    assert port_chaos.unplanted(",".join(catalog) + ",crypto.gpu") == \
        ["crypto.gpu"]


def test_a_spec_naming_every_planted_site_starts_the_daemon(tmp_path,
                                                             monkeypatch):
    """The daemon's ``run`` accepts a ``chaos`` spec naming every JAX
    site, the two crypto rungs too, and arms each (seeded, p < 1)."""
    import pybitmessage_tpu_torch.__main__ as main
    import pybitmessage_tpu_torch.core as core

    class _Stop(Exception):
        pass

    built = []

    class Recorded(core.Node):
        async def start(self):
            built.append(self)
            raise _Stop

    monkeypatch.setattr(core, "Node", Recorded)
    spec = ",".join("%s:0.01x1" % site for site in port_chaos.SITES)
    args = main.build_parser().parse_args(
        ["-d", str(tmp_path / "home"), "-t", "--no-listen", "--no-api",
         "--device", "cpu", "--set", "profiling=false",
         "--set", "chaos=" + spec, "--set", "chaosseed=7"])
    try:
        with pytest.raises(_Stop):
            asyncio.run(main.run(args))
        assert set(port_chaos.CHAOS.active()) == set(port_chaos.SITES)
    finally:
        for node in built:
            node.pow_journal.close()
            node.db.close()


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


def test_the_stall_guard_counts_as_the_jax_guard():
    out = {}
    for which, mod in (("jax", _jax("resilience.watchdog")),
                       ("port", port_watchdog)):
        release = threading.Event()
        reg = _pkg(which).registry
        before = reg.sample("pow_stall_total", {"site": "test.stall"})
        guard = mod.StallGuard(timeout=5.0, site="test.guard")
        passed = guard.run(lambda: 42)
        with pytest.raises(KeyError):
            guard.run(lambda: {}["k"])
        with pytest.raises(mod.SlabStallError):
            mod.StallGuard(timeout=0.05, site="test.stall").run(
                lambda: release.wait(5.0))
        release.set()
        inline = mod.StallGuard(timeout=0.0).run(threading.get_ident)
        out[which] = (passed, inline == threading.get_ident(),
                      reg.sample("pow_stall_total",
                                 {"site": "test.stall"}) - before)
    assert out["port"] == out["jax"] == (42, True, 1)


def test_the_pipeline_guard_counts_a_held_fetch():
    """A fetch the test holds past the stall deadline: the pipeline raises
    the watchdog's SlabStallError (one class), counts the stall at
    ``pow.slab`` and flight-records it."""
    from pybitmessage_tpu_torch.observability import FLIGHT_RECORDER
    assert port_pipeline.SlabStallError is port_watchdog.SlabStallError
    held = threading.Event()
    pipe = port_pipeline._PipelineDriver(
        fetch=lambda pending: held.wait(5.0), stall_timeout=0.05)
    launched = []

    def next_launch():
        if launched:
            return None
        launched.append(1)
        return ("tag", None)

    before = REGISTRY.sample("pow_stall_total", {"site": "pow.slab"})
    try:
        with pytest.raises(port_watchdog.SlabStallError):
            pipe.run(next_launch, lambda tag, host: None)
    finally:
        held.set()
    assert REGISTRY.sample("pow_stall_total",
                           {"site": "pow.slab"}) == before + 1
    assert any(e["kind"] == "stall" and e["site"] == "pow.slab"
               for e in FLIGHT_RECORDER.events())


def _items(n: int, tag: bytes) -> list:
    return [(hashlib.sha512(tag + b"%d" % i).digest(), EASY)
            for i in range(n)]


async def test_the_service_rides_out_a_readback_fault_and_a_stall(
        monkeypatch):
    """``PowService`` over the dispatcher on the CPU: one readback fault,
    then one stall (``pow.readback`` armed once with a delay over the
    stall deadline).  Each batch is requeued and returns the lowest
    nonce; the stall is counted once and its recovery observed once."""
    monkeypatch.setattr(port_dispatcher, "solve_batch_pipelined",
                        functools.partial(
                            port_pipeline.solve_batch_pipelined, rows=8))
    disp = PowDispatcher("cpu", stall_timeout=0.3)
    svc = PowService(disp, window=0.01)
    svc.start()
    stalls = REGISTRY.sample("pow_stall_total", {"site": "pow.slab"})
    recoveries = REGISTRY.sample("pow_stall_recovery_seconds")
    requeues = REGISTRY.sample("pow_requeue_total", {"reason": "failure"})
    try:
        for tag, arm in ((b"fault", {}), (b"stall", {"delay": 1.0})):
            port_chaos.CHAOS.arm("pow.readback", 1.0, count=1, **arm)
            items = _items(2, tag)
            got = await asyncio.wait_for(asyncio.gather(
                *(svc.solve(ih, t) for ih, t in items)), 30)
            for (ih, t), (nonce, _) in zip(items, got):
                assert nonce == python_solve(ih, t)[0]
            assert port_chaos.CHAOS.active()["pow.readback"]["fired"] == 1
            port_chaos.CHAOS.disarm()
    finally:
        await svc.stop()
    assert REGISTRY.sample("pow_stall_total",
                           {"site": "pow.slab"}) == stalls + 1
    assert REGISTRY.sample("pow_stall_recovery_seconds") == recoveries + 1
    assert REGISTRY.sample("pow_requeue_total",
                           {"reason": "failure"}) >= requeues + 2


def test_the_resilience_block_has_the_jax_keys():
    from pybitmessage_tpu_torch.api.commands import CommandHandler
    from pybitmessage_tpu_torch.resilience import CircuitBreaker
    jax = _jax("api.commands")
    _jax("resilience").CircuitBreaker("test.block", threshold=1)
    CircuitBreaker("test.block", threshold=1)
    blocks = [handler(SimpleNamespace(pow_journal=None))._resilience_stats()
              for handler in (jax.CommandHandler, CommandHandler)]
    jax_block, port_block = blocks
    assert set(port_block) == set(jax_block) == {
        "breakers", "stallEvents", "handshakeTimeouts", "powRequeues",
        "journal", "chaos"}
    assert set(port_block["journal"]) == set(jax_block["journal"])
    assert port_block["breakers"]["test.block"] == \
        jax_block["breakers"]["test.block"]
    for block in blocks:
        assert isinstance(block["stallEvents"], int)
        assert isinstance(block["handshakeTimeouts"], int)
