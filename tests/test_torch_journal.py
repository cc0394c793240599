"""The port's PoW journal, chaos registry and resumable PowService
against the JAX package's, on the CPU.

The same seeded operations go through both packages' ``PowJournal`` and
must leave the same rows (ids, hashes, targets, checkpoints, statuses,
attempts) with the same return values; the schema is the same, so a
journal file written by either package is adopted by the other, stale
rows purged at open and in-flight rows re-queued.  Two owners hammering
one job from two threads keep one row with a monotonic checkpoint.  A
seeded ``ChaosRegistry`` fires the same calls in both packages, parses
the same env spec and raises the same exception types; the port names
the sites it does not plant.  ``PowService`` with a journal: a solve
interrupted after a checkpoint ("the crash") and resubmitted after the
journal is reopened, by either package, resumes from the checkpoint and
returns the nonce of an uninterrupted solve (``python_solve``'s); a
failed solve stays journaled, a solved one leaves the journal, and
``db.write`` faults never fail a solve.  ``powmaxretries`` and
``powstalltimeout`` reach the service and the dispatcher through each
package's daemon ``run``.

Nothing of JAX is imported at module level.
"""

import asyncio
import dataclasses
import hashlib
import sqlite3
import threading

import numpy as np
import pytest

from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.pow.dispatcher import (PowDispatcher,
                                                   python_solve)
from pybitmessage_tpu_torch.pow.service import PowService
from pybitmessage_tpu_torch.resilience import (CHAOS, ChaosError,
                                               ChaosRegistry, PowJournal,
                                               RetryPolicy)
from pybitmessage_tpu_torch.resilience import chaos as port_chaos

IH = hashlib.sha512(b"resilience").digest()
#: ~4,000 expected trials: python_solve finds it in milliseconds, and the
#: port's plain torch search takes its single synchronous launch
RESUME_TARGET = (1 << 64) // 4000


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu import resilience
    from pybitmessage_tpu.pow import dispatcher, service
    return resilience, service, dispatcher


def _journal_cls(pkg: str):
    return _jax()[0].PowJournal if pkg == "jax" else PowJournal


def _rows(journal) -> list[tuple]:
    return [dataclasses.astuple(job) for job in journal.pending()]


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


def _journal_ops(journal, seed: int) -> list:
    """One seeded sequence of journal operations; every return value
    and the rows after each operation."""
    rng = np.random.default_rng(seed)
    hashes = [hashlib.sha512(b"job %d" % i).digest() for i in range(6)]
    targets = [int(t) for t in rng.integers(1, 1 << 62, size=3)]
    ids: list[int] = []
    trail = []
    for _ in range(120):
        op = int(rng.integers(6))
        if op == 0 or not ids:
            out = journal.add(hashes[int(rng.integers(6))],
                              targets[int(rng.integers(3))])
            ids.append(out[0])
        else:
            jid = ids[int(rng.integers(len(ids)))]
            if op == 1:
                out = journal.mark_inflight(jid)
            elif op == 2:
                out = journal.checkpoint(jid, int(rng.integers(1 << 40)))
            elif op == 3:
                out = journal.requeue(jid)
            elif op == 4:
                out = journal.complete(jid)
            else:
                job = journal.get(jid)
                out = None if job is None else dataclasses.astuple(job)
        trail.append((op, out, journal.pending_count(), _rows(journal)))
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_operations_leave_the_same_rows(seed):
    jax_journal = _journal_cls("jax")()
    port_journal = PowJournal()
    try:
        assert _journal_ops(port_journal, seed) == \
            _journal_ops(jax_journal, seed)
    finally:
        jax_journal.close()
        port_journal.close()


@pytest.mark.parametrize("cls", ["pow", "farm"])
def test_the_schema_is_the_jax_schema(tmp_path, cls):
    resilience = _jax()[0]
    if cls == "pow":
        ours, theirs = PowJournal, resilience.PowJournal
    else:
        from pybitmessage_tpu.powfarm import FarmJournal as theirs
        from pybitmessage_tpu_torch.powfarm import FarmJournal as ours
    sql = []
    for name, journal_cls in (("port", ours), ("jax", theirs)):
        path = tmp_path / (name + ".dat")
        journal_cls(str(path)).close()
        conn = sqlite3.connect(path)
        sql.append(conn.execute(
            "SELECT type, name, sql FROM sqlite_master ORDER BY name"
        ).fetchall())
        conn.close()
    assert sql[0] == sql[1]


def test_journal_add_checkpoint_complete_cycle():
    j = PowJournal()
    jid, start = j.add(IH, 2**40)
    assert start == 0
    j.mark_inflight(jid)
    j.checkpoint(jid, 1 << 20)
    # monotonic: a stale smaller offset never rolls back
    j.checkpoint(jid, 1 << 10)
    assert j.get(jid).start_nonce == 1 << 20
    # re-adding the same (ih, target) adopts the row + checkpoint
    resumes = REGISTRY.sample("pow_journal_resume_total")
    assert j.add(IH, 2**40) == (jid, 1 << 20)
    assert REGISTRY.sample("pow_journal_resume_total") == resumes + 1
    j.complete(jid)
    assert j.pending_count() == 0
    j.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_journal_file_survives_reopen_by_the_other_package(tmp_path,
                                                             writer):
    """Written by one package up to a crash with the job in flight, the
    file is adopted by the other: the row re-queued, its checkpoint
    handed back by ``add``."""
    reader = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "powjournal.dat")
    j = _journal_cls(writer)(path)
    jid, _ = j.add(IH, 2**42)
    j.mark_inflight(jid)
    j.checkpoint(jid, 777 * 4096)
    j.close()                    # the crash point

    recovered = REGISTRY.sample("pow_journal_recovered_total")
    j2 = _journal_cls(reader)(path)
    [job] = j2.pending()
    assert (job.job_id, job.status, job.attempts) == (jid, "queued", 1)
    assert job.initial_hash == IH and job.target == 2**42
    assert job.start_nonce == 777 * 4096
    assert j2.add(IH, 2**42) == (jid, 777 * 4096)
    if reader == "port":
        assert REGISTRY.sample("pow_journal_recovered_total") == \
            recovered + 1
    j2.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stale_rows_are_purged_at_open_and_fresh_ones_resume(tmp_path,
                                                             writer):
    reader = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "powjournal.dat")
    j = _journal_cls(writer)(path)
    stale_id, _ = j.add(hashlib.sha512(b"stale").digest(), 7)
    fresh_id, _ = j.add(IH, 2 ** 42)
    j.checkpoint(fresh_id, 123 * 4096)
    j.mark_inflight(fresh_id)
    # age only the first row past the purge horizon
    j._conn.execute("UPDATE powjobs SET enqueued_at = enqueued_at - ?"
                    " WHERE id = ?", (30 * 24 * 3600, stale_id))
    j.close()
    j2 = _journal_cls(reader)(path)
    jobs = j2.pending()
    assert [job.initial_hash for job in jobs] == [IH]
    assert jobs[0].status == "queued"
    assert j2.add(IH, 2 ** 42)[1] == 123 * 4096
    j2.close()


def test_two_owners_share_one_row_with_a_monotonic_checkpoint():
    """A farm and a fallback may hold the same journaled job at once:
    add/checkpoint/requeue from two threads keep exactly one row, the
    highest checkpoint wins, and a completion is final."""
    j = PowJournal()
    target = 2 ** 44
    barrier = threading.Barrier(2)
    errors = []

    def owner(base: int) -> None:
        try:
            barrier.wait(timeout=10)
            for i in range(200):
                jid, _ = j.add(IH, target)
                j.mark_inflight(jid)
                j.checkpoint(jid, base + i * 4096)
                j.requeue(jid)
        except Exception as exc:  # pragma: no cover - fails the test
            errors.append(exc)

    threads = [threading.Thread(target=owner, args=(b,))
               for b in (1 << 20, 1 << 21)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors
    assert j.pending_count() == 1
    jid, start = j.add(IH, target)
    assert start == (1 << 21) + 199 * 4096
    j.complete(jid)
    j.requeue(jid)
    j.checkpoint(jid, 1 << 30)
    assert j.pending_count() == 0
    jid2, start2 = j.add(IH, target)
    assert jid2 != jid and start2 == 0
    j.close()


# ---------------------------------------------------------------------------
# the chaos registry
# ---------------------------------------------------------------------------


def _fire_pattern(registry_cls, error_cls, seed: int, sites, spec=None):
    reg = registry_cls(seed=seed)
    if spec is not None:
        reg.configure(spec)
    else:
        for i, site in enumerate(sites):
            reg.arm(site, probability=0.25 + 0.2 * i,
                    count=None if i % 2 else 40)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(300):
        site = sites[int(rng.integers(len(sites)))]
        try:
            reg.inject(site)
            out.append((site, None))
        except (error_cls, OSError) as exc:
            out.append((site, type(exc).__name__))
    return out, reg.active()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_seeded_chaos_fires_the_same_calls(seed):
    resilience = _jax()[0]
    sites = ["farm.dispatch", "db.write", "pow.device_launch", "net.send"]
    ours = _fire_pattern(ChaosRegistry, ChaosError, seed, sites)
    theirs = _fire_pattern(resilience.ChaosRegistry,
                           resilience.ChaosError, seed, sites)
    assert ours == theirs
    assert any(exc for _, exc in ours[0])
    spec = "farm.accept:0.5, db.write:1x3 ,farm.result:0.3x5"
    ours = _fire_pattern(ChaosRegistry, ChaosError, seed,
                         ["farm.accept", "db.write", "farm.result"], spec)
    theirs = _fire_pattern(resilience.ChaosRegistry,
                           resilience.ChaosError, seed,
                           ["farm.accept", "db.write", "farm.result"], spec)
    assert ours == theirs


def test_chaos_count_cap_disarm_and_spec_parsing():
    reg = ChaosRegistry()
    reg.arm("db.write", probability=1.0, count=2)
    fired = 0
    for _ in range(5):
        try:
            reg.inject("db.write")
        except ChaosError:
            fired += 1
    assert fired == 2 and reg.active()["db.write"]["fired"] == 2
    reg.disarm("db.write")
    reg.inject("db.write")        # disarmed: no-op
    reg.configure("a.b:0.25, c.d:1x3 ,net.send", seed=5)
    active = reg.active()
    assert active["a.b"]["probability"] == 0.25
    assert active["c.d"] == {"probability": 1.0, "count": 3, "fired": 0,
                             "delay": 0.0}
    with pytest.raises(ConnectionError):
        reg.inject("net.send")


def test_the_port_names_the_sites_it_does_not_plant():
    assert port_chaos.unplanted(
        "pow.device_launch:0.5,db.write:1x3,farm.accept,farm.dispatch:1,"
        "farm.result:0.1x2,role.ipc:1,role.handoff,role.replica:0.5,"
        "role.client:1,sync.sketch_decode:0.5,crypto.native:0.5,"
        "crypto.tpu") == []
    # a site outside the JAX catalog: the JAX registry would arm it to
    # no effect; the port names it (its daemon refuses the spec)
    assert port_chaos.unplanted(
        "net.send:1, farm.accept:1,crypto.gpu:0.5,net.bogus") \
        == ["crypto.gpu", "net.bogus"]
    # every planted site is in the JAX catalog
    import inspect
    catalog = inspect.getdoc(_jax()[0].chaos)
    for site in port_chaos.SITES:
        assert "``%s``" % site in catalog


async def test_db_write_faults_never_fail_a_solve():
    """The journal's ``db.write`` site fires on half its writes; every
    solve still lands (the service's bounded retry, then un-journaled
    operation), in both packages."""
    resilience, service, _ = _jax()

    class InstantDispatcher:
        last_backend = "instant"

        def solve_batch(self, items, should_stop=None, start_nonces=None,
                        progress=None):
            return [(11, 1)] * len(items)

    ihs = [hashlib.sha512(b"fault %d" % i).digest() for i in range(8)]
    for registry, journal_cls, svc_cls in (
            (CHAOS, PowJournal, PowService),
            (resilience.CHAOS, resilience.PowJournal, service.PowService)):
        journal = journal_cls()
        registry.arm("db.write", probability=0.5)
        svc = svc_cls(InstantDispatcher(), window=0.01, journal=journal)
        svc.start()
        try:
            results = await asyncio.wait_for(asyncio.gather(
                *(svc.solve(ih, 2**60) for ih in ihs)), timeout=30)
            assert results == [(11, 1)] * 8
            assert registry.active()["db.write"]["fired"] > 0
        finally:
            await svc.stop()
            registry.disarm()
            journal.close()


# ---------------------------------------------------------------------------
# PowService: journaled, resumed
# ---------------------------------------------------------------------------


class _CrashAfterCheckpoint:
    """Searches nothing: reports every nonce below ``checkpoint`` as
    searched, then stops as a killed process would (``interrupted``:
    the package's own ``PowInterrupted``)."""

    last_backend = "crash"

    def __init__(self, checkpoint: int, shutdown: asyncio.Event, loop,
                 interrupted):
        self.checkpoint = checkpoint
        self.shutdown, self.loop = shutdown, loop
        self.interrupted = interrupted

    def solve_batch(self, items, should_stop=None, start_nonces=None,
                    progress=None):
        progress(0, self.checkpoint)
        self.loop.call_soon_threadsafe(self.shutdown.set)
        raise self.interrupted("killed mid-solve")


class _Spy:
    """Wraps a dispatcher and records the start offsets it was given."""

    def __init__(self, inner):
        self.inner = inner
        self.last_backend = ""
        self.starts = []

    def solve_batch(self, items, should_stop=None, start_nonces=None,
                    progress=None):
        self.starts.append(list(start_nonces))
        out = self.inner.solve_batch(items, should_stop=should_stop,
                                     start_nonces=start_nonces,
                                     progress=progress)
        self.last_backend = self.inner.last_backend
        return out


@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "jax"),
                                          ("jax", "port"), ("port", "jax")])
async def test_a_resumed_solve_returns_the_uninterrupted_nonce(
        tmp_path, first, second):
    """Process 1 journals the solve and checkpoints an offset below the
    answer, then dies; process 2 reopens the journal file and solves the
    same job through its real dispatcher (the port's plain torch search,
    the JAX package's python tier).  It starts at the checkpoint and
    returns python_solve's nonce."""
    resilience, service, dispatcher = _jax()
    ih = hashlib.sha512(b"resume %s %s" % (first.encode(),
                                           second.encode())).digest()
    nonce, _ = python_solve(ih, RESUME_TARGET)
    assert nonce > 16
    checkpoint = nonce // 2
    from pybitmessage_tpu.ops.pow_search import PowInterrupted as JaxStop
    from pybitmessage_tpu_torch.ops.pow_search import PowInterrupted
    pkgs = {
        "port": (PowJournal, PowService,
                 lambda: PowDispatcher(device="cpu"), PowInterrupted),
        "jax": (resilience.PowJournal, service.PowService,
                lambda: dispatcher.PowDispatcher(use_tpu=False,
                                                 use_native=False),
                JaxStop),
    }
    path = str(tmp_path / "powjournal.dat")

    journal_cls, svc_cls, _, stop_cls = pkgs[first]
    journal = journal_cls(path)
    shutdown = asyncio.Event()
    svc = svc_cls(_CrashAfterCheckpoint(
        checkpoint, shutdown, asyncio.get_running_loop(), stop_cls),
        window=0.0, shutdown=shutdown, journal=journal)
    svc.start()
    with pytest.raises(asyncio.CancelledError):
        await asyncio.wait_for(svc.solve(ih, RESUME_TARGET), timeout=30)
    await svc.stop()
    [job] = journal.pending()
    assert job.start_nonce == checkpoint
    journal.close()                  # the crash boundary

    journal_cls, svc_cls, make, _ = pkgs[second]
    journal = journal_cls(path)
    spy = _Spy(make())
    svc = svc_cls(spy, window=0.0, journal=journal)
    svc.start()
    try:
        got = await asyncio.wait_for(svc.solve(ih, RESUME_TARGET),
                                     timeout=60)
    finally:
        await svc.stop()
    assert spy.starts == [[checkpoint]]
    assert got[0] == nonce
    assert journal.pending_count() == 0
    journal.close()


class _Flaky:
    last_backend = "flaky"

    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.calls = 0

    def solve_batch(self, items, should_stop=None, start_nonces=None,
                    progress=None):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("transient tier failure %d" % self.calls)
        return [(7, 1)] * len(items)


@pytest.mark.parametrize("pkg", ["jax", "port"])
async def test_a_failed_solve_stays_journaled_and_a_solved_one_leaves(pkg):
    resilience, service, _ = _jax()
    journal_cls, svc_cls, retry_cls = (
        (PowJournal, PowService, RetryPolicy) if pkg == "port" else
        (resilience.PowJournal, service.PowService,
         resilience.RetryPolicy))
    journal = journal_cls()
    flaky = _Flaky(fail_times=99)
    svc = svc_cls(flaky, window=0.01, max_attempts=2, journal=journal,
                  retry=retry_cls(attempts=2, base_delay=0.01, jitter=0.0))
    svc.start()
    try:
        with pytest.raises(RuntimeError, match="transient tier failure"):
            await asyncio.wait_for(svc.solve(IH, 2**60), timeout=10)
        assert flaky.calls == 2
        assert [(j.status, j.attempts) for j in journal.pending()] == \
            [("queued", 2)]
        flaky.fail_times = 0
        other = hashlib.sha512(b"solved").digest()
        assert await asyncio.wait_for(svc.solve(other, 2**60), 10) == (7, 1)
        assert [j.initial_hash for j in journal.pending()] == [IH]
    finally:
        await svc.stop()
        journal.close()


# ---------------------------------------------------------------------------
# the daemon's settings reach the service and the dispatcher
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_powmaxretries_and_powstalltimeout_reach_service_and_dispatcher(
        tmp_path, monkeypatch, pkg):
    """Each package's daemon ``run`` builds its node from
    ``--set powmaxretries=7 --set powstalltimeout=33``: the node's
    service and dispatcher carry both before the node starts."""
    if pkg == "jax":
        _jax()
        import pybitmessage_tpu.__main__ as main
        import pybitmessage_tpu.core as core
        # no sampling profiler thread left behind in the test process
        flags = ["--no-udp", "--set", "profiling=false"]
    else:
        import pybitmessage_tpu_torch.__main__ as main
        import pybitmessage_tpu_torch.core as core
        flags = ["--device", "cpu", "--set", "cryptobatch=false"]
    built = []

    class Recorded(core.Node):
        async def start(self):
            built.append(self)
            raise _Stop

    monkeypatch.setattr(core, "Node", Recorded)
    args = main.build_parser().parse_args(
        ["-d", str(tmp_path / "home"), "-t", "--no-listen", "--no-api",
         "--set", "powmaxretries=7", "--set", "powstalltimeout=33",
         *flags])
    with pytest.raises(_Stop):
        asyncio.run(main.run(args))
    [node] = built
    try:
        assert node.pow_service.max_attempts == 7
        assert node.solver.stall_timeout == 33.0
    finally:
        node.pow_journal.close()
        node.db.close()


# ---------------------------------------------------------------------------
# a requeued request names its wire trace (ROADMAP fault 3.11)
# ---------------------------------------------------------------------------


class _RaisesOnce:
    """A dispatcher whose first ``solve_batch`` raises ``exc``; later
    calls return ``[(0, 1)]``."""

    last_backend = "stub"

    def __init__(self, exc):
        self.exc = exc

    def solve_batch(self, items, **kwargs):
        if self.exc is not None:
            exc, self.exc = self.exc, None
            raise exc
        return [(0, 1)] * len(items)


@pytest.mark.parametrize("reason", ["failure", "interrupt"])
async def test_a_requeued_request_names_its_trace_as_the_jax_service_does(
        reason):
    """One solve through each package's ``PowService``: the failure
    requeue (a dispatcher that raises once) or the interrupt requeue
    (a set shutdown) leaves a ``pow_requeue`` flight event with the
    same keys in both packages, ``traces`` holding the 8-hex prefix of
    the object's trace id."""
    from pybitmessage_tpu.observability import flightrec as jax_flightrec
    from pybitmessage_tpu_torch.observability import flightrec
    from pybitmessage_tpu_torch.ops.pow_search import PowInterrupted
    resilience, service, _ = _jax()
    from pybitmessage_tpu.ops.pow_search import \
        PowInterrupted as JaxInterrupted

    ih = hashlib.sha512(b"probe").digest()
    events = {}
    for pkg, svc_cls, retry_cls, recorder, interrupted in (
            ("jax", service.PowService, resilience.RetryPolicy,
             jax_flightrec.FLIGHT_RECORDER, JaxInterrupted),
            ("port", PowService, RetryPolicy, flightrec.FLIGHT_RECORDER,
             PowInterrupted)):
        d = _RaisesOnce(RuntimeError("first launch fails")
                        if reason == "failure" else interrupted("stop"))
        svc = svc_cls(d, window=0.0, max_attempts=3,
                      retry=retry_cls(attempts=3, base_delay=0.01))
        svc.start()
        try:
            if reason == "failure":
                assert await asyncio.wait_for(
                    svc.solve(ih, 1 << 63), 10) == (0, 1)
            else:
                with pytest.raises(asyncio.CancelledError):
                    await asyncio.wait_for(svc.solve(ih, 1 << 63), 10)
        finally:
            await svc.stop()
        events[pkg] = [e for e in recorder.events(kind="pow_requeue")
                       if e["reason"] == reason][-1]
    assert events["port"].keys() == events["jax"].keys()
    for event in events.values():
        [prefix] = event["traces"]
        assert len(prefix) == 8 and int(prefix, 16) >= 0
