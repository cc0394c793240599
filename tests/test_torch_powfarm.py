"""The port's PoW solver farm against the JAX package's, on the CPU.

Codecs: the same seeded messages encode to the same frames and MACs in
both packages, each decodes the other's, and ``parse_header`` rejects
the same garbage.  Scheduler: the same seeded register / admit / push /
take / drain sequence under one fake clock gives the same admission
verdicts, drain order and snapshot; the JAX package's fairness, lane
and admission cases hold in both.  Journals: a ``FarmJournal`` (or a
base ``PowJournal``) file written by either package is adopted by the
other with its tenant and lane.  Wire interop both ways: the port's
``FarmClient`` against the JAX ``FarmServer`` over the JAX python tier,
and the JAX ``FarmClient`` against the port's ``FarmServer`` over
``PowDispatcher(device="cpu")``, both returning ``python_solve``'s
nonces.  Failure paths: signed submissions, admission rejects with
``retry_after``, the three ``farm.*`` chaos sites, restart adoption with
dedupe, a lying farm refused by the host check; the dispatcher's farm
rung, and the card rung taking over with ``pow_fallback_total``
counted.  Wiring: a ``Node`` serving the farm and one delegating to it,
``farmStatus`` against the JAX command on the same state, and the
daemon: ``python -m pybitmessage_tpu_torch`` with ``powfarmlisten`` and
one with ``powfarmconnect`` answer ``farmStatus``; a ``chaos`` spec
naming a site the port does not plant exits 1 naming it.

Targets are easy (about four trials a job) and the scheduler's clock is
injected; nothing sleeps beyond the farm's coalescing window.  Nothing
of JAX is imported at module level.
"""

import asyncio
import contextlib
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from pybitmessage_tpu_torch import __main__ as daemon
from pybitmessage_tpu_torch.api import CommandHandler
from pybitmessage_tpu_torch.core import config as port_config
from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.pow.dispatcher import (PowDispatcher,
                                                   host_trial,
                                                   python_solve)
from pybitmessage_tpu_torch.powfarm import (FarmClient, FarmError,
                                            FarmJournal, FarmRejected,
                                            FarmScheduler, FarmServer,
                                            FarmSolverTier, TenantConfig)
from pybitmessage_tpu_torch.powfarm import protocol as port_proto
from pybitmessage_tpu_torch.powfarm.protocol import (LANE_BULK,
                                                     LANE_INTERACTIVE)
from pybitmessage_tpu_torch.resilience import CHAOS, Deadline, PowJournal

ROOT = Path(__file__).resolve().parent.parent
#: trivial difficulty: ~4 expected trials per solve
EASY_TARGET = 1 << 62
#: seconds for one blocking client call, a daemon start, a clean stop
CALL_TIMEOUT = 30.0
START_TIMEOUT = 60.0
STOP_TIMEOUT = 30.0


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import pybitmessage_tpu.powfarm as powfarm
    from pybitmessage_tpu.pow import dispatcher
    from pybitmessage_tpu.powfarm import protocol
    return powfarm, protocol, dispatcher


def _ih(i: int) -> bytes:
    return hashlib.sha512(b"farm job %d" % i).digest()


class _StubSolver:
    """python_solve per item (the JAX tests' stand-in for a ladder),
    with an optional per-batch delay to shape the farm's capacity."""

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.last_backend = "stub"
        self.calls = 0

    def solve_batch(self, items, *, should_stop=None, start_nonces=None,
                    progress=None):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        starts = list(start_nonces) if start_nonces else [0] * len(items)
        out = []
        for i, (ih, target) in enumerate(items):
            res = python_solve(ih, target, start_nonce=starts[i],
                               should_stop=should_stop)
            if progress is not None:
                progress(i, res[0] + 1)
            out.append(res)
        return out


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def _submit(proto, rng, secret_len: int):
    lane = (LANE_INTERACTIVE, LANE_BULK)[int(rng.integers(2))]
    msg = proto.SubmitMsg(
        job_ref=int(rng.integers(1 << 63)),
        tenant="tenant-%d" % rng.integers(1000), lane=lane,
        initial_hash=rng.bytes(64),
        target=int(rng.integers(1 << 63)) * 2 + 1,
        start_nonce=int(rng.integers(1 << 62)),
        deadline_ms=int(rng.integers(1 << 31)),
        trace=rng.bytes(32) if rng.integers(2) else b"")
    secret = rng.bytes(secret_len) if secret_len else None
    return msg, secret


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_submit_frames_and_macs_are_byte_identical(seed):
    _, jax_proto, _ = _jax()
    for secret_len in (0, 16, 40):
        port_msg, secret = _submit(port_proto,
                                   np.random.default_rng([seed, secret_len]),
                                   secret_len)
        jax_msg, _ = _submit(jax_proto,
                             np.random.default_rng([seed, secret_len]),
                             secret_len)
        wire = port_proto.pack_frame(port_proto.MSG_SUBMIT,
                                     port_msg.encode(secret))
        assert wire == jax_proto.pack_frame(jax_proto.MSG_SUBMIT,
                                            jax_msg.encode(secret))
        payload = wire[port_proto.HEADER_LEN:]
        ours = port_proto.SubmitMsg.decode(payload)
        theirs = jax_proto.SubmitMsg.decode(payload)
        for name in ("job_ref", "tenant", "lane", "initial_hash", "target",
                     "start_nonce", "deadline_ms", "trace", "mac"):
            assert getattr(ours, name) == getattr(theirs, name), name
        assert ours._signed == theirs._signed
        if secret:
            assert port_proto.compute_mac(secret, ours._signed) == \
                jax_proto.compute_mac(secret, ours._signed) == ours.mac
            assert port_proto.mac_ok(secret, ours._signed, ours.mac)
            assert not port_proto.mac_ok(b"wrong", ours._signed, ours.mac)
            # flipping any signed byte breaks the mac in both
            flip = int(np.random.default_rng(seed).integers(
                len(ours._signed)))
            bad = bytearray(payload)
            bad[flip] ^= 1
            for proto in (port_proto, jax_proto):
                try:
                    tampered = proto.SubmitMsg.decode(bytes(bad))
                except proto.ProtocolError:
                    continue
                assert not proto.mac_ok(secret, tampered._signed,
                                        tampered.mac)


def test_other_codecs_are_byte_identical():
    _, jax_proto, _ = _jax()
    rng = np.random.default_rng(5)
    for _ in range(20):
        a = [int(rng.integers(1 << 63)), int(rng.integers(1 << 63)),
             int(rng.integers(1 << 32)), int(rng.integers(1 << 32))]
        r = [int(rng.integers(1 << 63)), "backlog"[:int(rng.integers(8))],
             int(rng.integers(1 << 32))]
        res = [int(rng.integers(1 << 63)), int(rng.integers(3)),
               int(rng.integers(1 << 63)), int(rng.integers(1 << 63)),
               int(rng.integers(1 << 32)), int(rng.integers(1 << 32)),
               "detail %d" % rng.integers(100)]
        for cls in ("AcceptMsg", "RejectMsg", "ResultMsg"):
            args = {"AcceptMsg": a, "RejectMsg": r, "ResultMsg": res}[cls]
            wire = getattr(port_proto, cls)(*args).encode()
            assert wire == getattr(jax_proto, cls)(*args).encode()
            assert getattr(port_proto, cls).decode(wire).__dict__ == \
                getattr(jax_proto, cls).decode(wire).__dict__
    for msg_type in (port_proto.MSG_PING, port_proto.MSG_PONG):
        assert port_proto.pack_frame(msg_type, b"") == \
            jax_proto.pack_frame(msg_type, b"")


def _verdict(proto, call):
    try:
        return ("ok", call(proto))
    except proto.ProtocolError:
        return ("error",)


def test_parse_header_and_decoders_reject_the_same_garbage():
    _, jax_proto, _ = _jax()
    rng = np.random.default_rng(11)
    headers = [b"XX\x01\x01\x00\x00\x00\x00",
               b"\xfa\x12\x63\x01\x00\x00\x00\x00",     # bad version
               b"\xfa\x12\x01\x01\x00\x01\x00\x01",     # over MAX_FRAME
               b"\xfa\x12\x01\x04\x00\x01\x00\x00",     # exactly MAX_FRAME
               port_proto.pack_frame(1, b"abc")[:8]]
    headers += [b"\xfa\x12" + rng.bytes(6) for _ in range(40)]
    headers += [rng.bytes(8) for _ in range(20)]
    for header in headers:
        assert _verdict(port_proto, lambda p: p.parse_header(header)) == \
            _verdict(jax_proto, lambda p: p.parse_header(header))
    msg, secret = _submit(port_proto, rng, 16)
    good = msg.encode(secret)
    payloads = [good[:n] for n in range(0, len(good), 7)]
    payloads += [bytes([b]) * 10 for b in (0, 1, 2, 255)]
    for payload in payloads:
        for cls in ("SubmitMsg", "AcceptMsg", "RejectMsg", "ResultMsg"):
            def decode(p, _cls=cls, _payload=payload):
                return getattr(p, _cls).decode(_payload).__dict__
            assert _verdict(port_proto, decode)[0] == \
                _verdict(jax_proto, decode)[0], (cls, payload)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _scheduler_run(farm, seed: int) -> list:
    """One seeded sequence of scheduler calls under a fake clock; every
    verdict, every drained job and the final snapshot."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    s = farm.FarmScheduler(capacity_hint=40.0, max_wait=2.0, max_tenants=5,
                           clock=lambda: now[0])
    s.register("heavy", farm.TenantConfig(weight=3.0, quota=30))
    s.register("rated", farm.TenantConfig(rate=20.0, burst=4.0))
    s.register("frac", farm.TenantConfig(weight=0.5, quota=12))
    names = ["heavy", "rated", "frac", "open-a", "open-b", "open-c",
             "open-d"]
    trail = []
    serial = 0
    for _ in range(400):
        op = int(rng.integers(10))
        if op < 6:
            tenant = names[int(rng.integers(len(names)))]
            lane = (LANE_INTERACTIVE, LANE_BULK)[int(rng.integers(2))]
            deadline = float(rng.uniform(0.01, 3.0)) \
                if rng.integers(4) == 0 else None
            v = s.admit(tenant, lane, deadline)
            trail.append(("admit", v.ok, v.reason, v.retry_after,
                          v.est_wait, v.depth))
            if v.ok:
                serial += 1
                s.push(farm.FarmJob(tenant=tenant, lane=lane,
                                    initial_hash=_ih(serial),
                                    target=EASY_TARGET),
                       front=bool(rng.integers(8) == 0))
        elif op < 8:
            jobs = s.take(int(rng.integers(1, 12)))
            trail.append(("take", [(j.tenant, j.lane, j.initial_hash,
                                    j.enqueued) for j in jobs]))
            for j in jobs:
                s.note_solved(j)
            s.note_drained(len(jobs), float(rng.uniform(0.01, 0.5)))
        elif op == 8:
            s.inflight = int(rng.integers(0, 20))
        now[0] += float(rng.exponential(0.05))
    trail.append(("snapshot", s.snapshot()))
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_gives_the_same_decisions(seed):
    import pybitmessage_tpu_torch.powfarm as port_farm
    jax_farm = _jax()[0]
    ours, theirs = _scheduler_run(port_farm, seed), \
        _scheduler_run(jax_farm, seed)
    assert ours == theirs
    assert any(t[0] == "admit" and not t[1] for t in ours)
    assert any(t[0] == "take" and t[1] for t in ours)


def _pkg(name: str):
    if name == "port":
        import pybitmessage_tpu_torch.powfarm as farm
        return farm
    return _jax()[0]


def _job(farm, tenant, lane=LANE_BULK, i=0):
    return farm.FarmJob(tenant=tenant, lane=lane, initial_hash=_ih(i),
                        target=EASY_TARGET)


PKGS = ["jax", "port"]


@pytest.mark.parametrize("pkg", PKGS)
def test_drr_equal_weights_fair(pkg):
    farm = _pkg(pkg)
    s = farm.FarmScheduler(capacity_hint=1000.0)
    for t in range(4):
        for i in range(50):
            s.push(_job(farm, "t%d" % t, i=t * 100 + i))
    drained = {"t%d" % t: 0 for t in range(4)}
    for _ in range(10):
        for job in s.take(10):
            drained[job.tenant] += 1
    counts = sorted(drained.values())
    assert sum(counts) == 100
    assert counts[-1] - counts[0] <= 1


@pytest.mark.parametrize("pkg", PKGS)
def test_drr_weighted_shares_and_fractional_weights(pkg):
    farm = _pkg(pkg)
    s = farm.FarmScheduler(capacity_hint=1000.0)
    s.register("heavy", farm.TenantConfig(weight=3.0))
    s.register("light", farm.TenantConfig(weight=1.0))
    for i in range(120):
        s.push(_job(farm, "heavy", i=i))
        s.push(_job(farm, "light", i=1000 + i))
    got = {"heavy": 0, "light": 0}
    for job in s.take(80):
        got[job.tenant] += 1
    assert got["heavy"] + got["light"] == 80
    assert 2.0 <= got["heavy"] / max(got["light"], 1) <= 4.0
    s = farm.FarmScheduler(capacity_hint=1000.0)
    s.register("a", farm.TenantConfig(weight=0.25))
    s.register("b", farm.TenantConfig(weight=0.25))
    for i in range(10):
        s.push(_job(farm, "a", i=i))
        s.push(_job(farm, "b", i=100 + i))
    assert len(s.take(20)) == 20


@pytest.mark.parametrize("pkg", PKGS)
def test_interactive_lane_drains_first(pkg):
    farm = _pkg(pkg)
    s = farm.FarmScheduler(capacity_hint=1000.0)
    for i in range(10):
        s.push(_job(farm, "t", LANE_BULK, i=i))
    for i in range(3):
        s.push(_job(farm, "t", LANE_INTERACTIVE, i=100 + i))
    batch = s.take(5)
    assert [j.lane for j in batch[:3]] == [LANE_INTERACTIVE] * 3
    assert all(j.lane == LANE_BULK for j in batch[3:])


@pytest.mark.parametrize("pkg", PKGS)
def test_admission_quota_backlog_deadline_rate_and_cap(pkg):
    farm = _pkg(pkg)
    s = farm.FarmScheduler(capacity_hint=10.0, max_wait=1.0)
    s.register("t", farm.TenantConfig(quota=5))
    for i in range(5):
        assert s.admit("t", LANE_BULK).ok
        s.push(_job(farm, "t", i=i))
    verdict = s.admit("t", LANE_BULK)
    assert not verdict.ok and verdict.reason == "quota"
    assert verdict.retry_after > 0
    s.register("u", farm.TenantConfig(quota=1000))
    for i in range(50):
        s.push(_job(farm, "u", i=100 + i))
    verdict = s.admit("u", LANE_BULK)
    assert not verdict.ok and verdict.reason == "backlog"
    assert not s.admit("u", LANE_BULK, deadline_s=0.01).ok
    assert s.admit("u", LANE_INTERACTIVE).ok
    now = [0.0]
    s = farm.FarmScheduler(capacity_hint=1e6, clock=lambda: now[0],
                           max_tenants=2)
    s.register("r", farm.TenantConfig(rate=10.0, burst=2.0))
    assert s.admit("r", LANE_BULK).ok and s.admit("r", LANE_BULK).ok
    verdict = s.admit("r", LANE_BULK)
    assert not verdict.ok and verdict.reason == "rate"
    assert verdict.retry_after == pytest.approx(0.1, abs=0.05)
    now[0] += 0.2
    assert s.admit("r", LANE_BULK).ok
    assert s.admit("a", LANE_BULK).ok
    verdict = s.admit("b", LANE_BULK)
    assert not verdict.ok and verdict.reason == "tenant_limit"


# ---------------------------------------------------------------------------
# the farm journal
# ---------------------------------------------------------------------------


def _farm_journal(pkg):
    return _pkg(pkg).FarmJournal


@pytest.mark.parametrize("writer", PKGS)
def test_farm_journal_meta_and_dedupe_across_packages(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "farmjournal.dat")
    j = _farm_journal(writer)(path)
    job_id, start = j.add(_ih(1), EASY_TARGET,
                          meta={"tenant": "edge", "lane": "bulk"})
    assert start == 0
    again, _ = j.add(_ih(1), EASY_TARGET, meta={"tenant": "other"})
    assert again == job_id and j.pending_count() == 1
    j.checkpoint(job_id, 5000)
    j.mark_inflight(job_id)
    j.close()
    j2 = _farm_journal(reader)(path)
    [(pj, meta)] = j2.pending_meta()
    assert (pj.job_id, pj.status, pj.start_nonce) == (job_id, "queued",
                                                      5000)
    assert meta == {"tenant": "edge", "lane": "bulk"}
    j2.close()


@pytest.mark.parametrize("writer", PKGS)
def test_a_base_journal_is_adopted_by_the_other_farm_journal(tmp_path,
                                                             writer):
    """A journal of the base class (no meta column) of either package is
    opened by the other package's FarmJournal: meta degrades to {}."""
    reader = "port" if writer == "jax" else "jax"
    base = (_jax()[0].FarmJournal.__mro__[1] if writer == "jax"
            else PowJournal)
    path = str(tmp_path / "mixed.dat")
    b = base(path)
    b.add(_ih(2), EASY_TARGET)
    b.close()
    j = _farm_journal(reader)(path)
    [(pj, meta)] = j.pending_meta()
    assert pj.initial_hash == _ih(2) and meta == {}
    j.close()


# ---------------------------------------------------------------------------
# server and client over loopback
# ---------------------------------------------------------------------------


@contextlib.asynccontextmanager
async def _farm(solver=None, server_cls=FarmServer, **kw):
    server = server_cls(solver or _StubSolver(), window=0.0, **kw)
    await server.start()
    try:
        yield server
    finally:
        await asyncio.wait_for(server.stop(), CALL_TIMEOUT)


def _off_loop(fn, *args, **kw):
    """Run a blocking client call in a thread, under the call timeout."""
    loop = asyncio.get_running_loop()
    return asyncio.wait_for(
        loop.run_in_executor(None, lambda: fn(*args, **kw)), CALL_TIMEOUT)


async def test_port_farm_solves_with_python_solves_nonces():
    async with _farm(PowDispatcher(device="cpu")) as server:
        client = FarmClient("127.0.0.1", server.listen_port, tenant="e1")
        try:
            assert await _off_loop(client.ping)
            items = [(_ih(i), EASY_TARGET) for i in range(4)]
            results = await _off_loop(client.solve_batch, items)
            assert [n for n, _ in results] == \
                [python_solve(ih, t)[0] for ih, t in items]
            assert server.status()["scheduler"]["tenants"]["e1"][
                "solved"] == 4
        finally:
            client.close()


async def test_stop_returns_with_a_client_connected():
    """A client still connected when the farm stops: its connection is
    closed and ``stop`` returns (since Python 3.12 the listener's
    ``wait_closed`` waits for every connection)."""
    async with _farm() as server:
        client = FarmClient("127.0.0.1", server.listen_port)
        assert await _off_loop(client.ping)
    try:
        assert server.status()["connections"] == 0
        with pytest.raises(FarmError):
            await _off_loop(client.solve_batch, [(_ih(1), EASY_TARGET)])
    finally:
        client.close()


async def test_the_port_client_against_the_jax_farm():
    jax_farm, _, jax_dispatcher = _jax()
    solver = jax_dispatcher.PowDispatcher(use_tpu=False, use_native=False)
    async with _farm(solver, server_cls=jax_farm.FarmServer) as server:
        client = FarmClient("127.0.0.1", server.listen_port, tenant="p",
                            secret=b"k")
        try:
            assert await _off_loop(client.ping)
            items = [(_ih(10 + i), EASY_TARGET >> 4) for i in range(5)]
            results = await _off_loop(client.solve_batch, items,
                                      lane=LANE_BULK)
            assert [n for n, _ in results] == \
                [python_solve(ih, t)[0] for ih, t in items]
        finally:
            client.close()


async def test_the_jax_client_against_the_port_farm():
    jax_farm, _, _ = _jax()
    async with _farm(PowDispatcher(device="cpu"),
                     auth_required=True) as server:
        server.register_tenant("jax-edge", TenantConfig(secret=b"s3cret"))
        client = jax_farm.FarmClient("127.0.0.1", server.listen_port,
                                     tenant="jax-edge", secret=b"s3cret")
        tier = jax_farm.FarmSolverTier("127.0.0.1", server.listen_port,
                                       tenant="jax-edge", secret=b"s3cret")
        tier.breaker.reset()
        try:
            assert await _off_loop(client.ping)
            items = [(_ih(20 + i), EASY_TARGET >> 4) for i in range(5)]
            results = await _off_loop(client.solve_batch, items)
            assert [n for n, _ in results] == \
                [python_solve(ih, t)[0] for ih, t in items]
            (nonce, _), = await _off_loop(tier.solve_batch,
                                          [(_ih(30), EASY_TARGET)])
            assert nonce == python_solve(_ih(30), EASY_TARGET)[0]
            assert server.status()["scheduler"]["tenants"]["jax-edge"][
                "solved"] == 6
        finally:
            client.close()
            tier.close()


@pytest.mark.parametrize("route", ["port-port", "jax-port", "port-jax"])
async def test_a_delegated_job_joins_the_submitting_nodes_trace(route):
    """A ``FarmSolverTier`` fills each submission's trace field from its
    package's ``LIFECYCLE.trace_ctx_for``; the farm decodes it, so the
    job carries the submitting node's trace id and the farm's lifecycle
    adopts it, in either package (client-server)."""
    from pybitmessage_tpu_torch.observability import LIFECYCLE
    jax_farm, _, jax_dispatcher = _jax()
    from pybitmessage_tpu.observability import LIFECYCLE as JAX_LC
    client_pkg, server_pkg = route.split("-")
    if server_pkg == "port":
        solver, server_cls, server_lc = PowDispatcher(device="cpu"), \
            FarmServer, LIFECYCLE
    else:
        solver = jax_dispatcher.PowDispatcher(use_tpu=False,
                                              use_native=False)
        server_cls, server_lc = jax_farm.FarmServer, JAX_LC
    tier_cls, client_lc = (FarmSolverTier, LIFECYCLE) \
        if client_pkg == "port" else (jax_farm.FarmSolverTier, JAX_LC)
    ih = hashlib.sha512(b"traced job " + route.encode()).digest()
    async with _farm(solver, server_cls=server_cls) as server:
        jobs = []
        push = server.scheduler.push

        def spy(job):
            jobs.append(job)
            return push(job)
        server.scheduler.push = spy
        tier = tier_cls("127.0.0.1", server.listen_port, tenant="edge")
        tier.breaker.reset()
        try:
            (nonce, _), = await _off_loop(tier.solve_batch,
                                          [(ih, EASY_TARGET)])
        finally:
            tier.close()
    assert nonce == python_solve(ih, EASY_TARGET)[0]
    mine = client_lc.trace_meta(ih)
    assert mine is not None
    job, = jobs
    assert job.trace_id == mine["trace_id"]
    theirs = server_lc.trace_meta(ih)
    assert theirs["trace_id"] == mine["trace_id"]
    if server_lc is not client_lc:
        assert theirs["parent_span"] == mine["span"]
    for lc in (LIFECYCLE, JAX_LC):
        lc.discard(ih)


async def test_signed_submissions_auth():
    async with _farm(auth_required=True) as server:
        server.register_tenant("paid", TenantConfig(secret=b"s3cret"))
        clients = [FarmClient("127.0.0.1", server.listen_port,
                              tenant=tenant, secret=secret)
                   for tenant, secret in (("paid", b"s3cret"),
                                          ("paid", b"wrong"),
                                          ("stranger", b""))]
        try:
            (nonce, _), = await _off_loop(clients[0].solve_batch,
                                          [(_ih(1), EASY_TARGET)])
            assert host_trial(nonce, _ih(1)) <= EASY_TARGET
            for client, i in ((clients[1], 2), (clients[2], 3)):
                with pytest.raises(FarmRejected) as exc_info:
                    await _off_loop(client.solve_batch,
                                    [(_ih(i), EASY_TARGET)])
                assert exc_info.value.reason == "auth"
        finally:
            for client in clients:
                client.close()


async def test_admission_reject_carries_retry_after():
    scheduler = FarmScheduler(capacity_hint=0.5, max_wait=0.2)
    async with _farm(_StubSolver(delay=0.2),
                     scheduler=scheduler) as server:
        client = FarmClient("127.0.0.1", server.listen_port, tenant="t")
        try:
            with pytest.raises(FarmRejected) as exc_info:
                await _off_loop(
                    client.solve_batch,
                    [(_ih(i), EASY_TARGET) for i in range(16)],
                    lane=LANE_BULK)
            assert exc_info.value.reason == "backlog"
            assert exc_info.value.retry_after > 0
        finally:
            client.close()


async def test_farm_accept_chaos_is_a_retryable_reject():
    CHAOS.arm("farm.accept", probability=1.0, count=1)
    try:
        async with _farm() as server:
            client = FarmClient("127.0.0.1", server.listen_port)
            try:
                with pytest.raises(FarmRejected) as exc_info:
                    await _off_loop(client.solve_batch,
                                    [(_ih(1), EASY_TARGET)])
                assert exc_info.value.reason == "unavailable"
                (nonce, _), = await _off_loop(client.solve_batch,
                                              [(_ih(1), EASY_TARGET)])
                assert host_trial(nonce, _ih(1)) <= EASY_TARGET
            finally:
                client.close()
    finally:
        CHAOS.disarm()


async def test_farm_dispatch_chaos_requeues_without_loss():
    CHAOS.arm("farm.dispatch", probability=1.0, count=2)
    try:
        async with _farm(max_attempts=5) as server:
            server.retry.base_delay = 0.01
            client = FarmClient("127.0.0.1", server.listen_port)
            before = REGISTRY.sample("farm_requeue_total",
                                     {"reason": "failure"})
            try:
                items = [(_ih(i), EASY_TARGET) for i in range(3)]
                results = await _off_loop(client.solve_batch, items)
                assert [n for n, _ in results] == \
                    [python_solve(ih, t)[0] for ih, t in items]
                assert REGISTRY.sample("farm_requeue_total",
                                       {"reason": "failure"}) >= before + 1
            finally:
                client.close()
    finally:
        CHAOS.disarm()


async def test_farm_result_chaos_recovers_from_the_recent_cache():
    async with _farm() as server:
        client = FarmClient("127.0.0.1", server.listen_port)
        CHAOS.arm("farm.result", probability=1.0, count=1)
        try:
            with pytest.raises(FarmError):
                await _off_loop(client.solve_batch,
                                [(_ih(9), EASY_TARGET)], deadline_s=0.6)
            calls = server.solver.calls
            (nonce, _), = await _off_loop(client.solve_batch,
                                          [(_ih(9), EASY_TARGET)])
            assert nonce == python_solve(_ih(9), EASY_TARGET)[0]
            assert server.solver.calls == calls
        finally:
            CHAOS.disarm()
            client.close()


async def test_restart_adopts_a_jax_journal_and_dedupes_resubmission(
        tmp_path):
    """A job journaled by a JAX farm killed mid-flight is adopted by the
    port's farm at start with its tenant, lane and checkpoint; the
    client's resubmission attaches to it (one solve, one collision)."""
    jax_farm = _jax()[0]
    path = str(tmp_path / "farm.dat")
    journal = jax_farm.FarmJournal(path)
    ih = _ih(5)
    nonce = python_solve(ih, EASY_TARGET >> 8)[0]
    jid, _ = journal.add(ih, EASY_TARGET >> 8,
                         meta={"tenant": "edge", "lane": "interactive"})
    journal.checkpoint(jid, nonce)
    journal.mark_inflight(jid)
    journal.close()

    collisions = REGISTRY.sample("farm_adopt_collisions_total")
    journal2 = FarmJournal(path)
    slow = _StubSolver(delay=0.5)
    try:
        async with _farm(slow, journal=journal2) as server:
            assert server.status()["pendingJobs"] == 1
            [job] = server._by_key.values()
            assert (job.tenant, job.lane, job.start_nonce) == \
                ("edge", LANE_INTERACTIVE, nonce)
            client = FarmClient("127.0.0.1", server.listen_port,
                                tenant="edge")
            try:
                (got, trials), = await _off_loop(
                    client.solve_batch, [(ih, EASY_TARGET >> 8)])
            finally:
                client.close()
            assert (got, trials) == (nonce, 1)
            assert REGISTRY.sample("farm_adopt_collisions_total") == \
                collisions + 1
            assert slow.calls == 1 and journal2.pending_count() == 0
    finally:
        journal2.close()


async def test_a_lying_farm_is_refused_by_the_host_check():
    class Liar:
        last_backend = "liar"

        def solve_batch(self, items, **kw):
            return [(0, 1) for _ in items]

    async with _farm(Liar()) as server:
        tier = FarmSolverTier("127.0.0.1", server.listen_port)
        tier.breaker.reset()
        try:
            with pytest.raises(FarmError, match="host verification"):
                await _off_loop(tier.solve_batch, [(_ih(1), 1)])
        finally:
            tier.close()


async def test_dispatcher_farm_rung_then_the_card_rung_takes_over():
    """The dispatcher delegates to the farm while it is up; a dead farm
    opens the breaker (threshold 2), counts pow_fallback_total{from=
    "farm", to="torch"} and the batch is solved by the plain torch
    search (the card's rung on the CPU)."""
    async with _farm() as server:
        tier = FarmSolverTier("127.0.0.1", server.listen_port,
                              tenant="edge", deadline=10.0)
        tier.breaker.reset()
        dispatcher = PowDispatcher(device="cpu", farm=tier)
        assert dispatcher.backends() == ["farm", "torch"]
        nonce, _ = await _off_loop(dispatcher.solve, _ih(1), EASY_TARGET)
        assert dispatcher.last_backend == "farm"
        assert nonce == python_solve(_ih(1), EASY_TARGET)[0]
        results = await _off_loop(
            dispatcher.solve_batch,
            [(_ih(2), EASY_TARGET), (_ih(3), EASY_TARGET)])
        assert dispatcher.last_backend == "farm" and len(results) == 2
    before = REGISTRY.sample("pow_fallback_total",
                             {"from": "farm", "to": "torch"})
    nonce, _ = await _off_loop(dispatcher.solve, _ih(4), EASY_TARGET)
    assert nonce == python_solve(_ih(4), EASY_TARGET)[0]
    assert dispatcher.last_backend == "torch"
    assert REGISTRY.sample("pow_fallback_total",
                           {"from": "farm", "to": "torch"}) == before + 1
    results = await _off_loop(dispatcher.solve_batch,
                              [(_ih(5), EASY_TARGET), (_ih(6), EASY_TARGET)])
    assert dispatcher.last_backend == "torch-batch"
    assert [n for n, _ in results] == \
        [python_solve(_ih(i), EASY_TARGET)[0] for i in (5, 6)]
    assert dispatcher.backends() == ["torch"]
    tier.close()


async def test_lane_heuristic_and_deadline_propagation():
    async with _farm() as server:
        tier = FarmSolverTier("127.0.0.1", server.listen_port,
                              bulk_threshold=2, deadline=30.0)
        tier.breaker.reset()
        try:
            assert [tier.lane_for(n) for n in (1, 2, 3)] == \
                [LANE_INTERACTIVE, LANE_INTERACTIVE, LANE_BULK]
            with Deadline(5.0):
                assert tier._budget() <= 5.0
            assert tier._budget() == 30.0
            (nonce, _), = await _off_loop(tier.solve_batch,
                                          [(_ih(1), EASY_TARGET)])
            assert host_trial(nonce, _ih(1)) <= EASY_TARGET
            assert tier.snapshot()["breaker"]["state"] == "closed"
        finally:
            tier.close()


# ---------------------------------------------------------------------------
# wiring: the node, farmStatus, the daemon
# ---------------------------------------------------------------------------


async def test_node_farm_wiring():
    """One node serves the farm, another delegates its PoW to it through
    the dispatcher's farm rung."""
    from pybitmessage_tpu_torch.core import Node
    farm_node = Node(listen=False, device="cpu", crypto_batch=False,
                     farm_listen="127.0.0.1:0")
    await asyncio.wait_for(farm_node.start(), CALL_TIMEOUT)
    try:
        port = farm_node.farm_server.listen_port
        edge = Node(listen=False, device="cpu", crypto_batch=False,
                    farm_connect="127.0.0.1:%d" % port, farm_tenant="edge")
        assert edge.solver.backends() == ["farm", "torch"]
        edge.farm_client.breaker.reset()
        nonce, _ = await _off_loop(edge.solver.solve, _ih(1), EASY_TARGET)
        assert edge.solver.last_backend == "farm"
        assert nonce == python_solve(_ih(1), EASY_TARGET)[0]
        assert "edge" in farm_node.farm_server.status()["scheduler"][
            "tenants"]
        await asyncio.wait_for(edge.stop(), CALL_TIMEOUT)
    finally:
        await asyncio.wait_for(farm_node.stop(), CALL_TIMEOUT)


def _masked_farm_status(text: str) -> dict:
    """farmStatus with what is process-wide (the registry's counters)
    or a socket's port masked."""
    out = json.loads(text)
    if "server" in out:
        out["server"]["listen"] = "<masked>"
        out["server"]["jobs"] = "<masked>"
        out["server"]["adoptCollisions"] = "<masked>"
    if "client" in out:
        out["client"]["endpoint"] = "<masked>"
    return out


async def test_farm_status_answers_as_the_jax_command():
    """The same farm state (tenants, queued jobs, a drained batch, a
    client tier) behind each package's command handler: equal text."""
    jax_farm = _jax()[0]
    from pybitmessage_tpu.api import CommandHandler as JaxHandler
    answers = []
    for farm, handler_cls in ((jax_farm, JaxHandler),
                              (_pkg("port"), CommandHandler)):
        now = [100.0]
        scheduler = farm.FarmScheduler(clock=lambda: now[0])
        server = farm.FarmServer(_StubSolver(), scheduler=scheduler,
                                 auth_required=True, port=0)
        server.register_tenant("a", farm.TenantConfig(weight=2.0,
                                                      secret=b"x"))
        server.register_tenant("b", farm.TenantConfig(quota=9))
        for i in range(5):
            scheduler.push(_job(farm, "a", LANE_BULK, i))
        scheduler.push(_job(farm, "b", LANE_INTERACTIVE, 9))
        for job in scheduler.take(3):
            scheduler.note_solved(job)
        scheduler.note_drained(3, 0.5)
        tier = farm.FarmSolverTier("127.0.0.1", 1, tenant="edge",
                                   deadline=12.0, bulk_threshold=3)
        node = SimpleNamespace(farm_server=server, farm_client=tier)
        answers.append(_masked_farm_status(
            handler_cls(node).cmd_farmStatus()))
        node = SimpleNamespace(farm_server=None, farm_client=None)
        answers.append(json.loads(handler_cls(node).cmd_farmStatus()))
    assert answers[2] == answers[0]
    assert answers[3] == answers[1] == {"serving": False,
                                        "delegating": False}


@pytest.mark.parametrize("key", ["chaos", "powfarmconnect",
                                 "powfarmlisten"])
def test_farm_and_chaos_settings_are_applied_not_refused(key):
    """The settings that left ``REFUSED``: set, they no longer refuse
    the start; their defaults and validators are the JAX ones."""
    import pybitmessage_tpu.core.config as jax_config
    _jax()
    assert key not in daemon.REFUSED
    assert port_config.DEFAULTS[key] == jax_config.DEFAULTS[key]
    settings = port_config.Settings()
    settings.set(key, {"chaos": "farm.dispatch:0.5x2"}.get(
        key, "127.0.0.1:9"))
    assert daemon.refused_options(settings) == []
    for value in ("", "1", "127.0.0.1:0", "host:65536", "x:y", "a:b:3"):
        check = port_config.VALIDATORS.get(key)
        if check is not None:
            assert check(value) == jax_config.VALIDATORS[key](value)
    assert port_config.parse_tenant_table("a:s, b:t:2.5") == \
        jax_config.parse_tenant_table("a:s, b:t:2.5")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


def _rpc(port: int, method: str, *params):
    import http.client
    import base64
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=CALL_TIMEOUT)
    auth = base64.b64encode(b"u:p").decode()
    try:
        conn.request("POST", "/", json.dumps(
            {"method": method, "params": list(params), "id": 1}).encode(),
            {"Content-Type": "application/json",
             "Authorization": "Basic " + auth})
        resp = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    assert not resp.get("error"), resp
    return resp["result"]


def _start_daemon(home, *settings):
    api_port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pybitmessage_tpu_torch", "-d", str(home),
         "--device", "cpu", "-t", "--no-listen", "--api-port",
         str(api_port), "--api-user", "u", "--api-password", "p",
         "--set", "cryptobatch=false",
         *[arg for kv in settings for arg in ("--set", kv)]],
        env=_env(), cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + START_TIMEOUT
    while True:
        assert proc.poll() is None, "daemon exited %s" % proc.returncode
        assert time.monotonic() < deadline, "daemon never answered"
        try:
            json.loads(_rpc(api_port, "farmStatus"))
            return proc, api_port
        except OSError:
            time.sleep(0.2)


def _stop_daemon(proc) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=STOP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=STOP_TIMEOUT)
    return proc.returncode


def test_a_farm_daemon_and_a_delegating_daemon_answer_farm_status(
        tmp_path):
    farm_proc, farm_api = _start_daemon(
        tmp_path / "F", "powfarmlisten=127.0.0.1:0", "powfarmauth=true",
        "powfarmtenants=edge:sec:2,other:x", "powmaxretries=4")
    edge_proc = None
    try:
        status = json.loads(_rpc(farm_api, "farmStatus"))
        assert status["serving"] and not status["delegating"]
        server = status["server"]
        assert server["authRequired"]
        assert set(server["scheduler"]["tenants"]) == {"edge", "other"}
        assert server["scheduler"]["tenants"]["edge"]["weight"] == 2.0
        farm_port = int(server["listen"].rpartition(":")[2])
        assert farm_port > 0
        edge_proc, edge_api = _start_daemon(
            tmp_path / "E", "powfarmconnect=127.0.0.1:%d" % farm_port,
            "powfarmtenant=edge", "powfarmsecret=sec",
            "powfarmdeadline=12")
        status = json.loads(_rpc(edge_api, "farmStatus"))
        assert status["delegating"] and not status["serving"]
        assert status["client"]["endpoint"] == "127.0.0.1:%d" % farm_port
        assert status["client"]["tenant"] == "edge"
        assert status["client"]["deadline"] == 12.0
        assert status["client"]["breaker"]["state"] == "closed"
        client = json.loads(_rpc(edge_api, "clientStatus"))
        assert client["powBackends"] == ["farm", "torch"]
        assert client["farm"] == status
        assert client["resilience"]["journal"]["pending"] == 0
        assert (tmp_path / "F" / "farmjournal.dat").exists()
        assert (tmp_path / "E" / "powjournal.dat").exists()
    finally:
        codes = [_stop_daemon(p) for p in (edge_proc, farm_proc) if p]
    assert codes == [0] * len(codes)


def test_a_chaos_spec_naming_an_unplanted_site_exits_1(tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "pybitmessage_tpu_torch", "-d",
         str(tmp_path / "home"), "--device", "cpu", "-t", "--no-api",
         "--no-listen", "--set",
         "chaos=farm.dispatch:0.5,crypto.gpu:1x2,net.bogus"],
        env=_env(), cwd=ROOT, capture_output=True, timeout=START_TIMEOUT)
    assert run.returncode == 1
    assert b"chaos names crypto.gpu, net.bogus" in run.stderr
    assert b"node started" not in run.stderr
