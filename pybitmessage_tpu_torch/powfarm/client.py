"""Edge-side farm delegation: blocking client + the dispatcher's top
rung (copy of ``pybitmessage_tpu.powfarm.client``).

:class:`FarmClient` speaks the protocol over a plain blocking socket —
deliberately: the dispatcher runs inside ``run_in_executor`` threads
(pow/service.py), so the client tier must not touch the event loop.
:class:`FarmSolverTier` wraps it as the rung registered with
:class:`~pybitmessage_tpu_torch.pow.dispatcher.PowDispatcher` in front
of the card (``farm -> cuda``):

- **deadline propagation** — the tier forwards the remaining budget of
  any context-propagated :class:`~pybitmessage_tpu_torch.resilience.
  policy.Deadline` (clamped by its own per-job ceiling) on the wire, so
  the farm's admission can refuse a job it cannot finish in time
  *before* queueing it;
- **requeue-on-farm-failure** — any farm failure (dial, REJECT,
  protocol error, bad nonce) surfaces as an ordinary tier failure:
  the dispatcher's breaker opens and the batch is solved on the card,
  so an unreachable farm degrades to exactly the node without one;
- **trust boundary** — every nonce a farm returns is host-verified
  (one double-SHA512) before being trusted; a lying farm is a failed
  tier, not a corrupted send.

Each submission carries the object's wire trace context
(``LIFECYCLE.trace_ctx_for`` of its initial hash), so the farm's job
joins the submitting node's trace.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time
from typing import Callable

from ..observability import REGISTRY
from ..observability.lifecycle import LIFECYCLE
from ..ops.pow_search import PowInterrupted
from ..pow.dispatcher import host_trial
from ..resilience.policy import CircuitBreaker, current_deadline
from .protocol import (LANE_BULK, LANE_INTERACTIVE, MSG_ACCEPT,
                       MSG_PING, MSG_PONG, MSG_REJECT, MSG_RESULT,
                       MSG_SUBMIT, ST_EXPIRED, ST_OK, AcceptMsg,
                       ProtocolError, RejectMsg, ResultMsg, SubmitMsg,
                       pack_frame, recv_frame)

logger = logging.getLogger("pybitmessage_tpu_torch.powfarm")

SUBMISSIONS = REGISTRY.counter(
    "farm_client_submit_total",
    "Farm job submissions from this edge, by terminal outcome",
    ("outcome",))


class FarmError(Exception):
    """Farm-side failure — the dispatcher treats it as a tier failure
    and requeues the work on the local ladder."""


class FarmRejected(FarmError):
    """Admission refused with a retry-after hint."""

    def __init__(self, reason: str, retry_after: float):
        super().__init__("farm rejected: %s (retry after %.2fs)"
                         % (reason, retry_after))
        self.reason = reason
        self.retry_after = retry_after


class FarmClient:
    """Blocking farm connection (executor-thread side); thread-safe —
    one in-flight batch at a time under the lock."""

    def __init__(self, host: str, port: int, *, tenant: str = "default",
                 secret: bytes = b"", timeout: float = 60.0,
                 connect_timeout: float = 5.0):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.secret = secret
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._refs = itertools.count(1)

    # -- connection ----------------------------------------------------------

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        sock.settimeout(0.25)        # poll slice for should_stop checks
        self._sock = sock
        return sock

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _drop(self) -> None:
        # caller holds the lock
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def ping(self, timeout: float = 2.0) -> bool:
        """Liveness probe through the full framing path."""
        with self._lock:
            try:
                sock = self._connect()
                sock.sendall(pack_frame(MSG_PING, b""))
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    try:
                        msg_type, _ = recv_frame(sock)
                    except socket.timeout:
                        continue
                    return msg_type == MSG_PONG
                return False
            except (OSError, ProtocolError):
                self._drop()
                return False

    # -- solving -------------------------------------------------------------

    def solve_batch(self, items, *, lane: str = LANE_INTERACTIVE,
                    should_stop: Callable[[], bool] | None = None,
                    start_nonces=None, deadline_s: float | None = None,
                    traces=None):
        """Submit ``[(initial_hash, target), ...]``; block until every
        job lands -> ``[(nonce, trials), ...]``.  Raises
        :class:`FarmRejected` / :class:`FarmError` on any refusal or
        farm-side failure — the caller's ladder takes over."""
        items = list(items)
        if not items:
            return []
        starts = list(start_nonces) if start_nonces else [0] * len(items)
        traces = list(traces) if traces else [b""] * len(items)
        budget = deadline_s if deadline_s is not None else self.timeout
        give_up = time.monotonic() + budget
        with self._lock:
            try:
                sock = self._connect()
                pending: dict[int, int] = {}
                for i, (ih, target) in enumerate(items):
                    ref = next(self._refs)
                    pending[ref] = i
                    msg = SubmitMsg(
                        job_ref=ref, tenant=self.tenant, lane=lane,
                        initial_hash=bytes(ih), target=int(target),
                        start_nonce=starts[i],
                        deadline_ms=int(budget * 1e3),
                        trace=traces[i] or b"")
                    sock.sendall(pack_frame(
                        MSG_SUBMIT, msg.encode(self.secret or None)))
                results: dict[int, tuple[int, int]] = {}
                while len(results) < len(items):
                    if should_stop is not None and should_stop():
                        raise PowInterrupted("farm solve interrupted")
                    if time.monotonic() > give_up:
                        raise FarmError(
                            "farm gave no result inside %.1fs" % budget)
                    try:
                        msg_type, payload = recv_frame(sock)
                    except socket.timeout:
                        continue
                    if msg_type == MSG_ACCEPT:
                        AcceptMsg.decode(payload)   # validated, FYI only
                        continue
                    if msg_type == MSG_REJECT:
                        rej = RejectMsg.decode(payload)
                        SUBMISSIONS.labels(outcome="rejected").inc()
                        raise FarmRejected(rej.reason,
                                           rej.retry_after_ms / 1e3)
                    if msg_type != MSG_RESULT:
                        continue
                    res = ResultMsg.decode(payload)
                    idx = pending.get(res.job_ref)
                    if idx is None:
                        continue
                    if res.status == ST_OK:
                        results[idx] = (res.nonce, res.trials)
                        continue
                    SUBMISSIONS.labels(
                        outcome="expired" if res.status == ST_EXPIRED
                        else "error").inc()
                    raise FarmError(
                        "farm job failed (%s): %s"
                        % ("expired" if res.status == ST_EXPIRED
                           else "error", res.detail or "-"))
                SUBMISSIONS.labels(outcome="ok").inc(len(items))
                return [results[i] for i in range(len(items))]
            except (OSError, ConnectionError, ProtocolError) as exc:
                self._drop()
                SUBMISSIONS.labels(outcome="error").inc()
                raise FarmError("farm connection failed: %r" % exc)
            except Exception:
                # a refusal/timeout/interrupt leaves unread frames on
                # the wire; drop the connection so the next batch
                # starts clean, then let the ladder take over
                self._drop()
                raise


class FarmSolverTier:
    """The dispatcher's top rung: delegate PoW to a shared solver farm.

    Attach to a dispatcher with ``dispatcher.attach_farm(tier)`` —
    ``solve_batch``/``solve`` try the farm first; any failure opens
    the tier breaker and the batch is solved on the card.
    """

    def __init__(self, host: str, port: int, *, tenant: str = "default",
                 secret: bytes = b"", deadline: float = 60.0,
                 bulk_threshold: int = 2,
                 breaker: CircuitBreaker | None = None,
                 client: FarmClient | None = None):
        self.client = client or FarmClient(
            host, port, tenant=tenant, secret=secret, timeout=deadline)
        #: per-job wall ceiling; a tighter context-propagated Deadline
        #: (resilience/policy.py) wins
        self.deadline = deadline
        #: batches above this size ride the bulk lane — a coalesced
        #: storm is bulk traffic by construction, a lone user send is
        #: interactive
        self.bulk_threshold = max(1, bulk_threshold)
        self.breaker = breaker or CircuitBreaker(
            "pow.tier.farm", threshold=2, cooldown=30.0)

    def lane_for(self, n_items: int) -> str:
        return (LANE_INTERACTIVE if n_items <= self.bulk_threshold
                else LANE_BULK)

    def _budget(self) -> float:
        budget = self.deadline
        ctx = current_deadline()
        if ctx is not None:
            budget = min(budget, max(ctx.remaining(), 0.05))
        return budget

    def solve_batch(self, items, *, should_stop=None, start_nonces=None):
        items = list(items)
        traces = []
        for ih, _ in items:
            ctx = LIFECYCLE.trace_ctx_for(ih)
            traces.append(ctx.encode() if ctx is not None else b"")
        results = self.client.solve_batch(
            items, lane=self.lane_for(len(items)),
            should_stop=should_stop, start_nonces=start_nonces,
            deadline_s=self._budget(), traces=traces)
        self._verify(items, results)
        return results

    def solve(self, initial_hash: bytes, target: int, *,
              start_nonce: int = 0, should_stop=None):
        return self.solve_batch(
            [(initial_hash, target)], should_stop=should_stop,
            start_nonces=[start_nonce])[0]

    @staticmethod
    def _verify(items, results) -> None:
        """Host re-check every returned nonce — a farm is a remote
        peer, not a trusted device tier."""
        for (ih, target), (nonce, _) in zip(items, results):
            if host_trial(nonce, ih) > target:
                raise FarmError(
                    "farm returned a nonce failing host verification")

    def close(self) -> None:
        self.client.close()

    def snapshot(self) -> dict:
        """clientStatus farm-client block."""
        return {
            "endpoint": "%s:%d" % (self.client.host, self.client.port),
            "tenant": self.client.tenant,
            "deadline": self.deadline,
            "bulkThreshold": self.bulk_threshold,
            "breaker": self.breaker.snapshot(),
        }
