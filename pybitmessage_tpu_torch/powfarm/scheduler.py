"""Fair multi-tenant farm scheduler: WDRR + lanes + admission control
(copy of ``pybitmessage_tpu.powfarm.scheduler``).

The farm fronts a scarce accelerator with the same discipline a
continuous-batching inference scheduler fronts a GPU (Orca/vLLM
shape): admission happens at the *door*, fairness happens at the
*queue*, and the solver only ever sees coalesced batches.

Three mechanisms, composable and individually testable:

- **Weighted deficit-round-robin across tenants.**  Each tenant owns
  a FIFO per lane and a deficit counter; :meth:`FarmScheduler.take`
  visits tenants in rotation, crediting ``quantum * weight`` and
  popping one unit-cost job per debit.  Equal weights converge to
  equal goodput (the bench's max/min <= 1.5 acceptance bar); a 2x
  weight gets 2x the drain share under contention and no advantage
  when idle (DRR's work-conserving property).
- **Two strict-priority lanes.**  ``interactive`` (a user waiting on
  a message send) always drains before ``bulk`` (broadcast storms,
  resend sweeps).  Bulk cannot starve interactive by flooding, and
  interactive traffic is by definition sparse enough that bulk
  drains whenever a human is not actively waiting — the overload
  latency split the bench asserts (interactive p99 << bulk p99).
- **Queue-depth-aware admission.**  ``admit()`` projects the queue
  wait a new job would see (jobs ahead in its lane's drain order
  divided by the measured solve rate EWMA) and rejects with a
  computed ``retry_after`` *before* the queue melts — per-tenant
  token buckets and queued-job quotas bound any single tenant's
  share of the backlog, and a job whose own deadline cannot be met
  is refused immediately rather than accepted and expired later.

The scheduler is synchronous and lock-free by construction: every
caller is the farm server's event loop (asyncio single-threaded); the
solver executor only touches jobs *after* ``take()`` hands them over.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from ..observability import REGISTRY
from .protocol import LANE_BULK, LANE_INTERACTIVE, LANES

QUEUE_DEPTH = REGISTRY.gauge(
    "farm_queue_depth", "PoW jobs queued in the farm scheduler",
    ("lane",))
ADMISSION = REGISTRY.counter(
    "farm_admission_total",
    "Farm admission decisions: accepted, or rejected-with-retry-after "
    "by reason (quota / rate / backlog / deadline / auth / "
    "tenant_limit)", ("outcome",))
QUEUE_WAIT = REGISTRY.histogram(
    "farm_queue_wait_seconds",
    "Time an accepted farm job waited in the scheduler before its "
    "batch dispatched, by lane", ("lane",))
TENANT_SOLVED = REGISTRY.counter(
    "farm_tenant_solved_total",
    "Farm jobs solved per tenant and lane — the per-tenant goodput "
    "series fairness is measured on (tenant ids are bounded by the "
    "registration cap)", ("tenant", "lane"))

#: admission reject vocabulary (bounded — these become metric label
#: values and wire reason strings)
REJECT_QUOTA = "quota"
REJECT_RATE = "rate"
REJECT_BACKLOG = "backlog"
REJECT_DEADLINE = "deadline"
REJECT_AUTH = "auth"
REJECT_TENANT_LIMIT = "tenant_limit"


@dataclass
class TenantConfig:
    """Per-tenant policy knobs (the farm operator's SLA table)."""
    weight: float = 1.0              # WDRR drain share
    quota: int = 256                 # max jobs queued at once
    rate: float = 0.0                # token-bucket jobs/s (0 = unlimited)
    burst: float = 32.0              # token-bucket capacity
    secret: bytes = b""              # HMAC key ("" = unsigned accepted)


@dataclass
class FarmJob:
    """One accepted job flowing through the scheduler."""
    tenant: str
    lane: str
    initial_hash: bytes
    target: int
    start_nonce: int = 0
    deadline: float | None = None    # monotonic expiry (None = none)
    job_id: int | None = None        # farm journal row id
    enqueued: float = 0.0            # monotonic accept time
    trace_id: bytes = b""
    attempts: int = 0
    last_checkpoint: float = 0.0     # journal write throttle
    #: client endpoints awaiting this job's result:
    #: ``[(connection key, client job_ref), ...]`` — several clients
    #: may ride one job (restart-adoption dedupe collisions)
    refs: list = field(default_factory=list)

    @property
    def key(self) -> tuple[bytes, int]:
        return (self.initial_hash, self.target)


@dataclass
class Admission:
    """One admission verdict (``ok`` or a reject reason + backoff)."""
    ok: bool
    reason: str = ""
    retry_after: float = 0.0
    est_wait: float = 0.0
    depth: int = 0


class _TenantState:
    __slots__ = ("name", "config", "queues", "deficit", "tokens",
                 "token_ts", "queued", "solved")

    def __init__(self, name: str, config: TenantConfig,
                 now: float):
        self.name = name
        self.config = config
        self.queues = {lane: deque() for lane in LANES}
        self.deficit = {lane: 0.0 for lane in LANES}
        self.tokens = config.burst
        self.token_ts = now
        self.queued = 0
        self.solved = 0


class FarmScheduler:
    """Multi-tenant job queue with WDRR drain order and admission."""

    def __init__(self, *, default_config: TenantConfig | None = None,
                 max_wait: float = 30.0, max_tenants: int = 64,
                 capacity_hint: float = 50.0, ewma_alpha: float = 0.3,
                 clock=time.monotonic):
        #: policy applied to tenants auto-registered in open mode
        self.default_config = default_config or TenantConfig()
        #: admission ceiling on the projected queue wait, seconds
        self.max_wait = max_wait
        #: auto-registration cap — tenant ids become metric label
        #: values, so the set must stay bounded (docs/observability.md)
        self.max_tenants = max_tenants
        self.ewma_alpha = ewma_alpha
        self.clock = clock
        #: measured drain throughput, jobs/s (EWMA fed by the server
        #: after each batch lands; seeded by the operator's hint so
        #: the first admissions are not blind)
        self.solve_rate = max(capacity_hint, 1e-3)
        self._tenants: dict[str, _TenantState] = {}
        #: per-lane tenant rotation for DRR (tenant names)
        self._rotation: dict[str, deque] = {lane: deque()
                                            for lane in LANES}
        #: jobs currently dispatched to the solver (set by the server
        #: around each batch) — admission must count work the queue no
        #: longer shows or a long batch hides the true backlog
        self.inflight = 0

    # -- tenants -------------------------------------------------------------

    def register(self, name: str,
                 config: TenantConfig | None = None) -> None:
        """Pre-register a tenant with explicit policy (SLA table)."""
        state = self._tenants.get(name)
        if state is not None:
            state.config = config or state.config
            return
        self._tenants[name] = _TenantState(
            name, config or self.default_config, self.clock())

    def tenant(self, name: str) -> _TenantState | None:
        return self._tenants.get(name)

    def tenants(self) -> dict[str, _TenantState]:
        return dict(self._tenants)

    def _auto_register(self, name: str) -> _TenantState | None:
        """Open-mode registration, bounded by ``max_tenants``."""
        state = self._tenants.get(name)
        if state is not None:
            return state
        if len(self._tenants) >= self.max_tenants:
            return None
        state = _TenantState(name, self.default_config, self.clock())
        self._tenants[name] = state
        return state

    # -- capacity model ------------------------------------------------------

    def note_drained(self, jobs: int, seconds: float) -> None:
        """Fold one completed batch into the solve-rate EWMA."""
        if jobs <= 0 or seconds <= 0:
            return
        rate = jobs / seconds
        self.solve_rate += self.ewma_alpha * (rate - self.solve_rate)
        self.solve_rate = max(self.solve_rate, 1e-3)

    def depth(self, lane: str | None = None) -> int:
        if lane is None:
            return sum(t.queued for t in self._tenants.values())
        return sum(len(t.queues[lane]) for t in self._tenants.values())

    def projected_wait(self, lane: str) -> float:
        """Queue seconds a job admitted NOW would wait: everything
        that drains before it (its lane plus, for bulk, the whole
        interactive lane) over the measured solve rate."""
        ahead = self.depth(LANE_INTERACTIVE) + self.inflight
        if lane == LANE_BULK:
            ahead += self.depth(LANE_BULK)
        return ahead / self.solve_rate

    # -- admission -----------------------------------------------------------

    def admit(self, tenant_name: str, lane: str,
              deadline_s: float | None = None) -> Admission:
        """Decide whether one job may enter ``lane`` for ``tenant``.

        Rejections carry a computed ``retry_after`` so well-behaved
        clients back off precisely; nothing is ever accepted and then
        silently shed — reject-before-melt, not drop-after.
        """
        state = self._auto_register(tenant_name)
        if state is None:
            ADMISSION.labels(outcome=REJECT_TENANT_LIMIT).inc()
            return Admission(False, REJECT_TENANT_LIMIT,
                             retry_after=self.max_wait)
        cfg = state.config
        # per-tenant queued-job quota.  The retry hint is the time the
        # tenant's FAIR SHARE of the drain rate needs to empty its
        # queue — hinting the raw pod rate would invite a retry storm
        # that melts the accept path under exactly the overload the
        # quota exists for
        if state.queued >= cfg.quota:
            ADMISSION.labels(outcome=REJECT_QUOTA).inc()
            share = self.solve_rate / max(len(self._tenants), 1)
            return Admission(
                False, REJECT_QUOTA,
                retry_after=max(state.queued / max(share, 1e-3), 0.05),
                depth=self.depth())
        # per-tenant token bucket
        now = self.clock()
        if cfg.rate > 0:
            state.tokens = min(
                cfg.burst,
                state.tokens + (now - state.token_ts) * cfg.rate)
            state.token_ts = now
            if state.tokens < 1.0:
                ADMISSION.labels(outcome=REJECT_RATE).inc()
                return Admission(
                    False, REJECT_RATE,
                    retry_after=(1.0 - state.tokens) / cfg.rate,
                    depth=self.depth())
        # queue-depth-aware wait projection
        est = self.projected_wait(lane)
        if est > self.max_wait:
            ADMISSION.labels(outcome=REJECT_BACKLOG).inc()
            return Admission(False, REJECT_BACKLOG,
                             retry_after=est - self.max_wait,
                             est_wait=est, depth=self.depth())
        if deadline_s is not None and est > deadline_s:
            ADMISSION.labels(outcome=REJECT_DEADLINE).inc()
            return Admission(False, REJECT_DEADLINE,
                             retry_after=max(est - deadline_s, 0.05),
                             est_wait=est, depth=self.depth())
        if cfg.rate > 0:
            state.tokens -= 1.0
        ADMISSION.labels(outcome="accepted").inc()
        return Admission(True, est_wait=est, depth=self.depth())

    # -- queue ---------------------------------------------------------------

    def push(self, job: FarmJob, *, front: bool = False) -> None:
        """Enqueue an accepted job (``front=True`` re-queues a failed
        dispatch without losing its drain position).

        Unlike :meth:`admit`, push never refuses: it is only reached
        for jobs that already passed admission or were adopted from
        the crash journal at restart (whose tenant set is local
        state, not attacker-controlled)."""
        state = self._tenants.get(job.tenant)
        if state is None:
            state = self._tenants[job.tenant] = _TenantState(
                job.tenant, self.default_config, self.clock())
        q = state.queues[job.lane]
        if front:
            q.appendleft(job)
        else:
            q.append(job)
        state.queued += 1
        if not job.enqueued:
            job.enqueued = self.clock()
        rot = self._rotation[job.lane]
        if job.tenant not in rot:
            rot.append(job.tenant)
        QUEUE_DEPTH.labels(lane=job.lane).set(self.depth(job.lane))

    def take(self, max_jobs: int) -> list[FarmJob]:
        """Pop up to ``max_jobs`` in drain order: interactive lane
        fully before bulk; WDRR across tenants within each lane."""
        out: list[FarmJob] = []
        for lane in (LANE_INTERACTIVE, LANE_BULK):
            if len(out) >= max_jobs:
                break
            out.extend(self._take_lane(lane, max_jobs - len(out)))
        for lane in LANES:
            QUEUE_DEPTH.labels(lane=lane).set(self.depth(lane))
        now = self.clock()
        for job in out:
            QUEUE_WAIT.labels(lane=job.lane).observe(now - job.enqueued)
        return out

    def _take_lane(self, lane: str, budget: int) -> list[FarmJob]:
        out: list[FarmJob] = []
        rot = self._rotation[lane]
        while budget > 0 and rot:
            # quantum scaling: credit each visited tenant
            # ``weight / min_weight`` so even the smallest weight
            # earns >= 1 credit per rotation — fractional weights
            # cannot livelock the sweep, and the common factor
            # preserves the ratios that define the drain shares
            min_w = min((self._tenants[n].config.weight
                         for n in rot if n in self._tenants),
                        default=1.0)
            scale = 1.0 / max(min_w, 1e-6)
            progressed = False
            for _ in range(len(rot)):
                if budget <= 0 or not rot:
                    break
                name = rot[0]
                rot.rotate(-1)
                state = self._tenants.get(name)
                if state is None or not state.queues[lane]:
                    # lazy removal: tenant left the lane
                    try:
                        rot.remove(name)
                    except ValueError:
                        pass
                    if state is not None:
                        state.deficit[lane] = 0.0
                    continue
                state.deficit[lane] += state.config.weight * scale
                while (state.deficit[lane] >= 1.0
                       and state.queues[lane] and budget > 0):
                    job = state.queues[lane].popleft()
                    state.queued -= 1
                    state.deficit[lane] -= 1.0
                    out.append(job)
                    budget -= 1
                    progressed = True
                if not state.queues[lane]:
                    state.deficit[lane] = 0.0
                    try:
                        rot.remove(name)
                    except ValueError:
                        pass
            if not progressed:
                break
        return out

    def note_solved(self, job: FarmJob) -> None:
        """Goodput bookkeeping for one landed job."""
        state = self._tenants.get(job.tenant)
        if state is not None:
            state.solved += 1
        TENANT_SOLVED.labels(tenant=job.tenant, lane=job.lane).inc()

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """clientStatus farm block: depths, rate, per-tenant state."""
        return {
            "queueDepth": {lane: self.depth(lane) for lane in LANES},
            "solveRateJobsPerS": round(self.solve_rate, 2),
            "projectedWait": {lane: round(self.projected_wait(lane), 3)
                              for lane in LANES},
            "maxWait": self.max_wait,
            "tenants": {
                name: {"queued": t.queued, "solved": t.solved,
                       "weight": t.config.weight,
                       "quota": t.config.quota,
                       "rate": t.config.rate}
                for name, t in sorted(self._tenants.items())},
        }
