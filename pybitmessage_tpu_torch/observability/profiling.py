"""Continuous profiling: always-on CPU and cost attribution (twin of
``pybitmessage_tpu.observability.profiling``).

:class:`SamplingProfiler` is a wall-clock sampler with no dependency: a
daemon thread walks ``sys._current_frames()`` at a configurable rate
(``DEFAULT_HZ``, the ``profilehz`` setting) and classifies every sample
twice:

- **thread class**, from the ``bmtpu-`` thread names every thread of the
  package carries (event loop, crypto pool, PoW guards, the farm's
  dispatch thread, the asyncio default executor);
- **subsystem**, from the module directory of the innermost frame of
  THIS package (``pow/``, ``powfarm/``, ``crypto/``, ``network/``,
  ``roles/``, ...).  The package is recognised by the path component
  ``/pybitmessage_tpu_torch/``, so in a process that also runs the JAX
  package a frame of ``/pybitmessage_tpu/`` is never counted as one of
  this package's subsystems (nor is a frame of this package by the JAX
  package's profiler, whose marker is ``/pybitmessage_tpu/``).

Each sample feeds ``cpu_samples_total{subsystem,thread_class}``, a
bounded folded-stack trie (the ``profileDump`` / ``GET /debug/profile``
source, as collapsed-stack text and speedscope JSON) and a rolling
window ring, so a flight-recorder dump carries the stacks of the seconds
before it and the loop-lag probe can name the callback that held the
event loop (:func:`loop_culprit`).

:func:`cost_status` joins the sampler's shares with the per-unit
telemetry into the ``costStatus`` document: CPU-µs per object per
ingest stage (``ingest_stage_seconds``), per-tenant farm CPU
(``farm_tenant_cpu_seconds_total``), the crypto engine's seconds and
items (``crypto_rung_seconds_total``; the port's engine has one rung,
the card) and the device's busy seconds by program.

Blocked threads are sampled too (a wall sampler), but a sample whose
leaf is a known scheduler or queue wait is classified
``subsystem="idle"``; the event-loop thread is idle only inside the
selector poll.  The sampler measures its own cost
(``profile_sampler_overhead_ratio``).
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from collections import Counter as _Counter
from collections import deque

from .devicetelemetry import device_cost_block
from .metrics import REGISTRY

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

CPU_SAMPLES = REGISTRY.counter(
    "cpu_samples_total",
    "Profiler samples by subsystem (module-prefix map; 'idle' = the "
    "thread was parked in a scheduler/queue wait) and thread class "
    "(bmtpu- thread-name prefixes)", ("subsystem", "thread_class"))
SAMPLER_OVERHEAD = REGISTRY.gauge(
    "profile_sampler_overhead_ratio",
    "Fraction of wall time the sampling profiler spends walking "
    "frames (self-measured; the profile-smoke gate asserts <0.02)")
SAMPLER_ERRORS = REGISTRY.counter(
    "profile_sampler_errors_total",
    "Sampler ticks that raised (swallowed; the profiler must never "
    "kill or skew the process it observes)")
SLOW_CALLBACKS = REGISTRY.counter(
    "event_loop_slow_callback_total",
    "Event-loop lag samples above threshold attributed to the "
    "callback/coroutine site that held the loop", ("site",))

#: default sampling rate, Hz — low enough to be always-on (each tick
#: costs tens of µs), high enough that a multi-second stall yields
#: dozens of stacks
DEFAULT_HZ = 19.0

#: rolling-window ring capacity (per-thread samples, not ticks) — at
#: the default rate and ~10 threads this holds roughly a minute
DEFAULT_RING = 8192

#: bounded trie size (nodes); beyond it new stacks account to their
#: deepest existing prefix instead of growing memory
DEFAULT_TRIE_NODES = 50_000

#: stacks deeper than this are truncated INNERMOST-side after the
#: walk (outermost frames kept, so same-hot-path samples at varying
#: depth share a root-anchored trie prefix instead of minting
#: disconnected roots); the leaf is still what classifies the sample
MAX_STACK_DEPTH = 48

#: hard walk ceiling (pathological recursion guard)
MAX_WALK_FRAMES = 256

#: thread-name prefix -> thread class (first match wins; every thread
#: the package starts carries a bmtpu- name)
THREAD_CLASSES: tuple[tuple[str, str], ...] = (
    ("bmtpu-crypto", "crypto_pool"),      # cryptopool + batch + fanout
    ("bmtpu-slab", "slab"),               # drainer + seal finalizer
    ("bmtpu-pow", "pow"),                 # slab guards, verify probe,
                                          # native-solve stop watcher
    ("bmtpu-stall", "pow"),               # one-shot stall guards
    ("bmtpu-farm", "farm"),               # farm solve dispatch thread
    ("bmtpu-tor", "plugin"),
    ("bmtpu-profiler", "profiler"),
    ("bmtpu-", "other"),                  # named but unmapped
    ("asyncio_", "loop_executor"),        # run_in_executor(None, ...)
    ("ThreadPoolExecutor", "loop_executor"),
)

#: leaf function names that mean "parked, waiting for work" on a
#: non-loop thread (queue gets, condition waits, executor idles)
IDLE_LEAVES = frozenset({
    "wait", "_wait_for_tstate_lock", "acquire", "get", "sleep",
    "select", "poll", "epoll", "kqueue", "_worker", "settle",
    "wait_for", "accept", "recv", "recv_into", "readinto",
})

#: leaf names that mean the EVENT LOOP is idle (inside the selector);
#: anything else on the loop thread — a lock, a C call, SQL — is a
#: callback holding the loop and must count as busy
LOOP_IDLE_LEAVES = frozenset({"select", "poll", "epoll", "kqueue"})

#: the path component that marks a frame of this package
_PKG_MARKER = "pybitmessage_tpu_torch"

#: module-directory -> subsystem label (bounded by the source layout)
SUBSYSTEMS = frozenset({
    "pow", "powfarm", "crypto", "network", "sync", "storage",
    "workers", "roles", "observability", "resilience", "api", "ops",
    "parallel", "models", "utils", "core", "gateways", "plugins",
})


def _frame_site(frame) -> tuple[str, bool]:
    """``("pow/dispatcher.py:solve_batch", in_package)`` for a frame."""
    code = frame.f_code
    fn = code.co_filename.replace("\\", "/")
    i = fn.rfind("/" + _PKG_MARKER + "/")
    if i >= 0:
        rel = fn[i + len(_PKG_MARKER) + 2:]
        return rel + ":" + code.co_name, True
    return fn.rsplit("/", 1)[-1] + ":" + code.co_name, False


def _subsystem_of(site: str) -> str:
    """Package-relative site -> subsystem label."""
    top = site.split("/", 1)[0]
    if top in SUBSYSTEMS:
        return top
    return "core"        # package-root modules (gui, tui, viewmodel…)


class _TrieNode:
    __slots__ = ("children", "self_count")

    def __init__(self):
        self.children: dict[str, _TrieNode] = {}
        self.self_count = 0


class _StackTrie:
    """Bounded folded-stack aggregate.  Inserts walk root->leaf and
    count the sample at the deepest node reached; once ``max_nodes``
    is hit, new suffixes account to their existing prefix (bounded
    memory, no sample ever dropped)."""

    def __init__(self, max_nodes: int = DEFAULT_TRIE_NODES):
        self.root = _TrieNode()
        self.max_nodes = max_nodes
        self.nodes = 1
        self.samples = 0

    def insert(self, path: tuple[str, ...]) -> None:
        node = self.root
        for part in path:
            child = node.children.get(part)
            if child is None:
                if self.nodes >= self.max_nodes:
                    break
                child = node.children[part] = _TrieNode()
                self.nodes += 1
            node = child
        node.self_count += 1
        self.samples += 1

    def collapsed(self) -> list[str]:
        """Brendan-Gregg folded lines, ``a;b;c N``, stable order."""
        out: list[str] = []

        def walk(node: _TrieNode, prefix: list[str]) -> None:
            if node.self_count:
                out.append("%s %d" % (";".join(prefix), node.self_count))
            for part in sorted(node.children):
                prefix.append(part)
                walk(node.children[part], prefix)
                prefix.pop()

        walk(self.root, [])
        return out

    def clear(self) -> None:
        self.root = _TrieNode()
        self.nodes = 1
        self.samples = 0


def speedscope_doc(collapsed: list[str], *, name: str = "bmtpu") -> dict:
    """Collapsed folded lines -> one speedscope ``sampled`` profile
    (https://www.speedscope.app/file-format-schema.json)."""
    frames: list[dict] = []
    index: dict[str, int] = {}
    samples: list[list[int]] = []
    weights: list[float] = []
    for line in collapsed:
        stack_s, _, count_s = line.rpartition(" ")
        try:
            weight = float(count_s)
        except ValueError:
            continue
        stack = []
        for part in stack_s.split(";"):
            if not part:
                continue
            i = index.get(part)
            if i is None:
                i = index[part] = len(frames)
                frames.append({"name": part})
            stack.append(i)
        samples.append(stack)
        weights.append(weight)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "exporter": "pybitmessage-tpu profiling",
        "name": name,
        "activeProfileIndex": 0,
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled", "name": name, "unit": "none",
            "startValue": 0, "endValue": total,
            "samples": samples, "weights": weights,
        }],
    }


class SamplingProfiler:
    """Daemon-thread wall sampler over ``sys._current_frames()``.

    ``start()``/``stop()`` are idempotent; one process-wide instance
    (:data:`PROFILER`) is the default, and a caller that wants its own
    attribution window constructs another.
    """

    def __init__(self, hz: float = DEFAULT_HZ, *,
                 ring: int = DEFAULT_RING,
                 max_nodes: int = DEFAULT_TRIE_NODES,
                 counter=CPU_SAMPLES):
        self.hz = max(0.1, float(hz))
        self.counter = counter
        self.trie = _StackTrie(max_nodes)
        #: rolling window of (wall_t, thread_class, subsystem,
        #: leaf_site, folded_key) — the stall-dump / culprit source
        self.ring: deque = deque(maxlen=max(64, ring))
        #: loop-thread ident for event_loop classification; defaults
        #: to the main thread, overridden by Node.start() in case the
        #: loop runs elsewhere
        self._loop_ident = threading.main_thread().ident
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        #: guards ring + trie against readers: the sampler thread
        #: appends/inserts while dump/window/culprit callers iterate
        #: from the event loop — unguarded, CPython raises
        #: "deque mutated during iteration" / "dictionary changed
        #: size during iteration" mid-read
        self._data_lock = threading.Lock()
        self._busy = 0.0          # seconds spent inside ticks
        self._started_at = 0.0    # wall clock of start()
        self.samples = 0          # per-thread samples taken
        self.ticks = 0

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def note_loop_thread(self, ident: int | None = None) -> None:
        """Record which thread runs the asyncio loop (call from it)."""
        self._loop_ident = ident if ident is not None \
            else threading.get_ident()

    def start(self) -> bool:
        """Begin sampling; False when already running."""
        with self._lock:
            if self.running:
                return False
            self._stop.clear()
            self._started_at = time.monotonic()
            self._busy = 0.0
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="bmtpu-profiler")
            self._thread.start()
        # the stall auto-dump must capture the stacks OF the stall:
        # wire the rolling window into every flight-recorder dump
        from .flightrec import FLIGHT_RECORDER
        if FLIGHT_RECORDER.profile_provider is None:
            FLIGHT_RECORDER.profile_provider = self.flight_profile
        return True

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
            self._stop.set()
        if thread is not None:
            thread.join(timeout=2.0)
        from .flightrec import FLIGHT_RECORDER
        if FLIGHT_RECORDER.profile_provider == self.flight_profile:
            FLIGHT_RECORDER.profile_provider = None

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            t0 = time.monotonic()
            try:
                self.sample_once()
            except Exception:  # pragma: no cover — never kill/skew
                SAMPLER_ERRORS.inc()
                logger.debug("profiler tick failed", exc_info=True)
            self._busy += time.monotonic() - t0
            interval = 1.0 / self.hz      # hz is live-tunable
            if self.ticks % 64 == 0:
                SAMPLER_OVERHEAD.set(self.overhead())

    # -- one tick ------------------------------------------------------------

    def sample_once(self) -> int:
        """Walk every thread once; returns per-thread samples taken."""
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        now = time.time()
        taken = 0
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            cls = self._classify_thread(ident, names.get(ident, ""))
            sites: list[str] = []
            leaf_site, leaf_name, leaf_pkg_site = "", "", ""
            leaf_in_pkg = False
            depth = 0
            # walk innermost (leaf) -> outermost via f_back
            while frame is not None and depth < MAX_WALK_FRAMES:
                site, in_pkg = _frame_site(frame)
                sites.append(site)
                if depth == 0:
                    leaf_site, leaf_name = site, frame.f_code.co_name
                    leaf_in_pkg = in_pkg
                if in_pkg and not leaf_pkg_site:
                    leaf_pkg_site = site     # innermost package frame
                frame = frame.f_back
                depth += 1
            sites.reverse()               # outermost first
            if len(sites) > MAX_STACK_DEPTH:
                # keep the OUTERMOST frames: a root-anchored prefix
                # merges in the trie; truncating the root side would
                # fragment one hot path into per-depth orphans
                sites = sites[:MAX_STACK_DEPTH - 1] + ["(truncated)"]
            subsystem = self._classify_sample(
                cls, leaf_name, leaf_pkg_site, leaf_in_pkg)
            self.counter.labels(subsystem=subsystem,
                                thread_class=cls).inc()
            path = (cls,) + tuple(sites)
            with self._data_lock:
                self.trie.insert(path)
                self.ring.append((now, cls, subsystem,
                                  leaf_pkg_site or leaf_site,
                                  ";".join(path)))
            taken += 1
        self.samples += taken
        self.ticks += 1
        return taken

    def _classify_thread(self, ident: int, name: str) -> str:
        if ident == self._loop_ident:
            return "event_loop"
        for prefix, cls in THREAD_CLASSES:
            if name.startswith(prefix):
                return cls
        return "other"

    def _classify_sample(self, cls: str, leaf_name: str,
                         leaf_pkg_site: str,
                         leaf_in_pkg: bool = False) -> str:
        # the idle sets name STDLIB scheduler/queue waits; a PACKAGE
        # function that happens to be called get/acquire/wait (e.g.
        # bufpool.acquire on the packet path) is real work, never
        # idle — in-package leaves skip the idle check entirely
        if not leaf_in_pkg:
            if cls == "event_loop":
                if leaf_name in LOOP_IDLE_LEAVES:
                    return "idle"
            elif leaf_name in IDLE_LEAVES:
                return "idle"
        if leaf_pkg_site:
            return _subsystem_of(leaf_pkg_site)
        return "other"

    # -- readers -------------------------------------------------------------

    def overhead(self) -> float:
        """Sampler self-time as a fraction of wall time since start."""
        wall = time.monotonic() - self._started_at
        return self._busy / wall if wall > 1e-6 else 0.0

    def window(self, seconds: float) -> list[tuple]:
        """Ring entries newer than ``seconds`` ago (oldest first)."""
        cutoff = time.time() - max(seconds, 0.0)
        with self._data_lock:
            entries = list(self.ring)
        return [e for e in entries if e[0] >= cutoff]

    def collapsed(self) -> list[str]:
        """The whole-run trie as folded lines (locked snapshot — the
        sampler thread may be inserting concurrently)."""
        with self._data_lock:
            return self.trie.collapsed()

    def window_collapsed(self, seconds: float) -> list[str]:
        counts = _Counter(e[4] for e in self.window(seconds))
        return ["%s %d" % (k, v) for k, v in sorted(counts.items())]

    def loop_culprit(self, seconds: float) -> str | None:
        """The site that dominated the event-loop thread's non-idle
        samples in the last ``seconds`` — the name behind a lag spike
        (None without samples, e.g. profiler off or loop truly idle)."""
        counts = _Counter(
            e[3] for e in self.window(seconds)
            if e[1] == "event_loop" and e[2] != "idle")
        if not counts:
            return None
        return counts.most_common(1)[0][0]

    def dump(self, seconds: float | None = None, *,
             speedscope: bool = True, node_id: str = "") -> dict:
        """The ``profileDump`` document: collapsed stacks (whole-run
        trie, or the rolling window when ``seconds`` is given) plus an
        optional speedscope rendering and the classification totals."""
        if seconds is not None:
            collapsed = self.window_collapsed(seconds)
            entries = self.window(seconds)
            samples = len(entries)
            by_sub = dict(_Counter(e[2] for e in entries))
            by_cls = dict(_Counter(e[1] for e in entries))
        else:
            collapsed = self.collapsed()
            samples = self.trie.samples
            by_sub = by_cls = {}
        out = {
            "node": node_id,
            "hz": self.hz,
            "running": self.running,
            "seconds": seconds,
            "samples": samples,
            "overhead_frac": round(self.overhead(), 5),
            "by_subsystem": by_sub,
            "by_thread_class": by_cls,
            "collapsed": collapsed,
        }
        if speedscope:
            out["speedscope"] = speedscope_doc(
                collapsed, name=node_id or "bmtpu")
        return out

    def flight_profile(self) -> dict:
        """Compact window block for flight-recorder dumps: the stacks
        of the last ~10s — what the loop/workers were doing DURING a
        stall, captured before the ring scrolls past it."""
        return {"seconds": 10.0,
                "samples": len(self.window(10.0)),
                "collapsed": self.window_collapsed(10.0)}


#: the process-wide profiler (the daemon starts it; tests may run their
#: own instances)
PROFILER = SamplingProfiler()


def note_slow_callback(site: str, lag: float) -> None:
    """Count one attributed slow-callback event and drop a flight
    breadcrumb (called by the loop-lag probe on threshold crossings)."""
    SLOW_CALLBACKS.labels(site=site).inc()
    from .flightrec import record
    record("slow_callback", site=site, lag_ms=round(lag * 1e3, 1))


# ---------------------------------------------------------------------------
# cost attribution: join sampler shares with the per-unit telemetry
# ---------------------------------------------------------------------------


def _family_values(name: str) -> dict[tuple[str, ...], float]:
    fam = REGISTRY.get(name)
    if fam is None:
        return {}
    out = {}
    for values, child in fam.children():
        v = getattr(child, "value", None)
        if v is None:                      # histogram: use the sum
            _, v, _ = child.snapshot()
        out[values] = float(v)
    return out


def _shares(totals: dict[str, float], ndigits: int = 4) -> dict:
    total = sum(totals.values())
    return {k: {"value": round(v, 6),
                "share": round(v / total, ndigits) if total else 0.0}
            for k, v in sorted(totals.items())}


def cpu_shares(*, exclude_idle: bool = True) -> dict:
    """Subsystem and thread-class CPU-sample shares since process
    start, from ``cpu_samples_total`` (the same series federation
    pushes fleet-wide)."""
    by_sub: dict[str, float] = {}
    by_cls: dict[str, float] = {}
    for (sub, cls), v in _family_values("cpu_samples_total").items():
        if exclude_idle and sub == "idle":
            continue
        if cls == "profiler":
            continue
        by_sub[sub] = by_sub.get(sub, 0.0) + v
        by_cls[cls] = by_cls.get(cls, 0.0) + v
    return {"subsystems": _shares(by_sub),
            "thread_classes": _shares(by_cls)}


def ingest_stage_costs() -> dict:
    """CPU-µs per object per ingest stage: the sampler's window says
    which subsystem owns the cycles; ``ingest_stage_seconds`` says
    what each *object* costs at each lifecycle stage.  sum/count is
    worker-thread wall — the per-object cost attribution unit."""
    fam = REGISTRY.get("ingest_stage_seconds")
    out: dict = {}
    if fam is None:
        return out
    for values, child in fam.children():
        _, total_s, count = child.snapshot()
        if count:
            out[values[0]] = {
                "objects": count,
                "cpu_us_per_object": round(total_s / count * 1e6, 1),
            }
    return out


def farm_tenant_costs() -> dict:
    """Per-tenant farm CPU share (``farm_tenant_cpu_seconds_total``,
    solve wall attributed by batch composition in powfarm/server.py)."""
    return _shares({k[0]: v for k, v in _family_values(
        "farm_tenant_cpu_seconds_total").items()})


def crypto_rung_costs() -> dict:
    """Per-rung share of crypto drain work (the engine's seconds from
    ``crypto_rung_seconds_total`` + items from
    ``crypto_batch_ops_total``; the port's engine has one rung, the
    card)."""
    rungs = _shares({k[0]: v for k, v in _family_values(
        "crypto_rung_seconds_total").items()})
    for (op, path), v in _family_values(
            "crypto_batch_ops_total").items():
        slot = rungs.setdefault(
            path, {"value": 0.0, "share": 0.0})
        slot.setdefault("items", {})[op] = int(v)
    return rungs


def cost_status(node=None, *, profiler: SamplingProfiler | None = None
                ) -> dict:
    """The ``costStatus`` API document: sampler state + every cost-
    attribution join (never raises on missing subsystems — a node
    without a farm simply reports an empty tenant table)."""
    prof = profiler or PROFILER
    out = {
        "sampler": {
            "running": prof.running,
            "hz": prof.hz,
            "samples": prof.samples,
            "overheadFrac": round(prof.overhead(), 5),
        },
        "cpu": cpu_shares(),
        "ingestStages": ingest_stage_costs(),
        "farmTenants": farm_tenant_costs(),
        "cryptoRungs": crypto_rung_costs(),
        "device": device_cost_block(),
    }
    if node is not None:
        out["node"] = getattr(node, "node_id", "")
        out["role"] = getattr(node, "role", "all")
    return out
