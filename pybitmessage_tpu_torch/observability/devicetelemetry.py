"""Device telemetry plane: launch, transfer and utilization attribution
for every program the port runs on the card (twin of
``pybitmessage_tpu.observability.devicetelemetry``).

A process-wide :class:`DeviceTelemetry` registry that every host driver
of a kernel routes its launches through.  Per named program it
attributes, with the JAX package's semantics:

- **compiles vs cache hits** - the first launch of a (program, key)
  counts as a compile, later ones as cache hits.  The port's kernels are
  built once per process by ``ops/_build.py`` and take their shapes as
  launch arguments, so the drivers key by device type: the "compile" is
  a program's first launch on the card (or the CPU), the build itself
  is in ``env_fingerprint``'s kernel record;
- **dispatch vs execute wait** - host seconds spent issuing the launch
  vs waiting for its results on the host (the event wait of
  ``ops.sha512_cuda.HostCopy``, or the ``.cpu()`` copy);
- **device-busy seconds, double-buffer aware** - each launch contributes
  its (dispatch_start, fetch_end) span to a per-program union of
  intervals, so two overlapping in-flight slabs credit the overlap once;
- **host<->device bytes** (and donated bytes, always 0 here: no CUDA
  kernel of the port donates its inputs);
- **derived rates** - ``device_hashrate_hps`` (EWMA work items per busy
  second) and ``device_mfu_ratio``.

``device_mfu_ratio`` is the port's own model: the share of this card's
bound, the work items of every launch times the least seconds one item
needs on this card (``ops/bounds.py``, the count ``chip_smoke.py``'s
bound column uses), over the program's busy seconds.  The SM count and
the SM clock are read from the card the first time a ratio is computed,
and only when a CUDA context already exists.  ``flopsPerItem`` in
``deviceStatus`` is the per-item instruction count of that model
(32-bit integer instructions of a trial; IMAD slots of a secp lane at an
average scalar).  No TPU constant enters it.

Program catalog (the JAX catalog's names, so one dashboard reads both
daemons), with the kernel each one launches:

``pallas_slab`` - ``bm_search_kernel`` (``csrc/pow_kernels.cu``), one
  object, under ``ops.sha512_cuda.solve``.
``batch_search`` - ``bm_batch_search_kernel``, the pipeline's batched
  mode (``pow.pipeline.solve_batch_pipelined``).
``packed_search`` - ``bm_packed_search_kernel``, the pipeline's packed
  (storm) mode and its single-sync mode.
``pow_verify`` - no hand-written kernel: batched PoW verification of
  received objects in plain torch ops on the card
  (``ops.pow_search.verify`` under ``pow.verify_service``), as the JAX
  package leaves it to XLA; the wrappers' ``LAUNCHES`` do not count it.
``secp_verify`` - ``bm_secp_verify_kernel``
  (``csrc/secp256k1_kernels.cu``), under
  ``crypto.gpu.CudaSecp.verify_prepared``.
``secp_ecdh`` - ``bm_secp_ecdh_kernel`` (also P = G), under
  ``CudaSecp.ecdh_batch`` / ``base_mult_batch``.
``pod_slab`` - ``bm_search_kernel`` on every shard of a mesh, one
  record per pod slab over ``devices`` shards
  (``parallel.pallas_sharded_solve``); the wrappers' ``LAUNCHES`` count
  each shard's launch.
``pod_batch`` - ``bm_batch_search_kernel`` on every shard
  (``parallel.pallas_sharded_solve_batch``).
``sharded_search`` - no hand-written kernel: the plain torch search of
  ``parallel.sharded_solve`` (the JAX XLA tier's twin), one chunk per
  shard a round.
``sharded_batch`` - the same for ``parallel.sharded_solve_batch``.

Left out of the port's catalog: ``pow_slab`` (the XLA windowed search;
the port's single-object route is ``pallas_slab`` on the card and its
plain version on the CPU) and ``packed_search_xla`` (the XLA stand-in
of the packed kernel for CPU runs; the port's CPU runs record the plain
version under the planned program's own name).

An abandoned speculative launch (the slab in flight when a search has
its answer) counts as a launch with no work items and no wait: the host
never waits for it, so its card time is not measured.  On the CPU the
drivers record their plain versions' calls under the same names, and no
ratio is computed.

This plane never initializes CUDA: the device table, the environment
fingerprint and the ratio read only a context that already exists
(``torch.cuda.is_initialized()``).  Recording never raises into a launch
path - a failed update counts into ``device_telemetry_dropped_total``
instead.  :class:`DeviceTrace` / :func:`capture_device_trace` record a
``torch.profiler`` trace (CPU, plus CUDA when a context exists) as
Chrome trace JSON, in place of the JAX package's XPlane directory.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import tempfile
import threading
import time

from .metrics import REGISTRY

logger = logging.getLogger("pybitmessage_tpu_torch.observability")

#: bound on remembered (program, static-key) compile-cache entries - a
#: runaway dynamic key degrades to counting everything as a compile
#: rather than growing without bound
MAX_COMPILE_KEYS = 4096
#: EWMA smoothing for the derived hashrate gauge
RATE_ALPHA = 0.3

#: bounded per-device label values ("d00".."d15", then "overflow")
_MAX_DEVICE_LABELS = 16
_DEVICE_LABELS = tuple("d%02d" % i for i in range(_MAX_DEVICE_LABELS)
                       ) + ("overflow",)


def _device_label(index: int) -> str:
    return _DEVICE_LABELS[min(int(index), _MAX_DEVICE_LABELS)]


COMPILES = REGISTRY.counter(
    "device_program_compiles_total",
    "First-call traces+compiles per named device program (a new "
    "(program, static-shape key) pairing)", ("program",))
CACHE_HITS = REGISTRY.counter(
    "device_program_cache_hits_total",
    "Launches that reused an already-compiled executable",
    ("program",))
COMPILE_SECONDS = REGISTRY.histogram(
    "device_program_compile_seconds",
    "Dispatch wall seconds of first-key launches (trace+compile "
    "happens synchronously inside that dispatch)", ("program",))
LAUNCHES = REGISTRY.counter(
    "device_launches_total",
    "Device program launches by program name", ("program",))
DISPATCH_SECONDS = REGISTRY.histogram(
    "device_dispatch_seconds",
    "Host seconds spent issuing one launch (async dispatch call, "
    "excludes the blocking fetch)", ("program",))
EXECUTE_WAIT_SECONDS = REGISTRY.histogram(
    "device_execute_wait_seconds",
    "Host seconds blocked on the device->host fetch of one launch "
    "(the on-device execute proxy under double buffering)",
    ("program",))
BUSY_SECONDS = REGISTRY.counter(
    "device_busy_seconds_total",
    "Union-of-spans device-busy seconds per program: overlapping "
    "double-buffered launches credit their overlap once",
    ("program",))
H2D_BYTES = REGISTRY.counter(
    "device_h2d_bytes_total",
    "Host->device bytes uploaded as launch operands", ("program",))
D2H_BYTES = REGISTRY.counter(
    "device_d2h_bytes_total",
    "Device->host bytes fetched as launch results", ("program",))
DONATED_BYTES = REGISTRY.counter(
    "device_donated_bytes_total",
    "Uploaded bytes whose device buffer was donated back "
    "(donate_argnums — the donation hit-rate numerator over "
    "device_h2d_bytes_total)", ("program",))
WORK_ITEMS = REGISTRY.counter(
    "device_work_items_total",
    "Work items (PoW trial hashes, crypto lane items) executed per "
    "program — the hashrate/MFU numerator", ("program",))
HASHRATE = REGISTRY.gauge(
    "device_hashrate_hps",
    "EWMA work items per second per program, from launch spans and "
    "the kernel's known items-per-launch", ("program",))
MFU = REGISTRY.gauge(
    "device_mfu_ratio",
    "Share of the card's bound: work items x the least seconds one item "
    "needs on this card (ops/bounds.py) over the busy seconds",
    ("program",))
DEVICE_MEMORY = REGISTRY.gauge(
    "device_memory_bytes",
    "Live device memory from torch.cuda (bytes_in_use: allocated; "
    "bytes_limit: the card's memory) per bounded device label",
    ("device", "kind"))
DEVICE_INFO = REGISTRY.gauge(
    "device_backend_info",
    "Device count by backend platform and device kind (a presence/"
    "topology gauge for federation panes)", ("platform", "kind"))
TELEMETRY_DROPPED = REGISTRY.counter(
    "device_telemetry_dropped_total",
    "record_launch updates that raised and were dropped (telemetry "
    "must never fail the launch path it observes)")


def _live_cuda():
    """The torch module when a CUDA context already exists, else None:
    this plane must never be the reason the card initializes."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch if torch.cuda.is_initialized() else None
    except Exception:
        return None


def _card_rates() -> tuple[int, float] | None:
    """(SM count, SM clock in Hz) of the current card, read once from
    the card (the clock from nvidia-smi when torch does not report
    it); None without a CUDA context."""
    torch = _live_cuda()
    if torch is None:
        return None
    if _CARD:
        return _CARD[0]
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    clock_hz = float(getattr(props, "clock_rate", 0) or 0) * 1e3
    if clock_hz <= 0:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        clock_hz = float(out.stdout.split()[0]) * 1e6
    _CARD.append((int(props.multi_processor_count), clock_hz))
    return _CARD[0]


#: the card's (SMs, clock Hz), filled at the first ratio computed
_CARD: list = []


class DeviceTelemetry:
    """Process-wide device-program registry + launch recorder.

    ``register_program`` is called at import time by each launch module
    with a literal program name; ``record_launch`` is called per launch
    from the host drivers and never raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: dict[str, dict] = {}
        self._seen_keys: set[tuple] = set()
        #: per-program busy-span watermark (monotonic end time of the
        #: union of all credited spans) - spans complete in fetch order,
        #: so a watermark is an exact union of intervals
        self._busy_end: dict[str, float] = {}
        self._rate: dict[str, float] = {}
        #: per-program (least seconds of the credited work, busy
        #: seconds), the two sums of the utilization ratio
        self._util: dict[str, list] = {}

    # -- registration --------------------------------------------------------

    def register_program(self, name: str, *, cost=None,
                         module: str = "") -> None:
        """Declare a named device program (idempotent).

        ``cost`` is its per-item model (``ops.bounds.ItemCost``: the
        instructions of one item and the least card seconds it needs);
        ``module`` is the defining module for the deviceStatus table."""
        with self._lock:
            spec = self._programs.setdefault(
                name, {"cost": None, "module": ""})
            if cost is not None:
                spec["cost"] = cost
            if module:
                spec["module"] = module

    def programs(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._programs.items()}

    # -- recording -----------------------------------------------------------

    def record_launch(self, program: str, *, key=None,
                      dispatch_seconds: float = 0.0,
                      wait_seconds: float = 0.0,
                      span: tuple[float, float] | None = None,
                      items: float = 0, bytes_in: int = 0,
                      bytes_out: int = 0, bytes_donated: int = 0,
                      devices: int = 1) -> None:
        """Attribute one finished launch.  Never raises.

        ``key`` is the program's static-shape tuple: its first sighting
        counts as a compile (with ``dispatch_seconds`` as its wall),
        later sightings as cache hits.  ``span`` is (dispatch_start,
        fetch_end) in ``time.monotonic`` terms; overlap with the
        previous span is credited once.
        """
        try:
            self._record(program, key, float(dispatch_seconds),
                         float(wait_seconds), span, float(items),
                         int(bytes_in), int(bytes_out),
                         int(bytes_donated), max(1, int(devices)))
        except Exception:
            try:
                TELEMETRY_DROPPED.inc()
            except Exception:  # pragma: no cover - last resort
                pass
            logger.debug("device telemetry update dropped",
                         exc_info=True)

    def _record(self, program, key, dispatch_seconds, wait_seconds,
                span, items, bytes_in, bytes_out, bytes_donated,
                devices):
        LAUNCHES.labels(program=program).inc()
        DISPATCH_SECONDS.labels(program=program).observe(
            dispatch_seconds)
        EXECUTE_WAIT_SECONDS.labels(program=program).observe(
            wait_seconds)
        if bytes_in:
            H2D_BYTES.labels(program=program).inc(bytes_in)
        if bytes_out:
            D2H_BYTES.labels(program=program).inc(bytes_out)
        if bytes_donated:
            DONATED_BYTES.labels(program=program).inc(bytes_donated)
        if items:
            WORK_ITEMS.labels(program=program).inc(items)

        if key is not None:
            compile_key = (program, key)
            with self._lock:
                new = compile_key not in self._seen_keys
                if new and len(self._seen_keys) < MAX_COMPILE_KEYS:
                    self._seen_keys.add(compile_key)
            if new:
                COMPILES.labels(program=program).inc()
                COMPILE_SECONDS.labels(program=program).observe(
                    dispatch_seconds)
            else:
                CACHE_HITS.labels(program=program).inc()

        if span is None:
            busy = dispatch_seconds + wait_seconds
        else:
            start, end = float(span[0]), float(span[1])
            with self._lock:
                watermark = self._busy_end.get(program, start)
                busy = max(0.0, end - max(start, watermark))
                self._busy_end[program] = max(watermark, end)
        if busy > 0:
            BUSY_SECONDS.labels(program=program).inc(busy)

        if items and busy > 0:
            inst = items / busy
            with self._lock:
                prev = self._rate.get(program)
                rate = inst if prev is None else (
                    prev + RATE_ALPHA * (inst - prev))
                self._rate[program] = rate
            HASHRATE.labels(program=program).set(rate)
        self._utilization(program, items, busy, devices)

    def _utilization(self, program, items, busy, devices) -> None:
        """Feed the share of the card's bound: the least seconds of all
        credited work over all busy seconds of the program (not
        clamped, so a bound model that undercounts shows above 1)."""
        if _live_cuda() is None:
            return
        with self._lock:
            cost = self._programs.get(program, {}).get("cost")
        if cost is None:
            return
        sms, clock_hz = _card_rates()
        least = items * cost.seconds(sms * devices, clock_hz)
        with self._lock:
            util = self._util.setdefault(program, [0.0, 0.0])
            util[0] += least
            util[1] += busy
            ratio = util[0] / util[1] if util[1] > 0 else 0.0
        MFU.labels(program=program).set(ratio)


#: the process-wide registry every launch site routes through
DEVICE_TELEMETRY = DeviceTelemetry()


def register_program(name: str, *, cost=None, module: str = "") -> None:
    DEVICE_TELEMETRY.register_program(name, cost=cost, module=module)


def record_launch(program: str, **kwargs) -> None:
    DEVICE_TELEMETRY.record_launch(program, **kwargs)


# ---------------------------------------------------------------------------
# device enumeration (reads only an existing CUDA context)
# ---------------------------------------------------------------------------


def update_device_gauges() -> list[dict]:
    """Refresh per-device labels/memory gauges; returns the device table
    (empty when no CUDA context exists)."""
    torch = _live_cuda()
    if torch is None:
        return []
    table = []
    by_kind: dict[str, int] = {}
    current = torch.cuda.current_device()
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        kind = str(props.name)
        by_kind[kind] = by_kind.get(kind, 0) + 1
        label = _device_label(i)
        # mem_get_info works through a context: only the current
        # device's, so enumerating never creates one on another card
        limit = (torch.cuda.mem_get_info(i)[1] if i == current
                 else int(props.total_memory))
        row = {"id": i, "label": label, "platform": "gpu", "kind": kind,
               "capability": "%d.%d" % (props.major, props.minor),
               "sms": int(props.multi_processor_count),
               "bytes_in_use": int(torch.cuda.memory_allocated(i)),
               "peak_bytes_in_use": int(
                   torch.cuda.max_memory_allocated(i)),
               "bytes_limit": int(limit)}
        DEVICE_MEMORY.labels(device=label, kind="bytes_in_use").set(
            row["bytes_in_use"])
        DEVICE_MEMORY.labels(device=label, kind="bytes_limit").set(
            row["bytes_limit"])
        table.append(row)
    for kind, n in by_kind.items():
        DEVICE_INFO.labels(platform="gpu", kind=kind).set(n)
    return table


def env_fingerprint() -> dict:
    """python/torch/CUDA versions, the card's identity and the kernel
    library's build record - the stamp the doctor leads its report with.
    The card is read only when a CUDA context already exists."""
    import platform as _platform

    import torch

    from ..ops import _build
    out: dict = {"python": _platform.python_version(),
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "kernels": {"built": bool(_build.build_info["built"]),
                             "loaded": _build._lib is not None,
                             "nvccSeconds": round(
                                 _build.build_info["seconds"], 3)}}
    live = _live_cuda()
    out["cudaContext"] = live is not None
    if live is None:
        out["backend"] = None
        out["note"] = "no CUDA context: the card was never touched"
        return out
    try:
        dev = torch.cuda.current_device()
        out["backend"] = "cuda"
        out["device_count"] = torch.cuda.device_count()
        out["device_kind"] = torch.cuda.get_device_name(dev)
        out["capability"] = "%d.%d" % torch.cuda.get_device_capability(dev)
    except Exception as exc:
        out["backend"] = None
        out["error"] = repr(exc)
    return out


# ---------------------------------------------------------------------------
# status document / on-demand trace capture
# ---------------------------------------------------------------------------


def _series(name: str, program: str):
    fam = REGISTRY.get(name)
    if fam is None:
        return None
    for values, child in fam.children():
        if values == (program,):
            return child
    return None


def _counter_value(name: str, program: str) -> float:
    child = _series(name, program)
    return float(child.value) if child is not None else 0.0


def _hist_stats(name: str, program: str) -> tuple[int, float]:
    child = _series(name, program)
    if child is None:
        return 0, 0.0
    _, total_sum, count = child.snapshot()
    return count, total_sum


def device_status() -> dict:
    """The ``deviceStatus`` document: per-program attribution table +
    device identity (JSON-able, read-only)."""
    programs = {}
    for name, spec in sorted(DEVICE_TELEMETRY.programs().items()):
        launches = _counter_value("device_launches_total", name)
        _, dispatch_sum = _hist_stats("device_dispatch_seconds", name)
        _, wait_sum = _hist_stats("device_execute_wait_seconds", name)
        h2d = _counter_value("device_h2d_bytes_total", name)
        donated = _counter_value("device_donated_bytes_total", name)
        cost = spec.get("cost")
        programs[name] = {
            "module": spec.get("module", ""),
            "flopsPerItem": cost.instructions() if cost else None,
            "launches": int(launches),
            "compiles": int(_counter_value(
                "device_program_compiles_total", name)),
            "cacheHits": int(_counter_value(
                "device_program_cache_hits_total", name)),
            "compileSeconds": round(_hist_stats(
                "device_program_compile_seconds", name)[1], 6),
            "dispatchSeconds": round(dispatch_sum, 6),
            "executeWaitSeconds": round(wait_sum, 6),
            "busySeconds": round(_counter_value(
                "device_busy_seconds_total", name), 6),
            "h2dBytes": int(h2d),
            "d2hBytes": int(_counter_value(
                "device_d2h_bytes_total", name)),
            "donatedBytes": int(donated),
            "donationRate": round(donated / h2d, 4) if h2d else 0.0,
            "workItems": int(_counter_value(
                "device_work_items_total", name)),
            "hashrateHps": round(REGISTRY.sample(
                "device_hashrate_hps", {"program": name}), 2),
            "mfu": round(REGISTRY.sample(
                "device_mfu_ratio", {"program": name}), 6),
        }
    return {
        "devices": update_device_gauges(),
        "env": env_fingerprint(),
        "programs": programs,
        "dropped": REGISTRY.sample("device_telemetry_dropped_total"),
    }


def device_cost_block() -> dict:
    """The ``costStatus`` ``device`` block: the card's busy seconds in
    all and by program, compile and execute-wait seconds, launches (the
    attribution a cost view needs, without the per-program table)."""
    progs = DEVICE_TELEMETRY.programs()
    busy = {p: _counter_value("device_busy_seconds_total", p)
            for p in progs}
    total_busy = sum(busy.values())
    return {
        "busySeconds": round(total_busy, 6),
        "byProgram": {p: round(s, 6) for p, s in sorted(busy.items())
                      if s > 0},
        "compileSeconds": round(sum(
            _hist_stats("device_program_compile_seconds", p)[1]
            for p in progs), 6),
        "executeWaitSeconds": round(sum(
            _hist_stats("device_execute_wait_seconds", p)[1]
            for p in progs), 6),
        "launches": int(sum(
            _counter_value("device_launches_total", p)
            for p in progs)),
    }


#: bound on one on-demand capture - a forgotten long trace would hold
#: the profiler (and its buffer growth) for the whole session
MAX_TRACE_SECONDS = 60.0
#: one torch.profiler session per process: held for the whole capture
_CAPTURE = threading.Lock()
#: the file a capture writes into its directory
TRACE_FILE = "trace.json"


def _all_threads():
    """The profiler option that records host ops and spans of every
    thread, not only the one that opened the capture (the event loop,
    the PoW executor and the crypto drain threads all launch work);
    None on a torch that lacks it, which then records the opening
    thread's host side only (the card's activity is recorded whole)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class DeviceTrace:
    """``torch.profiler`` session around a block: CPU activity, plus CUDA
    when a context exists, written as Chrome trace JSON to
    ``trace_dir/trace.json`` on exit.  Launches from other threads land
    in the trace while it is open.  Entering while another capture runs
    raises ``RuntimeError``."""

    def __init__(self, trace_dir: str | None = None):
        self.trace_dir = trace_dir
        self.activities: list[str] = []
        self.wall = 0.0
        self._prof = None
        self._t0 = 0.0

    @property
    def path(self) -> str:
        return os.path.join(self.trace_dir, TRACE_FILE)

    def __enter__(self) -> "DeviceTrace":
        if not _CAPTURE.acquire(blocking=False):
            raise RuntimeError("a device trace capture is already running")
        try:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if _live_cuda() is not None:
                activities.append(ProfilerActivity.CUDA)
            self.activities = [a.name for a in activities]
            self.trace_dir = self.trace_dir or tempfile.mkdtemp(
                prefix="bmtorch_devtrace_")
            self._prof = profile(activities=activities,
                                 experimental_config=_all_threads())
            self._t0 = time.monotonic()
            self._prof.__enter__()
        except BaseException:
            _CAPTURE.release()
            raise
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            self._prof.__exit__(exc_type, exc, tb)
            self.wall = time.monotonic() - self._t0
            self._prof.export_chrome_trace(self.path)
        finally:
            _CAPTURE.release()
        return False


def capture_device_trace(seconds: float,
                         out_dir: str | None = None) -> dict:
    """Hold a :class:`DeviceTrace` open for ``seconds`` and report the
    artifact paths (the ``profileDevice`` / ``GET /debug/device?seconds=N``
    backend).  Blocking - API callers run it in an executor.  A failure,
    a second capture among them, answers ``ok: false``; it is never
    replaced by a trace of less than was asked."""
    seconds = float(seconds)
    if not 0 < seconds <= MAX_TRACE_SECONDS:
        raise ValueError("trace seconds must be in (0, %g]"
                         % MAX_TRACE_SECONDS)
    cap = DeviceTrace(out_dir)
    try:
        with cap:
            time.sleep(seconds)
    except Exception as exc:
        return {"ok": False, "error": repr(exc), "traceDir": cap.trace_dir}
    files = []
    for root, _dirs, names in os.walk(cap.trace_dir):
        for fname in names:
            path = os.path.join(root, fname)
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            files.append({"path": os.path.relpath(path, cap.trace_dir),
                          "bytes": size})
    return {"ok": True, "traceDir": cap.trace_dir,
            "seconds": round(cap.wall, 3), "activities": cap.activities,
            "files": sorted(files, key=lambda f: f["path"])}
