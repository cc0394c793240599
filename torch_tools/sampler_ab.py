#!/usr/bin/env python3
"""What the daemons' sampling profiler costs the PoW farm's storm.

    python3 torch_tools/sampler_ab.py [--variants off,on,tick,nostore]
                                      [--seed N] [--report PATH]

Runs ``chip_smoke.phase_farm`` (daemon F serving 8 tenants' storm, E
delegating to it, F's SIGKILL and resume) once for each variant, then
once more for each in the reverse order.  Every run gets the same
inputs (a generator seeded with ``--seed``).  Each daemon runs through
this file, which sets it up for the variant and then runs ``python -m
pybitmessage_tpu_torch`` in its process:

- ``off``: ``--set profiling=false``, no sampler thread;
- ``on``: the default, the sampler walking every thread at 19 Hz;
- ``tick``: the sampler thread wakes at 19 Hz and takes the GIL, but
  walks no frame (``SamplingProfiler.sample_once`` does nothing);
- ``nostore``: the sampler walks and classifies every thread and counts
  ``cpu_samples_total``, but keeps no stack (the trie's ``insert`` does
  nothing, the rolling window holds 64 entries);
- ``hz1``: the default sampler at 1 Hz.

Every daemon also sums its garbage collector's pauses by generation
(``gc.callbacks``) and writes them beside its data directory every
second.  Per run it prints F's storm wall, the bulk lane's jobs/s, F's
collections and their seconds over the storm, F's loop-lag p99 and
the sampler's ``overheadFrac`` where it runs.  Prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

VARIANTS = ("off", "on", "tick", "nostore", "hz1")


def _as_daemon(variant: str, argv: list) -> None:
    """Set this process up for ``variant`` and run the port's daemon
    with ``argv``."""
    import gc
    import runpy
    import threading

    data_dir = argv[argv.index("-d") + 1]
    totals = {g: [0, 0.0] for g in range(3)}
    started: list = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            row = totals[info["generation"]]
            row[0] += 1
            row[1] += time.perf_counter() - started.pop()

    def write() -> None:
        while True:
            time.sleep(1.0)
            with open(data_dir + ".gc.json", "w") as fh:
                json.dump({"at": time.time(), "gc": totals}, fh)

    gc.callbacks.append(on_gc)
    threading.Thread(target=write, daemon=True, name="bmtpu-ab-gc").start()
    sys.path.insert(0, str(ROOT))
    from collections import deque

    from pybitmessage_tpu_torch.observability import profiling
    if variant == "tick":
        profiling.SamplingProfiler.sample_once = lambda self: 0
    elif variant == "nostore":
        profiling._StackTrie.insert = lambda self, path: None
        profiling.PROFILER.ring = deque(maxlen=64)
    extra = {"off": ["--set", "profiling=false"],
             "hz1": ["--set", "profilehz=1"]}.get(variant, [])
    sys.argv = ["pybitmessage_tpu_torch", *argv, *extra]
    runpy.run_module("pybitmessage_tpu_torch", run_name="__main__",
                     alter_sys=True)


def _gc_of(d) -> dict:
    try:
        with open(d.dir + ".gc.json") as fh:
            return json.load(fh)["gc"]
    except (OSError, ValueError):
        return {}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--as-daemon":
        _as_daemon(sys.argv[2], sys.argv[3:])
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default="off,on,tick,nostore")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", default=None)
    args = parser.parse_args()
    variants = args.variants.split(",")
    for v in variants:
        if v not in VARIANTS:
            parser.error("unknown variant %r" % v)

    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs

    # the card's name and power limit, and the kernels built here,
    # before any timed run
    cs.phase_environment()
    argv, read, check = cs._Daemon.argv, cs.profiler_read, cs.sampler_check
    state: dict = {}

    def daemon_argv(self, *extra):
        cmd = argv(self, *extra)
        i = cmd.index("-m")
        return [cmd[0], __file__, "--as-daemon", state["variant"],
                *cmd[i + 2:]]

    def after_storm(d, name):
        # F right after (n): its collections so far and its loop lag
        state["gc"] = _gc_of(d)
        health = json.loads(d.rpc("clientStatus"))["health"]["loop"]
        state["lag_p99_ms"] = health["lagP99Ms"]
        if state["variant"] in ("off", "tick"):
            # no sampler, or one that keeps no sample: nothing to check
            if state["variant"] == "tick":
                return {"sampler": json.loads(d.rpc("costStatus"))[
                    "sampler"]}
            return {}
        return read(d, name)

    def sampler_check(d, name):
        if state["variant"] in ("off", "tick"):
            return {}
        return check(d, name)

    cs._Daemon.argv = daemon_argv
    cs.profiler_read = after_storm
    cs.sampler_check = sampler_check
    rows = []
    for variant in variants + variants[::-1]:
        state.clear()
        state["variant"] = variant
        t0 = time.perf_counter()
        r = cs.phase_farm(np.random.default_rng([args.seed, 7]))
        storm = r["phases"]["storm"]
        f_cost = r["phases"].get("f_cost") or {}
        row = {"variant": variant, "storm_wall_s": storm["wall_s"],
               "bulk_jobs_per_s": storm["lanes"]["bulk"]["jobs_per_s"],
               "f_gc": state.get("gc"),
               "f_lag_p99_ms": state.get("lag_p99_ms"),
               "overhead_frac": (f_cost.get("sampler") or {}).get(
                   "overheadFrac"),
               "phase_s": time.perf_counter() - t0}
        rows.append(row)
        print("sampler A/B: %s" % json.dumps(row), flush=True)
    for v in variants:
        walls = [r["storm_wall_s"] for r in rows if r["variant"] == v]
        print("sampler A/B %s: storm walls %s s" % (v, walls))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(rows, fh, indent=1)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
