#!/usr/bin/env python3
"""Time the packed nonce-search kernel's design part by part on one card.

    python3 torch_tools/pow_packed_bench.py [--seed N] [--parent DIR]
        [--variants parent,0,...,6,shipped] [--reps N] [--report PATH]

Builds ``torch_tools/pow_packed_parts.cu`` (variants 0-6, listed at its
head: 0 the first port's step-major kernel with the launch counters
added, 1-5 per-object claims by single warps, 6 the shipped loop with
atomic reads) and, with ``--parent``, the PoW kernels of an earlier
checkout of the repo (its ``pybitmessage_tpu_torch/csrc/
pow_kernels.cu``); the shipped kernel (per-object claims by blocks whose
warps hash in step, plain loads) comes from the port's own library.
Then, at the storm's packed shape (1,024 objects, pack 16, rows 128,
chunks 64), on the storm's own targets and on targets that mostly miss,
times each variant with CUDA events over warm launches in the order
given and back (parent, 0, ..., 6, shipped, shipped, 6, ..., 0, parent)
and prints each reading; variants 3 and 5 also print their probe (where
the warps' time went).  Every variant's lowest hits must equal
``packed_search_ref``'s.  For each variant with counters it prints the
trials executed (32 per hashed round) against the trials the data needs,
the claims and the claims that found their object finished.  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

PARTS_SRC = Path(__file__).resolve().parent / "pow_packed_parts.cu"
CSRC = ROOT / "pybitmessage_tpu_torch" / "csrc"
PARENT_SRC = Path("pybitmessage_tpu_torch") / "csrc" / "pow_kernels.cu"
BUILD = ROOT / "build" / "pow_parts"
VARIANTS = ("parent", "0", "1", "2", "3", "4", "5", "6", "shipped")
#: words of a probed warp's record (variants 3 and 5, pow_packed_parts.cu)
PROBE_WORDS = 6


def _nvcc(src: Path, out: Path, include: Path) -> subprocess.Popen:
    from pybitmessage_tpu_torch.ops import _build

    return subprocess.Popen(
        [_build.nvcc(), *_build._FLAGS, "-shared", "-I", str(include), "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def build(parent: Path | None) -> dict:
    """The variants' library, the parent's and the port's, built at once."""
    from pybitmessage_tpu_torch.ops import _build

    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {"parts": (PARTS_SRC, CSRC)}
    if parent is not None:
        src = parent / PARENT_SRC
        jobs["parent"] = (src, src.parent)
    t0 = time.monotonic()
    procs = {name: _nvcc(src, BUILD / ("lib%s.so" % name), inc)
             for name, (src, inc) in jobs.items()}
    libs = {"shipped": _build.load()}
    ptxas = _build.build_info["ptxas"]
    for i, line in enumerate(ptxas):
        if "bm_packed_search_kernel" in line:
            print("  ptxas shipped: " + " ".join(ptxas[i:i + 3]))
    for name, proc in procs.items():
        out = proc.communicate()[0]
        chip_smoke.require(proc.returncode == 0,
                           "nvcc %s failed:\n%s" % (name, out))
        for line in out.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas %s: %s" % (name, line.strip()))
        libs[name] = ctypes.CDLL(str(BUILD / ("lib%s.so" % name)))
    print("built %s in %.1f s" % (", ".join(libs), time.monotonic() - t0))
    return libs


def _probe_summary(recs: np.ndarray, counters: dict) -> dict:
    """Where variant 3's warps spent the launch: its span on the global
    timer, when warps started and left, the idle share of the warp slots
    after each warp left, and the shares of the warps' SM cycles spent
    picking objects, claiming and hashing."""
    recs = recs[recs[:, 0] != 0].astype(np.float64)
    start, end = recs[:, 0], recs[:, 1]
    t0 = start.min()
    span = end.max() - t0
    cycles = recs[:, 2:5].sum(axis=0)
    return {
        "warps": len(recs), "span_us": float(span / 1e3),
        "start_spread_us": float((start.max() - t0) / 1e3),
        "exit_us": {q: float(np.quantile(end - t0, q / 100)) / 1e3
                    for q in (1, 10, 50, 90, 99, 100)},
        "idle_after_exit": float((end.max() - end).sum()
                                 / (len(recs) * span)),
        "cycle_shares": dict(zip(("pick", "claim", "hash"),
                                 (cycles / cycles.sum()).tolist())),
        "cycles_per_round": float(cycles[2] / recs[:, 5].sum()),
        "cycles_per_claim": float(cycles[1] / counters["claims"]),
        "cycles_per_pick": float(cycles[0] / max(1, counters["switches"])),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", type=Path, default=None,
                        help="an earlier checkout whose packed kernel to "
                        "time beside these")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated, of %s" % (VARIANTS,))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--report", default=None)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("pow_packed_bench: no CUDA device", file=sys.stderr)
        return 2
    from pybitmessage_tpu_torch.ops import _build
    from pybitmessage_tpu_torch.ops import sha512_cuda as sc

    variants = args.variants.split(",")
    chip_smoke.require(set(variants) <= set(VARIANTS),
                       "unknown variant in %r" % args.variants)
    chip_smoke.require("parent" not in variants or args.parent is not None,
                       "variant parent needs --parent")
    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi)
    libs = build(args.parent if "parent" in variants else None)
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(_build.stream(dev))
    env = {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
           "clock_mhz": float(
               chip_smoke.nvidia_smi("clocks.max.sm").split()[0]),
           "ops_per_trial": chip_smoke.ops_per_trial()}
    shape = chip_smoke.STORM_PACKED
    n_obj = chip_smoke.STORM_OBJECTS
    groups, pack = n_obj // shape["pack"], shape["pack"]
    span = shape["rows"] // pack * 128
    steps = shape["chunks"] * shape["unroll"]
    n = span * steps
    rng = np.random.default_rng(args.seed)
    inputs = {"storm": chip_smoke._storm_objects(rng, n_obj),
              "miss": chip_smoke._main_shape_objects(rng, n_obj, n)}
    c_void = ctypes.c_void_p
    report = {"smi": smi, "seed": args.seed, "reps": args.reps, "cases": {}}
    order = variants + variants[::-1]
    # a record for every warp the card can hold (64 an SM at most)
    probes = {v: torch.zeros(env["sms"] * 64 * PROBE_WORDS,
                             dtype=torch.int64, device=dev)
              for v in ("3", "5")}
    for kind, (ihs, bases, targets) in inputs.items():
        ins = chip_smoke._tensors(ihs, bases, targets, dev)
        want = sc.packed_search_ref(*ins, **shape)
        needed = chip_smoke._needed_trials(want.cpu().tolist(), bases, n)
        bound_ms = needed * chip_smoke.trial_seconds_bound(env) * 1e3
        ptrs = [c_void(t.data_ptr()) for t in ins]
        readings: dict = {}
        counters: dict = {}
        for variant in order:
            words = n_obj + 2 if variant == "parent" else \
                2 * n_obj + len(sc.PACKED_COUNTERS)
            scratch = torch.empty(words, dtype=torch.int64, device=dev)
            if variant in ("parent", "shipped"):
                fn = libs[variant].bm_pow_packed_search
                head, tail = [], []
            else:
                fn = libs["parts"].bm_part_packed_search
                head = [ctypes.c_int(int(variant))]
                probe = probes.get(variant)
                tail = [c_void(probe.data_ptr() if probe is not None
                               else None)]

            def launch():
                err = fn(*head, *ptrs, ctypes.c_int(groups),
                         ctypes.c_int(pack), ctypes.c_uint64(steps),
                         ctypes.c_uint64(span), c_void(scratch.data_ptr()),
                         *tail, stream)
                chip_smoke.require(err == 0, "%s did not launch (%d)"
                                   % (variant, err))

            launch()
            torch.cuda.synchronize()
            chip_smoke.require(
                torch.equal(sc._rows(scratch[:n_obj], ins[1], span), want),
                "%s targets: variant %s differs from packed_search_ref"
                % (kind, variant))
            readings.setdefault(variant, []).append(
                chip_smoke._event_ms(launch, args.reps))
            if variant != "parent":
                got = dict(zip(sc.PACKED_COUNTERS,
                               scratch[2 * n_obj:].tolist()))
                got["executed_per_needed"] = 32 * got["hashed_rounds"] / needed
                counters[variant] = got
        report["cases"][kind] = {"needed_trials": needed,
                                 "bound_ms": bound_ms, "ms": readings,
                                 "counters": counters}
        for variant in ("3", "5"):
            if variant in variants:
                report["cases"][kind]["probe " + variant] = _probe_summary(
                    probes[variant].view(-1, PROBE_WORDS).cpu().numpy(),
                    counters[variant])
        print("%s targets: %d trials needed, bound %.4f ms" % (
            kind, needed, bound_ms))
        for variant in variants:
            line = "  %-7s %s ms" % (variant, " / ".join(
                "%.4f" % t for t in readings[variant]))
            if variant in counters:
                c = counters[variant]
                line += (" | executed/needed %.4f, hashed %d, skipped %d, "
                         "claims %d, switches %d" % (
                             c["executed_per_needed"], c["hashed_rounds"],
                             c["skipped_rounds"], c["claims"],
                             c["switches"]))
            print(line)
        for variant in ("3", "5"):
            if "probe " + variant in report["cases"][kind]:
                print("  probe (variant %s, its last launch): %s" % (
                    variant,
                    json.dumps(report["cases"][kind]["probe " + variant])))
    print("every variant's lowest hits equal packed_search_ref's")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
