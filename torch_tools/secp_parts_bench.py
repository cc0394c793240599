#!/usr/bin/env python3
"""Time the secp256k1 kernels' design part by part on one CUDA card.

    python3 torch_tools/secp_parts_bench.py [--seed N] [--parent DIR]
                                            [--report PATH]

Builds ``torch_tools/secp_parts.cu`` (the design's
parts 1-4 as one-thread-per-lane variants over ``csrc/secp256k1.cuh``)
and, with ``--parent``, the secp kernels of an earlier checkout of the
repo (its ``pybitmessage_tpu_torch/csrc/secp256k1_kernels.cu``, whose
launchers take no comb).  Then times, with CUDA events over warm
launches, verify and ECDH at 4,096 lanes (the main path's drain) and
65,536 lanes, and ECDH with P = G at 4,096 lanes (key derivation), for
the parent, parts 1-4 and the shipped kernels (part 5), in the order
parent, 1, 2, 3, 4, 5, 5, 4, 3, 2, 1, parent; each reading is printed.
Every variant's output must be bit-identical to the shipped kernel's on
the same lanes.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

BENCH_SRC = Path(__file__).resolve().parent / "secp_parts.cu"
CSRC = ROOT / "pybitmessage_tpu_torch" / "csrc"
PARENT_SRC = Path("pybitmessage_tpu_torch") / "csrc" / "secp256k1_kernels.cu"
BUILD = ROOT / "build" / "secp_parts"


def _nvcc(src: Path, out: Path, include: Path) -> subprocess.Popen:
    from pybitmessage_tpu_torch.ops import _build

    return subprocess.Popen(
        [_build.nvcc(), *_build._FLAGS, "-shared", "-I", str(include), "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def build(parent: Path | None) -> dict:
    """The variants' library and the parent's, built at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {"parts": (BENCH_SRC, CSRC)}
    if parent is not None:
        src = parent / PARENT_SRC
        jobs["parent"] = (src, src.parent)
    t0 = time.monotonic()
    procs = {name: _nvcc(src, BUILD / ("lib%s.so" % name), inc)
             for name, (src, inc) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        chip_smoke.require(proc.returncode == 0,
                           "nvcc %s failed:\n%s" % (name, out))
        for line in out.splitlines():
            if "registers" in line or "stack" in line:
                print("  ptxas %s: %s" % (name, line.strip()))
        libs[name] = ctypes.CDLL(str(BUILD / ("lib%s.so" % name)))
    print("built %s in %.1f s" % (", ".join(libs), time.monotonic() - t0))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", type=Path, default=None,
                        help="an earlier checkout whose secp kernels to "
                        "time beside these")
    parser.add_argument("--report", default=None)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("secp_parts_bench: no CUDA device", file=sys.stderr)
        return 2
    from pybitmessage_tpu_torch.crypto import fallback
    from pybitmessage_tpu_torch.ops import _build
    from pybitmessage_tpu_torch.ops import secp256k1_cuda as scc

    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi)
    libs = build(args.parent)
    dev = torch.device("cuda")
    stream = _build.stream(dev)
    comb = scc.comb_table(dev)
    prng = random.Random(args.seed)
    vlanes, _ = chip_smoke._verify_lanes(prng, 4096)
    elanes = chip_smoke._ecdh_lanes(prng, 4096)
    glanes = [(prng.randrange(1, fallback.N), (fallback.GX, fallback.GY))
              for _ in range(4096)]
    c_void = ctypes.c_void_p

    def verify_fn(variant, ins):
        ok = torch.empty(ins[0].shape[0], dtype=torch.uint8, device=dev)
        ptrs = [c_void(t.data_ptr()) for t in ins]
        n = ctypes.c_int(ins[0].shape[0])
        if variant == "parent":
            def launch():
                return libs["parent"].bm_secp_verify(
                    *ptrs, c_void(ok.data_ptr()), n, c_void(stream))
        elif variant == 5:
            def launch():
                return scc.secp_verify(*ins)
        else:
            def launch():
                return libs["parts"].bm_part_verify(
                    variant, *ptrs, c_void(comb.data_ptr()),
                    c_void(ok.data_ptr()), n, c_void(stream))
        return launch, lambda: [ok]

    def ecdh_fn(variant, ins):
        n = ins[0].shape[0]
        outs = [torch.empty((n, 32), dtype=torch.uint8, device=dev),
                torch.empty((n, 32), dtype=torch.uint8, device=dev),
                torch.empty(n, dtype=torch.uint8, device=dev)]
        ptrs = [c_void(t.data_ptr()) for t in ins]
        optrs = [c_void(t.data_ptr()) for t in outs]
        if variant == "parent":
            def launch():
                return libs["parent"].bm_secp_ecdh(
                    *ptrs, *optrs, ctypes.c_int(n), c_void(stream))
        elif variant == 5:
            def launch():
                return scc.secp_ecdh(*ins)
        else:
            def launch():
                return libs["parts"].bm_part_ecdh(
                    variant, *ptrs, c_void(comb.data_ptr()), *optrs,
                    ctypes.c_int(n), c_void(stream))
        return launch, lambda: outs

    variants = [1, 2, 3, 4, 5]
    if "parent" in libs:
        variants = ["parent"] + variants
    order = variants + variants[::-1]
    cases = [("secp_verify", 4096, vlanes, chip_smoke._verify_tensors,
              verify_fn),
             ("secp_verify", 65536, vlanes, chip_smoke._verify_tensors,
              verify_fn),
             ("secp_ecdh", 4096, elanes, chip_smoke._ecdh_tensors, ecdh_fn),
             ("secp_ecdh", 65536, elanes, chip_smoke._ecdh_tensors, ecdh_fn),
             ("secp_ecdh P=G", 4096, glanes, chip_smoke._ecdh_tensors,
              ecdh_fn)]
    report = {"smi": smi, "seed": args.seed, "times": {}}
    for name, count, lanes, tensors, make in cases:
        ins = tensors(lanes * (count // len(lanes)), dev)
        want = None
        readings: dict = {}
        for variant in order:
            launch, outputs = make(variant, ins)
            got = launch()
            if isinstance(got, int):
                chip_smoke.require(got == 0, "%s %s did not launch (%d)"
                                   % (name, variant, got))
            torch.cuda.synchronize()
            result = [t.clone() for t in outputs()] if variant != 5 else (
                [got] if isinstance(got, torch.Tensor) else list(got))
            if want is None and variant == 5:
                want = result
            ms = chip_smoke._event_ms(launch, 3)
            readings.setdefault(str(variant), []).append(ms)
            if variant != 5:
                readings.setdefault("_out_" + str(variant), result)
        for variant in variants:
            if variant == 5:
                continue
            got = readings.pop("_out_" + str(variant))
            chip_smoke.require(
                all(torch.equal(g, w) for g, w in zip(got, want)),
                "%s x %d: variant %s differs from the shipped kernel"
                % (name, count, variant))
        key = "%s x %d" % (name, count)
        report["times"][key] = readings
        print("%s: %s" % (key, "; ".join(
            "%s %s ms" % (v, " / ".join("%.4f" % t for t in readings[str(v)]))
            for v in variants)))
    print("every variant bit-identical to the shipped kernels")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
