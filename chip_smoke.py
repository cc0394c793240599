#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PoW send path on one CUDA card.

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases (any failure exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), compute
   capability 9.0, and the build of the kernels from ``csrc/``;
2. each kernel against its plain torch version on the card, on seeded
   inputs (hits mid-slab, no hits, always-hit pads, bases near 2^32 and
   2^64, pack 16/4/1 for the packed kernel): outputs must be
   bit-identical;
3. the main path, ``PowService(PowDispatcher())`` at network difficulty
   and at real sizes: (a) one 1 KB msg object (single-object kernel),
   (b) 128 queued objects (batch kernel), (c) a 10,000-object chan
   broadcast storm (packed kernel), (d) one tiny object (packed kernel,
   pack 1).  Every nonce is re-checked with hashlib, and for (a) and 8
   objects of (b) the plain trial over [0, nonce) proves no lower valid
   nonce exists.  Each kernel must have been launched on this path;
4. times: each kernel at its main-path slab shape (CUDA events over warm
   launches) beside its plain version and its bound; the packed kernel
   on the storm's own targets and on targets that mostly miss.

The second-to-last line of output is the ``{"kernels": [...]}`` record,
the last ``{"ok": true, "device": {...}}``.  Exits non-zero without
printing either when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import subprocess
import sys
import time

import numpy as np

#: Hopper SM issue rates, 32-bit lanes per clock (NVIDIA H100 white
#: paper; CUDA C programming guide throughput table, compute capability
#: 9.0): 64 integer lanes (shifts, logic, adds) and 64 integer
#: multiply-add lanes (IMAD, which also adds), four schedulers issuing
#: one 32-lane warp instruction each per clock
INT_ALU_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
#: HBM rate of an H100 SXM (NVIDIA data sheet), bytes/s
MEMORY_BYTES_PER_S = 3.35e12

SOURCE = "pybitmessage_tpu_torch/csrc/pow_kernels.cu"
REPLACES = {
    "search": "pybitmessage_tpu/ops/sha512_pallas.py:207",
    "batch_search": "pybitmessage_tpu/ops/sha512_pallas.py:233",
    "packed_search": "pybitmessage_tpu/ops/sha512_pallas.py:274",
}
MASK64 = (1 << 64) - 1
ALWAYS_HIT = MASK64


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def trial(nonce: int, ih: bytes) -> int:
    d = hashlib.sha512(hashlib.sha512(
        nonce.to_bytes(8, "big") + ih).digest()).digest()
    return int.from_bytes(d[:8], "big")


def ops_per_trial() -> tuple[int, int]:
    """32-bit integer instructions one double-SHA512 trial needs on
    Hopper, for the kernels' bound, as (shifts and logic, adds).

    A u64 word is two 32-bit halves.  A word is one of three kinds:
    ``var`` changes with the nonce (the nonce and all it feeds); ``obj``
    is fixed for an object (its initial-hash words, and what only they
    and constants feed: sigma0 of w1..w8, the schedule words w17, w19
    and w21), so it is computed once per object, not per trial; a
    constant is known when the kernel is compiled (padding, lengths, K,
    H0).  Only operations on ``var`` words are counted, and the ``obj``
    and constant terms of a sum fold into one term:

    * a rotate is 2 funnel shifts; Sigma0/Sigma1 are 3 rotates plus a
      3-input xor (1 LOP3 per half): 8; sigma0/sigma1 are 2 rotates, a
      shift (2) and a LOP3 per half: 8;
    * ch and maj are 1 LOP3 per half: 2;
    * a sum of t terms is 2*ceil((t-1)/2): IADD3 adds three terms per
      half and carries two bits into the high half's IADD3.X.

    Shifts and logic run on the integer ALU only; an add can also issue
    as an IMAD.  Only the first output word of the second compression is
    needed.
    """
    shift_logic = adds = 0
    var = ("var", False)
    obj = ("obj", False)

    def const(zero: bool = False):
        return ("const", zero)

    def add(*terms):
        nonlocal adds
        n_var = sum(1 for t in terms if t[0] == "var")
        folded = any(t[0] == "obj" or (t[0] == "const" and not t[1])
                     for t in terms)
        if n_var == 0:
            if any(t[0] == "obj" for t in terms):
                return obj
            return const(all(t[1] for t in terms))
        t = n_var + folded
        adds += 2 * (t // 2) if t >= 2 else 0
        return var

    def mix(*words, cost: int):
        nonlocal shift_logic
        if any(w[0] == "var" for w in words):
            shift_logic += cost
            return var
        return obj if any(w[0] == "obj" for w in words) else const()

    def compress(w, outputs):
        w = list(w)
        a = b = c = d = e = f = g = h = const()
        for t in range(80):
            if t >= 16:
                w[t % 16] = add(mix(w[(t - 2) % 16], cost=8),
                                w[(t - 7) % 16],
                                mix(w[(t - 15) % 16], cost=8), w[t % 16])
            t1 = add(h, mix(e, cost=8), mix(e, f, g, cost=2), const(),
                     w[t % 16])
            new_a = add(t1, mix(a, cost=8), mix(a, b, c, cost=2))
            h, g, f, e, d, c, b, a = g, f, e, add(d, t1), c, b, a, new_a
        return [add(const(), s) for s in (a, b, c, d, e, f, g, h)[:outputs]]

    block1 = [var] + [obj] * 8 + [const()] + [const(True)] * 5 + [const()]
    block2 = compress(block1, 8) + [const()] + [const(True)] * 6 + [const()]
    compress(block2, 1)
    return shift_logic, adds


def trial_seconds_bound(env: dict) -> float:
    """Least card time per trial: shifts and logic need the integer ALU
    (64 lanes a clock per SM); adds can share it with the IMAD lanes,
    and all of it passes the schedulers' 128 lanes a clock."""
    shift_logic, adds = env["ops_per_trial"]
    lanes_per_s = env["sms"] * env["clock_mhz"] * 1e6
    return max(shift_logic / (INT_ALU_LANES_PER_SM * lanes_per_s),
               (shift_logic + adds) / (ISSUE_LANES_PER_SM * lanes_per_s))


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_environment() -> dict:
    import torch

    from pybitmessage_tpu_torch.ops import _build

    smi = nvidia_smi("name,power.limit")
    print(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print("device: %s, capability %d.%d, torch %s, CUDA %s"
          % (name, cap[0], cap[1], torch.__version__, torch.version.cuda))
    require(cap == (9, 0), "compute capability 9.0 (sm_90a), got %r" % (cap,))
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.monotonic()
    _build.load()
    load_s = time.monotonic() - t0
    info = _build.build_info
    print("kernels: %s (%.1f s; nvcc %.1f s)" % (
        "built" if info["built"] else "loaded up to date", load_s,
        info["seconds"]))
    for line in info["ptxas"]:
        print("  ptxas: " + line)
    env = {"smi": smi, "name": name, "sms": sms, "clock_mhz": clock_mhz,
           "ops_per_trial": ops_per_trial(), "build_seconds": load_s,
           "ptxas": info["ptxas"], "sass": sass_histogram()}
    print("bound: %d shift/logic + %d add instructions per trial on %d SMs "
          "at %.0f MHz -> %.4g trials/s" % (
              *env["ops_per_trial"], sms, clock_mhz,
              1 / trial_seconds_bound(env)))
    return env


def sass_histogram() -> dict:
    """Instructions per kernel in the built library, by opcode (what
    the compiler made of the trial); empty without cuobjdump."""
    from pathlib import Path

    from pybitmessage_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("cuobjdump not found: no SASS histogram")
        return {}
    out = subprocess.run([str(tool), "-sass",
                          str(_build.BUILD_DIR / _build.LIB_NAME)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    kernels: dict = {}
    current = None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            current = kernels.setdefault(
                next((k for k in REPLACES if "bm_%s_kernel" % k in name),
                     name), {})
        elif current is not None and line.strip().startswith("/*") \
                and "*/" in line:
            text = line.split("*/", 1)[1].strip().rstrip(";").strip()
            if text.startswith("@"):
                text = text.split(None, 1)[1] if " " in text else text
            if text:
                op = text.split()[0].split(".")[0].rstrip(";")
                current[op] = current.get(op, 0) + 1
    for name, hist in kernels.items():
        top = sorted(hist.items(), key=lambda kv: -kv[1])[:8]
        print("SASS %s: %d instructions; %s" % (
            name, sum(hist.values()),
            ", ".join("%s %d" % kv for kv in top)))
    return kernels


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _objects(rng, n: int, n_trials: int):
    """Seeded initial hashes, bases and targets covering the edge cases:
    hits mid-slab, no hit, always-hit pads, bases near 2^32 and 2^64."""
    ihs, bases, targets = [], [], []
    for i in range(n):
        ihs.append(rng.bytes(64))
        kind = i % 5
        base = int(rng.integers(0, 1 << 40))
        target = (1 << 64) // max(1, n_trials // 3)      # hit mid-slab
        if kind == 1:
            target = (1 << 64) // (n_trials * 4096)       # no hit
        elif kind == 2:
            target = ALWAYS_HIT                           # pad slot
        elif kind == 3:
            base = (1 << 32) - int(rng.integers(1, n_trials))
        elif kind == 4:
            base = (1 << 64) - int(rng.integers(1, n_trials))
        bases.append(base)
        targets.append(target)
    return ihs, bases, targets


def _tensors(ihs, bases, targets, device):
    import torch

    from pybitmessage_tpu_torch.ops.u64 import to_i64, words_from_bytes
    return (torch.tensor([words_from_bytes(ih) for ih in ihs],
                         dtype=torch.int64, device=device),
            torch.tensor([to_i64(b) for b in bases], dtype=torch.int64,
                         device=device),
            torch.tensor([to_i64(t) for t in targets], dtype=torch.int64,
                         device=device))


def _same(name: str, got, want, ihs, targets, step_rows) -> int:
    """Require bit-identical outputs and hashlib-valid hits; returns
    the max |kernel - plain| over the outputs (0)."""
    import torch
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "%s differs from its plain version (max |diff| %d)" % (name, err))
    if step_rows:
        for i, row in enumerate(got[0].tolist()):
            if row[0]:
                nonce = (row[1] << 32) | row[2]
                require(trial(nonce, ihs[i]) <= targets[i],
                        "%s returned an invalid nonce" % name)
    return err


def phase_compare(rng) -> dict:
    import torch

    from pybitmessage_tpu_torch.ops import sha512_cuda as sc
    from pybitmessage_tpu_torch.ops.u64 import words_from_bytes

    dev = torch.device("cuda")
    errs = {"search": 0, "batch_search": 0, "packed_search": 0}
    cases = 0
    # kernel 1: one object per case, slab rows 128 x 8 chunks x unroll 5
    rows, chunks, unroll = 128, 8, 5
    n = rows * 128 * unroll * chunks
    ihs, bases, targets = _objects(rng, 5, n)
    for ih, base, target in zip(ihs, bases, targets):
        words = torch.tensor(words_from_bytes(ih), dtype=torch.int64,
                             device=dev)
        got = sc.cuda_search(words, base, target, rows=rows, chunks=chunks,
                             unroll=unroll)
        want = sc.search_ref(words, base, target, rows=rows, chunks=chunks,
                             unroll=unroll)
        errs["search"] = max(errs["search"], _same(
            "cuda_search", got, want, [ih], [target], False))
        found, nonce = (t.cpu().tolist() for t in got)
        if any(found):
            step = found.index(1)
            value = (nonce[step][0] << 32) | nonce[step][1]
            require(trial(value, ih) <= target, "cuda_search invalid nonce")
        cases += 1
    # kernel 2: 64 objects, rows 128 x 8 chunks x unroll 4
    rows, chunks, unroll = 128, 8, 4
    n = rows * 128 * unroll * chunks
    ihs, bases, targets = _objects(rng, 64, n)
    args = _tensors(ihs, bases, targets, dev)
    got = sc.cuda_batch_search(*args, rows=rows, chunks=chunks, unroll=unroll)
    want = sc.batch_search_ref(*args, rows=rows, chunks=chunks, unroll=unroll)
    errs["batch_search"] = _same("cuda_batch_search", [got], [want], ihs,
                                 targets, True)
    # again with every object hitting: the launch ends once all have
    targets = [max(t, (1 << 64) // max(1, n // 3)) for t in targets]
    args = _tensors(ihs, bases, targets, dev)
    got = sc.cuda_batch_search(*args, rows=rows, chunks=chunks, unroll=unroll)
    want = sc.batch_search_ref(*args, rows=rows, chunks=chunks, unroll=unroll)
    errs["batch_search"] = max(errs["batch_search"], _same(
        "cuda_batch_search (all hit)", [got], [want], ihs, targets, True))
    cases += 128
    # kernel 3: pack 16, 4 and 1 at rows 128 x 8 chunks
    for pack, n_obj, unroll in ((16, 64, 1), (4, 16, 2), (1, 4, 1)):
        chunks = 8
        n = 128 // pack * 128 * unroll * chunks
        ihs, bases, targets = _objects(rng, n_obj, n)
        args = _tensors(ihs, bases, targets, dev)
        got = sc.cuda_packed_search(*args, rows=128, chunks=chunks,
                                    pack=pack, unroll=unroll)
        want = sc.packed_search_ref(*args, rows=128, chunks=chunks,
                                    pack=pack, unroll=unroll)
        errs["packed_search"] = max(errs["packed_search"], _same(
            "cuda_packed_search pack %d" % pack, [got], [want], ihs,
            targets, True))
        cases += n_obj
    torch.cuda.synchronize()
    print("compare: %d objects, kernels bit-identical to plain versions"
          % cases)
    return errs


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _msg(rng, length: int, ttl: int, ntpb: int = 1000, extra: int = 1000,
         clamp: bool = True):
    """(initial_hash, target) of an object of ``length`` bytes (nonce
    included), as the sender computes them."""
    from pybitmessage_tpu_torch.models.pow_math import (pow_initial_hash,
                                                        pow_target)
    sans_nonce = rng.bytes(length - 8)
    return (pow_initial_hash(sans_nonce),
            pow_target(length, ttl, ntpb, extra, clamp=clamp))


def _no_lower_nonce(ih: bytes, target: int, nonce: int) -> None:
    """Plain trial over [0, nonce) on the card: nothing may hit."""
    import torch

    from pybitmessage_tpu_torch.ops.sha512 import (initial_hash_words,
                                                   trial_values)
    from pybitmessage_tpu_torch.ops.u64 import le_u, to_i64

    words = initial_hash_words(ih, "cuda")
    chunk = 1 << 23
    t = to_i64(target)
    for start in range(0, nonce, chunk):
        values, _ = trial_values(start, words, min(chunk, nonce - start))
        require(not bool(le_u(values, t).any()),
                "a valid nonce below %d exists" % nonce)
    torch.cuda.synchronize()


def phase_main_path(rng) -> dict:
    from pybitmessage_tpu_torch.ops import sha512_cuda as sc
    from pybitmessage_tpu_torch.pow.dispatcher import PowDispatcher
    from pybitmessage_tpu_torch.pow.service import PowService

    day = 86400
    phases = {
        "a_single_1kB": [_msg(rng, 1016, 4 * day)],
        "b_queue_128": [_msg(rng, int(rng.integers(100, 8193)),
                             int(rng.integers(3600, 4 * day + 1)))
                        for _ in range(128)],
        "c_storm_10k": [_msg(rng, 116, 3600, 10, 10, clamp=False)
                        for _ in range(10000)],
        "d_tiny": [_msg(rng, 116, 3600, 10, 10, clamp=False)],
    }
    expect = {"a_single_1kB": ("cuda", "search"),
              "b_queue_128": ("cuda-batch", "batch_search"),
              "c_storm_10k": ("cuda-batch", "packed_search"),
              "d_tiny": ("cuda-batch", "packed_search")}
    dispatcher = PowDispatcher()
    report: dict = {}

    async def drive():
        service = PowService(dispatcher)
        service.start()
        try:
            for name, items in phases.items():
                before = dict(sc.LAUNCHES)
                t0 = time.perf_counter()
                results = await asyncio.gather(
                    *(service.solve(ih, t) for ih, t in items))
                wall = time.perf_counter() - t0
                backend, kernel = expect[name]
                delta = {k: sc.LAUNCHES[k] - before[k] for k in before}
                require(dispatcher.last_backend == backend,
                        "%s ran on %r, expected %r"
                        % (name, dispatcher.last_backend, backend))
                require(delta[kernel] > 0,
                        "%s launched no %s kernel" % (name, kernel))
                for (ih, target), (nonce, _) in zip(items, results):
                    require(trial(nonce, ih) <= target,
                            "%s: invalid nonce %d" % (name, nonce))
                trials = sum(r[1] for r in results)
                report[name] = {
                    "objects": len(items), "wall_s": wall,
                    "objects_per_s": len(items) / wall,
                    "credited_trials": trials,
                    "expected_trials": sum((1 << 64) / t for _, t in items),
                    "backend": dispatcher.last_backend, "launches": delta,
                    "results": results}
                print("main path %s: %d objects in %.3f s (%.1f obj/s), "
                      "%d credited trials, launches %s"
                      % (name, len(items), wall, len(items) / wall, trials,
                         delta))
        finally:
            await service.stop()

    sc.reset_launches()
    asyncio.run(drive())
    launches = dict(sc.LAUNCHES)
    for kernel, count in launches.items():
        require(count > 0, "kernel %s not launched on the main path" % kernel)

    t0 = time.perf_counter()
    (ih, target), = phases["a_single_1kB"]
    _no_lower_nonce(ih, target, report["a_single_1kB"]["results"][0][0])
    sample = rng.choice(128, size=8, replace=False)
    for i in sample:
        ih, target = phases["b_queue_128"][i]
        _no_lower_nonce(ih, target, report["b_queue_128"]["results"][i][0])
    print("lowest-nonce proof: (a) and 8 objects of (b) have no valid "
          "nonce below theirs (%.1f s)" % (time.perf_counter() - t0))
    for entry in report.values():
        entry.pop("results")
    return {"phases": report, "launches": launches}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def _event_ms(fn, reps: int) -> float:
    import torch
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _main_shape_objects(rng, n_obj: int, n_trials: int):
    """Inputs for a launch at a main-path shape: objects without a hit
    in the launch (their whole range runs) plus, with four or more
    objects, a mid-range hit, an always-hit pad and hits past a base
    near 2^32 and near 2^64.  One object gets a target whose mean work
    is one launch."""
    ihs = [rng.bytes(64) for _ in range(n_obj)]
    bases = [int(rng.integers(0, 1 << 40)) for _ in range(n_obj)]
    miss = (1 << 64) // (n_trials * 4096)
    mid = (1 << 64) // max(1, n_trials // 2)
    targets = [miss] * n_obj
    if n_obj == 1:
        targets[0] = (1 << 64) // n_trials
    else:
        targets[0] = mid
        targets[1] = ALWAYS_HIT
        bases[2], targets[2] = (1 << 32) - n_trials // 8, mid
        bases[3], targets[3] = (1 << 64) - n_trials // 8, mid
    return ihs, bases, targets


def _needed_trials(rows, bases, n_trials: int) -> int:
    """Trials the data needs: up to and including each object's lowest
    hit, the whole range for an object without one."""
    total = 0
    for (step1, hi, lo), base in zip(rows, bases):
        total += ((((hi << 32) | lo) - base) & MASK64) + 1 if step1 \
            else n_trials
    return total


def _storm_objects(rng, n_obj: int):
    """Inputs of a packed launch in the storm (c): 116 B objects, TTL 1 h,
    ntpb = extra = 10, each searched from nonce 0."""
    objs = [_msg(rng, 116, 3600, 10, 10, clamp=False) for _ in range(n_obj)]
    return [ih for ih, _ in objs], [0] * n_obj, [t for _, t in objs]


def phase_times(rng, env: dict, launches: dict, errs: dict) -> list:
    """Each kernel at its main-path shape against its plain version on
    the same inputs: bit-identical outputs, CUDA-event times over warm
    launches, and the bound for the work these inputs need.

    The packed kernel runs twice: on the storm's own targets (its entry
    in the kernels line: what the main path gives it) and on targets
    that mostly miss (its rate when every slot is hashed)."""
    import torch

    from pybitmessage_tpu_torch.ops import sha512_cuda as sc

    dev = torch.device("cuda")
    packed = dict(rows=sc.DEFAULT_ROWS, chunks=64, pack=16, unroll=1)
    cases = [
        ("search", "miss", dict(rows=sc.DEFAULT_ROWS,
                                chunks=sc.DEFAULT_CHUNKS,
                                unroll=sc.DEFAULT_UNROLL), 1),
        ("batch_search", "miss", dict(rows=sc.DEFAULT_ROWS,
                                      chunks=sc.BATCH_CHUNKS,
                                      unroll=sc.BATCH_UNROLL),
         sc.BATCH_OBJS),
        ("packed_search", "storm", packed, 64 * 16),
        ("packed_search", "miss", packed, 64 * 16),
    ]
    kernels = []
    for name, inputs, shape, n_obj in cases:
        per_step = shape["rows"] // shape.get("pack", 1) * 128 \
            * shape["unroll"]
        n_trials = per_step * shape["chunks"]
        if inputs == "storm":
            ihs, bases, targets = _storm_objects(rng, n_obj)
        else:
            ihs, bases, targets = _main_shape_objects(rng, n_obj, n_trials)
        args = _tensors(ihs, bases, targets, dev)
        if name == "search":
            words = args[0][0].contiguous()

            def kernel():
                return sc.cuda_search(words, bases[0], targets[0], **shape)

            def plain():
                return sc.search_ref(words, bases[0], targets[0], **shape)
        else:
            wrapper = getattr(sc, "cuda_" + name)
            ref = getattr(sc, name + "_ref")

            def kernel():
                return wrapper(*args, **shape)

            def plain():
                return ref(*args, **shape)
        got = kernel()                              # warm
        ms = _event_ms(kernel, 5)
        plain_ms = _event_ms(plain, 1)
        want = plain()
        if name == "search":
            err = _same(name, got, want, ihs, targets, False)
            found, nonce = (t.cpu().tolist() for t in want)
            step1 = found.index(1) + 1 if any(found) else 0
            rows = [(step1, *(nonce[step1 - 1] if step1 else (0, 0)))]
        else:
            err = _same(name, [got], [want], ihs, targets, True)
            rows = want.cpu().tolist()
        trials = _needed_trials(rows, bases, n_trials)
        ops_ms = trials * trial_seconds_bound(env) * 1e3
        io_bytes = n_obj * (8 * 8 + 8 + 8) + n_obj * 3 * 8
        bytes_ms = io_bytes / MEMORY_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        print("time %s (%s targets) %s x %d objects: %.3f ms/launch "
              "(%d trials needed, %.4g trials/s), plain %.1f ms, "
              "bound %.3f ms (%.1f%%)"
              % (name, inputs, shape, n_obj, ms, trials, trials / ms * 1e3,
                 plain_ms, bound_ms, bound_ms / ms * 100))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(err, errs[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "inputs": inputs, "trials": trials,
            "trials_per_s": trials / ms * 1e3,
            "shape": dict(shape, objects=n_obj)})
    # the kernels line holds each kernel once, at the main path's inputs
    for entry in kernels:
        entry["main"] = not (entry["name"] == "packed_search"
                             and entry["inputs"] == "miss")
        if entry["name"] == "packed_search":
            entry["max_abs_err"] = max(
                e["max_abs_err"] for e in kernels
                if e["name"] == "packed_search")
    return kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", default=None,
                        help="also write the full record as JSON here")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import pybitmessage_tpu_torch  # noqa: F401  (the port must be present)

    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    env = phase_environment()
    errs = phase_compare(rng)
    main_path = phase_main_path(rng)
    kernels = phase_times(rng, env, main_path["launches"], errs)
    wall = time.perf_counter() - t_start
    print("chip_smoke wall %.1f s" % wall)
    if args.report:
        with open(args.report, "w") as fh:
            json.dump({"env": env, "main_path": main_path,
                       "kernels": kernels, "wall_s": wall}, fh, indent=1)
    print(json.dumps({"kernels": [
        {k: v for k, v in entry.items()
         if k not in ("inputs", "trials", "trials_per_s", "shape", "main")}
        for entry in kernels if entry["main"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
