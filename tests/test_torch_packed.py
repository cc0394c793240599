"""The packed kernel's per-object claims, held to its contract on the CPU.

``csrc/packed_claims.cuh`` holds every decision a block of
``bm_packed_search_kernel`` makes (which object, which offsets, when to
move on), with the launch's atomics passed in.  ``packed_claims_sim.cpp``
builds it with g++ and runs many simulated blocks ("claimers") over
shared words in a seeded random interleaving, optionally with stale
reads; every run must give ``packed_search_ref``'s rows: the lowest hit
of each object.
"""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pybitmessage_tpu_torch.ops import sha512_cuda
from pybitmessage_tpu_torch.ops.u64 import to_i64, words_from_bytes

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pybitmessage_tpu_torch" / "csrc"
MASK64 = (1 << 64) - 1
#: the test geometry: rows 32 / pack 16 * 128 lanes = 256 offsets a step,
#: 2 steps: n = 512 offsets (two claims of 256) an object
ROWS, PACK, CHUNKS = 32, 16, 2
N = ROWS // PACK * sha512_cuda.LANE_COLS * CHUNKS
#: offsets a claim (csrc/packed_claims.cuh kBmClaim)
CLAIM = 256
COUNTERS = 5


def _trial(nonce: int, ih: bytes) -> int:
    d = hashlib.sha512(hashlib.sha512(
        (nonce & MASK64).to_bytes(8, "big") + ih).digest()).digest()
    return int.from_bytes(d[:8], "big")


def _mean(trials: int) -> int:
    """The target whose mean work is ``trials``."""
    return (1 << 64) // trials


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """packed_claims_sim.cpp compiled by g++ into a ctypes library."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    lib_path = tmp_path_factory.mktemp("packed_sim") / "libpackedsim.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(lib_path),
                    str(Path(__file__).with_name("packed_claims_sim.cpp"))],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.bm_sim_packed.restype = ctypes.c_uint64
    lib.bm_sim_packed.argtypes = [u64p, u64p, u64p] + [ctypes.c_uint64] * 4 \
        + [ctypes.c_uint, u64p, u64p]
    return lib


# ---------------------------------------------------------------------------
# edge-case objects, built and checked with hashlib
# ---------------------------------------------------------------------------


def _first_hit(ih: bytes, target: int, start: int, limit: int = 1 << 16):
    for off in range(limit):
        if _trial(start + off, ih) <= target:
            return (start + off) & MASK64
    raise AssertionError("no hit within %d trials" % limit)


def _edge_objects(rng, n: int):
    """(name, ih, base, target) for each edge case of the contract."""
    edges = []

    ih = rng.bytes(64)
    target = _mean(64)
    edges.append(("hit at 0", ih, _first_hit(ih, target, 1 << 20), target))

    # last slot: a hit whose previous hit lies n or more nonces before it
    ih, target = rng.bytes(64), _mean(4 * n)
    prev = nonce = 1 << 24
    while True:
        nonce = _first_hit(ih, target, nonce + 1)
        if nonce - prev >= n:
            break
        prev = nonce
    edges.append(("hit in the last slot", ih, nonce - (n - 1), target))

    # two hits in one round of 32, the lower one not at its start
    ih, target = rng.bytes(64), _mean(8)
    base = 1 << 28
    while True:
        hits = [off for off in range(32) if _trial(base + off, ih) <= target]
        if len(hits) >= 2 and hits[0] > 0:
            break
        base += 32
    edges.append(("two hits in a round", ih, base, target))

    edges.append(("no hit", rng.bytes(64), 1 << 30, 1))
    edges.append(("base near 2^32", rng.bytes(64), (1 << 32) - 3,
                  _mean(64)))
    edges.append(("base near 2^64", rng.bytes(64), MASK64 - 2, _mean(64)))
    edges.append(("pad", rng.bytes(64), 0, MASK64))
    return edges


def _objects(seed: int, count: int, n: int = N):
    """The edge cases first, then objects hitting about a third into
    their range or, one in three, mostly missing."""
    rng = np.random.default_rng(seed)
    objs = [obj[1:] for obj in _edge_objects(rng, n)]
    while len(objs) < count:
        mean = 4 * n if len(objs) % 3 == 0 else n // 3
        objs.append((rng.bytes(64), int(rng.integers(0, 1 << 40)),
                     _mean(mean)))
    return objs[:count]


def _tensors(objs):
    return (torch.tensor([words_from_bytes(ih) for ih, _, _ in objs],
                         dtype=torch.int64),
            torch.tensor([to_i64(b) for _, b, _ in objs], dtype=torch.int64),
            torch.tensor([to_i64(t) for _, _, t in objs], dtype=torch.int64))


def _simulate(lib, objs, n, claimers, seed, stale):
    """(best offsets with -1 for none, counters) of one simulated launch."""
    u64 = ctypes.c_uint64
    ih = (u64 * (8 * len(objs)))(*[w & MASK64 for ih, _, _ in objs
                                   for w in words_from_bytes(ih)])
    bases = (u64 * len(objs))(*[b for _, b, _ in objs])
    targets = (u64 * len(objs))(*[t for _, _, t in objs])
    best = (u64 * len(objs))()
    counters = (u64 * COUNTERS)()
    lib.bm_sim_packed(ih, bases, targets, len(objs), n, claimers, seed,
                      stale, best, counters)
    return (torch.tensor([to_i64(b) for b in best], dtype=torch.int64),
            dict(zip(sha512_cuda.PACKED_COUNTERS, counters)))


def _needed_rounds(best: torch.Tensor, n: int, unit: int = 32) -> int:
    """Rounds of 32 in the claims of ``unit`` offsets up to each object's
    lowest hit (all its rounds, without one)."""
    return sum(min((b // unit + 1) * unit, n) // 32 if b >= 0 else n // 32
               for b in best.tolist())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_edge_objects_are_what_they_claim():
    """The constructed cases hold in the plain version's rows."""
    objs = _objects(5, 7)
    ih, bases, targets = _tensors(objs)
    rows = sha512_cuda.packed_search_ref(ih, bases, targets, rows=ROWS,
                                         chunks=CHUNKS, pack=PACK)
    offs = [((((hi << 32) | lo) - base) & MASK64) if step else None
            for (step, hi, lo), (_, base, _) in zip(rows.tolist(), objs)]
    assert offs[0] == 0
    assert offs[1] == N - 1
    ih2, base2, t2 = objs[2]
    hits = [o for o in range(32) if _trial(base2 + o, ih2) <= t2]
    assert len(hits) >= 2 and offs[2] == hits[0] > 0
    assert offs[3] is None
    assert offs[6] == 0
    for (step, hi, lo), (ih, _, target) in zip(rows.tolist(), objs):
        if step:
            assert _trial((hi << 32) | lo, ih) <= target


@pytest.mark.parametrize("stale", [0, 4])
@pytest.mark.parametrize("claimers", [1, 5, 32, 96])
@pytest.mark.parametrize("rows,chunks", [(ROWS, CHUNKS), (16, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_claims_give_the_plain_rows(sim, seed, rows, chunks, claimers,
                                    stale):
    """32 objects (2 groups of 16), one to three claimers per object,
    fresh and stale reads, ranges of two claims and of one and a half
    (n = 384): the rows are packed_search_ref's, and every claim was
    either hashed or found its object finished."""
    n = rows // PACK * sha512_cuda.LANE_COLS * chunks
    objs = _objects(seed, 32, n)
    ih, bases, targets = _tensors(objs)
    best, counters = _simulate(sim, objs, n, claimers,
                               100 * seed + claimers, stale)
    step = rows // PACK * sha512_cuda.LANE_COLS
    want = sha512_cuda.packed_search_ref(ih, bases, targets, rows=rows,
                                         chunks=chunks, pack=PACK)
    assert torch.equal(sha512_cuda._rows(best, bases, step), want)
    assert counters["claims"] >= counters["skipped_rounds"]
    assert counters["hashed_rounds"] >= _needed_rounds(best, n)
    assert counters["solved"] == int((best >= 0).sum())


@pytest.mark.parametrize("claimers", [1, 8, 64])
def test_claims_one_object_alone(sim, claimers):
    """pack 1: one object, every claimer on it."""
    rng = np.random.default_rng(claimers)
    n = 4 * sha512_cuda.LANE_COLS * 2              # rows 4, pack 1, 2 steps
    for ih, base, target in [(rng.bytes(64), 7, _mean(n // 2)),
                             (rng.bytes(64), MASK64 - 40, _mean(n // 3)),
                             (rng.bytes(64), 0, 1)]:
        objs = [(ih, base, target)]
        t_ih, t_bases, t_targets = _tensors(objs)
        best, _ = _simulate(sim, objs, n, claimers, claimers, 2)
        want = sha512_cuda.packed_search_ref(t_ih, t_bases, t_targets,
                                             rows=4, chunks=2, pack=1)
        assert torch.equal(sha512_cuda._rows(best, t_bases, n // 2), want)


def test_one_claimer_hashes_exactly_the_needed_claims(sim):
    """A lone claimer with fresh reads wastes nothing: it hashes each
    object's claims up to the one with its hit (all claims without one),
    makes one claim more per object, which finds it finished, and picks
    each object once."""
    objs = _objects(7, 16)
    best, counters = _simulate(sim, objs, N, 1, 0, 0)
    assert counters["hashed_rounds"] == _needed_rounds(best, N, CLAIM)
    assert counters["skipped_rounds"] == len(objs)
    assert counters["switches"] == len(objs)
    assert counters["claims"] == (counters["skipped_rounds"]
                                  + _needed_rounds(best, N, CLAIM)
                                  // (CLAIM // 32))
