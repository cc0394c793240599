"""The PyTorch port held against the JAX package on the same inputs.

Inputs are made with numpy from a seed and fed to both packages: the
JAX side takes (..., 2) uint32 (hi, lo) pairs, the port the int64 words
``from_reference_pairs`` makes of them.  The JAX functions run on the
CPU (the Pallas kernels themselves are too slow in interpret mode for
this gate; their XLA stand-in ``_packed_search_xla`` and the jitted
``pow_search_jit`` carry the same output contracts).  All JAX calls here
share three compiled shapes.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybitmessage_tpu.ops import pow_search as jax_pow_search
from pybitmessage_tpu.ops.sha512_jax import double_sha512_trial as jax_trial
from pybitmessage_tpu.pow import dispatcher as jax_dispatcher
from pybitmessage_tpu.pow import pipeline as jax_pipeline
from pybitmessage_tpu_torch.ops import pow_search, sha512_cuda
from pybitmessage_tpu_torch.ops.sha512 import (double_sha512_trial,
                                               initial_hash_words,
                                               sha512_block)
from pybitmessage_tpu_torch.ops.u64 import (from_i64, from_reference_pairs,
                                            to_i64, to_reference_pairs)
from pybitmessage_tpu_torch.pow import pipeline
from pybitmessage_tpu_torch.pow.dispatcher import PowDispatcher

#: one slab geometry for every JAX comparison: 8 objects, 8 chunks of
#: 256 lanes (so the JAX programs compile once per test worker)
N_OBJ, LANES, CHUNKS = 8, 256, 8
#: mean 1024 trials: most objects hit inside a 2048-trial slab
EASY = 1 << 54


def _pairs(values):
    return np.array([[(v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF]
                     for v in values], dtype=np.uint32)


def _host_trial(nonce: int, ih: bytes) -> int:
    d = hashlib.sha512(hashlib.sha512(
        nonce.to_bytes(8, "big") + ih).digest()).digest()
    return int.from_bytes(d[:8], "big")


@pytest.fixture(scope="module")
def objects():
    """Seeded objects covering mid-slab hits, no hits, an always-hit pad
    and bases that carry past 2^32 and wrap past 2^64."""
    rng = np.random.default_rng(7)
    ih = rng.integers(0, 1 << 32, size=(N_OBJ, 8, 2), dtype=np.uint32)
    bases = [0, 5000, (1 << 32) - 700, (1 << 64) - 900, 123456789,
             1 << 63, 77, (1 << 64) - 1]
    targets = [EASY, EASY, EASY, EASY, 1 << 40, (1 << 64) - 1, EASY << 1,
               EASY]
    return ih, _pairs(bases), _pairs(targets)


@pytest.fixture(scope="module")
def jax_rows(objects):
    ih, bases, targets = objects
    return np.asarray(jax_pipeline._packed_search_xla(
        jnp.asarray(ih), jnp.asarray(bases), jnp.asarray(targets),
        lanes=LANES, chunks=CHUNKS))


def _port(objects):
    return tuple(from_reference_pairs(a) for a in objects)


# ---------------------------------------------------------------------------
# (i) SHA-512
# ---------------------------------------------------------------------------


def test_u64_state_conversion_round_trips():
    rng = np.random.default_rng(1)
    pairs = rng.integers(0, 1 << 32, size=(3, 8, 2), dtype=np.uint32)
    words = from_reference_pairs(pairs)
    assert words.dtype == torch.int64 and tuple(words.shape) == (3, 8)
    assert np.array_equal(to_reference_pairs(words), pairs)
    for v in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1):
        assert from_i64(to_i64(v)) == v
        assert from_i64(from_reference_pairs(_pairs([v]))[0]) == v


def test_trial_matches_jax_and_hashlib():
    rng = np.random.default_rng(2)
    nonces = [0, (1 << 32) - 1, 1 << 32, 1 << 63, (1 << 64) - 1]
    nonces += [int(x) for x in rng.integers(0, 1 << 63, size=11,
                                            dtype=np.int64)]
    ih = hashlib.sha512(b"port parity").digest()
    words = initial_hash_words(ih)
    got = double_sha512_trial(
        torch.tensor([to_i64(n) for n in nonces]), words)
    ih_pairs = to_reference_pairs(words)
    n_pairs = _pairs(nonces)
    v_hi, v_lo = jax.jit(jax_trial)(
        jnp.asarray(n_pairs[:, 0]), jnp.asarray(n_pairs[:, 1]),
        jnp.asarray(ih_pairs[:, 0]), jnp.asarray(ih_pairs[:, 1]))
    ref = to_reference_pairs(got)
    assert np.array_equal(ref[:, 0], np.asarray(v_hi))
    assert np.array_equal(ref[:, 1], np.asarray(v_lo))
    assert [from_i64(v) for v in got.tolist()] == [
        _host_trial(n, ih) for n in nonces]


def test_sha512_block_is_the_fips_compression():
    # SHA512("abc") is one compression of its padded block
    block = b"abc" + b"\x80" + b"\x00" * 108 + (24).to_bytes(16, "big")
    w = torch.tensor([to_i64(int.from_bytes(block[i:i + 8], "big"))
                      for i in range(0, 128, 8)])
    out = sha512_block(w)
    digest = b"".join(from_i64(v).to_bytes(8, "big") for v in out.tolist())
    assert digest == hashlib.sha512(b"abc").digest()


# ---------------------------------------------------------------------------
# (ii) the plain versions of the three kernels
# ---------------------------------------------------------------------------


def _as_u32(rows: torch.Tensor) -> np.ndarray:
    a = rows.numpy()
    assert a.min() >= 0 and a.max() < (1 << 32)
    return a.astype(np.uint32)


def _kernel_rows(xla_rows: np.ndarray) -> np.ndarray:
    """The XLA stand-in leaves the base nonce in a row without a hit;
    the Pallas kernels, and so the CUDA kernels, write zeros there."""
    rows = xla_rows.copy()
    rows[rows[:, 0] == 0] = 0
    return rows


def test_packed_search_ref_matches_xla(objects, jax_rows):
    assert jax_rows[:, 0].any() and not jax_rows[:, 0].all()
    ih, bases, targets = _port(objects)
    got = pipeline._packed_search_ref(ih, bases, targets, lanes=LANES,
                                      chunks=CHUNKS)
    assert np.array_equal(_as_u32(got), jax_rows)


@pytest.mark.parametrize("rows,pack,unroll", [(16, 8, 1), (4, 2, 1),
                                              (8, 8, 2), (1, 1, 2)])
def test_packed_kernel_plain_version_matches_xla(objects, jax_rows, rows,
                                                 pack, unroll):
    ih, bases, targets = _port(objects)
    assert rows // pack * 128 * unroll == LANES
    got = sha512_cuda.packed_search_ref(ih, bases, targets, rows=rows,
                                        chunks=CHUNKS, pack=pack,
                                        unroll=unroll)
    assert np.array_equal(_as_u32(got), _kernel_rows(jax_rows))
    # the wrapper takes the plain version because the tensors are on the CPU
    via_wrapper = sha512_cuda.cuda_packed_search(
        ih, bases, targets, rows=rows, chunks=CHUNKS, pack=pack,
        unroll=unroll)
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("rows,unroll", [(2, 1), (1, 2)])
def test_batch_kernel_plain_version_matches_xla(objects, jax_rows, rows,
                                                unroll):
    ih, bases, targets = _port(objects)
    got = sha512_cuda.batch_search_ref(ih, bases, targets, rows=rows,
                                       chunks=CHUNKS, unroll=unroll)
    assert np.array_equal(_as_u32(got), _kernel_rows(jax_rows))
    assert torch.equal(sha512_cuda.cuda_batch_search(
        ih, bases, targets, rows=rows, chunks=CHUNKS, unroll=unroll), got)


def test_single_kernel_plain_version_matches_xla_and_jit(objects, jax_rows):
    ih, bases, targets = _port(objects)
    for b in range(N_OBJ):
        base, target = from_i64(bases[b]), from_i64(targets[b])
        found, nonce = sha512_cuda.search_ref(ih[b], base, target, rows=2,
                                              chunks=CHUNKS, unroll=1)
        assert torch.equal(sha512_cuda.cuda_search(
            ih[b], base, target, rows=2, chunks=CHUNKS, unroll=1)[0], found)
        step1, n_hi, n_lo = (int(x) for x in jax_rows[b])
        want = np.zeros(CHUNKS, np.int64)
        if step1:
            want[step1 - 1] = 1
        assert np.array_equal(found.numpy(), want)
        assert nonce[step1 - 1].tolist() == ([n_hi, n_lo] if step1 else
                                             [0, 0])
        # the jitted single-object search of the XLA tier agrees too
        # (called as its host driver calls it, so the compile is shared)
        ih_pairs = jnp.asarray(objects[0][b])
        b_pairs, t_pairs = objects[1][b], objects[2][b]
        j_found, j_hi, j_lo, j_chunks = jax_pow_search.pow_search_jit(
            ih_pairs[:, 0], ih_pairs[:, 1], jnp.uint32(t_pairs[0]),
            jnp.uint32(t_pairs[1]), jnp.uint32(b_pairs[0]),
            jnp.uint32(b_pairs[1]), LANES, CHUNKS,
            jax_pow_search.DEFAULT_VARIANT)
        p_found, p_nonce, p_chunks = pow_search.pow_search(
            ih[b], target, base, lanes=LANES, max_chunks=CHUNKS)
        assert (p_found, p_chunks) == (bool(j_found), int(j_chunks))
        if p_found:
            assert from_i64(p_nonce) == (int(j_hi) << 32) | int(j_lo)
            assert int(j_chunks) == step1


# ---------------------------------------------------------------------------
# (iii) the planner
# ---------------------------------------------------------------------------


def _items(n, target, tag=b"plan"):
    return [(hashlib.sha512(tag + b" %d" % i).digest(), target)
            for i in range(n)]


@pytest.mark.parametrize("name,items", [
    ("storm", _items(64, 1 << 60)),
    ("hard", _items(8, 1 << 38)),
    ("single", _items(1, 1 << 60)),
    ("single-hard", _items(1, 1 << 40)),
    ("mixed", [(hashlib.sha512(b"%d" % i).digest(), t) for i, t in
               enumerate([1 << 50, 1 << 62, 1 << 56, 1 << 58, 1 << 44,
                          1 << 61, 1 << 57])]),
])
@pytest.mark.parametrize("tuned", [False, True])
def test_plan_batch_matches_reference(name, items, tuned):
    port_tuner = pipeline.SlabAutotuner()
    jax_tuner = jax_pipeline.SlabAutotuner()
    if tuned:
        for tuner in (port_tuner, jax_tuner):
            tuner.record("packed", 64, 0.01)
            tuner.record("batch", 4096, 3.0)
    for rows in (16, 128):
        got = pipeline.plan_batch(items, rows=rows, autotuner=port_tuner)
        want = jax_pipeline.plan_batch(items, rows=rows,
                                       autotuner=jax_tuner)
        assert (got.mode, got.pack, got.chunks, list(got.order)) == (
            want.mode, want.pack, want.chunks, list(want.order)), name


# ---------------------------------------------------------------------------
# (iv) host loops, pipeline and dispatcher
# ---------------------------------------------------------------------------


def test_pipeline_matches_reference_with_checkpoints():
    items = _items(6, EASY, tag=b"pipe")
    starts = [0, 3000, (1 << 64) - 500, 17, 0, 1 << 40]
    order = list(range(len(items)))
    port_progress, jax_progress = [], []
    got = pipeline.solve_batch_pipelined(
        items, rows=16, device="cpu", start_nonces=starts,
        plan=pipeline.BatchPlan("packed", 8, CHUNKS, order),
        progress=lambda i, n: port_progress.append((i, n)))
    want = jax_pipeline.solve_batch_pipelined(
        items, rows=16, impl="xla", start_nonces=starts,
        plan=jax_pipeline.BatchPlan("packed", 8, CHUNKS, order),
        progress=lambda i, n: jax_progress.append((i, n)))
    assert got == want
    assert port_progress == jax_progress
    for (ih, target), start, (nonce, _) in zip(items, starts, got):
        assert nonce == _lowest_from(ih, target, start)


def _lowest_from(ih: bytes, target: int, start: int) -> int:
    """hashlib scan from ``start`` upward, wrapping mod 2^64."""
    nonce = start
    while _host_trial(nonce, ih) > target:
        nonce = (nonce + 1) & ((1 << 64) - 1)
    return nonce


def test_pow_search_solve_matches_reference_host_driver():
    ih = hashlib.sha512(b"host driver").digest()
    for start in (0, 4097):
        port_cp, jax_cp = [], []
        got = pow_search.solve(ih, EASY >> 2, start_nonce=start,
                               lanes=LANES, chunks_per_call=CHUNKS,
                               progress=port_cp.append, device="cpu")
        want = jax_pow_search.solve(ih, EASY >> 2, start_nonce=start,
                                    lanes=LANES, chunks_per_call=CHUNKS,
                                    progress=jax_cp.append)
        assert got == want
        assert port_cp == jax_cp


def test_single_object_solves_match_python_solve():
    ih = hashlib.sha512(b"single").digest()
    nonce, _ = jax_dispatcher.python_solve(ih, EASY)
    slab = 2 * 128 * 1 * 4
    got = sha512_cuda.solve(ih, EASY, rows=2, chunks_per_call=4, unroll=1,
                            device="cpu")
    # trials are whole slabs, up to and including the one with the hit
    assert got == (nonce, (nonce // slab + 1) * slab)
    assert pow_search.solve(ih, EASY, lanes=LANES, chunks_per_call=CHUNKS,
                            device="cpu")[0] == nonce


def test_dispatcher_matches_reference_dispatcher():
    items = _items(3, EASY, tag=b"dispatch")
    ref = jax_dispatcher.PowDispatcher(use_tpu=False, use_native=False)
    want = [ref.solve(ih, t)[0] for ih, t in items]
    port = PowDispatcher(device="cpu")
    assert [port.solve(ih, t)[0] for ih, t in items] == want
    assert port.last_backend == "torch"
    assert [r[0] for r in port.solve_batch(items)] == want
    assert port.last_backend == "torch-batch"
    assert port.solve_batch(items[:1])[0][0] == want[0]
