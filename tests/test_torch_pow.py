"""The PyTorch port on its own: host loops, pipeline, dispatcher, service,
the shared trial header built for the host, import hygiene, and the
kernels against their plain versions (on a card only).

Tests marked ``cuda`` decide inside the ``cuda`` fixture whether a card
is present and skip themselves without one, so every worker collects
the same tests.
"""

import ast
import asyncio
import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pybitmessage_tpu_torch.ops import pow_search, sha512_cuda
from pybitmessage_tpu_torch.ops.pow_search import PowInterrupted
from pybitmessage_tpu_torch.ops.sha512 import initial_hash_words
from pybitmessage_tpu_torch.ops.u64 import to_i64, words_from_bytes
from pybitmessage_tpu_torch.pow import pipeline
from pybitmessage_tpu_torch.pow.dispatcher import PowDispatcher, python_solve
from pybitmessage_tpu_torch.pow.service import PowService, RetryPolicy

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pybitmessage_tpu_torch"
MASK64 = (1 << 64) - 1
#: mean 1024 trials per object
EASY = 1 << 54


def _items(n, target=EASY, tag=b"port"):
    return [(hashlib.sha512(tag + b" %d" % i).digest(), target)
            for i in range(n)]


def _trial(nonce: int, ih: bytes) -> int:
    d = hashlib.sha512(hashlib.sha512(
        nonce.to_bytes(8, "big") + ih).digest()).digest()
    return int.from_bytes(d[:8], "big")


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def _imported_modules(path: Path):
    """Every module a file imports: import statements, and the constant
    names handed to ``importlib.import_module`` or ``__import__``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and (
                    getattr(node.func, "attr", None) == "import_module"
                    or getattr(node.func, "id", None) == "__import__"):
            yield node.args[0].value


#: what the scan reads: the package (``powfarm/``, ``resilience/`` and
#: every other subpackage), ``chip_smoke.py`` and ``torch_tools/``
SCANNED = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "torch_tools").glob("*.py")))


@pytest.mark.parametrize("path", SCANNED,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "pybitmessage_tpu"), (
            "%s imports %s" % (path.relative_to(ROOT), name))


def test_the_import_scan_covers_the_farm_and_the_journal(tmp_path):
    scanned = {str(p.relative_to(PORT)) for p in SCANNED
               if p.is_relative_to(PORT)}
    farm = {"powfarm/%s.py" % m for m in
            ("__init__", "client", "journal", "protocol", "scheduler",
             "server")}
    assert farm | {"resilience/journal.py", "resilience/chaos.py",
                   "resilience/watchdog.py", "storage/slabstore.py",
                   "storage/fs_inventory.py"} <= scanned
    # the email gateway, the native PoW rung and the host leftovers
    assert {"gateways/__init__.py", "gateways/email_account.py",
            "gateways/smtp_server.py", "gateways/smtp_deliver.py",
            "gateways/namecoin.py", "utils/tasks.py", "pow/native.py",
            "core/testdata.py", "core/plugins.py", "plugins/__init__.py",
            "plugins/sound_bell.py", "plugins/proxyconfig_stem.py",
            "models/messagetypes.py", "migrate.py"} <= scanned
    # the multi-device tier
    assert {"parallel/%s.py" % m for m in
            ("__init__", "mesh", "pow_sharded", "pow_pallas_sharded")} \
        <= scanned
    # the scan sees a dynamic import of the reference
    probe = tmp_path / "probe.py"
    probe.write_text('import importlib\n'
                     'importlib.import_module("pybitmessage_tpu.powfarm")\n'
                     '__import__("jax")\n')
    assert list(_imported_modules(probe)) == [
        "importlib", "pybitmessage_tpu.powfarm", "jax"]


# ---------------------------------------------------------------------------
# the trial header, built for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_trial_lib(tmp_path_factory):
    """csrc/sha512_pow.cuh compiled by g++ into a ctypes library."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = tmp_path_factory.mktemp("host_trial")
    src = out / "host_trial.cpp"
    src.write_text(
        '#include "sha512_pow.cuh"\n'
        'extern "C" uint64_t bm_host_trial(uint64_t nonce, '
        'const uint64_t* ih) { return bm_pow_trial(nonce, ih); }\n')
    lib_path = out / "libhosttrial.so"
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-I",
                    str(PORT / "csrc"), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    lib.bm_host_trial.restype = ctypes.c_uint64
    lib.bm_host_trial.argtypes = [ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_uint64)]
    return lib


def test_kernel_trial_header_matches_hashlib(host_trial_lib):
    rng = np.random.default_rng(3)
    for k in range(4):
        ih = rng.bytes(64)
        words = (ctypes.c_uint64 * 8)(*[int.from_bytes(ih[i:i + 8], "big")
                                        for i in range(0, 64, 8)])
        nonces = [0, (1 << 32) - 1, 1 << 32, 1 << 63, MASK64]
        nonces += [int(x) for x in rng.integers(0, 1 << 63, size=8,
                                                dtype=np.int64)]
        for nonce in nonces:
            assert host_trial_lib.bm_host_trial(nonce, words) == \
                _trial(nonce, ih), (k, nonce)


# ---------------------------------------------------------------------------
# device selection: no silent fallback
# ---------------------------------------------------------------------------


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PowDispatcher()
    ih, target = _items(1)[0]
    with pytest.raises(RuntimeError):
        sha512_cuda.solve(ih, target)
    with pytest.raises(RuntimeError):
        pipeline.solve_batch_pipelined(_items(2))
    with pytest.raises(RuntimeError):
        pow_search.solve(ih, target)


def test_wrappers_check_their_inputs():
    ih = torch.zeros((4, 8), dtype=torch.int64)
    bases = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        sha512_cuda.cuda_batch_search(ih.to(torch.int32), bases, bases)
    with pytest.raises(ValueError):
        sha512_cuda.cuda_batch_search(ih, bases[:3], bases)
    with pytest.raises(ValueError):
        sha512_cuda.cuda_packed_search(ih, bases, bases, rows=16, pack=8)
    with pytest.raises(ValueError):
        sha512_cuda.cuda_search(ih[:, :4].T, 0, 0)


# ---------------------------------------------------------------------------
# host loops on the CPU
# ---------------------------------------------------------------------------


def test_single_object_host_loop_checkpoints_and_resumes():
    ih, target = _items(1, tag=b"resume")[0]
    want, _ = python_solve(ih, target, start_nonce=300)
    slab = 2 * 128 * 2                     # rows 2 x 128 lanes x chunks 2
    checkpoints = []
    nonce, trials = sha512_cuda.solve(
        ih, target, start_nonce=300, rows=2, chunks_per_call=2, unroll=1,
        progress=checkpoints.append, device="cpu")
    assert nonce == want
    assert trials == ((nonce - 300) // slab + 1) * slab
    assert checkpoints == [300 + slab * (k + 1)
                           for k in range((nonce - 300) // slab)]


def test_single_object_host_loop_interrupts():
    ih, _ = _items(1)[0]
    with pytest.raises(PowInterrupted):
        sha512_cuda.solve(ih, 1, rows=1, chunks_per_call=1, unroll=1,
                          should_stop=lambda: True, device="cpu")
    calls = []
    with pytest.raises(PowInterrupted):
        # the first slab harvests miss-free; at the stop the slab in
        # flight is harvested too before the search gives up
        sha512_cuda.solve(ih, 1, rows=1, chunks_per_call=1, unroll=1,
                          should_stop=lambda: len(calls) > 0,
                          progress=calls.append, device="cpu")
    assert calls == [128, 256]


def test_wrapped_nonce_range():
    """A base just below 2^64 wraps to small nonces."""
    ih, target = _items(1, tag=b"wrap")[0]
    start = MASK64 - 99
    nonce, _ = sha512_cuda.solve(ih, target, start_nonce=start, rows=4,
                                 chunks_per_call=4, unroll=1, device="cpu")
    n = start
    while _trial(n, ih) > target:
        n = (n + 1) & MASK64
    assert nonce == n


@pytest.mark.parametrize("mode,pack", [("packed", 4), ("batched", 1)])
def test_pipeline_modes_match_python_solve(mode, pack):
    items = _items(5, tag=mode.encode())
    starts = [0, 1000, 0, 77, 5]
    stats, seen = {}, []
    got = pipeline.solve_batch_pipelined(
        items, rows=4, device="cpu", start_nonces=starts, stats=stats,
        plan=pipeline.BatchPlan(mode, pack, 2, list(range(5))),
        progress=lambda i, n: seen.append((i, n)))
    for (ih, target), start, (nonce, trials) in zip(items, starts, got):
        assert nonce == python_solve(ih, target, start_nonce=start)[0]
        assert trials > 0
    assert stats["mode"] == mode and stats["launches"] >= 1
    assert stats["credited_trials"] == sum(t for _, t in got)
    for i, n in seen:
        # a checkpoint ends a miss-free slab: it never passes the answer
        assert starts[i] < n <= got[i][0]


def test_pipeline_default_plans_and_interrupt():
    storm = _items(20, 1 << 60, tag=b"storm")
    stats = {}
    got = pipeline.solve_batch_pipelined(storm, rows=16, device="cpu",
                                         stats=stats)
    assert stats["mode"] == "packed" and stats["pack"] == 16
    assert all(_trial(n, ih) <= t for (ih, t), (n, _) in zip(storm, got))
    single = pipeline.solve_batch_pipelined(_items(1, tag=b"one"), rows=16,
                                            device="cpu")
    assert single[0][0] == python_solve(*_items(1, tag=b"one")[0])[0]
    with pytest.raises(PowInterrupted):
        pipeline.solve_batch_pipelined(_items(4, 1), rows=8, device="cpu",
                                       should_stop=lambda: True)


def test_pipeline_stall_guard_raises():
    driver = pipeline._PipelineDriver(
        fetch=lambda pending: __import__("time").sleep(0.5),
        stall_timeout=0.05)
    launched = []

    def next_launch():
        if launched:
            return None
        launched.append(1)
        return ("tag", None)

    with pytest.raises(pipeline.SlabStallError):
        driver.run(next_launch, lambda tag, host: None)


def test_autotuner_suggests_power_of_two_within_bounds():
    tuner = pipeline.SlabAutotuner(target_seconds=0.5)
    assert tuner.suggest("k", 64) == 64
    tuner.record("k", 64, 0.064)           # 1 ms per grid step
    assert tuner.suggest("k", 64, lo=32, hi=1024) == 512
    tuner.record("k", 64, 640.0)           # outlier clamped to 10x
    assert tuner.seconds_per_chunk("k") == pytest.approx(
        0.4 * 0.01 + 0.6 * 0.001)


def test_verify_batch():
    ih = hashlib.sha512(b"verify").digest()
    nonce, _ = python_solve(ih, EASY)
    assert pow_search.verify([(nonce, ih, EASY), (nonce, ih, 1),
                              (nonce + 1, ih, MASK64)],
                             device="cpu") == [True, False, True]


# ---------------------------------------------------------------------------
# dispatcher and service
# ---------------------------------------------------------------------------


class _Recorder:
    """Wraps a dispatcher; records batch sizes, fails on demand."""

    def __init__(self, inner, failures=0):
        self.inner = inner
        self.failures = failures
        self.batches = []
        self.last_backend = ""

    def solve_batch(self, items, **kwargs):
        self.batches.append(len(items))
        if self.failures:
            self.failures -= 1
            raise RuntimeError("kernel launch failed")
        out = self.inner.solve_batch(items, **kwargs)
        self.last_backend = self.inner.last_backend
        return out


async def test_service_coalesces_concurrent_solves():
    items = _items(6, tag=b"svc")
    rec = _Recorder(PowDispatcher(device="cpu"))
    svc = PowService(rec, window=0.05)
    svc.start()
    try:
        got = await asyncio.wait_for(asyncio.gather(
            *(svc.solve(ih, t) for ih, t in items)), 60)
    finally:
        await svc.stop()
    assert rec.batches == [6]
    assert (svc.batches, svc.solved) == (1, 6)
    assert [n for n, _ in got] == [python_solve(ih, t)[0] for ih, t in items]


async def test_service_requeues_then_surfaces_failures():
    items = _items(3, tag=b"requeue")
    rec = _Recorder(PowDispatcher(device="cpu"), failures=1)
    svc = PowService(rec, window=0.01,
                     retry=RetryPolicy(base_delay=0.01, jitter=0.0))
    svc.start()
    try:
        got = await asyncio.wait_for(asyncio.gather(
            *(svc.solve(ih, t) for ih, t in items)), 60)
        assert rec.batches == [3, 3]
        assert [n for n, _ in got] == [python_solve(ih, t)[0]
                                       for ih, t in items]
        rec.failures = 10
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            await asyncio.wait_for(svc.solve(*items[0]), 60)
        assert rec.batches[2:] == [1, 1, 1]      # max_attempts = 3
    finally:
        await svc.stop()


async def test_service_interrupt_cancels_batch():
    shutdown = asyncio.Event()
    shutdown.set()
    svc = PowService(PowDispatcher(device="cpu"), shutdown=shutdown,
                     window=0.0)
    svc.start()
    try:
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(svc.solve(*_items(1, 1)[0]), 60)
    finally:
        await svc.stop()


def test_dispatcher_routes_and_rates():
    port = PowDispatcher(device="cpu")
    ih, target = _items(1, tag=b"route")[0]
    nonce, trials = port.solve(ih, target)
    assert port.last_backend == "torch" and port.last_rate > 0
    assert nonce == python_solve(ih, target)[0]
    # whole slabs of the single-object loop, whatever chunk count the
    # autotuner picked
    step = sha512_cuda.DEFAULT_ROWS * sha512_cuda.LANE_COLS \
        * sha512_cuda.DEFAULT_UNROLL
    assert trials > 0 and trials % step == 0
    assert port.solve_batch([]) == []
    port.solve_batch(_items(1, 1 << 60, tag=b"tiny"))
    assert port.last_backend == "torch-batch"


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _device_objects(rng, n, n_trials, device):
    ihs = [rng.bytes(64) for _ in range(n)]
    bases = [int(rng.integers(0, 1 << 40)) for _ in range(n)]
    bases[1 % n] = (1 << 32) - 50
    bases[2 % n] = MASK64 - 50
    targets = [(1 << 64) // max(1, n_trials // 3)] * n
    targets[3 % n] = MASK64
    targets[4 % n] = 1
    return (torch.tensor([words_from_bytes(ih) for ih in ihs],
                         device=device),
            torch.tensor([to_i64(b) for b in bases], device=device),
            torch.tensor([to_i64(t) for t in targets], device=device))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    rng = np.random.default_rng(11)
    ih, bases, targets = _device_objects(rng, 8, 2 * 128 * 4, cuda)
    got = sha512_cuda.cuda_batch_search(ih, bases, targets, rows=2,
                                        chunks=4, unroll=1)
    assert torch.equal(got, sha512_cuda.batch_search_ref(
        ih, bases, targets, rows=2, chunks=4, unroll=1))
    for pack in (8, 2, 1):
        got = sha512_cuda.cuda_packed_search(ih, bases, targets, rows=8,
                                             chunks=4, pack=pack)
        assert torch.equal(got, sha512_cuda.packed_search_ref(
            ih, bases, targets, rows=8, chunks=4, pack=pack))
    for b in range(8):
        base, target = int(bases[b]) & MASK64, int(targets[b]) & MASK64
        got = sha512_cuda.cuda_search(ih[b], base, target, rows=2, chunks=4,
                                      unroll=2)
        want = sha512_cuda.search_ref(ih[b], base, target, rows=2, chunks=4,
                                      unroll=2)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the packed kernel at the storm's shape (1,024 objects, pack 16,
    # chunks 64) with every edge case of its contract, then pack 1 alone;
    # every hit re-checked with hashlib
    import chip_smoke
    for shape, ihs, bases, targets in chip_smoke.packed_edge_cases(
            np.random.default_rng(12), cuda):
        args = chip_smoke._tensors(ihs, bases, targets, cuda)
        got = sha512_cuda.cuda_packed_search(*args, **shape)
        want = sha512_cuda.packed_search_ref(*args, **shape)
        assert torch.equal(got, want)
        for (step1, hi, lo), ih_b, target in zip(got.tolist(), ihs, targets):
            if step1:
                assert _trial((hi << 32) | lo, ih_b) <= target


@pytest.mark.cuda
def test_cuda_main_path_matches_python_solve(cuda):
    items = _items(5, tag=b"cuda")
    dispatcher = PowDispatcher()
    sha512_cuda.reset_launches()
    got = dispatcher.solve_batch(items)
    assert [n for n, _ in got] == [python_solve(ih, t)[0] for ih, t in items]
    nonce, _ = dispatcher.solve(*items[0])
    assert nonce == got[0][0]
    assert sha512_cuda.LAUNCHES["packed_search"] > 0
    assert sha512_cuda.LAUNCHES["search"] > 0
    words = initial_hash_words(items[0][0], cuda)
    assert words.device.type == "cuda"
