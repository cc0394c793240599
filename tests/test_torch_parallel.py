"""The port's multi-device PoW tier (``pybitmessage_tpu_torch/parallel``)
and the dispatcher's routing to it, on the CPU.

The JAX functions run on the conftest's 8 virtual CPU devices with
``impl="xla"``; the port's on eight ``"cpu"`` shards
(``make_mesh(devices=["cpu"] * 8)``), whose wrappers run the kernels'
plain versions.  Inputs come from a numpy seed.  Every JAX result is
computed once, in a module-scope fixture over five compiled shapes
(each takes seconds to compile); the port must return the same nonces,
trial counts and ``progress`` checkpoints.  Pod batch groups hold
``SMALL_POD`` objects a device in both packages (64 on the card), so
that the plain versions scan few always-hit pads.  At an unroll other
than 1 the port's step is ``unroll`` tiles (the Pallas grid step) where
the XLA slab's is one: there nonces equal ``python_solve``'s and trials
follow the geometry.  The dispatcher's routing is held with
``_devices()`` pointed at eight ``"cpu"`` shards.

Nothing of JAX is imported at module level; the ``cuda`` test runs
four shards of one card against the one-device solve.
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pybitmessage_tpu_torch import parallel
from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.ops import sha512_cuda
from pybitmessage_tpu_torch.ops.pow_search import PowInterrupted
from pybitmessage_tpu_torch.parallel import (make_mesh,
                                             pallas_sharded_solve,
                                             pallas_sharded_solve_batch,
                                             sharded_solve,
                                             sharded_solve_batch)
from pybitmessage_tpu_torch.pow import dispatcher as port_dispatcher
from pybitmessage_tpu_torch.pow.dispatcher import PowDispatcher, python_solve

CPU8 = ["cpu"] * 8
#: the small slab both packages run: 1 row x 128 lanes x 8 chunks
SMALL = dict(rows=1, chunks_per_call=8, unroll=1)


def _objects(seed: int, targets) -> list:
    rng = np.random.default_rng(seed)
    return [(hashlib.sha512(rng.bytes(32)).digest(), t) for t in targets]


def _stop_after_first_checkpoint(seen: list):
    """(progress, should_stop): stop once one checkpoint was reported."""
    return seen.append, lambda: bool(seen)


def _drive(pkg, cases: dict, threads: int = 1) -> dict:
    """Every case of one package: name -> its result, its checkpoints
    and whether it was interrupted.  With ``threads``, the groups of
    cases (one compiled shape each) run side by side, in order within a
    group."""
    out = {}

    def group(names):
        for name in names:
            seen = []
            try:
                result = cases[name][1](pkg, seen)
                out[name] = (result, seen, False)
            except pkg["PowInterrupted"]:
                out[name] = (None, seen, True)

    groups: dict = {}
    for name, (shape, _) in cases.items():
        groups.setdefault(shape, []).append(name)
    with ThreadPoolExecutor(threads) as pool:
        for done in [pool.submit(group, names) for names in groups.values()]:
            done.result()
    return out


#: the seeded inputs of the cases held against the JAX package
SINGLES = _objects(1, [2**59, 2**59, 2**58])
RESUME = _objects(2, [2**51])[0]
BATCH = _objects(3, [2**58, 2**57, 2**58])
EASY_HARD = _objects(4, [2**62, 2**51])
POD_RESUME = _objects(5, [2**53])[0]


def _case_table():
    """name -> run(pkg, seen): the same calls for either package."""

    def single(mesh, ih, t):
        return lambda pkg, seen: pkg["pallas_sharded_solve"](
            ih, t, pkg[mesh], **SMALL)

    runs = {}
    for i, (ih, t) in enumerate(SINGLES):
        runs["single2_%d" % i] = single("mesh2", ih, t)
        runs["single8_%d" % i] = single("mesh8", ih, t)
    ih, t = RESUME
    runs["single2_resume"] = lambda pkg, seen: pkg["pallas_sharded_solve"](
        ih, t, pkg["mesh2"], start_nonce=5000, progress=seen.append, **SMALL)

    def interrupted(pkg, seen):
        prog, stop = _stop_after_first_checkpoint(seen)
        return pkg["pallas_sharded_solve"](ih, t, pkg["mesh2"],
                                           progress=prog, should_stop=stop,
                                           **SMALL)
    runs["single2_interrupt"] = interrupted
    runs["single2_stop_at_once"] = lambda pkg, seen: \
        pkg["pallas_sharded_solve"](ih, 1, pkg["mesh2"],
                                    should_stop=lambda: True, **SMALL)
    runs["batch1d"] = lambda pkg, seen: pkg["pallas_sharded_solve_batch"](
        SINGLES[:2], pkg["mesh2"],
        progress=lambda i, n: seen.append((i, n)), **SMALL)
    runs["batch2x4"] = lambda pkg, seen: pkg["pallas_sharded_solve_batch"](
        BATCH, pkg["mesh2x4"], **SMALL)
    runs["batch2x4_easy_hard"] = lambda pkg, seen: \
        pkg["pallas_sharded_solve_batch"](EASY_HARD, pkg["mesh2x4"], **SMALL)
    runs["batch2x4_resume"] = lambda pkg, seen: \
        pkg["pallas_sharded_solve_batch"](
            [POD_RESUME], pkg["mesh2x4"], start_nonces=[1 << 20],
            progress=lambda i, n: seen.append((i, n)), **SMALL)

    def batch_interrupted(pkg, seen):
        prog, stop = _stop_after_first_checkpoint(seen)
        return pkg["pallas_sharded_solve_batch"](
            [RESUME], pkg["mesh2x4"], should_stop=stop,
            progress=lambda i, n: prog((i, n)), **SMALL)
    runs["batch2x4_interrupt"] = batch_interrupted
    xla = dict(lanes=128, chunks_per_call=8)
    for i, (ih_i, t_i) in enumerate(SINGLES):
        runs["sharded8_%d" % i] = (
            lambda pkg, seen, ih_i=ih_i, t_i=t_i: pkg["sharded_solve"](
                ih_i, t_i, pkg["mesh8"], start_nonce=77 * i, **xla))
    runs["sharded_batch1d"] = lambda pkg, seen: pkg["sharded_solve_batch"](
        SINGLES, pkg["mesh8"], **xla)
    runs["sharded_batch2x4"] = lambda pkg, seen: \
        pkg["sharded_solve_batch"](BATCH + EASY_HARD[:1], pkg["mesh2x4"],
                                   lanes=64, chunks_per_call=16)
    # the JAX shape each case compiles: the JAX cases run a thread a shape
    shapes = {"single2": "pallas 2", "single8": "pallas 8",
              "batch1d": "pallas 2", "batch2x4": "pallas 2x4",
              "sharded8": "xla 8", "sharded_batch1d": "xla 8",
              "sharded_batch2x4": "xla 2x4"}
    return {name: (next(v for k, v in shapes.items()
                        if name.startswith(k)), run)
            for name, run in runs.items()}


CASES = _case_table()

#: objects per device in a pod batch group on the CPU (64 on the card):
#: fewer always-hit pads for the plain versions to scan
SMALL_POD = 2


@pytest.fixture(scope="module")
def small_pods():
    """Both packages' batch groups at ``SMALL_POD`` objects a device."""
    from pybitmessage_tpu.parallel import pow_pallas_sharded as jax_pod
    from pybitmessage_tpu_torch.parallel import pow_pallas_sharded as pod
    with pytest.MonkeyPatch.context() as mp:
        for mod in (pod, jax_pod):
            mp.setattr(mod, "POD_BATCH_PER_DEVICE", SMALL_POD)
        yield


def _jax_results() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu import parallel as jpar
    from pybitmessage_tpu.ops.pow_search import PowInterrupted as JaxStop

    def xla(fn):
        return lambda *a, **kw: fn(*a, impl="xla", **kw)

    pkg = {"mesh2": jpar.make_mesh(2), "mesh8": jpar.make_mesh(8),
           "mesh2x4": jpar.make_mesh(8, obj_axis="obj", obj_size=2),
           "pallas_sharded_solve": xla(jpar.pallas_sharded_solve),
           "pallas_sharded_solve_batch": xla(jpar.pallas_sharded_solve_batch),
           "sharded_solve": jpar.sharded_solve,
           "sharded_solve_batch": jpar.sharded_solve_batch,
           "PowInterrupted": JaxStop}
    return _drive(pkg, CASES, threads=5)


@pytest.fixture(scope="module")
def results(small_pods):
    """Both packages' results."""
    pkg = {"mesh2": make_mesh(2, devices=CPU8),
           "mesh8": make_mesh(devices=CPU8),
           "mesh2x4": make_mesh(8, obj_axis="obj", obj_size=2,
                                devices=CPU8),
           "pallas_sharded_solve": pallas_sharded_solve,
           "pallas_sharded_solve_batch": pallas_sharded_solve_batch,
           "sharded_solve": sharded_solve,
           "sharded_solve_batch": sharded_solve_batch,
           "PowInterrupted": PowInterrupted}
    return {"port": _drive(pkg, CASES), "jax": _jax_results()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_solves_as_the_jax_tier(case, results):
    """Nonces, trial counts, checkpoints and interrupts equal the JAX
    function's on the same inputs and geometry; every nonce is the
    lowest valid one at or above the start."""
    assert results["port"][case] == results["jax"][case]
    result, seen, stopped = results["port"][case]
    if stopped:
        return
    results = result if isinstance(result, list) else [result]
    for nonce, trials in results:
        assert trials > 0
    if case == "single2_resume":
        assert result[0] == python_solve(*RESUME, start_nonce=5000)[0]
        assert seen and all(n > 5000 for n in seen) and seen == sorted(seen)


def test_a_resumed_pod_solve_returns_the_uninterrupted_nonce(results):
    """The interrupted solve's last checkpoint resumes to the nonce of
    the uninterrupted one; an easy object stops consuming while a hard
    one goes on."""
    mesh = make_mesh(2, devices=CPU8)
    _, seen, stopped = results["port"]["single2_interrupt"]
    assert stopped and seen
    nonce, _ = pallas_sharded_solve(*RESUME, mesh, start_nonce=seen[-1],
                                    **SMALL)
    assert nonce == python_solve(*RESUME)[0]
    (n_easy, t_easy), (n_hard, t_hard) = \
        results["port"]["batch2x4_easy_hard"][0]
    assert t_easy < t_hard
    assert [n_easy, n_hard] == [python_solve(*o)[0] for o in EASY_HARD]


@pytest.mark.parametrize("unroll", [2, 3])
def test_other_unrolls_find_the_lowest_nonce_with_geometric_trials(
        unroll, small_pods):
    """At unroll > 1 a kernel step covers ``unroll`` tiles: the nonce is
    still ``python_solve``'s, and the trials follow the geometry (whole
    pod slabs for one object; a batch object's winning shard up to its
    hit step, the row's other shards their whole slab)."""
    rows, chunks = 1, 2
    slab = rows * 128 * chunks * unroll
    step = rows * 128 * unroll
    stride = 2 * slab
    objs = _objects(10 + unroll, [2**54, 2**55])
    mesh = make_mesh(2, devices=CPU8)
    for ih, t in objs:
        nonce, trials = pallas_sharded_solve(
            ih, t, mesh, rows=rows, chunks_per_call=chunks, unroll=unroll,
            start_nonce=300)
        assert nonce == python_solve(ih, t, start_nonce=300)[0]
        assert trials == ((nonce - 300) // stride + 1) * stride
    mesh = make_mesh(4, obj_axis="obj", obj_size=2, devices=CPU8)
    starts = [999, 1 << 33]
    got = pallas_sharded_solve_batch(objs, mesh, rows=rows,
                                     chunks_per_call=chunks, unroll=unroll,
                                     start_nonces=starts)
    for (ih, t), start, (nonce, trials) in zip(objs, starts, got):
        assert nonce == python_solve(ih, t, start_nonce=start)[0]
        off = nonce - start
        hit_step = off % slab // step + 1
        assert trials == off // stride * stride + hit_step * step + slab


def test_the_mesh_reads_as_the_jax_mesh():
    mesh = make_mesh(8, obj_axis="obj", obj_size=2, devices=CPU8)
    assert mesh.axis_names == ("obj", "nonce")
    assert mesh.shape == {"obj": 2, "nonce": 4}
    assert mesh.devices.size == 8 and mesh.devices.shape == (2, 4)
    assert [(s.obj, s.nonce) for s in mesh.shards] == \
        [(o, d) for o in range(2) for d in range(4)]
    assert all(s.stream is None for s in mesh.shards)
    one = make_mesh(devices=["cpu"] * 3)
    assert one.axis_names == ("nonce",) and one.shape == {"nonce": 3}
    with pytest.raises(ValueError):
        make_mesh(6, obj_axis="obj", obj_size=4, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(9, devices=CPU8)


def test_without_a_card_and_without_devices_the_mesh_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)


# ---------------------------------------------------------------------------
# the dispatcher's routing
# ---------------------------------------------------------------------------

IH = hashlib.sha512(b"routing").digest()
EASY = 1 << 54


@pytest.fixture
def eight_shards(monkeypatch, small_pods):
    monkeypatch.setattr(PowDispatcher, "_devices",
                        lambda self: [torch.device("cpu")] * 8)


def _mesh_count(shape: str) -> float:
    return REGISTRY.sample("pow_mesh_compiles_total", {"shape": shape})


def test_multidevice_solves_route_to_the_sharded_tier(eight_shards):
    """One object -> ``torch-sharded`` on an 8x1 mesh, a batch ->
    ``torch-sharded-batch`` on the JAX rule's 8x2 mesh, each mesh built
    once; the nonces are ``python_solve``'s."""
    before = {s: _mesh_count(s) for s in ("8x1", "8x2")}
    d = PowDispatcher("cpu")
    nonce, trials = d.solve(IH, EASY)
    assert d.last_backend == "torch-sharded"
    assert nonce == python_solve(IH, EASY)[0] and trials > 0
    items = _objects(20, [EASY] * 3)
    results = d.solve_batch(items)
    assert d.last_backend == "torch-sharded-batch"
    assert [n for n, _ in results] == [python_solve(*o)[0] for o in items]
    assert d._mesh(8, 3).shape == {"obj": 2, "nonce": 4}
    assert d._mesh(8, 1) is d._mesh(8, 1)
    assert {s: _mesh_count(s) - before[s] for s in before} == \
        {"8x1": 1, "8x2": 1}


def test_mesh_shapes_follow_the_jax_dispatchers_rule(eight_shards):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.pow.dispatcher import PowDispatcher as JaxD
    port, ref = PowDispatcher("cpu"), JaxD(use_native=False)
    for ndev in (2, 4, 8):
        for batch in range(1, 10):
            assert port._mesh(ndev, batch).shape == \
                dict(ref._mesh(ndev, batch).shape), (ndev, batch)


def test_one_object_skips_the_pipeline_on_several_devices(eight_shards,
                                                          monkeypatch):
    tiny = _objects(21, [1 << 62])
    assert port_dispatcher.plan_batch(tiny).mode == "single-sync"

    def no_pipeline(*a, **k):
        raise AssertionError("the pipeline ran")

    monkeypatch.setattr(port_dispatcher, "solve_batch_pipelined",
                        no_pipeline)
    d = PowDispatcher("cpu")
    [(nonce, _)] = d.solve_batch(tiny, progress=lambda i, n: None)
    assert d.last_backend == "torch-sharded"
    assert nonce == python_solve(*tiny[0])[0]


@pytest.mark.parametrize("route", ["single", "batch"])
def test_a_failing_shard_raises_and_falls_to_no_other_tier(
        eight_shards, monkeypatch, route):
    """The fifth shard's kernel fails: the solve raises, no fallback is
    counted and the one-device tier never runs."""
    name = "cuda_search" if route == "single" else "cuda_batch_search"
    real = getattr(sha512_cuda, name)
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("shard kernel failed")
        return real(*a, **k)

    monkeypatch.setattr(sha512_cuda, name, flaky)
    monkeypatch.setattr(sha512_cuda, "solve", lambda *a, **k: 1 / 0)
    monkeypatch.setattr(port_dispatcher, "solve_batch_pipelined",
                        lambda *a, **k: 1 / 0)
    fallbacks = []
    monkeypatch.setattr(port_dispatcher, "_note_fallback",
                        lambda *a: fallbacks.append(a))
    d = PowDispatcher("cpu")
    with pytest.raises(RuntimeError, match="shard kernel failed"):
        if route == "single":
            d.solve(IH, EASY)
        else:
            d.solve_batch(_objects(22, [EASY] * 2))
    assert d.last_backend == ("torch-sharded" if route == "single"
                              else "torch-sharded-batch")
    assert fallbacks == []


def test_one_device_keeps_the_one_card_routes():
    d = PowDispatcher("cpu")
    assert d._devices() == [torch.device("cpu")]
    d.solve(IH, EASY)
    assert d.last_backend == "torch"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_four_shards_of_one_card_find_the_one_device_nonces(cuda):
    ih, target = _objects(30, [(1 << 64) // (1 << 27)])[0]
    one, _ = sha512_cuda.solve(ih, target, device=cuda)
    nonce, trials = pallas_sharded_solve(ih, target,
                                         make_mesh(4, devices=[cuda] * 4))
    stride = 4 * sha512_cuda.DEFAULT_ROWS * 128 * \
        sha512_cuda.DEFAULT_CHUNKS * sha512_cuda.DEFAULT_UNROLL
    assert nonce == one and trials % stride == 0
    items = _objects(31, [(1 << 64) // (1 << 22)] * 8)
    got = pallas_sharded_solve_batch(
        items, make_mesh(4, obj_axis="obj", obj_size=2, devices=[cuda] * 4))
    assert [n for n, _ in got] == \
        [sha512_cuda.solve(*o, device=cuda)[0] for o in items]
