"""The port's native C++ PoW rung and the dispatcher's card-off mode, on
the CPU.

``NativeSolver`` (one thread) against the JAX package's ``python_solve``
over seeded initial hashes, targets and start nonces, exactly; the
library built from ``native/pow/bitmsgpow.cpp`` into ``build/native/``
and the committed ``native/pow/libbitmsgpow.so`` never opened; a source
that does not compile and one whose self-test fails both raise;
``PowDispatcher(use_card=False)`` solving one object and a batch on the
native rung under the JAX ``"cpp"`` labels; and a dispatcher whose card
launch fails raising, with the native rung never built or called and no
fallback counted.
"""

import ctypes
import hashlib

import numpy as np
import pytest

from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.ops import sha512_cuda
from pybitmessage_tpu_torch.ops.pow_search import PowInterrupted
from pybitmessage_tpu_torch.pow import native as port_native
from pybitmessage_tpu_torch.pow.dispatcher import PowDispatcher


def _jax_python_solve():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.pow.dispatcher import python_solve
    return python_solve


def _seeded(seed: int, n: int):
    """(initial hash, target, start) triples: mean 256 - 4096 trials."""
    rng = np.random.default_rng([seed, 15, 8])
    return [(rng.bytes(64),
             (1 << 64) // int(rng.integers(256, 4097)),
             int(rng.integers(0, 1 << 40)) if i % 2 else 0)
            for i in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_native_nonces_are_the_jax_python_solve_ones(seed):
    python_solve = _jax_python_solve()
    solver = port_native.NativeSolver(num_threads=1)
    for ih, target, start in _seeded(seed, 8):
        nonce, trials = solver.solve(ih, target, start_nonce=start)
        want, want_trials = python_solve(ih, target, start_nonce=start)
        assert nonce == want
        # the C++ counts the trials before the hit, hashlib's loop the
        # hit as well
        assert trials + 1 == want_trials


def test_the_library_is_built_from_source_and_the_tracked_binary_never_opened(
        monkeypatch):
    opened = []
    real = ctypes.CDLL

    def spy(path, *args, **kwargs):
        opened.append(str(path))
        return real(path, *args, **kwargs)

    monkeypatch.setattr(ctypes, "CDLL", spy)
    monkeypatch.setattr(port_native, "_LIBS", {})
    solver = port_native.NativeSolver(num_threads=2)
    assert port_native.TRACKED_BINARY.exists()
    assert str(port_native.TRACKED_BINARY) not in opened
    [path] = opened
    lib = port_native.BUILD_DIR / path.rsplit("/", 1)[1]
    assert str(lib) == path and lib.name.startswith("libbitmsgpow-")
    assert lib.parent.parts[-2:] == ("build", "native")
    stamp = lib.with_name(lib.name + ".stamp").read_text().splitlines()
    assert stamp[1].endswith(str(port_native.SOURCE))
    ih = hashlib.sha512(b"two threads").digest()
    nonce, _ = solver.solve(ih, 1 << 60)
    assert int.from_bytes(hashlib.sha512(hashlib.sha512(
        nonce.to_bytes(8, "big") + ih).digest()).digest()[:8],
        "big") <= 1 << 60


@pytest.mark.parametrize("fault", ["compile", "selftest"])
def test_a_broken_source_raises(tmp_path, fault):
    text = port_native.SOURCE.read_text()
    if fault == "compile":
        text += "\n#error a broken source\n"
        match = "build failed"
    else:
        tail = "  return trial(nonce, ih);\n}\n\n}  // extern \"C\""
        assert tail in text
        text = text.replace(tail, tail.replace("trial(nonce, ih)",
                                               "trial(nonce, ih) + 1"))
        match = "self-test"
    source = tmp_path / "bitmsgpow.cpp"
    source.write_text(text)
    with pytest.raises(RuntimeError, match=match):
        port_native.NativeSolver(source=source,
                                 build_dir=tmp_path / "build")
    assert not [p for p in (tmp_path / "build").iterdir()
                if p.name.endswith(".tmp")]


def _count(name: str, labels: dict) -> float:
    return REGISTRY.sample(name, labels)


def test_card_off_mode_runs_the_native_rung():
    python_solve = _jax_python_solve()
    attempts = _count("pow_attempts_total", {"backend": "cpp"})
    d = PowDispatcher(use_card=False, num_threads=1)
    assert d.device is None and d.backends() == ["cpp"]
    (ih, target, _), *rest = _seeded(7, 4)
    nonce, _ = d.solve(ih, target)
    assert nonce == python_solve(ih, target)[0]
    assert d.last_backend == "cpp" and d.last_rate > 0
    items = [(i, t) for i, t, _ in rest]
    starts = [s for _, _, s in rest]
    results = d.solve_batch(items, start_nonces=starts)
    assert [r[0] for r in results] == [
        python_solve(i, t, start_nonce=s)[0] for (i, t), s in
        zip(items, starts)]
    assert _count("pow_attempts_total", {"backend": "cpp"}) == attempts + 4
    # an interrupted native search releases its breaker probe and raises
    with pytest.raises(PowInterrupted):
        d.solve(ih, 1, should_stop=lambda: True)
    assert d.breakers["cpp"].state == "closed"


def test_a_failed_card_launch_raises_and_never_reaches_the_native_rung(
        monkeypatch):
    built = []
    monkeypatch.setattr(port_native.NativeSolver, "__init__",
                        lambda self, *a, **k: built.append(a))

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(sha512_cuda, "solve", broken)
    import pybitmessage_tpu_torch.pow.dispatcher as dispatcher
    monkeypatch.setattr(dispatcher, "solve_batch_pipelined", broken)
    fallbacks = {(f, t): _count("pow_fallback_total", {"from": f, "to": t})
                 for f in ("torch", "cuda") for t in ("cpp", "native")}
    d = PowDispatcher(device="cpu")
    ih, target, _ = _seeded(9, 1)[0]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        d.solve(ih, target)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        d.solve_batch([(ih, target), (ih[::-1], target)])
    assert built == [] and d.native is None
    assert d.backends() == ["torch"]
    for key, value in fallbacks.items():
        assert _count("pow_fallback_total",
                      {"from": key[0], "to": key[1]}) == value
