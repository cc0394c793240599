"""The port's native secp256k1 rung and the engine's routing against the
JAX package's, on the CPU.

The native library: the port's ``NativeSecp`` (built from
``native/secp256k1/bmsecp256k1.cpp`` into the git-ignored
``build/native/``) and the JAX ``NativeSecp`` give identical booleans
and bytes over seeded verify and ECDH drains with edge lanes, and so
does ``CudaSecp(device="cpu")`` (the card kernels' plain versions); the
fixed-base, point-check and AES entry points agree with the JAX library
and with ``crypto/fallback.py``.  A source that does not compile or a
library that fails its self-test raises; builds racing on one directory
compile once and leave no temporary file.

The routing: for a seeded sequence of drains around
``cryptotpubatchmin``, each drain's rung is the JAX engine's with its
TPU rung on (``gpu`` for ``tpu``), with the rungs switched off in turn,
and the results are equal.  The card rung here is a stand-in speaking
the drain ABI (the native library), as the JAX engine's TPU rung is, so
no test waits on the plain torch ladder.  ``crypto.native`` chaos
re-runs one drain on the pure tier in both packages and counts
``crypto_native_fallback_total`` +1; ``crypto.tpu`` chaos is a failed
drain in the port, settled conservatively, with nothing run on the
native or pure rung.
"""

import asyncio
import importlib
import random
import threading

import numpy as np
import pytest

from pybitmessage_tpu_torch.crypto import batch, ecies, fallback, keys
from pybitmessage_tpu_torch.crypto import native as port_native
from pybitmessage_tpu_torch.crypto.gpu import CudaSecp
from pybitmessage_tpu_torch.observability import REGISTRY
from pybitmessage_tpu_torch.resilience.chaos import CHAOS

N = fallback.N


def ref(module: str):
    return importlib.import_module("pybitmessage_tpu." + module)


def _key(rng) -> bytes:
    return rng.randrange(1, N).to_bytes(32, "big")


def _be(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _point(p) -> bytes:
    return _be(p[0]) + _be(p[1])


@pytest.fixture(scope="module")
def libs():
    jax_native = ref("crypto.native").NativeSecp()
    assert jax_native.available
    return port_native.NativeSecp(), jax_native


def _verify_lanes(rng, n: int):
    """(u1s, u2s, pubs, rs) packed, with edge lanes: every third lane
    true, the others off by one in r, a zero u2, an off-curve point."""
    u1s, u2s, pubs, rs = [], [], [], []
    for i in range(n):
        u1, u2 = rng.randrange(1, N), rng.randrange(1, N)
        q = fallback.base_mult(rng.randrange(1, N))
        x = fallback._jac_to_affine(fallback._jac_add(
            fallback._as_jac(fallback.base_mult(u1)),
            fallback._as_jac(fallback.point_mult(u2, q))))[0] % N
        if i % 3:
            x = (x + 1) % N
        if i == 4:
            u2 = 0
        pt = _point(q)
        if i == 5:
            pt = pt[:63] + bytes([pt[63] ^ 1])
        u1s.append(_be(u1))
        u2s.append(_be(u2))
        pubs.append(pt)
        rs.append(_be(x))
    return n, b"".join(u1s), b"".join(u2s), b"".join(pubs), b"".join(rs)


def _ecdh_lanes(rng, n: int):
    """(points, scalars) packed, with a zero scalar, a scalar of n and
    an off-curve point among them."""
    points, scalars = [], []
    for i in range(n):
        pt = _point(fallback.base_mult(rng.randrange(1, N)))
        k = rng.randrange(1, N)
        if i == 1:
            k = 0
        if i == 2:
            k = N
        if i == 3:
            pt = pt[:63] + bytes([pt[63] ^ 1])
        points.append(pt)
        scalars.append(_be(k))
    return n, b"".join(points), b"".join(scalars)


def test_native_matches_jax_native_and_the_plain_kernels(libs):
    mine, theirs = libs
    rng = random.Random(301)
    v = _verify_lanes(rng, 24)
    e = _ecdh_lanes(rng, 24)
    got_v = mine.verify_prepared(*v)
    got_e = mine.ecdh_batch(*e)
    assert got_v == theirs.verify_prepared(*v, nthreads=1)
    assert got_e == theirs.ecdh_batch(*e, nthreads=1)
    # threads change nothing
    assert mine.verify_prepared(*v, nthreads=4) == got_v
    assert mine.ecdh_batch(*e, nthreads=0) == got_e
    assert got_v == [i % 3 == 0 and i not in (4, 5) for i in range(24)]
    assert [x is None for x in got_e] == [i in (1, 2, 3) for i in range(24)]
    plain = CudaSecp("cpu")
    assert plain.verify_prepared(*v) == got_v
    assert plain.ecdh_batch(*e) == got_e


def test_native_fixed_base_point_check_and_aes(libs):
    mine, theirs = libs
    rng = random.Random(302)
    for _ in range(4):
        k = _key(rng)
        assert mine.base_mult(k) == theirs.base_mult(k) \
            == _point(fallback.base_mult(int.from_bytes(k, "big")))
        assert mine.point_check(mine.base_mult(k))
    assert mine.base_mult(bytes(32)) is None is theirs.base_mult(bytes(32))
    bad = mine.base_mult(_key(rng))
    bad = bad[:63] + bytes([bad[63] ^ 1])
    assert not mine.point_check(bad) and not theirs.point_check(bad)
    key, iv, data = rng.randbytes(32), rng.randbytes(16), rng.randbytes(64)
    ct = mine.aes256_cbc(True, key, iv, data)
    assert ct == theirs.aes256_cbc(True, key, iv, data) \
        == fallback.aes256_cbc(True, key, iv, data)
    assert mine.aes256_cbc(False, key, iv, ct) == data
    with pytest.raises(ValueError):
        mine.aes256_cbc(True, key, iv, data[:15])


def test_the_library_builds_under_build_native_once(tmp_path):
    """Builds racing on one directory compile once, atomically; the
    shipped library sits in the git-ignored ``build/native/`` beside its
    stamp, never under ``native/``."""
    lib = port_native.build()
    assert lib.parent == port_native.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "native")
    stamp = lib.with_name(lib.name + ".stamp").read_text().splitlines()
    assert stamp[0].startswith(lib.name.split("-")[1][:-3])
    assert "-O3 -std=c++17 -fPIC -pthread -shared" in stamp[1]
    source = tmp_path / "bmsecp256k1.cpp"
    source.write_bytes(port_native.SOURCE.read_bytes()
                       + b"\n// another build\n")
    out = tmp_path / "build"
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(port_native.build(source, out)))
        for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(got)) == 1 and len(got) == 3
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [".lock", got[0].name, got[0].name + ".stamp"])
    assert port_native.NativeSecp(source=source, build_dir=out) \
        .base_mult(_be(1)) == _point((fallback.GX, fallback.GY))


@pytest.mark.parametrize("fault", ["compile", "selftest"])
def test_a_broken_source_raises(tmp_path, fault):
    text = port_native.SOURCE.read_text()
    if fault == "compile":
        text += "\n#error a broken source\n"
        match = "build failed"
    else:
        head = "int tpu_secp_selftest(void) {"
        assert head in text
        text = text.replace(head, head + "\n  if (1) return 0;")
        match = "self-test"
    source = tmp_path / "bmsecp256k1.cpp"
    source.write_text(text)
    with pytest.raises(RuntimeError, match=match):
        port_native.NativeSecp(source=source, build_dir=tmp_path / "build")
    assert not [p for p in (tmp_path / "build").iterdir()
                if p.name.endswith(".tmp")]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def material():
    """Signed items (True ones and a tampered one) and sealed payloads
    with their recipients' keys."""
    rng = random.Random(303)
    signer = _key(rng)
    pub = keys.priv_to_pub(signer)
    sign = ref("crypto.signing").sign
    signed = []
    for i in range(12):
        data = b"routed %d " % i + rng.randbytes(20)
        signed.append((data, sign(data, signer), pub, True))
    data, sig, _, _ = signed[0]
    signed.append((data + b"!", sig, pub, False))
    recipients = [_key(rng) for _ in range(3)]
    sealed = [(ecies.encrypt(b"for %d" % i, keys.priv_to_pub(r),
                             ephem_priv=_key(rng), iv=rng.randbytes(16)), i)
              for i, r in enumerate(recipients)]
    fillers = [_key(rng) for _ in range(120)]
    return signed, sealed, recipients, fillers


def _drains(material, seed: int):
    """A seeded sequence of (verify items, decrypt items) drains whose
    effective fans sit around 64."""
    signed, sealed, recipients, fillers = material
    rng = np.random.default_rng(seed)
    out = []
    for target in (1, 12, 40, 63, 64, 65, 96, 130):
        nv = int(rng.integers(0, min(target, len(signed)) + 1))
        rest = target - nv
        objects = []
        while rest > 0:
            payload, who = sealed[int(rng.integers(len(sealed)))]
            width = min(rest, int(rng.integers(1, 60)))
            cands = [(fillers[int(j)], "f%d" % j)
                     for j in rng.integers(0, len(fillers), width - 1)]
            cands.insert(int(rng.integers(width)),
                         (recipients[who], "r%d" % who))
            objects.append((payload, cands))
            rest -= width
        picks = rng.integers(0, len(signed), nv)
        out.append(([signed[int(i)] for i in picks], objects, target))
    return out


def _port_jobs(items, objects):
    return ([batch._VerifyJob(d, s, p, None) for d, s, p, _ in items],
            [batch._DecryptJob(p, list(c), None) for p, c in objects])


def _jax_jobs(items, objects):
    jb = ref("crypto.batch")
    return ([jb._VerifyJob(d, s, p, None) for d, s, p, _ in items],
            [jb._DecryptJob(p, list(c), None) for p, c in objects])


def _engines(libs, *, gpu: bool, native: bool):
    mine, theirs = libs
    port = batch.BatchCryptoEngine(backend=mine, use_gpu=gpu,
                                   use_native=native)
    jax = ref("crypto.batch").BatchCryptoEngine(use_tpu=gpu,
                                                use_native=native,
                                                tpu_batch_min=64)
    # the JAX engine's TPU rung is a stand-in speaking the drain ABI
    jax._tpu_engine = lambda: theirs if gpu else None
    return port, jax


@pytest.mark.parametrize("rungs", ["all", "no_gpu", "no_native"])
def test_each_drain_takes_the_jax_engines_rung(libs, material, rungs):
    port, jax = _engines(libs, gpu=rungs != "no_gpu",
                         native=rungs != "no_native")
    assert port.gpu_batch_min == jax.tpu_batch_min == 64
    seen = []
    for items, objects, fan in _drains(material, 304):
        got = port._execute(*_port_jobs(items, objects))
        want = jax._execute(*_jax_jobs(items, objects))
        assert got == want
        assert got[0] == [ok for _, _, _, ok in items]
        assert all(len(m) == 1 for m in got[1])
        rung = {"tpu": "gpu"}.get(jax.last_path, jax.last_path)
        assert port.last_path == rung, fan
        seen.append(rung)
    expect = {"all": ["native"] * 4 + ["gpu"] * 4,
              "no_gpu": ["native"] * 8,
              "no_native": ["pure"] * 4 + ["gpu"] * 4}[rungs]
    assert seen == expect
    if rungs != "no_gpu":
        # every drain under the threshold on a host rung, every other
        # on the card
        host = "native" if rungs == "all" else "pure"
        assert port.rung_fans[host][1] < 64 <= port.rung_fans["gpu"][0]
    assert port.rung_drains == {r: expect.count(r)
                                for r in ("gpu", "native", "pure")}
    assert port.failed_drains == 0
    port._fanout().shutdown()
    jax._fanout().shutdown()


def _fallbacks(registry) -> float:
    return registry.sample("crypto_native_fallback_total")


def test_native_chaos_reruns_one_drain_on_pure(libs, material):
    port, jax = _engines(libs, gpu=True, native=True)
    jax_chaos = ref("resilience.chaos").CHAOS
    jax_registry = ref("observability").REGISTRY
    items, objects, fan = _drains(material, 305)[1]
    assert fan < 64
    before = (_fallbacks(REGISTRY), _fallbacks(jax_registry))
    CHAOS.arm("crypto.native", count=1)
    jax_chaos.arm("crypto.native", count=1)
    try:
        got = port._execute(*_port_jobs(items, objects))
        want = jax._execute(*_jax_jobs(items, objects))
        assert got == want
        assert port.last_path == jax.last_path == "pure"
        assert (_fallbacks(REGISTRY) - before[0],
                _fallbacks(jax_registry) - before[1]) == (1, 1)
        # the fault is spent: the next drain is native again
        port._execute(*_port_jobs(items, objects))
        jax._execute(*_jax_jobs(items, objects))
        assert port.last_path == jax.last_path == "native"
    finally:
        CHAOS.disarm("crypto.native")
        jax_chaos.disarm("crypto.native")
    assert port.native_items == jax.native_items
    assert port.pure_items == jax.pure_items
    port._fanout().shutdown()
    jax._fanout().shutdown()


async def test_card_chaos_is_a_failed_drain_never_run_on_the_host(
        libs, material):
    mine, _ = libs
    engine = batch.BatchCryptoEngine(backend=mine)
    items, objects, fan = _drains(material, 306)[6]
    assert fan >= 64
    errors = REGISTRY.sample("resilience_errors_total", {"site": "crypto.tpu"})
    CHAOS.arm("crypto.tpu", count=1)
    engine.start()
    try:
        failed = await asyncio.gather(
            *(engine.verify(d, s, p) for d, s, p, _ in items),
            *(engine.try_decrypt(p, c) for p, c in objects))
        assert failed == [False] * len(items) + [[]] * len(objects)
        assert engine.failed_drains == 1
        assert engine.native_items == engine.pure_items == 0
        assert engine.gpu_items == 0
        assert REGISTRY.sample("resilience_errors_total",
                               {"site": "crypto.tpu"}) == errors + 1
        # the next drain runs on the card rung
        again = await asyncio.gather(
            *(engine.verify(d, s, p) for d, s, p, _ in items),
            *(engine.try_decrypt(p, c) for p, c in objects))
        assert again[:len(items)] == [ok for _, _, _, ok in items]
        assert engine.last_path == "gpu" and engine.failed_drains == 1
        assert engine.native_items == engine.pure_items == 0
    finally:
        CHAOS.disarm("crypto.tpu")
        await engine.stop()
