"""The port's receive path against the JAX package: the coalescing crypto
engine (signature drains with digest rounds, the transposed trial-decrypt
wavefront), the batched PoW verifier, and the host-side copies they
need.

The engines run on the CPU (``device="cpu"``: the kernels' plain torch
versions).  Drain plans are compared exactly by feeding the port's and
the reference's planners one recording backend; end-to-end results are
compared against the reference engine on its host rungs and against
``check_pow``.  Every input comes from a seed.
"""

import asyncio
import hashlib
import random
import time

import pytest
import torch

from pybitmessage_tpu.crypto import batch as ref_batch
from pybitmessage_tpu.crypto import ecies as ref_ecies
from pybitmessage_tpu.crypto import fallback as ref_fallback
from pybitmessage_tpu.crypto import keys as ref_keys
from pybitmessage_tpu.crypto import signing as ref_signing
from pybitmessage_tpu.models.pow_math import check_pow as ref_check_pow
from pybitmessage_tpu_torch.crypto import batch, ecies, fallback, keys
from pybitmessage_tpu_torch.crypto import signing
from pybitmessage_tpu_torch.models.pow_math import (check_pow,
                                                    pow_initial_hash,
                                                    pow_target, pow_value)
from pybitmessage_tpu_torch.pow import verify_service
from pybitmessage_tpu_torch.pow.verify_service import BatchVerifier

N = fallback.N


def _key(rng) -> bytes:
    return rng.randrange(1, N).to_bytes(32, "big")


def _point(pub64: bytes):
    return (int.from_bytes(pub64[:32], "big"),
            int.from_bytes(pub64[32:], "big"))


class RecordingBackend:
    """Speaks the drain ABI with the pure-Python oracle and records
    every call's packed arguments (``nthreads``: the reference engine
    passes it; the port's does not)."""

    def __init__(self):
        self.calls = []

    def verify_prepared(self, n, u1s, u2s, pubs, rs, nthreads=None):
        self.calls.append(("verify", n, u1s, u2s, pubs, rs))
        out = []
        for i in range(n):
            u1, u2, r = (int.from_bytes(b[32 * i:32 * i + 32], "big")
                         for b in (u1s, u2s, rs))
            q = _point(pubs[64 * i:64 * i + 64])
            pt = fallback._jac_add(
                fallback._as_jac(fallback.base_mult(u1) if u1 else None),
                fallback._as_jac(fallback.point_mult(u2, q) if u2 else None))
            aff = fallback._jac_to_affine(pt)
            out.append(aff is not None and aff[0] % N == r)
        return out

    def ecdh_batch(self, n, points, scalars, nthreads=None):
        self.calls.append(("ecdh", n, points, scalars))
        out = []
        for i in range(n):
            pt = fallback.point_mult(
                int.from_bytes(scalars[32 * i:32 * i + 32], "big"),
                _point(points[64 * i:64 * i + 64]))
            out.append(None if pt is None else pt[0].to_bytes(32, "big"))
        return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def signed():
    """(data, sig, pub) items and their expected acceptance: SHA-256 and
    SHA-1 signatures from the reference's signer, altered data, a wrong
    key, malformed DER, s = 0, off-curve and malformed pubkeys."""
    rng = random.Random(201)
    signers = [_key(rng) for _ in range(3)]
    legacy = _key(rng)              # signs SHA-1 only: no digest hint yet
    pubs = [keys.priv_to_pub(k) for k in signers]
    items = []
    for i in range(12):
        data = b"object %d " % i + rng.randbytes(40)
        k = i % 3
        items.append((data, ref_signing.sign(data, signers[k]), pubs[k],
                      True))
    for i in range(3):
        data = b"legacy %d" % i
        items.append((data, ref_signing.sign(data, legacy, "sha1"),
                      keys.priv_to_pub(legacy), True))
    data, sig, pub, _ = items[0]
    r, _s = fallback.der_decode_sig(sig)
    off_curve = pub[:-1] + bytes([pub[-1] ^ 1])
    items += [
        (data + b"!", sig, pub, False),                 # altered data
        (data, sig, pubs[1], False),                    # wrong key
        (data, sig[:-1], pub, False),                   # malformed DER
        (data, fallback.der_encode_sig(r, 0), pub, False),   # s = 0
        (data, sig, off_curve, False),                  # off curve
        (data, sig, pub[:64], False),                   # truncated pubkey
    ]
    return items


@pytest.fixture(scope="module")
def sealed():
    """ECIES payloads and (privkey, handle) candidates: matches at
    candidate 2 and 0, one payload for nobody, one made by the
    reference's encrypt, a malformed payload, and an invalid candidate
    scalar (zero) that must count as a miss."""
    rng = random.Random(202)
    recipients = [_key(rng) for _ in range(4)]
    stranger = _key(rng)
    candidates = [(recipients[0], "r0"), (bytes(32), "zero"),
                  (recipients[1], "r1"), (recipients[2], "r2")]

    def seal(text, key):
        return ecies.encrypt(text, keys.priv_to_pub(key),
                             ephem_priv=_key(rng), iv=rng.randbytes(16))

    payloads = [
        seal(b"to r1, third candidate", recipients[1]),
        seal(b"to r0, first candidate", recipients[0]),
        seal(b"to nobody here", stranger),
        ref_ecies.encrypt(b"sealed by the reference",
                          ref_keys.priv_to_pub(recipients[2])),
        b"\x00" * 40,
    ]
    want = [[(b"to r1, third candidate", "r1")],
            [(b"to r0, first candidate", "r0")], [],
            [(b"sealed by the reference", "r2")], []]
    return payloads, candidates, want


# ---------------------------------------------------------------------------
# host-side copies
# ---------------------------------------------------------------------------


def test_host_copies_match_reference(signed, sealed):
    rng = random.Random(203)
    for _ in range(4):
        k = _key(rng)
        pub = keys.priv_to_pub(k)
        assert pub == ref_keys.priv_to_pub(k)
        wire = keys.encode_pubkey_wire(pub)
        assert wire == ref_keys.encode_pubkey_wire(pub)
        assert keys.decode_pubkey_wire(wire) == \
            ref_keys.decode_pubkey_wire(wire)
        assert keys.pub_point64(pub) == ref_keys.pub_point64(pub)
    data, sig, pub, _ = signed[0]
    assert fallback.der_decode_sig(sig) == ref_fallback.der_decode_sig(sig)
    digest = hashlib.sha256(data).digest()
    assert fallback.ecdsa_sign_digest(digest, bytes(31) + b"\x07") == \
        ref_fallback.ecdsa_sign_digest(digest, bytes(31) + b"\x07")
    payloads, candidates, _ = sealed
    parsed = ecies.parse_payload(payloads[0])
    assert tuple(parsed) == tuple(ref_ecies.parse_payload(payloads[0]))
    assert ref_ecies.decrypt(payloads[0], candidates[2][0]) == \
        b"to r1, third candidate"
    x = fallback.ecdh_x(candidates[2][0], parsed.ephem_pub)
    assert ecies.kdf(x) == ref_ecies.kdf(x)
    key_e, key_m = ecies.kdf(x)
    assert ecies.mac_ok(key_m, parsed.macdata, parsed.tag)
    assert ecies.finish_decrypt(key_e, parsed) == b"to r1, third candidate"
    for bad in (b"", payloads[0][:60], b"\x00" * 90):
        with pytest.raises(ValueError):
            ecies.parse_payload(bad)
    with pytest.raises(ValueError):
        keys.priv_scalar32(bytes(32))
    with pytest.raises(ValueError):
        keys.pub_point64(b"\x04" + bytes(64))


def test_digest_hints_match_reference():
    pub = b"\x04" + hashlib.sha512(b"hint test").digest()
    for mod in (signing, ref_signing):
        assert mod.digest_order(pub) == ("sha256", "sha1")
        mod.note_digest(pub, "sha1", fallback=True)
        assert mod.digest_order(pub) == ("sha1", "sha256")
        mod.note_digest(pub, "sha256", fallback=True)
        assert mod.digest_order(pub) == ("sha256", "sha1")


# ---------------------------------------------------------------------------
# drain plans: the port's planners against the reference's
# ---------------------------------------------------------------------------


def _ref_verify_jobs(items):
    return [ref_batch._VerifyJob(d, s, p, None) for d, s, p, _ in items]


def _verify_jobs(items):
    return [batch._VerifyJob(d, s, p, None) for d, s, p, _ in items]


def test_verify_drains_match_reference_plan(signed):
    """Same digest rounds, same packed scalars, same results: round 1
    tries every parseable item's preferred digest, round 2 only the
    misses with the other one."""
    port_backend, ref_backend = RecordingBackend(), RecordingBackend()
    got = batch.BatchCryptoEngine(backend=port_backend)._backend_verify(
        port_backend, _verify_jobs(signed))
    want = ref_batch.BatchCryptoEngine(use_tpu=False)._backend_verify(
        ref_backend, _ref_verify_jobs(signed))
    assert got == want == [it[3] for it in signed]
    assert port_backend.calls == ref_backend.calls
    rounds = [call[1] for call in port_backend.calls]
    assert len(rounds) == 2 and rounds[1] < rounds[0]


def _decrypt_jobs(module, payloads, candidates):
    return [module._DecryptJob(p, list(candidates), None) for p in payloads]


def test_transposed_wavefront_matches_reference_plan(sealed):
    """Drains of at most drain_max pairs, planned wavefront-major; a
    matched object's remaining pairs are pruned; the plans and results
    are the reference's."""
    payloads, candidates, want = sealed
    rng = random.Random(204)
    more = [(_key(rng), "extra%d" % i) for i in range(5)]
    cands = candidates[:2] + more + candidates[2:]
    port_backend, ref_backend = RecordingBackend(), RecordingBackend()
    engine = batch.BatchCryptoEngine(backend=port_backend, drain_max=5)
    got = engine._backend_decrypt(
        port_backend, _decrypt_jobs(batch, payloads, cands))
    ref = ref_batch.BatchCryptoEngine(use_tpu=False, drain_max=5)
    expect = ref._backend_decrypt(
        ref_backend, _decrypt_jobs(ref_batch, payloads, cands))
    assert got == expect == want
    assert port_backend.calls == ref_backend.calls
    assert all(call[1] <= 5 for call in port_backend.calls)
    # object 1 matches at candidate 0 of the first drain: none of its
    # pairs (its ephemeral point) appears in a later drain
    point1 = ecies.parse_payload(payloads[1]).ephem_pub[1:]
    later = b"".join(call[2] for call in port_backend.calls[1:])
    assert all(later[i:i + 64] != point1 for i in range(0, len(later), 64))
    assert engine.drains == len(port_backend.calls)
    assert engine.drain_pairs == sum(c[1] for c in port_backend.calls)


# ---------------------------------------------------------------------------
# the engine end to end on the CPU: plain versions of the kernels
# ---------------------------------------------------------------------------


async def _run_engine(engine, signed=(), sealed=None):
    engine.start()
    try:
        verify = [engine.verify(d, s, p) for d, s, p, _ in signed]
        decrypt = [] if sealed is None else [
            engine.try_decrypt(p, sealed[1]) for p in sealed[0]]
        return await asyncio.gather(*verify, *decrypt)
    finally:
        await engine.stop()


async def test_engine_matches_reference_engine(signed, sealed):
    """One coalesced drain of signature checks and trial decrypts through
    ``CudaSecp(device="cpu")``, against the reference engine (host rungs)
    on the same inputs.  ``gpu_batch_min=1``: the drain (45 checks and
    pairs) is under the default threshold, which would route it to the
    native rung."""
    engine = batch.BatchCryptoEngine(device="cpu", gpu_batch_min=1)
    calls = []
    inner = engine.backend.verify_prepared

    def spy(n, *args, **kwargs):
        calls.append(n)
        return inner(n, *args, **kwargs)

    engine.backend.verify_prepared = spy
    got = await _run_engine(engine, signed, sealed)
    want = await _run_engine(ref_batch.BatchCryptoEngine(use_tpu=False),
                             signed, sealed)
    assert got == want
    assert got[:len(signed)] == [it[3] for it in signed]
    assert got[len(signed):] == sealed[2]
    assert len(calls) == 2                  # SHA-1 items take round 2
    assert engine.failed_drains == 0
    assert engine.gpu_items == len(signed) + len(sealed[0])
    assert engine.drains == 1
    assert engine.backend.snapshot()["calls"] == {"verify": 2, "ecdh": 1}


class FailingBackend(RecordingBackend):
    def verify_prepared(self, *args, **kwargs):
        raise RuntimeError("launch failed")


async def test_failed_drain_settles_conservatively(signed, sealed):
    """A failed card drain is settled conservatively, never re-run on a
    host rung."""
    engine = batch.BatchCryptoEngine(backend=FailingBackend(),
                                     gpu_batch_min=1)
    got = await _run_engine(engine, signed[:2], (sealed[0][:1], sealed[1]))
    assert got == [False, False, []]
    assert engine.failed_drains == 1
    assert engine.native_items == engine.pure_items == 0
    # the loop keeps draining after a failure
    engine.backend = RecordingBackend()
    got = await _run_engine(engine, signed[:1])
    assert got == [True] and engine.failed_drains == 1


class Screen:
    def __init__(self):
        self.inserted = []

    def insert(self, tag, epoch):
        self.inserted.append((tag, epoch))


async def test_screen_records_completed_no_match_sweeps(sealed):
    payloads, candidates, _ = sealed
    engine = batch.BatchCryptoEngine(backend=RecordingBackend())
    engine.screen = Screen()
    engine.start()
    try:
        got = await asyncio.gather(
            engine.try_decrypt(payloads[0], candidates, tag=b"t0", epoch=3),
            engine.try_decrypt(payloads[2], candidates, tag=b"t2", epoch=3),
            engine.try_decrypt(payloads[2], candidates))
        assert await engine.try_decrypt(payloads[2], []) == []
    finally:
        await engine.stop()
    assert got[0] and not got[1] and not got[2]
    assert engine.screen.inserted == [(b"t2", 3)]


async def test_stop_settles_queued_checks(signed, sealed):
    engine = batch.BatchCryptoEngine(backend=RecordingBackend())
    data, sig, pub, _ = signed[0]
    pending = [asyncio.ensure_future(engine.verify(data, sig, pub)),
               asyncio.ensure_future(engine.try_decrypt(sealed[0][0],
                                                        sealed[1]))]
    await asyncio.sleep(0)
    await engine.stop()
    assert await asyncio.gather(*pending) == [False, []]


# ---------------------------------------------------------------------------
# batched PoW verification
# ---------------------------------------------------------------------------


def _pow_objects(rng, n, flipped):
    """116-byte objects expiring in an hour, solved at ntpb = extra = 10
    with hashlib, and ``flipped`` copies with a nonce bit flipped."""
    expires = int(time.time()) + 3600
    target = pow_target(116, 3600, 10, 10, clamp=False)
    objs = []
    for i in range(n):
        body = expires.to_bytes(8, "big") + (2).to_bytes(4, "big") \
            + b"\x01\x01" + rng.randbytes(94)
        ih = pow_initial_hash(body)
        nonce = 0
        while pow_value(nonce.to_bytes(8, "big") + body) > target:
            nonce += 1
        assert pow_initial_hash(body) == ih
        objs.append(nonce.to_bytes(8, "big") + body)
    for i in range(flipped):
        ob = bytearray(objs[i])
        ob[7 - i % 8] ^= 1 << (i % 7)
        objs.append(bytes(ob))
    return objs


async def _check_all(verifier, objs):
    verifier.start()
    try:
        return await asyncio.gather(*(verifier.check(ob) for ob in objs))
    finally:
        await verifier.stop()


async def test_batch_verifier_matches_check_pow():
    objs = _pow_objects(random.Random(205), 10, 6)
    want = [ref_check_pow(ob, 10, 10, clamp=False) for ob in objs]
    assert want[:10] == [True] * 10
    assert want == [check_pow(ob, 10, 10, clamp=False) for ob in objs]
    verifier = BatchVerifier(device="cpu", ntpb=10, extra=10, clamp=False)
    assert await _check_all(verifier, objs) == want
    assert verifier.device_batches == 1
    assert verifier.device_checked == len(objs)
    # a drain below MIN_DEVICE_BATCH takes the host path
    small = BatchVerifier(device="cpu", ntpb=10, extra=10, clamp=False)
    assert await _check_all(small, objs[:1]) == want[:1]
    assert (small.host_checked, small.device_batches) == (1, 0)


async def test_batch_verifier_device_failure_reaches_callers(monkeypatch):
    def broken(items, device=None):
        raise RuntimeError("device verify failed")

    monkeypatch.setattr(verify_service, "verify", broken)
    objs = _pow_objects(random.Random(206), 4, 0)
    verifier = BatchVerifier(device="cpu", ntpb=10, extra=10, clamp=False)
    verifier.start()
    try:
        got = await asyncio.gather(*(verifier.check(ob) for ob in objs),
                                   return_exceptions=True)
    finally:
        await verifier.stop()
    assert all(isinstance(g, RuntimeError) for g in got)
    assert verifier.device_batches == 0 and verifier.host_checked == 0


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.BatchCryptoEngine()
    # an injected backend needs no device
    assert batch.BatchCryptoEngine(backend=RecordingBackend()).drains == 0
