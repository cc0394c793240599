"""Preflight doctor of the port: ``python -m pybitmessage_tpu_torch.doctor``
(twin of ``tools/tpu_doctor.py``).

It makes one tiny launch of every program in the device-telemetry
catalog and checks each answer: the nonce searches against hashlib (the
lowest valid nonce of a small range, found by a host scan), the batched
PoW check against hashlib, secp256k1 verify and ECDH against the
pure-Python curve arithmetic of ``crypto/fallback.py``.  Every probe
must also have been counted by the registry (``device_launches_total``).
A failure is matched against a table of known failure signatures and
named, with a remediation hint.  The report leads with the environment
fingerprint and the device table (``observability.devicetelemetry``).

Output is one JSON report on stdout; exit status 0 when every probe
passes, 1 otherwise.  ``--device cpu`` runs the kernels' plain versions
(no card is touched); without it the probes run on the CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import re
import sys
import time

#: known failure signatures, checked in order: (regex over the failure
#: text, diagnosis name, remediation hint)
SIGNATURES: list[tuple[str, str, str]] = [
    (r"no CUDA device|CUDA driver version is insufficient|"
     r"no CUDA-capable device",
     "no-cuda-device",
     "no usable CUDA card: check the driver and that the card is "
     "visible (nvidia-smi); on a host without one pass --device cpu"),
    (r"nvcc not found|nvcc failed",
     "kernel-build-failed",
     "the kernels of csrc/ did not build: check /usr/local/cuda (or "
     "CUDA_HOME) holds nvcc for sm_90a and read the compiler output"),
    (r"no kernel image is available|invalid device function",
     "wrong-architecture",
     "the kernel library was built for another card: the port builds "
     "for sm_90a (Hopper) only"),
    (r"out of memory|CUDA_ERROR_OUT_OF_MEMORY",
     "device-out-of-memory",
     "the card's memory is taken: another process may hold it "
     "(nvidia-smi lists them)"),
]

_IH = bytes(range(64))
#: a target a trial beats about once in 16
_TARGET = (1 << 64) // 16


def diagnose_text(text: str):
    """``{"name", "hint", "match"}`` of the first signature found in
    ``text``, or None."""
    for pattern, name, hint in SIGNATURES:
        m = re.search(pattern, text, re.IGNORECASE)
        if m:
            return {"name": name, "hint": hint, "match": m.group(0)}
    return None


def _trial(nonce: int, ih: bytes) -> int:
    d = hashlib.sha512(hashlib.sha512(
        nonce.to_bytes(8, "big") + ih).digest()).digest()
    return int.from_bytes(d[:8], "big")


def _lowest(ih: bytes, target: int, start: int = 0) -> int:
    nonce = start
    while _trial(nonce, ih) > target:
        nonce += 1
    return nonce


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# one probe per catalog program
# ---------------------------------------------------------------------------


def _probe_pallas_slab(device):
    from .ops import sha512_cuda
    nonce, _ = sha512_cuda.solve(_IH, _TARGET, rows=8, chunks_per_call=1,
                                 unroll=1, device=device)
    _require(nonce == _lowest(_IH, _TARGET),
             "pallas_slab nonce %d is not hashlib's lowest" % nonce)


def _pipeline_probe(device, plan):
    from .pow import pipeline
    items = [(hashlib.sha512(bytes([i])).digest(), _TARGET)
             for i in range(len(plan.order))]
    results = pipeline.solve_batch_pipelined(items, rows=16, device=device,
                                             plan=plan)
    for (ih, target), (nonce, _) in zip(items, results):
        _require(nonce == _lowest(ih, target),
                 "nonce %d is not hashlib's lowest" % nonce)


def _probe_batch_search(device):
    from .pow.pipeline import BatchPlan
    _pipeline_probe(device, BatchPlan("batched", 1, 1, list(range(4))))


def _probe_packed_search(device):
    from .pow.pipeline import BatchPlan
    _pipeline_probe(device, BatchPlan("packed", 2, 1, list(range(4))))


def _probe_pow_verify(device):
    from .ops import pow_search
    nonce = _lowest(_IH, _TARGET)
    items = [(nonce, _IH, _TARGET), (nonce, _IH, _trial(nonce, _IH) - 1)]
    want = [_trial(n, ih) <= t for n, ih, t in items]
    _require(pow_search.verify(items, device=device) == want,
             "pow_verify disagrees with hashlib")


def _secp_lanes(prng: random.Random):
    """Two verify lanes (one valid, one with r + 1), their u1, u2, Q, r
    as bytes, and one ECDH pair."""
    from .crypto import fallback as fb
    n = fb.N
    d = prng.randrange(1, n)
    q = fb.base_mult(d)
    k = prng.randrange(1, n)
    r = fb.base_mult(k)[0] % n
    u2 = prng.randrange(1, n)
    u1 = (k - u2 * d) % n
    lanes = [(u1, u2, q, r), (u1, u2, q, (r + 1) % n)]
    return lanes, (prng.randrange(1, n), fb.base_mult(prng.randrange(1, n)))


def _oracle_verify(u1, u2, q, r) -> bool:
    from .crypto import fallback as fb
    pt = fb._jac_add(fb._as_jac(fb.base_mult(u1)),
                     fb._as_jac(fb.point_mult(u2, q)))
    aff = fb._jac_to_affine(pt)
    return aff is not None and aff[0] % fb.N == r


def _probe_secp_verify(device):
    from .crypto.gpu import CudaSecp
    lanes, _ = _secp_lanes(random.Random(1))

    def be(vals):
        return b"".join(v.to_bytes(32, "big") for v in vals)
    got = CudaSecp(device).verify_prepared(
        len(lanes), be(u1 for u1, _, _, _ in lanes),
        be(u2 for _, u2, _, _ in lanes),
        b"".join(be(q) for _, _, q, _ in lanes),
        be(r for _, _, _, r in lanes))
    want = [_oracle_verify(*lane) for lane in lanes]
    _require(got == want == [True, False],
             "secp_verify %r, oracle %r" % (got, want))


def _probe_secp_ecdh(device):
    from .crypto import fallback as fb
    from .crypto.gpu import CudaSecp
    _, (k, p) = _secp_lanes(random.Random(2))
    got = CudaSecp(device).ecdh_batch(
        1, p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big"),
        k.to_bytes(32, "big"))
    want = fb.point_mult(k, p)[0].to_bytes(32, "big")
    _require(got == [want], "secp_ecdh disagrees with the oracle")


_PROBES = {
    "pallas_slab": _probe_pallas_slab,
    "batch_search": _probe_batch_search,
    "packed_search": _probe_packed_search,
    "pow_verify": _probe_pow_verify,
    "secp_verify": _probe_secp_verify,
    "secp_ecdh": _probe_secp_ecdh,
}


def run_preflight(device=None, only=None) -> dict:
    """Probe every catalog program; ``report["ok"]`` drives the exit
    status."""
    from . import resolve_device
    from .observability import REGISTRY, device_status
    from .observability.devicetelemetry import DEVICE_TELEMETRY

    report: dict = {}
    try:
        dev = resolve_device(device)
    except RuntimeError as exc:
        report.update(ok=False, error=repr(exc),
                      diagnosis=diagnose_text(str(exc)))
        return report
    report["device"] = str(dev)
    probes = {k: v for k, v in _PROBES.items() if not only or k in only}
    report["probes"] = {}
    ok = True
    for name, fn in sorted(probes.items()):
        entry: dict = {}
        before = REGISTRY.sample("device_launches_total",
                                 {"program": name})
        t0 = time.monotonic()
        try:
            fn(dev)
            launches = REGISTRY.sample("device_launches_total",
                                       {"program": name}) - before
            _require(launches >= 1, "%s made no counted launch" % name)
            entry.update(ok=True, launches=int(launches))
        except Exception as exc:
            ok = False
            entry.update(ok=False, error=repr(exc),
                         diagnosis=diagnose_text(
                             "%s\n%s" % (type(exc).__name__, exc)))
        entry["seconds"] = round(time.monotonic() - t0, 3)
        report["probes"][name] = entry
    # a registered program without a probe is a finding: the doctor
    # grows in lockstep with the catalog
    unprobed = sorted(set(DEVICE_TELEMETRY.programs()) - set(_PROBES))
    if unprobed and not only:
        ok = False
        report["unprobed"] = unprobed
    status = device_status()
    report["env"] = status["env"]
    report["devices"] = status["devices"]
    report["ok"] = ok
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions "
                         "(default: the CUDA card)")
    ap.add_argument("--only", action="append", default=None,
                    help="probe only this program (repeatable)")
    args = ap.parse_args(argv)
    report = run_preflight(args.device, args.only)
    print(json.dumps(report, indent=2, default=repr))
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
