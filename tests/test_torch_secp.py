"""The port's secp256k1 receive kernels against the JAX package and
Python integers.

* ``csrc/secp256k1.cuh`` built by g++ for the host: field operations
  against Python integers, full-width point multiplication and Shamir
  verification against the port's ``crypto/fallback.py``;
* the plain torch versions (``ops/secp256k1.py``) against the JAX
  package's limb arithmetic, limb for limb, and against its XLA drain
  programs ``xla_verify`` / ``xla_ecdh`` at full width;
* the drain ABI ``CudaSecp(device="cpu")`` against the JAX ``TpuSecp``
  (XLA path) and the pure-Python oracle, wire junk included;
* wrapper hygiene, and (on a card only) each kernel against its plain
  version.

Every input comes from a seed; every comparison is exact.  The JAX side
compiles each drain program once, at the 64-lane bucket.  The JAX
package is imported inside fixtures, so the header and card tests also
run where JAX is not installed.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pybitmessage_tpu_torch.crypto import fallback, gpu
from pybitmessage_tpu_torch.ops import _build, secp256k1_cuda
from pybitmessage_tpu_torch.ops import secp256k1 as S

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pybitmessage_tpu_torch" / "csrc"
P, N, GX, GY = S.P, S.N, S.GX, S.GY
LANES = 64


def _be(vals) -> bytes:
    return b"".join(v.to_bytes(32, "big") for v in vals)


def _ints(buf: bytes, n: int) -> list[int]:
    return [int.from_bytes(buf[32 * i:32 * i + 32], "big") for i in range(n)]


def _u8(vals) -> torch.Tensor:
    """Python ints -> the drain ABI's (n, 32) uint8 tensor."""
    return torch.from_numpy(
        np.frombuffer(_be(vals), dtype=np.uint8).reshape(-1, 32).copy())


def _affine_step(pt):
    """pt + G, affine."""
    return fallback._jac_to_affine(
        fallback._jac_add(fallback._as_jac(pt), (GX, GY, 1)))


def _verify_vectors(rng, count):
    """(u1, u2, (qx, qy), r, expected) ECDSA lanes: signature relations
    e = s*k - r*d (every fifth corrupted), with R = k*G and Q = d*G
    walked by one affine addition per lane, and the adversarial lanes:
    u1 = u2 = 0, Q = G, Q = -G, r = 0."""
    k0 = rng.randrange(1, N - count)
    d0 = rng.randrange(1, N - count)
    Rpt, Q = fallback.base_mult(k0), fallback.base_mult(d0)
    items = []
    for i in range(count):
        k, d = k0 + i, d0 + i
        r = Rpt[0] % N
        s = rng.randrange(1, N)
        e = (s * k - r * d) % N
        corrupted = i % 5 == 4
        if corrupted:
            e = (e + 1) % N
        w = pow(s, -1, N)
        items.append(((e * w) % N, (r * w) % N, Q, r, not corrupted))
        Rpt, Q = _affine_step(Rpt), _affine_step(Q)
    two_g = fallback.base_mult(2)
    items[0] = (0, 0, items[0][2], items[0][3], False)      # infinity
    items[1] = (1, 1, (GX, GY), two_g[0] % N, True)          # Q = G
    items[2] = (1, 1, (GX, P - GY), 1, False)                # Q = -G
    items[3] = (items[3][0], items[3][1], items[3][2], 0, False)  # r = 0
    # x in [n, p): accepted with r = x - n only; the join of the
    # kernels' halves doubles (u1 G == u2 G) and meets its inverse
    xn, yn = _point_from_x(N + 1)
    u = items[20][0] or 1
    items[20] = (0, 1, (xn, yn), xn - N, True)
    items[21] = (0, 1, (xn, yn), xn, False)
    items[22] = (u, u, (GX, GY), fallback.base_mult(2 * u)[0] % N, True)
    items[23] = (u, N - u, (GX, GY), 1, False)
    return items


def _ecdh_vectors(rng, count):
    """(k, (px, py), expected (x, y) or None) lanes: random scalars on
    a walk of points, plus k = 0, k = N, k = 1, k = N - 1, an off-curve
    P and P = G."""
    pt = fallback.base_mult(rng.randrange(1, N - count))
    ks, pts = [], []
    for _ in range(count):
        ks.append(rng.randrange(1, N))
        pts.append(pt)
        pt = _affine_step(pt)
    ks[0], ks[1], ks[2], ks[3] = 0, N, 1, N - 1
    pts[4] = (pts[4][0], pts[4][1] ^ 1)                      # off curve
    pts[5] = (GX, GY)
    # coordinates at or above p: the kernels reduce them once on load,
    # as the plain version's lazy limbs treat them
    x0, y0 = _small_x_point()
    pts[6], pts[7], pts[8] = (x0 + P, y0), (P, 0), (2**256 - 1, 5)
    # P = G through the comb with halves equal (the join doubles) and
    # inverse (k = n)
    k_hi = (1 << 128) - 1
    ks[9], pts[9] = (k_hi << 128) + (k_hi << 128) - N, (GX, GY)
    ks[10], pts[10] = N, (GX, GY)
    want = [fallback.point_mult(k, (x % P, y % P))
            if fallback.on_curve(x % P, y % P) else None
            for k, (x, y) in zip(ks, pts)]
    return ks, pts, want


def _point_from_x(x):
    """The on-curve point with the least x' >= x; p = 3 mod 4, so a
    square root is one power."""
    while True:
        v = (x ** 3 + 7) % P
        y = pow(v, (P + 1) // 4, P)
        if y * y % P == v:
            return x, y
        x += 1


def _small_x_point():
    """The on-curve point with the least x > 0 (x + p still fits 256
    bits)."""
    return _point_from_x(1)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, built for the host
# ---------------------------------------------------------------------------

_HARNESS = r'''
#include "secp256k1.cuh"
extern "C" void bm_host_selftest(int op, const uint8_t* a, const uint8_t* b,
                                 uint8_t* out, int n) {
    for (int i = 0; i < n; ++i)
        bm_secp_selftest_one(op, a + 32 * i, b + 32 * i, out + 64 * i);
}
extern "C" void bm_host_verify(const uint8_t* u1, const uint8_t* u2,
                               const uint8_t* qx, const uint8_t* qy,
                               const uint8_t* r, const uint32_t* comb,
                               uint8_t* ok, int n) {
    for (int i = 0; i < n; ++i)
        ok[i] = (uint8_t)bm_secp_verify_lane(u1 + 32 * i, u2 + 32 * i,
                                             qx + 32 * i, qy + 32 * i,
                                             r + 32 * i, comb);
}
extern "C" void bm_host_ecdh(const uint8_t* k, const uint8_t* px,
                             const uint8_t* py, const uint32_t* comb,
                             uint8_t* x, uint8_t* y, uint8_t* ok, int n) {
    for (int i = 0; i < n; ++i)
        ok[i] = (uint8_t)bm_secp_ecdh_lane(k + 32 * i, px + 32 * i,
                                           py + 32 * i, x + 32 * i,
                                           y + 32 * i, comb);
}
static void host_jac(bm_jac* p, const uint8_t* b, uint8_t inf) {
    bm_load256(p->X.v, b);
    bm_load256(p->Y.v, b + 32);
    bm_load256(p->Z.v, b + 64);
    p->inf = inf;
}
// op 0: a + b (complete), 1: a + (b.X, b.Y) mixed with use[i], 2: 2a;
// the result as canonical affine x || y (zeros at infinity) and inf
extern "C" void bm_host_group(int op, const uint8_t* a, const uint8_t* ainf,
                              const uint8_t* b, const uint8_t* binf,
                              const uint8_t* use, uint8_t* out,
                              uint8_t* oinf, int n) {
    for (int i = 0; i < n; ++i) {
        bm_jac p, q, s;
        host_jac(&p, a + 96 * i, ainf[i]);
        host_jac(&q, b + 96 * i, binf[i]);
        if (op == 0) bm_jac_add(&s, &p, &q);
        else if (op == 1) bm_jac_madd(&s, &p, &q.X, &q.Y, use[i]);
        else bm_jac_dbl(&s, &p);
        bm_fe x = {{0, 0, 0, 0, 0, 0, 0, 0}}, y = x;
        if (!s.inf) bm_jac_to_aff(&x, &y, &s);
        bm_store256(out + 64 * i, x.v);
        bm_store256(out + 64 * i + 32, y.v);
        oinf[i] = (uint8_t)s.inf;
    }
}
// P's window table: 15 points x || y then their shared Z, canonical
extern "C" void bm_host_window_table(const uint8_t* px, const uint8_t* py,
                                     uint8_t* out, int n) {
    for (int i = 0; i < n; ++i) {
        bm_fe x, y, zg;
        bm_aff T[15];
        bm_load256(x.v, px + 32 * i);
        bm_load256(y.v, py + 32 * i);
        bm_window_table(T, &zg, &x, &y);
        for (int j = 0; j < 15; ++j) {
            bm_fe_canon(&x, &T[j].x);
            bm_fe_canon(&y, &T[j].y);
            bm_store256(out + 992 * i + 64 * j, x.v);
            bm_store256(out + 992 * i + 64 * j + 32, y.v);
        }
        bm_fe_canon(&zg, &zg);
        bm_store256(out + 992 * i + 960, zg.v);
    }
}
extern "C" void bm_host_rcheck(const uint8_t* a, const uint8_t* ainf,
                               const uint8_t* r, uint8_t* ok, int n) {
    for (int i = 0; i < n; ++i) {
        bm_jac p;
        uint32_t rv[8];
        host_jac(&p, a + 96 * i, ainf[i]);
        bm_load256(rv, r + 32 * i);
        ok[i] = (uint8_t)bm_verify_rcheck(&p, rv);
    }
}
'''


@pytest.fixture(scope="module")
def host_secp(tmp_path_factory):
    """csrc/secp256k1.cuh compiled by g++ into a ctypes library."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = tmp_path_factory.mktemp("host_secp")
    src = out / "host_secp.cpp"
    src.write_text(_HARNESS)
    lib_path = out / "libhostsecp.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib_path))


_FIELD_OPS = {
    "mul": lambda a, b: a * b % P,
    "sqr": lambda a, b: a * a % P,
    "add": lambda a, b: (a + b) % P,
    "sub": lambda a, b: (a - b) % P,
    "fold": lambda a, b: (a * _M + b) % P,
    "canon": lambda a, b: a % P,
    "inv": lambda a, b: pow(a, P - 2, P),
}
#: op codes of bm_secp_selftest_one (csrc/secp256k1.cuh)
_SELFTEST = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "fold": 4, "canon": 5,
             "inv": 6, "split": 7}
_M = 1 << 256
_RC = _M - P                                 # 2^256 mod p = 2^32 + 977
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8


def _glv_split(k):
    """libsecp256k1's split on Python integers: k = k1 + k2 * lambda
    (mod n) with round(k b2 / n), round(k (-b1) / n) (b2 = a1)."""
    k %= N
    c1 = (k * (((GLV_A1 << 384) + N // 2) // N) + (1 << 383)) >> 384
    c2 = (k * (((-GLV_B1 << 384) + N // 2) // N) + (1 << 383)) >> 384
    return k - c1 * GLV_A1 - c2 * GLV_A2, -c1 * GLV_B1 - c2 * GLV_A1


def _selftest(lib, op, a, b):
    """The header's primitive ``op`` on operand pairs: its two 32-byte
    outputs as integers."""
    n = len(a)
    out = ctypes.create_string_buffer(64 * n)
    lib.bm_host_selftest(_SELFTEST[op], _be(a), _be(b), out, n)
    raw = out.raw
    return ([int.from_bytes(raw[64 * i:64 * i + 32], "big")
             for i in range(n)],
            [int.from_bytes(raw[64 * i + 32:64 * i + 64], "big")
             for i in range(n)])


def _signed(v):
    return v - _M if v >> 255 else v


def _boundaries():
    """Every pair of the carry boundaries, as operands taken unreduced,
    and 512-bit values whose fold carries out of 2^256 twice."""
    edges = [0, 1, 2, 976, 977, _RC - 1, _RC, _RC + 1, 2**32 - 1,
             2**224 - 1, 2**255, P - 1, P, P + 1, _M - _RC - 1, _M - 2,
             _M - 1, N - 1, N, LAMBDA]
    a = [x for x in edges for _ in edges]
    b = [y for _ in edges for y in edges]
    for hi in edges[-9:]:
        for j in (0, 1, 977):
            a.append(hi)
            b.append((_M - 1 - j - hi * _RC) % _M)
    return a, b


def _fold_carries_twice(hi, lo):
    """The fold's last addition carries out of 2^256 (its model)."""
    x = lo + hi * _RC
    return (x % _M + (x >> 256) * _RC) >> 256


@pytest.mark.parametrize("op", ["add", "inv", "mul", "sqr", "sub"])
def test_header_field_ops_match_python_ints(host_secp, op):
    """Results are lazy (below 2^256, equal mod p): reduced here, as the
    kernels reduce before a compare or a store."""
    rng = random.Random(101)
    edges = [0, 1, P - 1, P - 2, P - 3, 2**255, 2**255 - 1, 7, 2**128,
             2**256 - 2**32 - 978, 2**64 - 1]
    a = edges + [rng.randrange(P) for _ in range(1000)]
    b = [P - 1, P - 1, 1, P - 2, 2**255, 12345, P - 1, 0, P - 7, 2**255,
         1] + [rng.randrange(P) for _ in range(1000)]
    got, _ = _selftest(host_secp, op, a, b)
    want = [_FIELD_OPS[op](x, y) for x, y in zip(a, b)]
    bad = [i for i in range(len(a)) if got[i] % P != want[i]]
    assert not bad, (op, bad[:5])


@pytest.mark.parametrize("op", sorted(_SELFTEST))
def test_header_carry_boundaries_match_python_ints(host_secp, op):
    """Every primitive on the carry boundaries: 0, 1, p - 1, p, 2^256 - 1,
    2^32 + 977 and its neighbours, n, lambda, and folds that carry
    twice; canonical results exactly, the split exactly libsecp256k1's."""
    a, b = _boundaries()
    assert sum(_fold_carries_twice(x, y) for x, y in zip(a, b)) >= 9
    got, got2 = _selftest(host_secp, op, a, b)
    for i, (x, y) in enumerate(zip(a, b)):
        if op == "split":
            k1, k2 = _signed(got[i]), _signed(got2[i])
            assert (k1, k2) == _glv_split(x), i
        elif op == "canon":
            assert got[i] == x % P, i
        else:
            assert got[i] % P == _FIELD_OPS[op](x, y), (i, x, y)


def test_header_square_equals_product(host_secp):
    """The 36-product squaring gives the same words as a * a."""
    rng = random.Random(111)
    a = _boundaries()[0][:400] + [rng.randrange(_M) for _ in range(500)]
    assert _selftest(host_secp, "sqr", a, a)[0] == \
        _selftest(host_secp, "mul", a, a)[0]


def test_header_glv_split(host_secp):
    """k1 + k2 lambda == k (mod n), |k1|, |k2| < 2^128, over all 256 bits
    of k (k >= n is reduced first)."""
    rng = random.Random(112)
    ks = [0, 1, N - 1, N, N + 1, _M - 1, LAMBDA, N - LAMBDA, GLV_A1,
          -GLV_B1, GLV_A2] + [rng.randrange(_M) for _ in range(2000)]
    k1s, k2s = _selftest(host_secp, "split", ks, ks)
    for k, k1, k2 in zip(ks, k1s, k2s):
        k1, k2 = _signed(k1), _signed(k2)
        assert (k1 + k2 * LAMBDA - k) % N == 0, k
        assert abs(k1) < 1 << 128 and abs(k2) < 1 << 128, k
    assert fallback.point_mult(LAMBDA, (GX, GY))[1] == GY    # phi(G)


def test_comb_table_matches_base_mult():
    """comb[i][j - 1] = j * 16^i * G, canonical, for every entry."""
    words = secp256k1_cuda.comb_words()
    assert words.shape == (64, 15, 16) and words.dtype == np.uint32
    for i in range(64):
        for j in range(15):
            x, y = (sum(int(v) << (32 * m) for m, v in enumerate(half))
                    for half in (words[i, j, :8], words[i, j, 8:]))
            assert (x, y) == fallback.base_mult((j + 1) << (4 * i)), (i, j)
    table = secp256k1_cuda.comb_table("cpu")
    assert table is secp256k1_cuda.comb_table("cpu")
    assert table.shape == (64 * 15 * 16,) and table.dtype == torch.uint32


def test_header_window_table_matches_multiples(host_secp):
    """j * P for j = 1..15 as (x_j, y_j, zg): one Z for the table."""
    rng = random.Random(113)
    pts = [(GX, GY), _small_x_point(), _point_from_x(N)] + [
        fallback.base_mult(rng.randrange(1, N)) for _ in range(3)]
    n = len(pts)
    out = ctypes.create_string_buffer(992 * n)
    host_secp.bm_host_window_table(_be([p[0] for p in pts]),
                                   _be([p[1] for p in pts]), out, n)
    vals = _ints(out.raw, 31 * n)
    for i, pt in enumerate(pts):
        zg = vals[31 * i + 30]
        assert zg != 0
        for j in range(15):
            x, y = vals[31 * i + 2 * j:31 * i + 2 * j + 2]
            assert fallback._jac_to_affine((x, y, zg)) == \
                fallback.point_mult(j + 1, pt), (i, j)


def _jac_bytes(pt, z):
    """An affine point as X || Y || Z with Z = z (infinity: zeros)."""
    if pt is None:
        return _be([0, 0, 0])
    x, y = pt
    return _be([x * z * z % P, y * z * z * z % P, z])


def _group(lib, op, cases):
    """(a, b, use) cases of affine points or None -> bm_host_group's
    affine results (None at infinity)."""
    rng = random.Random(114)
    n = len(cases)
    a = b"".join(_jac_bytes(c[0], rng.randrange(2, P)) for c in cases)
    b = b"".join(_jac_bytes(c[1], 1 if op == 1 else rng.randrange(2, P))
                 for c in cases)
    ainf = bytes(int(c[0] is None) for c in cases)
    binf = bytes(int(c[1] is None) for c in cases)
    use = bytes(c[2] for c in cases)
    out = ctypes.create_string_buffer(64 * n)
    oinf = ctypes.create_string_buffer(n)
    lib.bm_host_group(op, a, ainf, b, binf, use, out, oinf, n)
    vals = _ints(out.raw, 2 * n)
    return [None if oinf.raw[i] else (vals[2 * i], vals[2 * i + 1])
            for i in range(n)]


def test_header_group_steps_with_equal_inverse_and_infinite_operands(
        host_secp):
    """The mixed addition (selects), the complete addition that joins a
    lane's halves, and the doubling, against the pure-Python group law:
    generic, equal (doubles), inverse (infinity), an operand at
    infinity, and a mixed addition with use = 0."""
    rng = random.Random(115)
    p1, p2 = (fallback.base_mult(rng.randrange(1, N)) for _ in range(2))
    neg = (p1[0], P - p1[1])
    dbl = fallback.point_mult(2, p1)
    add = fallback._jac_to_affine(fallback._jac_add(
        fallback._as_jac(p1), fallback._as_jac(p2)))
    cases = [(p1, p2, 1), (p1, p1, 1), (p1, neg, 1), (None, p2, 1),
             (p1, p2, 0), (None, p2, 0)]
    assert _group(host_secp, 1, cases) == [add, dbl, None, p2, p1, None]
    cases = [(p1, p2, 1), (p1, p1, 1), (p1, neg, 1), (None, p2, 1),
             (p1, None, 1), (None, None, 1)]
    assert _group(host_secp, 0, cases) == [add, dbl, None, p2, p1, None]
    assert _group(host_secp, 2, [(p1, p1, 1), (None, p1, 1)]) == \
        [dbl, None]


def test_header_projective_r_check(host_secp):
    """x mod n == r without an inversion: X == r Z^2, or (r + n) Z^2 when
    r + n < p; r >= n never matches; infinity never matches."""
    rng = random.Random(116)
    pt = fallback.base_mult(rng.randrange(1, N))
    xn = _point_from_x(N)                     # x = n exactly: x mod n = 0
    xw = _point_from_x(N + 12345)             # x in (n, p)
    x0 = _small_x_point()
    cases = [(pt, pt[0] % N, 1), (pt, pt[0] % N + 1, 0),
             (x0, x0[0], 1), (x0, x0[0] + N, 0), (xn, 0, 1), (xn, N, 0),
             (xw, xw[0] - N, 1), (xw, xw[0], 0), (None, 0, 0),
             (None, 5, 0)]
    assert xn[0] == N
    n = len(cases)
    a = b"".join(_jac_bytes(c[0], rng.randrange(2, P)) for c in cases)
    ainf = bytes(int(c[0] is None) for c in cases)
    ok = ctypes.create_string_buffer(n)
    host_secp.bm_host_rcheck(a, ainf, _be([c[1] for c in cases]), ok, n)
    assert list(ok.raw) == [c[2] for c in cases]


@pytest.fixture(scope="module")
def comb():
    """The comb as the host build reads it (a pointer to uint32 words)."""
    words = np.ascontiguousarray(secp256k1_cuda.comb_words().reshape(-1))
    return words, words.ctypes.data_as(ctypes.c_void_p)


def test_header_point_mult_matches_fallback(host_secp, comb):
    ks, pts, want = _ecdh_vectors(random.Random(102), 40)
    n = len(ks)
    x = ctypes.create_string_buffer(32 * n)
    y = ctypes.create_string_buffer(32 * n)
    ok = ctypes.create_string_buffer(n)
    host_secp.bm_host_ecdh(_be(ks), _be([p[0] for p in pts]),
                           _be([p[1] for p in pts]), comb[1], x, y, ok, n)
    xs, ys = _ints(x.raw, n), _ints(y.raw, n)
    for i in range(n):
        if want[i] is None:
            assert (ok.raw[i], xs[i], ys[i]) == (0, 0, 0), i
        else:
            assert (ok.raw[i], xs[i], ys[i]) == (1, *want[i]), i


def test_header_shamir_verify_matches_fallback(host_secp, comb):
    items = _verify_vectors(random.Random(103), 40)
    n = len(items)
    ok = ctypes.create_string_buffer(n)
    host_secp.bm_host_verify(
        _be([it[0] for it in items]), _be([it[1] for it in items]),
        _be([it[2][0] for it in items]), _be([it[2][1] for it in items]),
        _be([it[3] for it in items]), comb[1], ok, n)
    assert [bool(b) for b in ok.raw] == [it[4] for it in items]
    # the oracle agrees on a sample, through its own textbook verifier
    for u1, u2, q, r, want in items[4:12]:
        if u2:
            # (u1, u2) = (e/s, r/s): pick s = r/u2, then e = u1 * s
            s = r * pow(u2, -1, N) % N
            assert fallback.ecdsa_verify_scalars(u1 * s % N, r, s, q) \
                == want


@pytest.fixture(scope="module")
def host_parts(tmp_path_factory):
    """torch_tools/secp_parts.cu (the design's parts 1-4 as one-thread
    variants, timed by torch_tools/secp_parts_bench.py) compiled by g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    lib_path = tmp_path_factory.mktemp("host_parts") / "libhostparts.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-x", "c++", "-I",
                    str(CSRC), "-o", str(lib_path),
                    str(ROOT / "torch_tools" / "secp_parts.cu")],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib_path))


@pytest.mark.parametrize("part", [1, 2, 3, 4])
def test_part_variants_verify_match_fallback(host_parts, comb, part):
    items = _verify_vectors(random.Random(110), 24)
    n = len(items)
    ok = ctypes.create_string_buffer(n)
    assert host_parts.bm_part_verify_host(
        part, _be([it[0] for it in items]), _be([it[1] for it in items]),
        _be([it[2][0] for it in items]), _be([it[2][1] for it in items]),
        _be([it[3] for it in items]), comb[1], ok, n) == 0
    assert [bool(b) for b in ok.raw] == [it[4] for it in items]


@pytest.mark.parametrize("part", [1, 2, 3, 4])
def test_part_variants_ecdh_match_fallback(host_parts, comb, part):
    ks, pts, want = _ecdh_vectors(random.Random(111), 16)
    n = len(ks)
    x = ctypes.create_string_buffer(32 * n)
    y = ctypes.create_string_buffer(32 * n)
    ok = ctypes.create_string_buffer(n)
    assert host_parts.bm_part_ecdh_host(
        part, _be(ks), _be([p[0] for p in pts]), _be([p[1] for p in pts]),
        comb[1], x, y, ok, n) == 0
    xs, ys = _ints(x.raw, n), _ints(y.raw, n)
    for i in range(n):
        if want[i] is None:
            assert (ok.raw[i], xs[i], ys[i]) == (0, 0, 0), i
        else:
            assert (ok.raw[i], xs[i], ys[i]) == (1, *want[i]), i


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def R():
    """The JAX package's secp256k1 module (its limb arithmetic, codecs
    and XLA drain programs)."""
    pytest.importorskip("jax")
    from pybitmessage_tpu.ops import secp256k1_pallas
    return secp256k1_pallas


def _limbs(vals) -> np.ndarray:
    return S.bytes_to_limbs(_be(vals), len(vals))


@pytest.fixture(scope="module")
def field_pair():
    rng = random.Random(104)
    edges = [0, 1, P - 1, P - 2, 2**255, 2**256 - 1,
             sum(0x1FFF << (13 * i) for i in range(19)) + (0x1FF << 247)]
    a = edges + [rng.randrange(2**256) for _ in range(LANES - len(edges))]
    b = [P - 1] * len(edges) + [rng.randrange(P)
                                for _ in range(LANES - len(edges))]
    return _limbs(a), _limbs(b)


def _cat_times3(m, a, b):
    """A 39-row stack of large limbs: the widest input of f_reduce (a
    product's rows)."""
    cat = torch.cat if m is S else m.jnp.concatenate
    return cat([a, b[:m.LIMBS - 1]]) * 3


#: the same expression over either package's limb arithmetic
_REF_OPS = {
    "f_mul": lambda m, a, b: m.f_mul(a, b),
    "f_add": lambda m, a, b: m.f_add(a, b),
    "f_sub": lambda m, a, b: m.f_sub(a, b),
    "f_scale": lambda m, a, b: m.f_scale(a, 8),
    "f_canon": lambda m, a, b: m.f_canon(m.f_mul(a, b)),
    "f_reduce": lambda m, a, b: m.f_reduce(_cat_times3(m, a, b)),
    "cond_sub_n": lambda m, a, b: m._cond_sub(m.f_canon(a), m.N_LIMBS),
    "chain": lambda m, a, b: m.f_sub(m.f_sqr(m.f_add(a, b)),
                                     m.f_scale(m.f_mul(a, b), 3)),
}


@pytest.mark.parametrize("name", sorted(_REF_OPS))
def test_field_ops_match_reference_limb_for_limb(R, field_pair, name):
    """Every intermediate form, not only canonical results: the port's
    R* limbs equal the JAX package's."""
    import jax

    a, b = field_pair
    fn = _REF_OPS[name]
    want = np.asarray(jax.jit(lambda x, y: fn(R, x, y))(a, b))
    got = fn(S, S.from_reference_limbs(a), S.from_reference_limbs(b))
    np.testing.assert_array_equal(S.to_reference_limbs(got), want)


def _affine(pt):
    """A (X, Y, Z, inf) lane stack -> per lane affine (x, y) or None."""
    X, Y, Z = (_ints(S.limbs_to_bytes_tensor(S.f_canon(c)).numpy()
                     .tobytes(), c.shape[1]) for c in pt[:3])
    return [None if inf else fallback._jac_to_affine((x, y, z))
            for x, y, z, inf in zip(X, Y, Z, pt[3].tolist())]


def test_group_ops_match_python_ints():
    """jac_add on generic, doubling (P + P), inverse (P + -P) and
    infinity lanes, and jac_double, against the pure-Python group law."""
    rng = random.Random(105)
    a = [fallback.base_mult(rng.randrange(1, N)) for _ in range(8)]
    b = list(reversed(a))
    b[1] = a[1]                               # doubling
    b[2] = (a[2][0], P - a[2][1])             # inverse
    one = S.limbs_from_bytes(_u8([1] * 8))
    inf1 = torch.zeros(8, dtype=torch.bool)
    inf2 = torch.zeros(8, dtype=torch.bool)
    inf1[3] = inf2[4] = True
    pa = (S.limbs_from_bytes(_u8([p[0] for p in a])),
          S.limbs_from_bytes(_u8([p[1] for p in a])), one, inf1)
    pb = (S.limbs_from_bytes(_u8([p[0] for p in b])),
          S.limbs_from_bytes(_u8([p[1] for p in b])), one, inf2)
    want_sum = []
    for i in range(8):
        ja = None if i == 3 else (*a[i], 1)
        jb = None if i == 4 else (*b[i], 1)
        want_sum.append(fallback._jac_to_affine(fallback._jac_add(ja, jb)))
    assert _affine(S.jac_add(pa, pb)) == want_sum
    assert want_sum[2] is None and want_sum[1] == fallback.point_mult(2, a[1])
    want_dbl = [None if i == 3 else fallback.point_mult(2, a[i])
                for i in range(8)]
    assert _affine(S.jac_double(pa)) == want_dbl


def test_inversion_and_codecs_match_python_ints(R):
    rng = random.Random(106)
    vals = [1, 2, P - 1, P - 2, 2**128] + [rng.randrange(1, P)
                                          for _ in range(59)]
    got = S.limbs_to_bytes_tensor(S.f_canon(S.f_inv(S.limbs_from_bytes(
        _u8(vals)))))
    assert _ints(got.numpy().tobytes(), len(vals)) == [
        pow(v, P - 2, P) for v in vals]
    raw = _be(vals)
    np.testing.assert_array_equal(
        S.limbs_from_bytes(_u8(vals)).numpy(),
        R.bytes_to_limbs(raw, len(vals)).astype(np.int64))
    np.testing.assert_array_equal(
        S.words_from_bytes(_u8(vals)).numpy(),
        R.bytes_to_words(raw, len(vals)).astype(np.int64))
    assert S.limbs_to_bytes(S.bytes_to_limbs(raw, len(vals))) == \
        R.limbs_to_bytes(R.bytes_to_limbs(raw, len(vals)))


def test_ladders_walk_the_low_nbits():
    """``nbits < 256`` walks only the low bits of the scalar, as the
    reference does: k*P with k cut to its low 8 bits."""
    rng = random.Random(107)
    ks = [rng.randrange(1, N) for _ in range(8)]
    ks[0] = 256                                  # low 8 bits are zero
    p = fallback.base_mult(rng.randrange(1, N))
    px, py = S.limbs_from_bytes(_u8([p[0]] * 8)), \
        S.limbs_from_bytes(_u8([p[1]] * 8))
    x, y, ok = S.ecdh_core(S.words_from_bytes(_u8(ks)), px, py, nbits=8)
    for i, k in enumerate(ks):
        want = fallback.point_mult(k & 0xFF, p)
        got = _ints(S.limbs_to_bytes_tensor(x[:, i:i + 1]).numpy()
                    .tobytes(), 1)[0]
        assert bool(ok[i]) == (want is not None)
        if want is not None:
            assert got == want[0]


@pytest.fixture(scope="module")
def verify_lanes():
    items = _verify_vectors(random.Random(108), LANES)
    return items, (_be([it[0] for it in items]), _be([it[1] for it in items]),
                   _be([it[2][0] for it in items]),
                   _be([it[2][1] for it in items]),
                   _be([it[3] for it in items]))


def _verify_ref_args(lanes):
    """The reference's (8, n) word and (LIMBS, n) limb arrays of the
    lanes (the port's copies of its codecs, checked equal above)."""
    u1, u2, qx, qy, r = lanes[1]
    return (S.bytes_to_words(u1, LANES), S.bytes_to_words(u2, LANES),
            S.bytes_to_limbs(qx, LANES), S.bytes_to_limbs(qy, LANES),
            S.bytes_to_limbs(r, LANES))


@pytest.fixture(scope="module")
def verify_plain(verify_lanes):
    """The plain verify_core on the lanes, fed the JAX package's
    arrays."""
    args = _verify_ref_args(verify_lanes)
    return S.verify_core(S.from_reference_words(args[0]),
                         S.from_reference_words(args[1]),
                         *(S.from_reference_limbs(a) for a in args[2:]))


def test_verify_core_matches_xla_verify(R, verify_lanes, verify_plain):
    want = np.asarray(R.xla_verify(*_verify_ref_args(verify_lanes)))
    np.testing.assert_array_equal(verify_plain.numpy(),
                                  want.astype(np.int64))
    assert verify_plain.tolist() == [int(it[4]) for it in verify_lanes[0]]


def test_header_verify_matches_plain_version(host_secp, comb, verify_lanes,
                                              verify_plain):
    ok = ctypes.create_string_buffer(LANES)
    host_secp.bm_host_verify(*verify_lanes[1], comb[1], ok, LANES)
    assert list(ok.raw) == verify_plain.tolist()


@pytest.fixture(scope="module")
def ecdh_lanes():
    ks, pts, want = _ecdh_vectors(random.Random(109), LANES)
    return ks, pts, want, (_be(ks), _be([p[0] for p in pts]),
                           _be([p[1] for p in pts]))


def _ecdh_ref_args(lanes):
    kb, xb, yb = lanes[3]
    return (S.bytes_to_words(kb, LANES), S.bytes_to_limbs(xb, LANES),
            S.bytes_to_limbs(yb, LANES))


@pytest.fixture(scope="module")
def ecdh_plain(ecdh_lanes):
    """The plain ecdh_core on the lanes, fed the JAX package's arrays."""
    args = _ecdh_ref_args(ecdh_lanes)
    return S.ecdh_core(S.from_reference_words(args[0]),
                       S.from_reference_limbs(args[1]),
                       S.from_reference_limbs(args[2]))


def test_header_ecdh_matches_plain_version(host_secp, comb, ecdh_lanes,
                                            ecdh_plain):
    x = ctypes.create_string_buffer(32 * LANES)
    y = ctypes.create_string_buffer(32 * LANES)
    ok = ctypes.create_string_buffer(LANES)
    host_secp.bm_host_ecdh(*ecdh_lanes[3], comb[1], x, y, ok, LANES)
    assert x.raw == S.limbs_to_bytes_tensor(ecdh_plain[0]).numpy().tobytes()
    assert y.raw == S.limbs_to_bytes_tensor(ecdh_plain[1]).numpy().tobytes()
    assert list(ok.raw) == ecdh_plain[2].tolist()


def test_ecdh_core_matches_xla_ecdh(R, ecdh_lanes, ecdh_plain):
    ks, pts, want, _ = ecdh_lanes
    ref_out = [np.asarray(t) for t in R.xla_ecdh(*_ecdh_ref_args(ecdh_lanes))]
    got = ecdh_plain
    np.testing.assert_array_equal(S.to_reference_limbs(got[0]), ref_out[0])
    np.testing.assert_array_equal(S.to_reference_limbs(got[1]), ref_out[1])
    np.testing.assert_array_equal(got[2].numpy(),
                                  ref_out[2].astype(np.int64))
    assert got[2].tolist() == [int(w is not None) for w in want]


# ---------------------------------------------------------------------------
# the drain ABI against TpuSecp and the oracle
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_rung_on(R):
    """The reference's accelerator rung forced on (its XLA path on the
    CPU), restored afterwards: files share a worker."""
    from pybitmessage_tpu.crypto import tpu as ref_tpu

    ref_tpu.configure("on")
    ref_tpu.set_tpu_enabled(True)
    ref_tpu.reset_tpu()
    yield ref_tpu.get_tpu()
    ref_tpu.configure("auto")
    ref_tpu.set_tpu_enabled(True)
    ref_tpu.reset_tpu()


def test_verify_prepared_matches_tpusecp_and_oracle(ref_rung_on,
                                                    verify_lanes):
    items, (u1, u2, qx, qy, r) = verify_lanes
    pubs = b"".join(qx[32 * i:32 * i + 32] + qy[32 * i:32 * i + 32]
                    for i in range(LANES))
    rs = bytearray(r)
    pubs = bytearray(pubs)
    # wire junk the host screens: Q off curve, x = P, r = 0, r = N
    q = items[10][2]
    pubs[64 * 10:64 * 11] = _be([q[0], q[1] ^ 1])
    pubs[64 * 11:64 * 12] = _be([P, q[1]])
    rs[32 * 12:32 * 13] = _be([0])
    rs[32 * 13:32 * 14] = _be([N])
    expected = [it[4] for it in items]
    expected[10:14] = [False] * 4
    got = gpu.CudaSecp(device="cpu").verify_prepared(
        LANES, u1, u2, bytes(pubs), bytes(rs))
    want = ref_rung_on.verify_prepared(LANES, u1, u2, bytes(pubs), bytes(rs))
    assert got == want == expected


def test_ecdh_batch_matches_tpusecp_and_oracle(ref_rung_on, ecdh_lanes):
    ks, pts, want, (kb, xb, yb) = ecdh_lanes
    points = b"".join(xb[32 * i:32 * i + 32] + yb[32 * i:32 * i + 32]
                      for i in range(LANES))
    # k outside [1, n-1] and coordinates >= p are screened on the host
    expected = [None if w is None or not (0 < k < N and x < P and y < P)
                else w[0].to_bytes(32, "big")
                for w, k, (x, y) in zip(want, ks, pts)]
    assert expected[6] is None and want[6] is not None
    got = gpu.CudaSecp(device="cpu").ecdh_batch(LANES, points, kb)
    ref = ref_rung_on.ecdh_batch(LANES, points, kb)
    assert got == ref == expected


def test_base_mult_batch_matches_tpusecp_and_oracle(ref_rung_on):
    from pybitmessage_tpu.crypto import fallback as ref_fallback

    rng = random.Random(110)
    ks = [rng.randrange(1, N) for _ in range(LANES)]
    ks[0], ks[1], ks[2] = 0, N, N - 1
    engine = gpu.CudaSecp(device="cpu")
    got = engine.base_mult_batch(_be(ks), LANES)
    want = ref_rung_on.base_mult_batch(_be(ks), LANES)
    assert got == want
    assert got[0] is None and got[1] is None
    for i in (2, 3, 4, 63):
        pt = fallback.base_mult(ks[i])
        assert got[i] == _be(pt)
        assert b"\x04" + got[i] == ref_fallback.priv_to_pub(
            ks[i].to_bytes(32, "big"))
    snap = engine.snapshot()
    assert snap["kernel"] == "torch" and snap["calls"]["ecdh"] == 1
    assert snap["lanes"]["ecdh"] == LANES


def test_base_mult_is_one_lane_of_the_batch(monkeypatch):
    engine = gpu.CudaSecp(device="cpu")
    calls = []

    def batch(scalars, n):
        calls.append((scalars, n))
        return [b"xy"]

    monkeypatch.setattr(engine, "base_mult_batch", batch)
    assert engine.base_mult(b"k" * 32) == b"xy"
    assert calls == [(b"k" * 32, 1)]


# ---------------------------------------------------------------------------
# wrapper hygiene
# ---------------------------------------------------------------------------


def test_wrappers_check_their_inputs():
    ok = _u8([1, 2])
    with pytest.raises(TypeError):
        secp256k1_cuda.secp_verify(ok.to(torch.int64), ok, ok, ok, ok)
    with pytest.raises(ValueError):
        secp256k1_cuda.secp_verify(ok, ok[:1], ok, ok, ok)
    with pytest.raises(ValueError):
        secp256k1_cuda.secp_ecdh(ok, ok, ok.T.contiguous().T)
    with pytest.raises(ValueError):
        secp256k1_cuda.secp_ecdh(ok, ok, ok.reshape(32, 2))
    meta = torch.empty((2, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        secp256k1_cuda.secp_ecdh(meta, meta, meta)
    with pytest.raises(ValueError, match="is on"):
        secp256k1_cuda.secp_ecdh(ok, meta, ok)


def test_cuda_tensors_launch_or_raise(monkeypatch):
    """A tensor taken for a CUDA one never falls back to the plain
    version: without a kernel library the wrapper raises and counts no
    launch."""
    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "load", no_library)
    secp256k1_cuda.reset_launches()
    v = _u8([1, 2, 3])
    with pytest.raises(RuntimeError):
        secp256k1_cuda.secp_verify(v, v, v, v, v)
    with pytest.raises(RuntimeError):
        secp256k1_cuda.secp_ecdh(v, v, v)
    assert secp256k1_cuda.LAUNCHES == {"secp_verify": 0, "secp_ecdh": 0}


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu.CudaSecp()
    assert gpu.CudaSecp("cpu").snapshot()["device"] == "cpu"


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda, verify_lanes, ecdh_lanes):
    _, args = verify_lanes
    dev_args = [_u8(_ints(a, LANES)).to(cuda) for a in args]
    got = secp256k1_cuda.secp_verify(*dev_args)
    want = S.verify_ref(*dev_args)
    assert torch.equal(got, want)
    ks, _, _, (kb, xb, yb) = ecdh_lanes
    dev_args = [_u8(_ints(a, LANES)).to(cuda) for a in (kb, xb, yb)]
    got = secp256k1_cuda.secp_ecdh(*dev_args)
    want = S.ecdh_ref(*dev_args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
