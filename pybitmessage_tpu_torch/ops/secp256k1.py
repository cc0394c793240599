"""Batch secp256k1 in plain torch: the twin of ``ops/secp256k1_pallas.py``.

These are the plain versions of the two receive-path kernels
(``csrc/secp256k1_kernels.cu``): :func:`verify_core` (ECDSA acceptance,
Strauss-Shamir dual ladder) and :func:`ecdh_core` (k*P by
double-and-add, also the fixed-base multiply with P = G).  The wrappers
in ``secp256k1_cuda.py`` run them for CPU tensors; ``chip_smoke.py``
holds each kernel against them on the card.

The arithmetic is a line-for-line twin of the JAX core on int64
tensors: the same 20 x 13-bit lazy-carry limbs, the same R* working
form (value < 2^256 + 2^38, limbs <= 8223, top limb <= 520), the same
branchless Jacobian group law with explicit infinity flags.  That limb
form exists because the TPU's vector unit has no 32x32->64 multiply;
the CUDA kernels use 4 x 64-bit limbs instead.  It is kept here because
a twin can be held against the JAX package at every step
(:func:`from_reference_limbs` / :func:`to_reference_limbs` carry its
(LIMBS, n) uint32 limb stacks across).

A field element is an int64 tensor of shape (LIMBS, n): limb-major,
one lane per column.  Scalars are (8, n) int64 tensors of big-endian
u32 words; bit 0 of a scalar is the MSB of its 32 bytes.  ``nbits < 256``
walks only the LOW ``nbits`` bits of the scalars, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

# --- curve constants ---------------------------------------------------------

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

LIMB_BITS = 13
LIMBS = 20
MASK = (1 << LIMB_BITS) - 1

#: L^20 = 2^260 == 2^36 + 15632 (mod p); 2^36 = 2^10 * L^2
FOLD0, FOLD2 = 15632, 1024
#: 2^256 == 2^32 + 977 (mod p); 2^32 = 2^6 * L^2
TOP0, TOP2 = 977, 64


def _int_limbs(v: int, n: int = LIMBS) -> list[int]:
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(n - 1)] \
        + [v >> (LIMB_BITS * (n - 1))]


P_LIMBS = _int_limbs(P)
N_LIMBS = _int_limbs(N)
GX_LIMBS = _int_limbs(GX)
GY_LIMBS = _int_limbs(GY)

# Subtraction bias: 4p in a "borrow-lent" expansion whose limbs all
# dominate an R* subtrahend, so ``a + SUB_C - b`` never goes negative
# per limb while the value shifts by exactly 4p (== 0 mod p).
_B4 = _int_limbs(4 * P)
SUB_C = ([_B4[0] + 2 * (MASK + 1)]
         + [_B4[i] + 2 * (MASK + 1) - 2 for i in range(1, 19)]
         + [_B4[19] - 2])
assert sum(c << (LIMB_BITS * i) for i, c in enumerate(SUB_C)) == 4 * P
assert min(SUB_C[:19]) >= 16382 and SUB_C[19] >= 520

_I64 = torch.int64

# --- field arithmetic ((LIMBS, n) int64 tensors) -----------------------------

_COLUMNS: dict = {}


def _column(values, device) -> torch.Tensor:
    """``values`` as an int64 (len, 1) column on ``device``, made once."""
    key = (tuple(values), device)
    col = _COLUMNS.get(key)
    if col is None:
        col = _COLUMNS[key] = torch.tensor(
            key[0], dtype=_I64, device=device)[:, None]
    return col


def _const(limbs: list[int], like: torch.Tensor) -> torch.Tensor:
    """An integer-limb constant broadcast over the lanes of ``like``."""
    return _column(limbs, like.device).expand(len(limbs), like.shape[-1])


def _carry2(d: torch.Tensor, padded: bool = False) -> torch.Tensor:
    """Two parallel lazy-carry passes: limbs < 2^31 in -> limbs <= 8223
    out, value unchanged.  One extra limb absorbs the top carry (already
    there, zero, when ``padded``)."""
    if not padded:
        d = torch.nn.functional.pad(d, (0, 0, 0, 1))
    for _ in range(2):
        c = d >> LIMB_BITS
        d &= MASK
        d[1:] += c[:-1]
    return d


def f_reduce(d: torch.Tensor, padded: bool = False) -> torch.Tensor:
    """Arbitrary limb stack (rows <= 2*LIMBS, limbs < 2^31) -> R*.
    ``padded``: ``d`` already ends in a zero row for the top carry."""
    d = _carry2(d, padded)
    if d.shape[0] > 21:
        for _ in range(2):
            # fold rows >= 20 down: h*L^(20+k) == h*(FOLD0 + FOLD2*L^2)*L^k
            hi = d[LIMBS:]
            r = torch.nn.functional.pad(d[:LIMBS], (0, 0, 0, 2))
            r[:hi.shape[0]] += hi * FOLD0
            r[2:2 + hi.shape[0]] += hi * FOLD2
            d = _carry2(r)
        # rows > 20 are structurally zero after two passes
    # fold bits >= 2^256 (rows 19..20): t = value div 2^256
    t = (d[20] << 4) + (d[19] >> 9)
    r = d[:LIMBS].clone()
    r[19] &= 511
    r[0] += t * TOP0
    r[2] += t * TOP2
    return _carry2(r)[:LIMBS]


def f_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 20x20 (R* inputs), then reduced.

    Row i of ``q`` holds the partials a[i]*b[j] at j, followed by zeros;
    a view with row stride 39 (not 40) shifts row i right by i, so its
    column sums are the 39 product rows (plus a zero row for the carry).
    """
    n = a.shape[-1]
    q = torch.zeros((LIMBS, 2 * LIMBS, n), dtype=_I64, device=a.device)
    q[:, :LIMBS] = a[:, None, :] * b[None, :, :]
    shifted = q.as_strided((LIMBS, 2 * LIMBS, n),
                           ((2 * LIMBS - 1) * n, n, 1))
    return f_reduce(shifted.sum(0), padded=True)


def f_sqr(a: torch.Tensor) -> torch.Tensor:
    return f_mul(a, a)


def f_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return f_reduce(a + b)


def f_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return f_reduce(a + _const(SUB_C, a) - b)


def f_scale(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant (k <= 8: limbs stay < 2^17)."""
    return f_reduce(a * k)


#: 4 limbs make a 52-bit chunk; 5 chunks hold a value < 2^260
_CHUNK_BITS = 4 * LIMB_BITS
_CHUNK_MASK = (1 << _CHUNK_BITS) - 1
_CHUNK_SHIFTS = range(0, _CHUNK_BITS, LIMB_BITS)
#: 2^256 - p, in the same chunks
_RC_CHUNKS = [(2**256 - P) >> (_CHUNK_BITS * j) & _CHUNK_MASK
              for j in range(5)]


def _canon_chunks(a: torch.Tensor) -> torch.Tensor:
    """R* limbs -> the value mod p as five fully carried 52-bit chunks
    (5, n).  R* < 2p, so value mod p is the value, or value - p when
    value + (2^256 - p) reaches 2^256: both sums ripple at once."""
    n = a.shape[-1]
    shifts = _column(_CHUNK_SHIFTS, a.device)[None]
    c = (a.reshape(5, 4, n) << shifts).sum(1)
    c = torch.stack([c, c + _column(_RC_CHUNKS, a.device)], dim=1)
    out = []
    carry = torch.zeros_like(c[0])
    for j in range(5):
        t = c[j] + carry
        out.append(t & _CHUNK_MASK if j < 4 else t)
        carry = t >> _CHUNK_BITS
    out = torch.stack(out)                           # (5, 2, n)
    ge = (out[4, 1] >> (256 - 4 * _CHUNK_BITS)) > 0  # value >= p
    out[4, 1] &= (1 << (256 - 4 * _CHUNK_BITS)) - 1  # minus 2^256
    return torch.where(ge[None], out[:, 1], out[:, 0])


def f_canon(a: torch.Tensor) -> torch.Tensor:
    """R* -> canonical (< p, fully carried).  The reference ripples
    limb by limb and subtracts p once; this ripples 52-bit chunks, which
    gives the same limbs (the canonical form of a value is unique)."""
    ch = _canon_chunks(a)
    shifts = _column(_CHUNK_SHIFTS, a.device)[None]
    return ((ch[:, None, :] >> shifts) & MASK).reshape(LIMBS, -1)


def _cond_sub(a: torch.Tensor, mod_limbs: list[int]) -> torch.Tensor:
    """Subtract ``mod_limbs`` when a >= mod (a fully carried, < 2*mod)."""
    borrow = torch.zeros_like(a[0])
    subbed = []
    for i in range(LIMBS):
        t = a[i] + (MASK + 1 - mod_limbs[i]) - borrow
        subbed.append(t & MASK)
        borrow = 1 - (t >> LIMB_BITS)
    ge = borrow == 0
    return torch.where(ge[None], torch.stack(subbed), a)


def f_is_zero(a: torch.Tensor) -> torch.Tensor:
    """Lane mask: a == 0 (mod p), for R*/intermediate inputs."""
    return (_canon_chunks(f_reduce(a)) == 0).all(dim=0)


def f_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_canon_chunks(a) == _canon_chunks(b)).all(dim=0)


def f_inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) (Fermat) by the standard secp256k1 addition chain (258
    squarings, 14 multiplies), the reference's unrolled spelling, the
    one its Pallas kernels run; maps 0 -> 0."""
    def sqn(x, n):
        for _ in range(n):
            x = f_sqr(x)
        return x

    x2 = f_mul(f_sqr(a), a)
    x3 = f_mul(f_sqr(x2), a)
    x6 = f_mul(sqn(x3, 3), x3)
    x9 = f_mul(sqn(x6, 3), x3)
    x11 = f_mul(sqn(x9, 2), x2)
    x22 = f_mul(sqn(x11, 11), x11)
    x44 = f_mul(sqn(x22, 22), x22)
    x88 = f_mul(sqn(x44, 44), x44)
    x176 = f_mul(sqn(x88, 88), x88)
    x220 = f_mul(sqn(x176, 44), x44)
    x223 = f_mul(sqn(x220, 3), x3)
    t = f_mul(sqn(x223, 23), x22)
    t = f_mul(sqn(t, 5), a)
    t = f_mul(sqn(t, 3), x2)
    return f_mul(sqn(t, 2), a)


# --- Jacobian group law (branchless, infinity-flagged) ----------------------
# A point is (X, Y, Z, inf): limb stacks plus a lane bool.

def _pt_where(mask, a, b):
    m = mask[None]
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]), torch.where(mask, a[3], b[3]))


def jac_double(pt):
    X, Y, Z, inf = pt
    ysq = f_sqr(Y)
    s = f_scale(f_mul(X, ysq), 4)
    m = f_scale(f_sqr(X), 3)
    x3 = f_sub(f_sqr(m), f_scale(s, 2))
    y3 = f_sub(f_mul(m, f_sub(s, x3)), f_scale(f_sqr(ysq), 8))
    z3 = f_scale(f_mul(Y, Z), 2)
    return (x3, y3, z3, inf)


def jac_add(a, b):
    """Complete addition: either operand at infinity, equal operands
    (doubling) and inverse operands (infinity) by lane selects."""
    X1, Y1, Z1, inf1 = a
    X2, Y2, Z2, inf2 = b
    z1z1 = f_sqr(Z1)
    z2z2 = f_sqr(Z2)
    u1 = f_mul(X1, z2z2)
    u2 = f_mul(X2, z1z1)
    s1 = f_mul(f_mul(Y1, z2z2), Z2)
    s2 = f_mul(f_mul(Y2, z1z1), Z1)
    h = f_sub(u2, u1)
    rr = f_sub(s2, s1)
    h_zero = f_is_zero(h)
    r_zero = f_is_zero(rr)
    hh = f_sqr(h)
    hhh = f_mul(hh, h)
    u1hh = f_mul(u1, hh)
    x3 = f_sub(f_sub(f_sqr(rr), hhh), f_scale(u1hh, 2))
    y3 = f_sub(f_mul(rr, f_sub(u1hh, x3)), f_mul(s1, hhh))
    z3 = f_mul(f_mul(Z1, Z2), h)
    added = (x3, y3, z3, torch.zeros_like(inf1))
    dbl = h_zero & r_zero
    # the doubling matters only where a lane selects it; skipping it
    # otherwise changes no output
    out = _pt_where(dbl, jac_double(a), added) if bool(dbl.any()) \
        else added
    out = (out[0], out[1], out[2], out[3] | (h_zero & ~r_zero))
    out = _pt_where(inf2, a, out)
    return _pt_where(inf1, b, out)


def jac_infinity(like: torch.Tensor):
    one = _const([1] + [0] * (LIMBS - 1), like)
    return (one, one, one,
            torch.ones(like.shape[-1], dtype=torch.bool, device=like.device))


def jac_to_affine(pt):
    """(x, y) canonical affine coordinates; infinity lanes yield
    garbage the caller masks with the returned flag."""
    X, Y, Z, inf = pt
    zi = f_inv(Z)
    zi2 = f_sqr(zi)
    return f_canon(f_mul(X, zi2)), f_canon(f_mul(f_mul(Y, zi2), zi)), inf


def _scalar_bit(words: torch.Tensor, i: int) -> torch.Tensor:
    """Bit ``i`` (0 = MSB) of each lane's 256-bit scalar."""
    return (words[i >> 5] >> (31 - (i & 31))) & 1


# --- ladders -----------------------------------------------------------------

def shamir_ladder(u1w, u2w, q, nbits: int = 256):
    """u1*G + u2*Q per lane: one shared doubling chain, per-bit addend
    from {inf, G, Q, G+Q}.  ``nbits < 256`` walks the LOW nbits."""
    qx, qy = q
    gx = _const(GX_LIMBS, qx)
    gy = _const(GY_LIMBS, qx)
    one = _const([1] + [0] * (LIMBS - 1), qx)
    no = torch.zeros(qx.shape[-1], dtype=torch.bool, device=qx.device)
    gq_x, gq_y, gq_inf = jac_to_affine(
        jac_add((gx, gy, one, no), (qx, qy, one, no)))
    acc = jac_infinity(qx)
    for k in range(nbits):
        i = 256 - nbits + k
        acc = jac_double(acc)
        b1 = _scalar_bit(u1w, i) == 1
        b2 = _scalar_bit(u2w, i) == 1
        ax = torch.where(b1[None], torch.where(b2[None], gq_x, gx), qx)
        ay = torch.where(b1[None], torch.where(b2[None], gq_y, gy), qy)
        a_inf = torch.where(b1, b2 & gq_inf, ~b2)
        acc = jac_add(acc, (ax, ay, one, a_inf))
    return acc


def point_ladder(kw, p, p_inf=None, nbits: int = 256):
    """k*P per lane: plain double-and-add over ``nbits`` low bits."""
    px, py = p
    one = _const([1] + [0] * (LIMBS - 1), px)
    if p_inf is None:
        p_inf = torch.zeros(px.shape[-1], dtype=torch.bool,
                            device=px.device)
    acc = jac_infinity(px)
    for k in range(nbits):
        i = 256 - nbits + k
        acc = jac_double(acc)
        bit = _scalar_bit(kw, i)
        acc = jac_add(acc, (px, py, one, p_inf | (bit == 0)))
    return acc


# --- core drain programs -----------------------------------------------------

def _on_curve(x, y):
    """y^2 == x^3 + 7 per lane."""
    seven = _const([7] + [0] * (LIMBS - 1), x)
    return f_eq(f_sqr(y), f_add(f_mul(f_sqr(x), x), seven))


@torch.inference_mode()
def verify_core(u1w, u2w, qx, qy, r_limbs, nbits: int = 256):
    """ECDSA acceptance per lane: (u1*G + u2*Q).x mod n == r, as int64
    (n,) 0/1.  Off-curve Q and an infinity result give 0."""
    ok_curve = _on_curve(qx, qy)
    acc = shamir_ladder(u1w, u2w, (qx, qy), nbits=nbits)
    x_aff, _, inf = jac_to_affine(acc)
    # x < p < 2n: one conditional subtract is a full reduction mod n
    x_mod_n = _cond_sub(x_aff, N_LIMBS)
    ok = (x_mod_n == r_limbs).all(dim=0)
    return (ok & ok_curve & ~inf).to(_I64)


@torch.inference_mode()
def ecdh_core(kw, px, py, nbits: int = 256):
    """k*P per lane: canonical affine (x, y) and ok (0 for an off-curve
    P or an infinity result, with x and y zeroed there)."""
    ok_curve = _on_curve(px, py)
    acc = point_ladder(kw, (px, py), nbits=nbits)
    x_aff, y_aff, inf = jac_to_affine(acc)
    ok = ok_curve & ~inf
    zero = torch.zeros_like(x_aff)
    return (torch.where(ok[None], x_aff, zero),
            torch.where(ok[None], y_aff, zero), ok.to(_I64))


# --- numpy codecs (the reference's, exact) -----------------------------------

_LIMB_W = (1 << np.arange(LIMB_BITS, dtype=np.uint32)).astype(np.uint32)


def bytes_to_limbs(buf: bytes, n: int) -> np.ndarray:
    """n 32-byte big-endian field elements -> (LIMBS, n) u32 stack."""
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(n, 32)
    bits = np.unpackbits(raw[:, ::-1], axis=1, bitorder="little")
    bits = np.concatenate(
        [bits, np.zeros((n, LIMBS * LIMB_BITS - 256), dtype=np.uint8)],
        axis=1).reshape(n, LIMBS, LIMB_BITS)
    limbs = (bits.astype(np.uint32) * _LIMB_W).sum(axis=2, dtype=np.uint32)
    return np.ascontiguousarray(limbs.T)


def limbs_to_bytes(limbs: np.ndarray) -> list[bytes]:
    """Canonical (LIMBS, n) u32 stack -> n 32-byte big-endian values."""
    n = limbs.shape[1]
    bits = ((limbs.T.astype(np.uint32)[:, :, None]
             >> np.arange(LIMB_BITS, dtype=np.uint32)) & 1)
    bits = bits.reshape(n, LIMBS * LIMB_BITS)[:, :256].astype(np.uint8)
    raw = np.packbits(bits, axis=1, bitorder="little")[:, ::-1]
    return [raw[i].tobytes() for i in range(n)]


def bytes_to_words(buf: bytes, n: int) -> np.ndarray:
    """n 32-byte big-endian scalars -> (8, n) u32 big-endian words."""
    w = np.frombuffer(buf, dtype=">u4").reshape(n, 8).astype(np.uint32)
    return np.ascontiguousarray(w.T)


# --- the reference's arrays <-> the port's tensors ---------------------------

def from_reference_limbs(limbs: np.ndarray, device=None) -> torch.Tensor:
    """The JAX package's (LIMBS, n) uint32 limb stack -> a field-element
    tensor (int64, same shape) on ``device`` (CPU when None)."""
    return torch.from_numpy(np.asarray(limbs, dtype=np.int64)).to(device)


def to_reference_limbs(t: torch.Tensor) -> np.ndarray:
    """A field-element tensor -> the JAX package's (LIMBS, n) uint32
    limb stack."""
    return t.cpu().numpy().astype(np.uint32)


def from_reference_words(words: np.ndarray, device=None) -> torch.Tensor:
    """The JAX package's (8, n) big-endian u32 scalar words -> int64
    (8, n) on ``device`` (CPU when None)."""
    return torch.from_numpy(np.asarray(words, dtype=np.int64)).to(device)


# --- the drain ABI's (n, 32) uint8 tensors <-> limbs and words ---------------

_BIT8 = torch.arange(8, dtype=_I64)
_BIT13 = torch.arange(LIMB_BITS, dtype=_I64)


def limbs_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(n, 32) uint8 big-endian values -> (LIMBS, n) int64 limbs (the
    torch spelling of :func:`bytes_to_limbs`)."""
    n = b.shape[0]
    le = b.flip(1).to(_I64)
    bits = ((le[:, :, None] >> _BIT8.to(b.device)) & 1).reshape(n, 256)
    bits = torch.cat([bits, bits.new_zeros(n, LIMBS * LIMB_BITS - 256)], 1)
    weights = 1 << _BIT13.to(b.device)
    limbs = (bits.reshape(n, LIMBS, LIMB_BITS) * weights).sum(2)
    return limbs.T.contiguous()


def limbs_to_bytes_tensor(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical (LIMBS, n) limbs -> (n, 32) uint8 big-endian values."""
    n = limbs.shape[1]
    bits = (limbs.T[:, :, None] >> _BIT13.to(limbs.device)) & 1
    bits = bits.reshape(n, LIMBS * LIMB_BITS)[:, :256].reshape(n, 32, 8)
    le = (bits << _BIT8.to(limbs.device)).sum(2)
    return le.flip(1).to(torch.uint8).contiguous()


def words_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(n, 32) uint8 big-endian scalars -> (8, n) int64 u32 words."""
    q = b.to(_I64).reshape(b.shape[0], 8, 4)
    w = (q[:, :, 0] << 24) | (q[:, :, 1] << 16) | (q[:, :, 2] << 8) \
        | q[:, :, 3]
    return w.T.contiguous()


def verify_ref(u1: torch.Tensor, u2: torch.Tensor, qx: torch.Tensor,
               qy: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version of the verify kernel on the drain ABI's (n, 32)
    uint8 big-endian inputs; ok (n,) uint8."""
    ok = verify_core(words_from_bytes(u1), words_from_bytes(u2),
                     limbs_from_bytes(qx), limbs_from_bytes(qy),
                     limbs_from_bytes(r))
    return ok.to(torch.uint8)


def ecdh_ref(k: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Plain version of the ECDH kernel on (n, 32) uint8 big-endian
    inputs; x, y (n, 32) uint8 (zero where ok is 0) and ok (n,) uint8."""
    x, y, ok = ecdh_core(words_from_bytes(k), limbs_from_bytes(px),
                         limbs_from_bytes(py))
    return (limbs_to_bytes_tensor(x), limbs_to_bytes_tensor(y),
            ok.to(torch.uint8))
