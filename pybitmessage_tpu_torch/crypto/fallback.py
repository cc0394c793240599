"""Pure-Python secp256k1 and AES-256-CBC (copy of
``pybitmessage_tpu.crypto.fallback``, trimmed to what the receive path
uses).

The oracle the batch kernels are held against, the signer and key
derivation that tests and ``chip_smoke.py`` make their inputs with, and
the AES of the one real match per trial-decrypted object.  Big-int
arithmetic on public formulas (SEC2 curve constants, FIPS-197 AES); not
constant-time.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import threading as _threading

# --- secp256k1 domain parameters (SEC2) -------------------------------------

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def on_curve(x: int, y: int) -> bool:
    """y^2 == x^3 + 7 (mod p) with both coordinates in-field."""
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - x * x * x - 7) % P == 0


# --- Jacobian group law (a=0, b=7) ------------------------------------------
# Points are (X, Y, Z) with x = X/Z^2, y = Y/Z^3; None is infinity.

def _jac_double(pt):
    if pt is None:
        return None
    X, Y, Z = pt
    if Y == 0:
        return None
    ysq = (Y * Y) % P
    s = (4 * X * ysq) % P
    m = (3 * X * X) % P
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * ysq * ysq) % P
    z3 = (2 * Y * Z) % P
    return (x3, y3, z3)


def _jac_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    z1z1 = (Z1 * Z1) % P
    z2z2 = (Z2 * Z2) % P
    u1 = (X1 * z2z2) % P
    u2 = (X2 * z1z1) % P
    s1 = (Y1 * z2z2 * Z2) % P
    s2 = (Y2 * z1z1 * Z1) % P
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    if h == 0:
        if r == 0:
            return _jac_double(a)
        return None
    hh = (h * h) % P
    hhh = (hh * h) % P
    u1hh = (u1 * hh) % P
    x3 = (r * r - hhh - 2 * u1hh) % P
    y3 = (r * (u1hh - x3) - s1 * hhh) % P
    z3 = (Z1 * Z2 * h) % P
    return (x3, y3, z3)


def _jac_to_affine(pt):
    if pt is None:
        return None
    X, Y, Z = pt
    zi = pow(Z, -1, P)
    zi2 = (zi * zi) % P
    return ((X * zi2) % P, (Y * zi2 * zi) % P)


def point_mult(k: int, point: tuple[int, int] | None):
    """k * point -> affine (x, y) or None for infinity."""
    if point is None or k % N == 0:
        return None
    k %= N
    acc = None
    add = (point[0], point[1], 1)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return _jac_to_affine(acc)


def base_mult(k: int):
    """k * G -> affine (x, y) or None."""
    return point_mult(k, (GX, GY))


def point_add(a: tuple[int, int] | None, b: tuple[int, int] | None):
    """a + b for affine points (None is infinity) -> affine or None."""
    return _jac_to_affine(_jac_add(a and (a[0], a[1], 1),
                                   b and (b[0], b[1], 1)))


# --- byte-level helpers shared by every tier --------------------------------

def decode_point(pubkey: bytes) -> tuple[int, int]:
    """65-byte uncompressed 0x04||X||Y -> (x, y); raises ValueError off
    curve or malformed (matching EllipticCurvePublicKey.from_encoded_point
    rejection behavior)."""
    if len(pubkey) != 65 or pubkey[0] != 4:
        raise ValueError("not an uncompressed secp256k1 point")
    x = int.from_bytes(pubkey[1:33], "big")
    y = int.from_bytes(pubkey[33:65], "big")
    if not on_curve(x, y):
        raise ValueError("point not on curve")
    return x, y


def encode_point(x: int, y: int) -> bytes:
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def ecdh_x(privkey: bytes, peer_pub: bytes) -> bytes:
    """Raw ECDH: X coordinate of priv * peer, zero-padded to 32 bytes —
    the exact bytes OpenSSL's ECDH_compute_key (no KDF) emits."""
    d = int.from_bytes(privkey, "big")
    if not 0 < d < N:
        raise ValueError("private scalar out of range")
    shared = point_mult(d, decode_point(peer_pub))
    if shared is None:
        raise ValueError("ECDH produced infinity")
    return shared[0].to_bytes(32, "big")


def priv_to_pub(privkey: bytes) -> bytes:
    d = int.from_bytes(privkey, "big")
    if not 0 < d < N:
        raise ValueError("private scalar out of range")
    pt = base_mult(d)
    return encode_point(*pt)


# --- DER (strict) signature codec -------------------------------------------

def der_encode_sig(r: int, s: int) -> bytes:
    """Minimal DER SEQUENCE of two INTEGERs — byte-identical to what
    OpenSSL emits for the same (r, s)."""
    def _int(v: int) -> bytes:
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        if b[0] & 0x80:
            b = b"\x00" + b
        return b"\x02" + bytes([len(b)]) + b
    body = _int(r) + _int(s)
    return b"\x30" + bytes([len(body)]) + body


def der_decode_sig(sig: bytes) -> tuple[int, int]:
    """Strict-DER parse -> (r, s); raises ValueError on anything OpenSSL
    would reject (trailing bytes, non-minimal ints, bad tags)."""
    if len(sig) < 8 or sig[0] != 0x30 or sig[1] != len(sig) - 2:
        raise ValueError("bad DER envelope")
    if len(sig) > 72:
        raise ValueError("DER signature too long")

    def _int(buf: bytes) -> tuple[int, bytes]:
        if len(buf) < 2 or buf[0] != 0x02:
            raise ValueError("bad DER integer tag")
        n = buf[1]
        if n == 0 or len(buf) < 2 + n:
            raise ValueError("bad DER integer length")
        body = buf[2:2 + n]
        if body[0] & 0x80:
            raise ValueError("negative DER integer")
        if n > 1 and body[0] == 0 and not body[1] & 0x80:
            raise ValueError("non-minimal DER integer")
        return int.from_bytes(body, "big"), buf[2 + n:]

    r, rest = _int(sig[2:])
    s, rest = _int(rest)
    if rest:
        raise ValueError("trailing bytes after DER signature")
    return r, s


def digest_to_scalar(digest: bytes) -> int:
    """FIPS 186-4 bits2int: leftmost min(hashlen, qlen) bits.  Every
    supported digest (SHA1, SHA256) is <= 256 bits, so this is just the
    big-endian integer."""
    return int.from_bytes(digest, "big")


# --- ECDSA ------------------------------------------------------------------

def ecdsa_verify_scalars(e: int, r: int, s: int,
                         pub: tuple[int, int]) -> bool:
    """Textbook ECDSA acceptance: (u1*G + u2*Q).x == r (mod n)."""
    if not (0 < r < N and 0 < s < N):
        return False
    w = pow(s, -1, N)
    u1 = (e * w) % N
    u2 = (r * w) % N
    pt = _jac_add(
        None if u1 == 0 else _as_jac(base_mult(u1)),
        None if u2 == 0 else _as_jac(point_mult(u2, pub)))
    aff = _jac_to_affine(pt)
    if aff is None:
        return False
    return aff[0] % N == r


def _as_jac(aff):
    return None if aff is None else (aff[0], aff[1], 1)


def ecdsa_sign_digest(digest: bytes, privkey: bytes) -> bytes:
    """Deterministic ECDSA (RFC 6979-style HMAC-derived nonce) -> DER.

    The nonce is unique per (key, message) and never leaves this
    function; determinism additionally makes signing reproducible in
    tests.  Interoperates with any standard verifier — ECDSA places no
    constraint on HOW k is chosen, only that it is secret and unique.
    """
    d = int.from_bytes(privkey, "big")
    if not 0 < d < N:
        raise ValueError("private scalar out of range")
    e = digest_to_scalar(digest) % N
    counter = 0
    while True:
        k = int.from_bytes(
            hmac_mod.new(privkey, digest + counter.to_bytes(4, "big"),
                         hashlib.sha256).digest(), "big") % N
        counter += 1
        if k == 0:
            continue
        pt = base_mult(k)
        r = pt[0] % N
        if r == 0:
            continue
        s = (pow(k, -1, N) * (e + r * d)) % N
        if s == 0:
            continue
        return der_encode_sig(r, s)


# --- AES-256-CBC (FIPS-197) -------------------------------------------------

_SBOX: list[int] = []
_INV_SBOX: list[int] = []
#: GF(2^8) products by InvMixColumns' coefficients 9, 11, 13 and 14
_MUL9: list[int] = []
_MUL11: list[int] = []
_MUL13: list[int] = []
_MUL14: list[int] = []
_AES_TABLES_LOCK = _threading.Lock()


def _xtime(x: int) -> int:
    x <<= 1
    return (x ^ 0x11B) & 0xFF if x & 0x100 else x


def _init_aes_tables() -> None:
    # double-checked lock (the C++ twin uses std::call_once): the
    # engine's pure tier fans AES across a thread pool, and a reader
    # must never observe a half-built table.  The lock-free fast path
    # is safe because _SBOX goes non-empty only via the single
    # .extend() after both tables are fully built.
    if _SBOX:
        return
    with _AES_TABLES_LOCK:
        if _SBOX:
            return
        alog, log = [0] * 256, [0] * 256
        v = 1
        for i in range(255):
            alog[i] = v
            log[v] = i
            v ^= _xtime(v)          # multiply by generator 3
        sbox, inv_sbox = [0] * 256, [0] * 256
        for i in range(256):
            inv = alog[(255 - log[i]) % 255] if i else 0
            b, s = inv, 0x63
            for _ in range(5):
                s ^= b
                b = ((b << 1) | (b >> 7)) & 0xFF
            sbox[i] = s
            inv_sbox[s] = i
        # publish fully built, the others first: _SBOX doubles as the
        # "ready" flag for the lock-free fast path above
        for table, c in ((_MUL9, 9), (_MUL11, 11), (_MUL13, 13),
                         (_MUL14, 14)):
            table.extend(_gmul(x, c) for x in range(256))
        _INV_SBOX.extend(inv_sbox)
        _SBOX.extend(sbox)


def _gmul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a = _xtime(a)
        b >>= 1
    return r


def _expand_key(key: bytes) -> list[list[int]]:
    _init_aes_tables()
    w = [list(key[i:i + 4]) for i in range(0, 32, 4)]
    rcon = 1
    for i in range(8, 60):
        t = list(w[i - 1])
        if i % 8 == 0:
            t = [_SBOX[t[1]] ^ rcon, _SBOX[t[2]], _SBOX[t[3]], _SBOX[t[0]]]
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = [_SBOX[x] for x in t]
        w.append([w[i - 8][j] ^ t[j] for j in range(4)])
    return [sum(w[4 * r:4 * r + 4], []) for r in range(15)]


def _encrypt_block(rk: list[list[int]], block: bytes) -> bytes:
    st = [b ^ k for b, k in zip(block, rk[0])]
    for rnd in range(1, 14):
        st = [_SBOX[x] for x in st]
        st = [st[(i + 4 * (i % 4)) % 16] for i in range(16)]  # shift rows
        mixed = []
        for c in range(0, 16, 4):
            a0, a1, a2, a3 = st[c:c + 4]
            al = a0 ^ a1 ^ a2 ^ a3
            mixed += [a0 ^ al ^ _xtime(a0 ^ a1), a1 ^ al ^ _xtime(a1 ^ a2),
                      a2 ^ al ^ _xtime(a2 ^ a3), a3 ^ al ^ _xtime(a3 ^ a0)]
        st = [m ^ k for m, k in zip(mixed, rk[rnd])]
    st = [_SBOX[x] for x in st]
    st = [st[(i + 4 * (i % 4)) % 16] for i in range(16)]
    return bytes(x ^ k for x, k in zip(st, rk[14]))


def _decrypt_block(rk: list[list[int]], block: bytes) -> bytes:
    st = [b ^ k for b, k in zip(block, rk[14])]
    for rnd in range(13, 0, -1):
        st = [st[(i - 4 * (i % 4)) % 16] for i in range(16)]  # inv shift
        st = [_INV_SBOX[x] for x in st]
        st = [x ^ k for x, k in zip(st, rk[rnd])]
        mixed = []
        m9, m11, m13, m14 = _MUL9, _MUL11, _MUL13, _MUL14
        for c in range(0, 16, 4):
            a0, a1, a2, a3 = st[c:c + 4]
            mixed += [m14[a0] ^ m11[a1] ^ m13[a2] ^ m9[a3],
                      m9[a0] ^ m14[a1] ^ m11[a2] ^ m13[a3],
                      m13[a0] ^ m9[a1] ^ m14[a2] ^ m11[a3],
                      m11[a0] ^ m13[a1] ^ m9[a2] ^ m14[a3]]
        st = mixed
    st = [st[(i - 4 * (i % 4)) % 16] for i in range(16)]
    st = [_INV_SBOX[x] for x in st]
    return bytes(x ^ k for x, k in zip(st, rk[0]))


def aes256_cbc(encrypt: bool, key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-256-CBC over len(data) % 16 == 0 bytes; padding is the
    caller's job (PKCS7 lives in ecies.py for parity across tiers)."""
    if len(key) != 32 or len(iv) != 16 or len(data) % 16:
        raise ValueError("bad AES-256-CBC parameters")
    rk = _expand_key(key)
    out = bytearray()
    prev = iv
    for off in range(0, len(data), 16):
        block = data[off:off + 16]
        if encrypt:
            blk = _encrypt_block(rk, bytes(a ^ b
                                           for a, b in zip(block, prev)))
            out += blk
            prev = blk
        else:
            plain = _decrypt_block(rk, block)
            out += bytes(a ^ b for a, b in zip(plain, prev))
            prev = block
    return bytes(out)
