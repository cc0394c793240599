"""Opportunistic mid-stream TLS between peers (NODE_SSL), the twin of
``pybitmessage_tpu.network.tls`` with a certificate built from the
standard library.

Reference behavior (src/network/tls.py:62-220, bmproto.py:552-560):
after both veracks, when both peers advertise NODE_SSL, the stream is
upgraded to TLS with NO certificate verification: the point is
confidentiality against a passive eavesdropper between anonymous peers,
not authentication.  OpenSSL no longer offers the reference's anonymous
AECDH cipher, so each node presents an ephemeral self-signed certificate
that its peers deliberately do not verify.

The certificate is an ECDSA P-256 key (the JAX module's ``SECP256R1``)
and a self-signed X.509 v3 certificate with the JAX one's fields (CN
``bitmessage``, valid from a day ago for 3,650 days, a random serial),
signed with SHA-256.  Everything is made here: the key from ``secrets``,
the curve arithmetic on plain integers (Jacobian coordinates, a = -3),
and the DER of the PKCS#8 key and of the certificate by hand.  A failure
raises; nothing in this package falls back to plaintext on its own.

``StreamWriter.start_tls`` swaps the transport under the connection's
reader and writer, so the framed-packet code never sees the upgrade.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import os
import secrets
import ssl
import tempfile
from pathlib import Path

# -- NIST P-256 (SEC 2, secp256r1) ------------------------------------------

_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_G = (0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
      0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5)


def _double(pt):
    """Jacobian doubling for a = -3 (dbl-2001-b); None is infinity."""
    if pt is None:
        return None
    x, y, z = pt
    if y == 0:
        return None
    delta = z * z % _P
    gamma = y * y % _P
    beta = x * gamma % _P
    alpha = 3 * (x - delta) * (x + delta) % _P
    x3 = (alpha * alpha - 8 * beta) % _P
    z3 = ((y + z) * (y + z) - gamma - delta) % _P
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % _P
    return x3, y3, z3


def _add_affine(pt, q):
    """Jacobian ``pt`` plus affine ``q``."""
    if pt is None:
        return q[0], q[1], 1
    x1, y1, z1 = pt
    zz = z1 * z1 % _P
    h = (q[0] * zz - x1) % _P
    r = (q[1] * zz * z1 - y1) % _P
    if h == 0:
        return _double(pt) if r == 0 else None
    hh = h * h % _P
    hhh = h * hh % _P
    v = x1 * hh % _P
    x3 = (r * r - hhh - 2 * v) % _P
    y3 = (r * (v - x3) - y1 * hhh) % _P
    return x3, y3, z1 * h % _P


def _mult(k: int, point=_G) -> tuple[int, int]:
    """Affine k * point (1 <= k < n), double-and-add from the top bit."""
    acc = None
    for bit in bin(k)[2:]:
        acc = _double(acc)
        if bit == "1":
            acc = _add_affine(acc, point)
    if acc is None:
        raise ValueError("scalar multiple is the point at infinity")
    x, y, z = acc
    zinv = pow(z, -1, _P)
    zinv2 = zinv * zinv % _P
    return x * zinv2 % _P, y * zinv2 * zinv % _P


def _on_curve(pt) -> bool:
    x, y = pt
    return (y * y - (x * x * x - 3 * x + _B)) % _P == 0


def _sign(d: int, message: bytes) -> tuple[int, int]:
    """ECDSA over SHA-256 with a fresh random nonce."""
    e = int.from_bytes(hashlib.sha256(message).digest(), "big")
    while True:
        k = secrets.randbelow(_N - 1) + 1
        r = _mult(k)[0] % _N
        if r == 0:
            continue
        s = pow(k, -1, _N) * (e + r * d) % _N
        if s:
            return r, s


# -- DER ---------------------------------------------------------------------

def _tlv(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        length = bytes([n])
    else:
        raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
        length = bytes([0x80 | len(raw)]) + raw
    return bytes([tag]) + length + body


def _seq(*parts: bytes) -> bytes:
    return _tlv(0x30, b"".join(parts))


def _int(value: int) -> bytes:
    """A non-negative INTEGER (a leading zero keeps the sign bit clear)."""
    return _tlv(0x02, value.to_bytes(value.bit_length() // 8 + 1, "big"))


def _oid(dotted: str) -> bytes:
    arcs = [int(a) for a in dotted.split(".")]
    body = bytearray([40 * arcs[0] + arcs[1]])
    for arc in arcs[2:]:
        chunk = [arc & 0x7F]
        arc >>= 7
        while arc:
            chunk.append(0x80 | (arc & 0x7F))
            arc >>= 7
        body += bytes(reversed(chunk))
    return _tlv(0x06, bytes(body))


def _bits(data: bytes) -> bytes:
    return _tlv(0x03, b"\x00" + data)


def _time(when: datetime.datetime) -> bytes:
    """UTCTime through 2049, GeneralizedTime after (RFC 5280 4.1.2.5)."""
    if when.year < 2050:
        return _tlv(0x17, when.strftime("%y%m%d%H%M%SZ").encode())
    return _tlv(0x18, when.strftime("%Y%m%d%H%M%SZ").encode())


_EC_PUBLIC_KEY = _oid("1.2.840.10045.2.1")
_PRIME256V1 = _oid("1.2.840.10045.3.1.7")
_ECDSA_SHA256 = _seq(_oid("1.2.840.10045.4.3.2"))


def _pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der).decode()
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return ("-----BEGIN %s-----\n%s\n-----END %s-----\n"
            % (label, "\n".join(lines), label)).encode()


def _cert_and_key(common_name: str) -> tuple[bytes, bytes]:
    """(certificate PEM, PKCS#8 key PEM) of a fresh P-256 key."""
    d = secrets.randbelow(_N - 1) + 1
    pub = _mult(d)
    if not _on_curve(pub):
        raise ValueError("generated public key is not on P-256")
    point = b"\x04" + pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    name = _seq(_tlv(0x31, _seq(_oid("2.5.4.3"),
                                _tlv(0x0C, common_name.encode()))))
    now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
    tbs = _seq(
        _tlv(0xA0, _int(2)),                        # v3
        _int(secrets.randbits(159) | 1 << 158),     # 20 bytes, positive
        _ECDSA_SHA256,
        name,
        _seq(_time(now - datetime.timedelta(days=1)),
             _time(now + datetime.timedelta(days=3650))),
        name,
        _seq(_seq(_EC_PUBLIC_KEY, _PRIME256V1), _bits(point)))
    r, s = _sign(d, tbs)
    cert = _seq(tbs, _ECDSA_SHA256, _bits(_seq(_int(r), _int(s))))
    ec_key = _seq(_int(1), _tlv(0x04, d.to_bytes(32, "big")),
                  _tlv(0xA1, _bits(point)))
    pkcs8 = _seq(_int(0), _seq(_EC_PUBLIC_KEY, _PRIME256V1),
                 _tlv(0x04, ec_key))
    return _pem("CERTIFICATE", cert), _pem("PRIVATE KEY", pkcs8)


def generate_self_signed_cert(directory: str | Path | None = None,
                              common_name: str = "bitmessage") \
        -> tuple[str, str]:
    """Write an ephemeral self-signed P-256 certificate and its key;
    returns the (cert, key) paths.

    The files are ``tls.crt`` and ``tls.key`` (mode 0600) in
    ``directory``, or in a fresh temporary directory when it is None.
    The certificate carries no identity: clients never verify it.
    """
    cert_pem, key_pem = _cert_and_key(common_name)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="bmtls-")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    cert_path = directory / "tls.crt"
    key_path = directory / "tls.key"
    cert_path.write_bytes(cert_pem)
    key_path.unlink(missing_ok=True)
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "wb") as fh:
        fh.write(key_pem)
    return str(cert_path), str(key_path)


def make_server_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def make_client_context() -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE  # anonymity model: no cert trust
    return ctx
