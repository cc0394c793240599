"""The port's opportunistic TLS (NODE_SSL) against the JAX package's, on
the CPU.

The certificate: ``generate_self_signed_cert`` runs with ``cryptography``
unimportable, its files load through ``ssl``, the key file is 0600, a
second directory gets another key, and the certificate's fields are the
JAX generator's (checked with ``cryptography`` once it is importable
again, which also verifies the self-signature).  Over loopback TCP: a
port ``Node`` and a JAX ``Node`` negotiate TLS in both dial directions,
``tls_established`` on both ends, and an object crosses the upgraded
stream; a peer that does not advertise NODE_SSL stays plaintext (the
twin of ``tests/test_tls.py``'s second case).  Each socket test runs
under its own ``asyncio.wait_for`` limit.
"""

import asyncio
import functools
import importlib
import os
import ssl
import stat
import sys
import time

import pytest

from pybitmessage_tpu_torch.core import Node
from pybitmessage_tpu_torch.models.constants import NODE_SSL
from pybitmessage_tpu_torch.network import tls
from pybitmessage_tpu_torch.storage.knownnodes import Peer

from tests.test_torch_network import hold, solved

LOOPBACK = "127.0.0.1"
LIMIT = 30.0


def ref(module: str):
    return importlib.import_module("pybitmessage_tpu." + module)


def limited(fn):
    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), LIMIT)
    return wrapper


async def until(pred, what: str, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        await asyncio.sleep(0.02)


def port_node(**kw) -> Node:
    return Node(device="cpu", test_mode=True, allow_private_peers=True,
                crypto_batch=False, dandelion_enabled=False,
                federation_enabled=False, **kw)


def jax_node(**kw):
    import jax
    jax.config.update("jax_platforms", "cpu")
    core, dispatcher = ref("core"), ref("pow.dispatcher")

    def solver(ih, target, should_stop=None):
        return dispatcher.python_solve(ih, target, should_stop=should_stop)
    return core.Node(None, listen=True, solver=solver, test_mode=True,
                     dandelion_enabled=False, federation_enabled=False,
                     allow_private_peers=True, **kw)


# ---------------------------------------------------------------------------
# the certificate
# ---------------------------------------------------------------------------


def test_certificate_from_the_standard_library(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cryptography", None)
    with pytest.raises(ImportError):
        importlib.import_module("cryptography")
    cert_a, key_a = tls.generate_self_signed_cert(tmp_path / "a")
    cert_b, key_b = tls.generate_self_signed_cert(tmp_path / "b")
    assert (cert_a, key_a) == (str(tmp_path / "a" / "tls.crt"),
                               str(tmp_path / "a" / "tls.key"))
    for key in (key_a, key_b):
        assert stat.S_IMODE(os.stat(key).st_mode) == 0o600
    ctx = tls.make_server_context(cert_a, key_a)
    assert ctx.verify_mode == ssl.CERT_NONE
    tls.make_server_context(cert_b, key_b)
    with pytest.raises(ssl.SSLError):          # a's cert, b's key
        tls.make_server_context(cert_a, key_b)
    client = tls.make_client_context()
    assert not client.check_hostname and client.verify_mode == ssl.CERT_NONE
    # a second directory: another key, another certificate
    assert open(key_a, "rb").read() != open(key_b, "rb").read()
    assert open(cert_a, "rb").read() != open(cert_b, "rb").read()
    # regenerating in place replaces the key file
    again = tls.generate_self_signed_cert(tmp_path / "a")
    assert again == (cert_a, key_a)
    tls.make_server_context(*again)


def test_certificate_fields_are_the_jax_generators(tmp_path, monkeypatch):
    """The fields ``cryptography`` reads from the port's certificate are
    those of the JAX generator's, and the self-signature verifies."""
    x509 = pytest.importorskip("cryptography.x509")
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import \
        load_pem_private_key
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cryptography", None)
        mine = tls.generate_self_signed_cert(tmp_path / "port")
    theirs = ref("network.tls").generate_self_signed_cert(tmp_path / "jax")
    certs = [x509.load_pem_x509_certificate(open(c, "rb").read())
             for c, _ in (mine, theirs)]
    keys = [load_pem_private_key(open(k, "rb").read(), None)
            for _, k in (mine, theirs)]
    for cert, key in zip(certs, keys):
        assert cert.version == x509.Version.v3
        assert cert.subject == cert.issuer
        assert cert.signature_hash_algorithm.name == "sha256"
        assert key.curve.name == "secp256r1"
        assert key.public_key().public_numbers() == \
            cert.public_key().public_numbers()
        assert 0 < cert.serial_number < 1 << 160
    ours, jaxs = certs
    assert ours.subject == jaxs.subject
    assert ours.signature_algorithm_oid == jaxs.signature_algorithm_oid
    assert abs((ours.not_valid_before_utc - jaxs.not_valid_before_utc)
               .total_seconds()) < 60
    assert abs((ours.not_valid_after_utc - jaxs.not_valid_after_utc)
               .total_seconds()) < 60
    ours.public_key().verify(ours.signature, ours.tbs_certificate_bytes,
                             ec.ECDSA(hashes.SHA256()))


def test_enable_tls_raises_rather_than_going_plaintext(monkeypatch):
    node = port_node(tls_enabled=False)
    assert not node.ctx.services & NODE_SSL and node.ctx.tls_files is None

    def broken(directory=None):
        raise OSError("no room for the certificate")
    monkeypatch.setattr(tls, "generate_self_signed_cert", broken)
    with pytest.raises(OSError):
        node.ctx.enable_tls()
    assert not node.ctx.services & NODE_SSL and node.ctx.tls_files is None
    with pytest.raises(OSError):
        port_node()
    node.db.close()


# ---------------------------------------------------------------------------
# over loopback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dialer", ["port", "jax"])
@limited
async def test_port_and_jax_nodes_negotiate_tls(dialer, tmp_path):
    """Both ends advertise NODE_SSL: the stream upgrades after the
    veracks on both sides, and an object held by the dialed node crosses
    the TLS stream to the dialer."""
    port = port_node(data_dir=str(tmp_path / "port"))
    jax = jax_node(tls_enabled=True)
    assert port.ctx.services & NODE_SSL and jax.ctx.services & NODE_SSL
    assert port.ctx.tls_files == (str(tmp_path / "port" / "tls" / "tls.crt"),
                                  str(tmp_path / "port" / "tls" / "tls.key"))
    src, dst = (jax, port) if dialer == "port" else (port, jax)
    payload = solved(b"over tls from " + dialer.encode())
    h = hold(src.ctx, payload)
    await port.start()
    await jax.start()
    try:
        peer_cls = Peer if dialer == "port" else ref("storage").Peer
        conn = await dst.pool.connect_to(peer_cls(LOOPBACK,
                                                  src.pool.listen_port))
        await until(lambda: conn.fully_established
                    and src.pool.established(), "the handshake")
        theirs, = src.pool.established()
        assert conn.tls_established and theirs.tls_established
        for c in (conn, theirs):
            assert c.writer.get_extra_info("cipher") is not None
        await until(lambda: h in dst.ctx.inventory, "the object over TLS")
        assert bytes(dst.ctx.inventory[h].payload) == payload
    finally:
        await port.stop()
        await jax.stop()


@pytest.mark.parametrize("plain", ["port", "jax"])
@limited
async def test_a_peer_without_node_ssl_stays_plaintext(plain):
    """One end does not advertise NODE_SSL: no upgrade on either end,
    and the handshake completes in plaintext."""
    port = port_node(tls_enabled=plain != "port")
    jax = jax_node(tls_enabled=plain != "jax")
    await port.start()
    await jax.start()
    try:
        conn = await port.pool.connect_to(Peer(LOOPBACK,
                                               jax.pool.listen_port))
        await until(lambda: conn.fully_established
                    and jax.pool.established(), "the handshake")
        theirs, = jax.pool.established()
        assert not conn.tls_established and not theirs.tls_established
        assert conn.writer.get_extra_info("cipher") is None
    finally:
        await port.stop()
        await jax.stop()
