"""The port's host-only modules the daemon reaches, against the JAX
package's, on the CPU: ``core.testdata.populate``,
``models.messagetypes`` (and ``msgcoding``'s extended encoding through
it), ``core.plugins`` with the shipped ``sound_bell``,
``proxyconfig_stem``, ``qrcode_menu`` and ``desktop_autostart``
plugins, ``migrate``, ``crypto.blindsig`` (signatures and chains made
in one package verify in the other) and ``utils.qr``.

Inputs come from numpy seeds or from the JAX package's own fixtures
(``tests/test_migrate.py``'s reference directory, ``tests/test_plugins.py``'s
scripted Tor control port); every comparison is exact.
"""

import configparser
import json
import socket
import sqlite3
import threading

import numpy as np
import pytest

from pybitmessage_tpu_torch.core import plugins as port_plugins
from pybitmessage_tpu_torch.core import testdata as port_testdata
from pybitmessage_tpu_torch.core.config import Settings
from pybitmessage_tpu_torch.models import messagetypes as port_mt
from pybitmessage_tpu_torch.models import msgcoding as port_coding


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pybitmessage_tpu.core import plugins, testdata
    from pybitmessage_tpu.models import messagetypes, msgcoding
    return plugins, testdata, messagetypes, msgcoding


# ---------------------------------------------------------------------------
# --populate-test-data
# ---------------------------------------------------------------------------


class _Node:
    """What ``populate`` reads of a node: its keystore and store."""

    def __init__(self, keystore, store):
        self.keystore, self.store = keystore, store


def test_populate_seeds_the_jax_fixtures():
    _jax()
    from pybitmessage_tpu.storage.db import Database as JaxDatabase
    from pybitmessage_tpu.storage.messages import MessageStore as JaxStore
    from pybitmessage_tpu.workers.keystore import KeyStore as JaxKeyStore
    from pybitmessage_tpu_torch.storage.db import Database
    from pybitmessage_tpu_torch.storage.messages import MessageStore
    from pybitmessage_tpu_torch.workers.keystore import KeyStore
    jax_testdata = _jax()[1]
    seen = []
    for populate, ks, db, store in (
            (port_testdata.populate, KeyStore, Database, MessageStore),
            (jax_testdata.populate, JaxKeyStore, JaxDatabase, JaxStore)):
        node = _Node(ks(None), store(db(":memory:")))
        first = populate(node)
        assert populate(node) == first            # idempotent
        inbox = [(m.msgid, m.toaddress, m.fromaddress, m.subject,
                  m.message) for m in node.store.inbox()]
        ident = node.keystore.get(first)
        seen.append((first, ident.label, inbox,
                     node.store.addressbook()))
    assert seen[0] == seen[1]
    assert len(seen[0][2]) == 1
    assert seen[0][2][0][3] == port_testdata.SAMPLE_SUBJECT


# ---------------------------------------------------------------------------
# extended message types
# ---------------------------------------------------------------------------


def _maps(rng) -> list:
    text = lambda n: rng.bytes(n).hex()  # noqa: E731
    return [
        {"": "message", "subject": text(4), "body": text(20)},
        {"": "message", "subject": 7, "body": [1, 2]},
        {"": "message", "subject": text(3)},
        {"": "message", "body": text(3)},
        {"": "message", "subject": "", "body": "", "extra": text(2)},
        {"": "vote", "msgid": text(8), "vote": "yes"},
        {"": "vote"},
        {"": "nosuchtype", "subject": "s", "body": "b"},
        {"": 5, "subject": "s", "body": "b"},
        {"subject": "s", "body": "b"},
        [("", "message")], "message", None, 3,
    ]


def _outcome(construct, error, obj):
    try:
        return ("ok", construct(obj).data)
    except error as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("seed", range(2))
def test_messagetypes_and_the_extended_encoding_are_the_jax_ones(seed):
    jax_mt, jax_coding = _jax()[2], _jax()[3]
    assert port_mt.WHITELIST == jax_mt.WHITELIST
    rng = np.random.default_rng([seed, 15, 9])
    import msgpack
    import zlib
    for obj in _maps(rng):
        assert _outcome(port_mt.construct, port_mt.MessageTypeError, obj) \
            == _outcome(jax_mt.construct, jax_mt.MessageTypeError, obj)
        payload = zlib.compress(msgpack.packb(obj, use_bin_type=False))
        outs = []
        for coding in (port_coding, jax_coding):
            try:
                body = coding.decode_message(payload, coding.EXTENDED)
                outs.append(("ok", body.subject, body.body))
            except coding.DecodeError as exc:
                outs.append(("error", str(exc)))
        assert outs[0] == outs[1], obj
    subject, body = rng.bytes(6).hex(), rng.bytes(40).hex()
    data = port_coding.encode_message(subject, body, port_coding.EXTENDED)
    assert jax_coding.decode_message(data, 3).__dict__ == \
        port_coding.decode_message(data, 3).__dict__ == \
        {"subject": subject, "body": body}


# ---------------------------------------------------------------------------
# plugins
# ---------------------------------------------------------------------------


def test_plugin_lookups_are_the_jax_ones_but_the_front_ends():
    """Every group finds the JAX package's plugins, the front-end ones
    (``gui.menu`` qrcode, ``desktop`` autostart) included, each from the
    port's own copy."""
    jax_plugins = _jax()[0]
    assert port_plugins.KNOWN_GROUPS == jax_plugins.KNOWN_GROUPS
    for group in port_plugins.KNOWN_GROUPS:
        mine = dict(port_plugins.iter_plugins(group))
        theirs = dict(jax_plugins.iter_plugins(group))
        assert sorted(mine) == sorted(theirs), group
        for name, fn in mine.items():
            assert fn.__module__.startswith("pybitmessage_tpu_torch.")
            assert fn.__name__ == theirs[name].__name__
        assert (port_plugins.get_plugin(group) is None) == \
            (jax_plugins.get_plugin(group) is None)
    assert port_plugins.get_plugin("proxyconfig", "nosuch") is None


def test_the_sound_plugin_rings_as_the_jax_one(capsys, tmp_path):
    jax_plugins = _jax()[0]
    for plugins in (port_plugins, jax_plugins):
        sound = plugins.get_plugin("notification.sound")
        assert sound("") is True
        assert sound(str(tmp_path / "missing.wav")) is True
    out = capsys.readouterr().out
    assert out == "\a" * 4


def _settings_pair(tmp_path, values: dict):
    _jax()
    from pybitmessage_tpu.core.config import Settings as JaxSettings
    out = []
    for i, cls in enumerate((Settings, JaxSettings)):
        s = cls(tmp_path / ("settings%d.dat" % i))
        for key, value in values.items():
            s.set_temp(key, value)
        out.append(s)
    return out


def _accept_until_closed(sock) -> None:
    """A local SOCKS port the plugin probes: accept until closed."""
    try:
        while True:
            sock.accept()
    except OSError:
        pass


_KEYS = ("sockstype", "sockshostname", "socksport", "onionhostname",
         "onionservicekey", "onionservicekeytype")


@pytest.mark.parametrize("case", ["remote", "adopted", "hidden-service",
                                  "saved-key", "no-proxy", "unknown"])
def test_start_proxyconfig_against_a_fake_control_port(case, tmp_path,
                                                       monkeypatch):
    """Both packages' ``start_proxyconfig`` on the same settings: the
    same verdict, the same rewritten settings and the same control-port
    commands (the scripted control port of the JAX plugin tests)."""
    jax_plugins = _jax()[0]
    from tests.test_plugins import FakeTorControl
    proxy = socket.socket()
    proxy.bind(("127.0.0.1", 0))
    proxy.listen(8)
    threading.Thread(target=_accept_until_closed, args=(proxy,),
                     daemon=True).start()
    free = socket.socket()
    free.bind(("127.0.0.1", 0))
    closed_port = free.getsockname()[1]
    free.close()
    ctl = FakeTorControl(service_id="abcdefghijklmnop")
    values = {"sockstype": "stem", "port": 17011, "onionport": 8444}
    if case == "remote":
        values["sockshostname"] = "198.51.100.4"
    elif case == "adopted":
        values["socksport"] = proxy.getsockname()[1]
    elif case in ("hidden-service", "saved-key"):
        values.update(socksport=proxy.getsockname()[1], sockslisten=True,
                      torcontrolport=ctl.port)
        if case == "saved-key":
            values.update(onionservicekey="c2F2ZWQ=",
                          onionservicekeytype="RSA1024")
    elif case == "no-proxy":
        values["socksport"] = closed_port
        for mod in ("pybitmessage_tpu_torch.plugins.proxyconfig_stem",
                    "pybitmessage_tpu.plugins.proxyconfig_stem"):
            monkeypatch.setattr(mod + ".shutil.which", lambda name: None)
    else:
        values["sockstype"] = "nosuchplugin"
    try:
        results = []
        for plugins, s in zip((port_plugins, jax_plugins),
                              _settings_pair(tmp_path, values)):
            ctl.requests.clear()
            ok = plugins.start_proxyconfig(s)
            results.append((ok, [s.get(k) for k in _KEYS],
                            list(ctl.requests)))
    finally:
        proxy.close()
        ctl.close()
    assert results[0] == results[1]
    ok, after, requests = results[0]
    assert ok == (case not in ("no-proxy", "unknown"))
    if case in ("hidden-service", "saved-key"):
        assert after[3] == "abcdefghijklmnop.onion"
        assert any(r.startswith("ADD_ONION") for r in requests)


# ---------------------------------------------------------------------------
# migrate
# ---------------------------------------------------------------------------


def _rows(home) -> dict:
    con = sqlite3.connect(home / "messages.dat")
    try:
        return {t: sorted(map(repr, con.execute("SELECT * FROM %s" % t)))
                for t in ("inbox", "sent", "addressbook", "subscriptions",
                          "blacklist", "whitelist")}
    finally:
        con.close()


def _keys(home) -> dict:
    cfg = configparser.ConfigParser(interpolation=None)
    cfg.optionxform = str
    cfg.read(home / "keys.dat")
    return {s: dict(cfg[s]) for s in cfg.sections()}


def test_migrate_gives_the_jax_rows(tmp_path, capsys):
    _jax()
    from pybitmessage_tpu.migrate import migrate as jax_migrate
    from pybitmessage_tpu_torch import migrate as port_migrate
    from tests.test_migrate import _make_ref_dir
    ref, addr, chan = _make_ref_dir(tmp_path)
    homes = tmp_path / "port", tmp_path / "jax"
    mine = port_migrate.migrate(ref, homes[0])
    theirs = jax_migrate(ref, homes[1])
    assert mine == theirs and mine["identities"] == 2
    assert _rows(homes[0]) == _rows(homes[1])
    assert _keys(homes[0]) == _keys(homes[1])
    assert set(_keys(homes[0])) >= {addr, chan}
    nodes = [json.loads((h / "knownnodes.dat").read_text()) for h in homes]
    assert nodes[0] == nodes[1]
    # a second run imports nothing, and the entry point prints the same
    again = port_migrate.migrate(ref, homes[0])
    assert again == jax_migrate(ref, homes[1])
    assert port_migrate.main([str(ref), str(tmp_path / "third")]) == 0
    assert "identities: 2 imported" in capsys.readouterr().out
    assert port_migrate.main([str(tmp_path / "empty"),
                              str(tmp_path / "fourth")]) == 1


# ---------------------------------------------------------------------------
# blind signatures, the QR encoder and the front-end plugins
# ---------------------------------------------------------------------------


def _blindsig():
    _jax()
    from pybitmessage_tpu.crypto import blindsig as jax_bs
    from pybitmessage_tpu_torch.crypto import blindsig as port_bs
    return {"jax": jax_bs, "port": port_bs}


@pytest.mark.parametrize("signer", ["jax", "port"])
def test_a_blind_signature_verifies_in_both_packages(signer):
    """The signer of one package, the requester of the other: the
    unblinded signature verifies under both ``verify``; bound to its
    message."""
    mods = _blindsig()
    other = "port" if signer == "jax" else "jax"
    rng = np.random.default_rng(3)
    key = mods[signer].BlindSigner(int(rng.integers(1, 1 << 62)))
    message = rng.bytes(40)
    commitment = key.new_request()
    req = mods[other].BlindRequester(key.pubkey, commitment, message)
    sig = req.unblind(key.sign_blind(commitment, req.blinded_challenge))
    wire = sig.serialize()
    for name, mod in mods.items():
        theirs = mod.BlindSignature.deserialize(wire)
        assert theirs.serialize() == wire
        assert mod.verify(theirs, message), name
        assert not mod.verify(theirs, message + b"!"), name


def test_point_codec_and_challenge_are_byte_equal():
    mods = _blindsig()
    jax_bs, port_bs = mods["jax"], mods["port"]
    rng = np.random.default_rng(4)
    for _ in range(4):
        k = int(rng.integers(1, 1 << 62))
        point = port_bs._mul(k)
        assert point == jax_bs._mul(k)
        enc = port_bs._encode_point(point)
        assert enc == jax_bs._encode_point(point)
        assert port_bs._decode_point(enc) == jax_bs._decode_point(enc) \
            == point
        message = rng.bytes(int(rng.integers(0, 64)))
        assert port_bs._challenge(point, message) == \
            jax_bs._challenge(point, message)
    assert port_bs._encode_point(None) == jax_bs._encode_point(None)
    with pytest.raises(ValueError):
        port_bs._decode_point(b"\x02" + (5).to_bytes(32, "big"))


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_a_chain_built_in_one_package_verifies_in_the_other(maker):
    mods = _blindsig()
    mod = mods[maker]
    root, mid, leaf = (mod.BlindSigner(k) for k in (11, 22, 33))
    chain = mod.SignatureChain(root.pubkey)
    chain.extend(root, mid.pubkey)
    chain.extend(mid, leaf.pubkey)
    sig = mod.blind_sign_roundtrip(leaf, b"payload")
    for name, other in mods.items():
        copy = other.SignatureChain(root.pubkey)
        copy.links = [(pub, other.BlindSignature.deserialize(s.serialize()))
                      for pub, s in chain.links]
        theirs = other.BlindSignature.deserialize(sig.serialize())
        assert copy.verify_payload(b"payload", theirs), name
        assert not copy.verify_payload(b"other", theirs), name


def test_qr_matrices_and_renderings_are_the_jax_ones():
    _jax()
    from pybitmessage_tpu.utils import qr as jax_qr
    from pybitmessage_tpu_torch.utils import qr as port_qr
    rng = np.random.default_rng(5)
    alphabet = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
    for _ in range(4):
        n = int(rng.integers(30, 90))
        data = "bitmessage:BM-" + "".join(
            alphabet[i] for i in rng.integers(0, len(alphabet), n))
        matrix = port_qr.encode(data)
        assert matrix == jax_qr.encode(data)
        assert port_qr.render_text(matrix) == jax_qr.render_text(matrix)
        assert port_qr.render_svg(matrix) == jax_qr.render_svg(matrix)


def test_the_front_end_plugins_match_the_jax_ones(tmp_path, monkeypatch):
    """Both found through the port's loader: the QR plugin's renderings
    are the JAX plugin's, and the autostart plugin writes the same entry
    under a temporary home (the port's names its own daemon) and
    removes it."""
    jax_plugins = _jax()[0]
    qr = port_plugins.get_plugin("gui.menu", "qrcode")
    autostart = port_plugins.get_plugin("desktop", "autostart")
    assert qr.__module__ == "pybitmessage_tpu_torch.plugins.qrcode_menu"
    address = "BM-2cWy7cvHoq3f1rYMerRJp8PT653jjSuEdY"
    assert qr(address) == jax_plugins.get_plugin("gui.menu", "qrcode")(
        address)
    monkeypatch.delenv("XDG_CONFIG_HOME", raising=False)
    entries = {}
    for pkg, fn in (("port", autostart), ("jax", jax_plugins.get_plugin(
            "desktop", "autostart"))):
        monkeypatch.setenv("HOME", str(tmp_path / pkg))
        path = tmp_path / pkg / ".config" / "autostart" / \
            "pybitmessage-tpu.desktop"
        assert fn(exec_line="bmd -d /srv/bm") is True
        entries[pkg] = path.read_text()
        assert fn(enable=False) is True and not path.exists()
        assert fn() is True
        assert "-m %s -d" % ("pybitmessage_tpu_torch" if pkg == "port"
                             else "pybitmessage_tpu") in path.read_text()
    assert entries["port"] == entries["jax"]
