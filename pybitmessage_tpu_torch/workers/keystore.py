"""Own identities and broadcast subscriptions with derived-key caches
(copy of ``pybitmessage_tpu.workers.keystore``).

Reference: src/shared.py:108-184 — ``myECCryptorObjects`` (ripe ->
decryptor), ``myAddressesByHash``/``ByTag``, and
``MyECSubscriptionCryptorObjects`` rebuilt from keys.dat and the
subscriptions table.  Keys persist in the same keys.dat INI format as
the JAX package's, so either package opens the other's file.

Public keys are derived once, when an identity is created or loaded,
through ``derive`` (``priv_to_pub_many`` on the card, as the node
passes it); without one the store derives on the host.
"""

from __future__ import annotations

import configparser
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path

from ..crypto.keys import (
    GRIND_BATCH, grind_deterministic_keys, grind_random_keys,
    host_priv_to_pub_many, wif_decode, wif_encode,
)
from ..models.constants import (
    DEFAULT_EXTRA_BYTES, DEFAULT_NONCE_TRIALS_PER_BYTE,
)
from ..models.payloads import broadcast_v4_key, double_hash_of_address_data
from ..utils.addresses import decode_address, encode_address
from ..utils.hashes import address_ripe

logger = logging.getLogger("pybitmessage_tpu_torch.keystore")

#: tries per derivation batch when the host derives (one pure-Python
#: multiplication each: a large batch would overshoot the first hit)
HOST_GRIND_BATCH = 8


@dataclass
class OwnIdentity:
    label: str
    address: str
    version: int
    stream: int
    ripe: bytes
    priv_signing: bytes
    priv_encryption: bytes
    #: 65-byte uncompressed public keys, derived once by the KeyStore
    pub_signing_key: bytes
    pub_encryption_key: bytes
    nonce_trials_per_byte: int = DEFAULT_NONCE_TRIALS_PER_BYTE
    extra_bytes: int = DEFAULT_EXTRA_BYTES
    chan: bool = False
    enabled: bool = True
    last_pubkey_send_time: int = 0
    # keys.dat fields of the mailing-list and email-gateway features
    mailinglist: bool = False
    mailinglistname: str = ""
    gateway: str = ""
    gateway_registration: str = ""
    gateway_unregistration: str = ""
    gateway_relay: str = ""

    @property
    def tag(self) -> bytes:
        """v4 pubkey-object tag (double hash [32:])."""
        return double_hash_of_address_data(
            self.version, self.stream, self.ripe)[32:]


@dataclass
class Subscription:
    label: str
    address: str
    enabled: bool = True
    # derived at load time:
    version: int = 0
    stream: int = 0
    ripe: bytes = b""

    @property
    def broadcast_key(self) -> bytes:
        """Private key every subscriber derives from the address itself
        (class_singleWorker.py:648-665)."""
        if self.version <= 3:
            return broadcast_v4_key(self.version, self.stream, self.ripe)
        return double_hash_of_address_data(
            self.version, self.stream, self.ripe)[:32]

    @property
    def tag(self) -> bytes:
        return double_hash_of_address_data(
            self.version, self.stream, self.ripe)[32:]


class KeyStore:
    """``derive(privkeys) -> pubkeys`` derives public keys in bulk (the
    node passes ``priv_to_pub_many`` on its device); ``None`` derives on
    the host, one pure-Python multiplication per key."""

    def __init__(self, path: str | Path | None = None, *, derive=None):
        self._path = Path(path) if path else None
        self._derive = derive or host_priv_to_pub_many
        self._grind_batch = GRIND_BATCH if derive else HOST_GRIND_BATCH
        self.identities: dict[str, OwnIdentity] = {}
        self.by_ripe: dict[bytes, OwnIdentity] = {}
        self.by_tag: dict[bytes, OwnIdentity] = {}
        self.subscriptions: dict[str, Subscription] = {}
        #: keyring epoch: bumped on every identity or subscription
        #: add/remove so trial-decrypt negative caches know their
        #: no-match proofs are stale
        self.epoch = 0
        self._listeners: list = []
        if self._path and self._path.exists():
            self.load()

    def add_change_listener(self, fn) -> None:
        """``fn()`` is called (synchronously, on the mutating thread)
        after every keyring epoch bump."""
        self._listeners.append(fn)

    def _bump_epoch(self) -> None:
        self.epoch += 1
        for fn in list(self._listeners):
            fn()

    # -- identity management -------------------------------------------------

    def _index(self, ident: OwnIdentity) -> None:
        self.identities[ident.address] = ident
        self.by_ripe[ident.ripe] = ident
        self.by_tag[ident.tag] = ident
        self._bump_epoch()

    def create_random(self, label: str = "", *, version: int = 4,
                      stream: int = 1, leading_zeros: int = 1) -> OwnIdentity:
        sk, ek, ripe = grind_random_keys(
            leading_zeros, derive=self._derive, batch=self._grind_batch)
        return self._register(label, version, stream, ripe, sk, ek)

    def create_deterministic(self, passphrase: bytes, label: str = "", *,
                             version: int = 4, stream: int = 1,
                             chan: bool = False) -> OwnIdentity:
        sk, ek, ripe, _ = grind_deterministic_keys(
            passphrase, derive=self._derive, batch=self._grind_batch)
        return self._register(label, version, stream, ripe, sk, ek,
                              chan=chan)

    def _register(self, label, version, stream, ripe, sk, ek,
                  chan=False) -> OwnIdentity:
        pub_sk, pub_ek = self._derive([sk, ek])
        ident = OwnIdentity(
            label, encode_address(version, stream, ripe), version, stream,
            ripe, sk, ek, pub_sk, pub_ek, chan=chan)
        self._index(ident)
        self.save()
        return ident

    def get(self, address: str) -> OwnIdentity | None:
        return self.identities.get(address)

    def owns(self, address: str) -> bool:
        return address in self.identities

    def remove(self, address: str) -> OwnIdentity | None:
        """Drop an identity and its derived-key indexes (the
        deleteAddress/leaveChan path); bumps the keyring epoch."""
        ident = self.identities.pop(address, None)
        if ident is None:
            return None
        self.by_ripe.pop(ident.ripe, None)
        self.by_tag.pop(ident.tag, None)
        self._bump_epoch()
        self.save()
        return ident

    # -- subscriptions -------------------------------------------------------

    def subscribe(self, address: str, label: str = "") -> Subscription:
        a = decode_address(address)
        sub = Subscription(label, address, True, a.version, a.stream, a.ripe)
        self.subscriptions[address] = sub
        self._bump_epoch()
        self.save()
        return sub

    def unsubscribe(self, address: str) -> None:
        if self.subscriptions.pop(address, None) is not None:
            self._bump_epoch()
        self.save()

    def active_subscriptions(self) -> list[Subscription]:
        return [s for s in self.subscriptions.values() if s.enabled]

    # -- persistence (keys.dat-style INI) ------------------------------------

    def save(self) -> None:
        if not self._path:
            return
        # interpolation=None: labels/list names are free text and may
        # contain '%', which BasicInterpolation would reject
        cfg = configparser.ConfigParser(interpolation=None)
        cfg.optionxform = str  # base58 addresses are case-sensitive
        for ident in self.identities.values():
            cfg[ident.address] = {
                "label": ident.label,
                "enabled": str(ident.enabled).lower(),
                "privsigningkey": wif_encode(ident.priv_signing),
                "privencryptionkey": wif_encode(ident.priv_encryption),
                "noncetrialsperbyte": str(ident.nonce_trials_per_byte),
                "payloadlengthextrabytes": str(ident.extra_bytes),
                "chan": str(ident.chan).lower(),
                "lastpubkeysendtime": str(ident.last_pubkey_send_time),
                "mailinglist": str(ident.mailinglist).lower(),
                "mailinglistname": ident.mailinglistname,
                "gateway": ident.gateway,
                "gatewayregistration": ident.gateway_registration,
                "gatewayunregistration": ident.gateway_unregistration,
                "gatewayrelay": ident.gateway_relay,
            }
        if self.subscriptions:
            cfg["subscriptions"] = {
                s.address: s.label for s in self.subscriptions.values()}
        # keyfile perms (shared.py:197-255): the tmp file is 0600 before
        # any WIF key is written to it
        tmp = self._path.with_suffix(".tmp")
        tmp.unlink(missing_ok=True)
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as f:
            cfg.write(f)
        tmp.replace(self._path)

    def load(self) -> None:
        cfg = configparser.ConfigParser(interpolation=None)
        cfg.optionxform = str  # base58 addresses are case-sensitive
        cfg.read(self._path)
        sections = []
        for section in cfg.sections():
            if section.startswith("BM-"):
                sections.append(section)
                continue
            if section != "subscriptions":
                continue
            for addr, label in cfg[section].items():
                # populate directly — subscribe() would save() mid-load
                try:
                    full = addr if addr.startswith("BM-") else "BM-" + addr
                    a = decode_address(full)
                except ValueError:
                    logger.warning("skipping undecodable subscription "
                                   "address %r in keys.dat", addr)
                    continue
                self.subscriptions[full] = Subscription(
                    label, full, True, a.version, a.stream, a.ripe)
        privs = []
        for section in sections:
            s = cfg[section]
            privs += [wif_decode(s["privsigningkey"]),
                      wif_decode(s["privencryptionkey"])]
        # every identity's public keys in one derivation
        pubs = self._derive(privs) if privs else []
        for i, section in enumerate(sections):
            s = cfg[section]
            a = decode_address(section)
            sk, ek = privs[2 * i], privs[2 * i + 1]
            pub_sk, pub_ek = pubs[2 * i], pubs[2 * i + 1]
            ident = OwnIdentity(
                s.get("label", ""), section, a.version, a.stream,
                address_ripe(pub_sk, pub_ek), sk, ek, pub_sk, pub_ek,
                int(s.get("noncetrialsperbyte",
                          DEFAULT_NONCE_TRIALS_PER_BYTE)),
                int(s.get("payloadlengthextrabytes", DEFAULT_EXTRA_BYTES)),
                s.get("chan", "false") == "true",
                s.get("enabled", "true") == "true",
                int(s.get("lastpubkeysendtime", 0)),
                s.get("mailinglist", "false") == "true",
                s.get("mailinglistname", ""),
                gateway=s.get("gateway", ""),
                gateway_registration=s.get("gatewayregistration", ""),
                gateway_unregistration=s.get("gatewayunregistration", ""),
                gateway_relay=s.get("gatewayrelay", ""))
            self._index(ident)

    def touch_pubkey_sent(self, address: str) -> None:
        ident = self.identities.get(address)
        if ident:
            ident.last_pubkey_send_time = int(time.time())
            self.save()
