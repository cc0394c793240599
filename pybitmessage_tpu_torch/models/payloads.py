"""Typed object payload codecs: msg, pubkey, getpubkey, broadcast, ack
(copy of ``pybitmessage_tpu.models.payloads``).

Byte-exact with the reference network formats:

- msg plaintext + signature coverage: class_singleWorker.py:1135-1232 /
  class_objectProcessor.py:435-580
- pubkey v2/v3 plain, v4 tagged+encrypted: class_singleWorker.py:252-530
- getpubkey by ripe (v<=3) or tag (v4): class_singleWorker.py:1375-1493
- broadcast v4/v5 with address-derived encryption key:
  class_singleWorker.py:596-715, class_objectProcessor.py:749-973
- ack payloads (stealth levels): helper_ackPayload.py:13-52

All assembly here produces payloads *without* the 8-byte nonce; the
PoW solver prepends it.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from ..crypto.ecies import encrypt
from ..crypto.keys import priv_to_pub, random_private_key
from ..utils.hashes import double_sha512, sha512
from ..utils.varint import decode_varint, encode_varint
from .constants import (
    DEFAULT_EXTRA_BYTES, DEFAULT_NONCE_TRIALS_PER_BYTE,
    OBJECT_GETPUBKEY, OBJECT_MSG, OBJECT_PUBKEY,
)


class PayloadError(ValueError):
    pass


def get_bitfield(does_ack: bool = True) -> bytes:
    """Behavior bitfield (protocol.py:27-31); bit 31 = BITFIELD_DOESACK."""
    return struct.pack(">I", 1 if does_ack else 0)


def bitfield_does_ack(bitfield: bytes) -> bool:
    return bool(struct.unpack(">I", bitfield)[0] & 1)


def double_hash_of_address_data(version: int, stream: int,
                                ripe: bytes) -> bytes:
    """64-byte double-SHA512 of the address data; [:32] is the v4
    pubkey-object decryption key, [32:] is the public tag."""
    return double_sha512(
        encode_varint(version) + encode_varint(stream) + ripe)


def broadcast_v4_key(version: int, stream: int, ripe: bytes) -> bytes:
    """v<=3 broadcast decryption privkey: single SHA512 of address data."""
    return sha512(
        encode_varint(version) + encode_varint(stream) + ripe)[:32]


# --- object payload shells (expires + type + version + stream) --------------

def object_shell(expires: int, object_type: int, version: int,
                 stream: int) -> bytes:
    return (struct.pack(">Q", expires) + struct.pack(">I", object_type)
            + encode_varint(version) + encode_varint(stream))


# --- msg --------------------------------------------------------------------

@dataclass
class MsgPlaintext:
    sender_version: int
    sender_stream: int
    bitfield: bytes
    pub_signing_key: bytes     # 65-byte uncompressed (0x04-prefixed)
    pub_encryption_key: bytes  # 65-byte uncompressed
    nonce_trials_per_byte: int
    extra_bytes: int
    dest_ripe: bytes
    encoding: int
    message: bytes
    ack_data: bytes            # full ack wire packet ('' if none)
    signature: bytes = b""
    #: offset of the end of ack data — signature coverage boundary
    signed_span: int = 0

    def encode_unsigned(self) -> bytes:
        out = encode_varint(self.sender_version)
        out += encode_varint(self.sender_stream)
        out += self.bitfield
        out += self.pub_signing_key[1:]
        out += self.pub_encryption_key[1:]
        if self.sender_version >= 3:
            out += encode_varint(self.nonce_trials_per_byte)
            out += encode_varint(self.extra_bytes)
        out += self.dest_ripe
        out += encode_varint(self.encoding)
        out += encode_varint(len(self.message)) + self.message
        out += encode_varint(len(self.ack_data)) + self.ack_data
        return out

    def encode(self) -> bytes:
        return (self.encode_unsigned()
                + encode_varint(len(self.signature)) + self.signature)

    @classmethod
    def decode(cls, data: bytes) -> "MsgPlaintext":
        try:
            i = 0
            ver, n = decode_varint(data, i)
            i += n
            if ver == 0 or ver > 4:
                raise PayloadError(f"sender address version {ver}")
            if len(data) < 170:
                raise PayloadError("plaintext unreasonably short")
            stream, n = decode_varint(data, i)
            i += n
            if stream == 0:
                raise PayloadError("sender stream 0")
            bitfield = data[i:i + 4]
            i += 4
            pub_sign = b"\x04" + data[i:i + 64]
            i += 64
            pub_enc = b"\x04" + data[i:i + 64]
            i += 64
            ntpb = extra = 0
            if ver >= 3:
                ntpb, n = decode_varint(data, i)
                i += n
                extra, n = decode_varint(data, i)
                i += n
            ripe = data[i:i + 20]
            i += 20
            enc, n = decode_varint(data, i)
            i += n
            mlen, n = decode_varint(data, i)
            i += n
            msg = data[i:i + mlen]
            i += mlen
            alen, n = decode_varint(data, i)
            i += n
            ack = data[i:i + alen]
            i += alen
            signed_span = i
            slen, n = decode_varint(data, i)
            i += n
            sig = data[i:i + slen]
            return cls(ver, stream, bitfield, pub_sign, pub_enc, ntpb,
                       extra, ripe, enc, msg, ack, sig, signed_span)
        except PayloadError:
            raise
        except Exception as exc:
            raise PayloadError(f"malformed msg plaintext: {exc}") from exc


def msg_signed_data(object_payload: bytes, msg_version: int, stream: int,
                    plaintext_through_ack: bytes) -> bytes:
    """Bytes covered by the msg signature (objectProcessor.py:562-564):
    expires(8)+type(4) from the object, then varint(msgVersion),
    varint(stream), then the plaintext through the end of ackdata."""
    return (object_payload[8:20] + encode_varint(msg_version)
            + encode_varint(stream) + plaintext_through_ack)


# --- ack payloads -----------------------------------------------------------

def gen_ack_payload(stream: int = 1, stealth_level: int = 0) -> bytes:
    """The watched ackdata: type(4) + varint(version) + varint(stream) +
    body; stealth levels 0/1/2 (helper_ackPayload.py:13-52)."""
    if stealth_level == 2:
        dummy_pub = priv_to_pub(random_private_key())
        dummy_len = 234 + int.from_bytes(os.urandom(2), "big") % 567
        body = encrypt(os.urandom(dummy_len), dummy_pub)
        acktype, version = OBJECT_MSG, 1
    elif stealth_level == 1:
        body = os.urandom(32)
        acktype, version = OBJECT_GETPUBKEY, 4
    else:
        body = os.urandom(32)
        acktype, version = OBJECT_MSG, 1
    return (struct.pack(">I", acktype) + encode_varint(version)
            + encode_varint(stream) + body)


def ack_ttl_bucket(ttl: int) -> int:
    """Bucket the ack TTL to 1 d / 7 d / 28 d so acks can't be timing-
    correlated with their msg (class_singleWorker.py:1495-1508)."""
    if ttl < 24 * 3600:
        return 24 * 3600
    if ttl < 7 * 24 * 3600:
        return 7 * 24 * 3600
    return 28 * 24 * 3600


# --- getpubkey --------------------------------------------------------------

def assemble_getpubkey(expires: int, address_version: int, stream: int,
                       ripe: bytes) -> bytes:
    """getpubkey payload sans nonce: ripe for v<=3, tag for v4."""
    shell = object_shell(expires, OBJECT_GETPUBKEY, address_version, stream)
    if address_version <= 3:
        return shell + ripe
    return shell + double_hash_of_address_data(
        address_version, stream, ripe)[32:]


# --- pubkey -----------------------------------------------------------------

@dataclass
class PubkeyData:
    address_version: int
    stream: int
    bitfield: bytes
    pub_signing_key: bytes     # 65B
    pub_encryption_key: bytes  # 65B
    nonce_trials_per_byte: int = DEFAULT_NONCE_TRIALS_PER_BYTE
    extra_bytes: int = DEFAULT_EXTRA_BYTES
    signature: bytes = b""
    tag: bytes = b""


def assemble_pubkey(expires: int, data: PubkeyData, ripe: bytes,
                    sign_fn=None) -> bytes:
    """Full pubkey object payload sans nonce for v2/v3/v4.

    ``sign_fn(bytes) -> signature`` must be supplied for v3/v4.
    v4 output is tag + ECIES blob encrypted to the address-derived key
    (class_singleWorker.py:417-467).
    """
    v = data.address_version
    shell = object_shell(expires, OBJECT_PUBKEY, v, data.stream)
    inner = (data.bitfield + data.pub_signing_key[1:]
             + data.pub_encryption_key[1:])
    if v == 2:
        return shell + inner
    inner += encode_varint(data.nonce_trials_per_byte)
    inner += encode_varint(data.extra_bytes)
    if v == 3:
        sig = sign_fn(shell + inner)
        return shell + inner + encode_varint(len(sig)) + sig
    # v4: tag goes in the clear; the rest is encrypted to a key every
    # address-holder can derive
    dh = double_hash_of_address_data(v, data.stream, ripe)
    tagged = shell + dh[32:]
    sig = sign_fn(tagged + inner)
    inner += encode_varint(len(sig)) + sig
    return tagged + encrypt(inner, priv_to_pub(dh[:32]))


def parse_pubkey_inner(data: bytes, address_version: int,
                       stream: int) -> PubkeyData:
    """Parse the (decrypted, for v4) pubkey body starting at the
    bitfield (objectProcessor.py:270-433)."""
    try:
        i = 0
        bitfield = data[i:i + 4]
        i += 4
        pub_sign = b"\x04" + data[i:i + 64]
        i += 64
        pub_enc = b"\x04" + data[i:i + 64]
        i += 64
        ntpb = DEFAULT_NONCE_TRIALS_PER_BYTE
        extra = DEFAULT_EXTRA_BYTES
        sig = b""
        if address_version >= 3:
            ntpb, n = decode_varint(data, i)
            i += n
            extra, n = decode_varint(data, i)
            i += n
            slen, n = decode_varint(data, i)
            i += n
            sig = data[i:i + slen]
        return PubkeyData(address_version, stream, bitfield, pub_sign,
                          pub_enc, ntpb, extra, sig)
    except Exception as exc:
        raise PayloadError(f"malformed pubkey: {exc}") from exc


# --- broadcast --------------------------------------------------------------

@dataclass
class BroadcastPlaintext:
    sender_version: int
    sender_stream: int
    bitfield: bytes
    pub_signing_key: bytes
    pub_encryption_key: bytes
    nonce_trials_per_byte: int
    extra_bytes: int
    encoding: int
    message: bytes
    signature: bytes = b""
    signed_span: int = 0

    def encode_unsigned(self) -> bytes:
        out = encode_varint(self.sender_version)
        out += encode_varint(self.sender_stream)
        out += self.bitfield
        out += self.pub_signing_key[1:]
        out += self.pub_encryption_key[1:]
        if self.sender_version >= 3:
            out += encode_varint(self.nonce_trials_per_byte)
            out += encode_varint(self.extra_bytes)
        out += encode_varint(self.encoding)
        out += encode_varint(len(self.message)) + self.message
        return out

    def encode(self) -> bytes:
        return (self.encode_unsigned()
                + encode_varint(len(self.signature)) + self.signature)

    @classmethod
    def decode(cls, data: bytes) -> "BroadcastPlaintext":
        try:
            i = 0
            ver, n = decode_varint(data, i)
            i += n
            stream, n = decode_varint(data, i)
            i += n
            bitfield = data[i:i + 4]
            i += 4
            pub_sign = b"\x04" + data[i:i + 64]
            i += 64
            pub_enc = b"\x04" + data[i:i + 64]
            i += 64
            ntpb = extra = 0
            if ver >= 3:
                ntpb, n = decode_varint(data, i)
                i += n
                extra, n = decode_varint(data, i)
                i += n
            enc, n = decode_varint(data, i)
            i += n
            mlen, n = decode_varint(data, i)
            i += n
            msg = data[i:i + mlen]
            i += mlen
            signed_span = i
            slen, n = decode_varint(data, i)
            i += n
            sig = data[i:i + slen]
            return cls(ver, stream, bitfield, pub_sign, pub_enc, ntpb,
                       extra, enc, msg, sig, signed_span)
        except Exception as exc:
            raise PayloadError(f"malformed broadcast: {exc}") from exc


def broadcast_signed_data(object_payload_through_tag: bytes,
                          plaintext_through_msg: bytes) -> bytes:
    """Signature coverage: object payload from expires through the tag
    (if any), then the plaintext through the message
    (class_singleWorker.py:641-645)."""
    return object_payload_through_tag + plaintext_through_msg
