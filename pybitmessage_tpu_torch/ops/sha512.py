"""Batched double-SHA512 PoW trial in int64 torch (twin of ``ops/sha512_jax.py``).

The PoW trial is ``SHA512(SHA512(nonce(8B) || initialHash(64B)))`` and
only the first 8 output bytes matter.  The 72-byte message fits one
1024-bit block and the 64-byte digest another, so a trial is exactly
two 80-round compressions.  Every word is a u64 in an int64 tensor (see
``u64.py``), vectorised over any batch shape.  This is the plain version
the CUDA kernels are held against, and what the wrappers run for
tensors on the CPU.

FIPS 180-4 constants.
"""

from __future__ import annotations

import torch

from .u64 import rotr, shr, to_i64, words_from_bytes

_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]

_H0 = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

# int64 images of the constants: torch takes them as plain scalars
_K64 = [to_i64(k) for k in _K]
_H64 = [to_i64(h) for h in _H0]
#: the 0x80 pad byte opening the padding word
_PAD = to_i64(0x8000000000000000)


def _compress(w: list[torch.Tensor]) -> list[torch.Tensor]:
    """80 rounds over a 16-word window of same-shape int64 tensors;
    returns the eight output words (H0 added)."""
    w = list(w)
    a, b, c, d, e, f, g, h = (torch.full_like(w[0], v) for v in _H64)
    for t in range(80):
        if t >= 16:
            w15 = w[(t - 15) % 16]
            w2 = w[(t - 2) % 16]
            w[t % 16] = (w[t % 16]
                         + (rotr(w15, 1) ^ rotr(w15, 8) ^ shr(w15, 7))
                         + w[(t - 7) % 16]
                         + (rotr(w2, 19) ^ rotr(w2, 61) ^ shr(w2, 6)))
        s1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K64[t] + w[t % 16]
        s0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + s0 + maj
    return [x + h0 for x, h0 in zip((a, b, c, d, e, f, g, h), _H64)]


def sha512_block(w: torch.Tensor) -> torch.Tensor:
    """One SHA-512 compression of a single padded block.

    ``w``: int64 (16, ...) message words, batched over trailing
    dimensions.  Returns the eight output words as int64 (8, ...).
    """
    return torch.stack(_compress(list(w.unbind(0))))


def initial_hash_words(initial_hash: bytes, device=None) -> torch.Tensor:
    """The 64-byte initial hash as eight big-endian u64 words, int64 (8,)."""
    if len(initial_hash) != 64:
        raise ValueError("initial hash must be 64 bytes, got %d"
                         % len(initial_hash))
    return torch.tensor(words_from_bytes(initial_hash), dtype=torch.int64,
                        device=device)


def double_sha512_trial(nonce: torch.Tensor,
                        ih_words: torch.Tensor) -> torch.Tensor:
    """PoW trial values: the first 8 bytes of SHA512(SHA512(nonce || ih))
    as u64 words.

    ``nonce``: int64 (...) candidate nonces.  ``ih_words``: int64 (8,)
    for one object, or (8, ...) broadcastable against ``nonce`` for
    per-lane objects.  Returns int64 with ``nonce``'s shape.
    """
    zero = torch.zeros_like(nonce)
    # block 1: 72 message bytes + padding; W[15] = bit length 576
    w = [nonce] + [zero + ih_words[i] for i in range(8)]
    w += [zero + _PAD] + [zero] * 5 + [zero + 576]
    h1 = _compress(w)
    # block 2: the 64-byte digest + padding; W[15] = 512
    w2 = h1 + [zero + _PAD] + [zero] * 6 + [zero + 512]
    return _compress(w2)[0]


def trial_values(base, ih_words: torch.Tensor, lanes: int):
    """Trial values for nonces ``base .. base + lanes - 1`` (mod 2^64).

    ``base``: an int64 int or 0-dim tensor.  Returns (values, nonces),
    both int64 (lanes,).
    """
    nonces = base + torch.arange(lanes, dtype=torch.int64,
                                 device=ih_words.device)
    return double_sha512_trial(nonces, ih_words), nonces
