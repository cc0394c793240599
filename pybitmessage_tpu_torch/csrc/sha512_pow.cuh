// Double-SHA512 PoW trial on u64 words, shared by the CUDA kernels
// (pow_kernels.cu) and a host build of the same arithmetic (g++, used by
// the CPU tests to check it against hashlib before any card time).
//
// trial(nonce, ih) = first 8 bytes of SHA512(SHA512(nonce || ih)) read
// big-endian: one 72-byte block, then one 64-byte digest block, 80 rounds
// each, fully unrolled so every schedule index is a constant and the
// 16-word window and the state live in registers.  FIPS 180-4 constants.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD static inline
#endif

// Rotate right by a constant 1..63.  On the device each half is one
// funnel shift (SHF) of the two 32-bit halves; the host uses shifts.
BM_HD uint64_t bm_rotr(uint64_t x, unsigned n) {
#if defined(__CUDA_ARCH__)
    const uint32_t lo = (uint32_t)x;
    const uint32_t hi = (uint32_t)(x >> 32);
    uint32_t rlo, rhi;
    if (n < 32) {
        rlo = __funnelshift_r(lo, hi, n);
        rhi = __funnelshift_r(hi, lo, n);
    } else {
        rlo = __funnelshift_r(hi, lo, n - 32);
        rhi = __funnelshift_r(lo, hi, n - 32);
    }
    return ((uint64_t)rhi << 32) | rlo;
#else
    return (x >> n) | (x << (64 - n));
#endif
}

BM_HD uint64_t bm_Sigma0(uint64_t x) {
    return bm_rotr(x, 28) ^ bm_rotr(x, 34) ^ bm_rotr(x, 39);
}
BM_HD uint64_t bm_Sigma1(uint64_t x) {
    return bm_rotr(x, 14) ^ bm_rotr(x, 18) ^ bm_rotr(x, 41);
}
BM_HD uint64_t bm_sigma0(uint64_t x) {
    return bm_rotr(x, 1) ^ bm_rotr(x, 8) ^ (x >> 7);
}
BM_HD uint64_t bm_sigma1(uint64_t x) {
    return bm_rotr(x, 19) ^ bm_rotr(x, 61) ^ (x >> 6);
}
BM_HD uint64_t bm_ch(uint64_t e, uint64_t f, uint64_t g) {
    return (e & f) ^ (~e & g);
}
BM_HD uint64_t bm_maj(uint64_t a, uint64_t b, uint64_t c) {
    return (a & b) ^ (a & c) ^ (b & c);
}

// Round t (a literal) over the rotating state names: extends the
// schedule window in place for t >= 16, then d += T1 and h = T1 + T2
// (the next round names h as its a and d as its e).
#define BM_ROUND(a, b, c, d, e, f, g, h, t, k)                              \
    do {                                                                    \
        if ((t) >= 16)                                                      \
            w[(t) & 15] += bm_sigma1(w[((t) + 14) & 15]) + w[((t) + 9) & 15] \
                           + bm_sigma0(w[((t) + 1) & 15]);                  \
        const uint64_t t1 = h + bm_Sigma1(e) + bm_ch(e, f, g) + (k)         \
                            + w[(t) & 15];                                  \
        d += t1;                                                            \
        h = t1 + bm_Sigma0(a) + bm_maj(a, b, c);                            \
    } while (0)

// One compression of the padded block w[16] (clobbered); out = H0 + state.
BM_HD void bm_compress(uint64_t w[16], uint64_t out[8]) {
    const uint64_t H0[8] = {
        0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL, 0xA54FF53A5F1D36F1ULL,
        0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL, 0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};
    uint64_t a = H0[0], b = H0[1], c = H0[2], d = H0[3];
    uint64_t e = H0[4], f = H0[5], g = H0[6], h = H0[7];
    BM_ROUND(a, b, c, d, e, f, g, h, 0, 0x428A2F98D728AE22ULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 1, 0x7137449123EF65CDULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 2, 0xB5C0FBCFEC4D3B2FULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 3, 0xE9B5DBA58189DBBCULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 4, 0x3956C25BF348B538ULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 5, 0x59F111F1B605D019ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 6, 0x923F82A4AF194F9BULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 7, 0xAB1C5ED5DA6D8118ULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 8, 0xD807AA98A3030242ULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 9, 0x12835B0145706FBEULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 10, 0x243185BE4EE4B28CULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 11, 0x550C7DC3D5FFB4E2ULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 12, 0x72BE5D74F27B896FULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 13, 0x80DEB1FE3B1696B1ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 14, 0x9BDC06A725C71235ULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 15, 0xC19BF174CF692694ULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 16, 0xE49B69C19EF14AD2ULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 17, 0xEFBE4786384F25E3ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 18, 0x0FC19DC68B8CD5B5ULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 19, 0x240CA1CC77AC9C65ULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 20, 0x2DE92C6F592B0275ULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 21, 0x4A7484AA6EA6E483ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 22, 0x5CB0A9DCBD41FBD4ULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 23, 0x76F988DA831153B5ULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 24, 0x983E5152EE66DFABULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 25, 0xA831C66D2DB43210ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 26, 0xB00327C898FB213FULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 27, 0xBF597FC7BEEF0EE4ULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 28, 0xC6E00BF33DA88FC2ULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 29, 0xD5A79147930AA725ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 30, 0x06CA6351E003826FULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 31, 0x142929670A0E6E70ULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 32, 0x27B70A8546D22FFCULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 33, 0x2E1B21385C26C926ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 34, 0x4D2C6DFC5AC42AEDULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 35, 0x53380D139D95B3DFULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 36, 0x650A73548BAF63DEULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 37, 0x766A0ABB3C77B2A8ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 38, 0x81C2C92E47EDAEE6ULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 39, 0x92722C851482353BULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 40, 0xA2BFE8A14CF10364ULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 41, 0xA81A664BBC423001ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 42, 0xC24B8B70D0F89791ULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 43, 0xC76C51A30654BE30ULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 44, 0xD192E819D6EF5218ULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 45, 0xD69906245565A910ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 46, 0xF40E35855771202AULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 47, 0x106AA07032BBD1B8ULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 48, 0x19A4C116B8D2D0C8ULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 49, 0x1E376C085141AB53ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 50, 0x2748774CDF8EEB99ULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 51, 0x34B0BCB5E19B48A8ULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 52, 0x391C0CB3C5C95A63ULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 53, 0x4ED8AA4AE3418ACBULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 54, 0x5B9CCA4F7763E373ULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 55, 0x682E6FF3D6B2B8A3ULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 56, 0x748F82EE5DEFB2FCULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 57, 0x78A5636F43172F60ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 58, 0x84C87814A1F0AB72ULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 59, 0x8CC702081A6439ECULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 60, 0x90BEFFFA23631E28ULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 61, 0xA4506CEBDE82BDE9ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 62, 0xBEF9A3F7B2C67915ULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 63, 0xC67178F2E372532BULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 64, 0xCA273ECEEA26619CULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 65, 0xD186B8C721C0C207ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 66, 0xEADA7DD6CDE0EB1EULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 67, 0xF57D4F7FEE6ED178ULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 68, 0x06F067AA72176FBAULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 69, 0x0A637DC5A2C898A6ULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 70, 0x113F9804BEF90DAEULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 71, 0x1B710B35131C471BULL);
    BM_ROUND(a, b, c, d, e, f, g, h, 72, 0x28DB77F523047D84ULL);
    BM_ROUND(h, a, b, c, d, e, f, g, 73, 0x32CAAB7B40C72493ULL);
    BM_ROUND(g, h, a, b, c, d, e, f, 74, 0x3C9EBE0A15C9BEBCULL);
    BM_ROUND(f, g, h, a, b, c, d, e, 75, 0x431D67C49C100D4CULL);
    BM_ROUND(e, f, g, h, a, b, c, d, 76, 0x4CC5D4BECB3E42B6ULL);
    BM_ROUND(d, e, f, g, h, a, b, c, 77, 0x597F299CFC657E2AULL);
    BM_ROUND(c, d, e, f, g, h, a, b, 78, 0x5FCB6FAB3AD6FAECULL);
    BM_ROUND(b, c, d, e, f, g, h, a, 79, 0x6C44198C4A475817ULL);
    out[0] = H0[0] + a; out[1] = H0[1] + b;
    out[2] = H0[2] + c; out[3] = H0[3] + d;
    out[4] = H0[4] + e; out[5] = H0[5] + f;
    out[6] = H0[6] + g; out[7] = H0[7] + h;
}

#undef BM_ROUND

// The PoW trial value of one nonce against an object's initial-hash
// words (big-endian u64s of the 64-byte SHA512 of the object sans nonce).
BM_HD uint64_t bm_pow_trial(uint64_t nonce, const uint64_t ih[8]) {
    uint64_t w[16];
    uint64_t h[8];
    w[0] = nonce;
    w[1] = ih[0]; w[2] = ih[1]; w[3] = ih[2]; w[4] = ih[3];
    w[5] = ih[4]; w[6] = ih[5]; w[7] = ih[6]; w[8] = ih[7];
    w[9] = 0x8000000000000000ULL;
    w[10] = 0; w[11] = 0; w[12] = 0; w[13] = 0; w[14] = 0;
    w[15] = 576;  // message bit length
    bm_compress(w, h);
    w[0] = h[0]; w[1] = h[1]; w[2] = h[2]; w[3] = h[3];
    w[4] = h[4]; w[5] = h[5]; w[6] = h[6]; w[7] = h[7];
    w[8] = 0x8000000000000000ULL;
    w[9] = 0; w[10] = 0; w[11] = 0; w[12] = 0; w[13] = 0; w[14] = 0;
    w[15] = 512;
    bm_compress(w, h);
    return h[0];
}
