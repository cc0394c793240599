// secp256k1 field, scalar and group arithmetic for the receive kernels
// (secp256k1_kernels.cu), shared with a host build of the same source (g++,
// used by the CPU tests to check every line against Python integers before
// any card time).
//
// Field elements are 8 x 32-bit little-endian limbs, kept lazily below
// 2^256 (not necessarily below p) between operations and made canonical
// only where a value is compared or stored.  Every carry goes through the
// primitives of the first section: PTX carry chains (add.cc / addc,
// sub.cc / subc, mad.lo.cc / madc.hi.cc) on the card, a portable C twin
// on the host.  Those primitives are the only code that differs between
// the two builds.  A carry chain lives in the CC flag between consecutive
// asm statements, so each chain is straight-line code: every loop around
// one is unrolled at compile time.
//
// Scalars are 8 x 32-bit limbs read from 32 big-endian bytes and taken
// over all 256 bits (k >= n gives (k mod n) * P).  A coordinate at or
// above p is reduced once on load, which the lazy form does by itself
// (2^256 < 2p).
//
// Group law: Jacobian coordinates with an explicit infinity flag,
// doubling dbl-2009-l for a = 0 (2 M + 5 S), mixed Jacobian + affine
// addition (8 M + 3 S) with every exceptional case chosen by select, and
// one complete Jacobian addition to join the two halves of a lane.  A
// window table shares one Z instead of being made affine (no inversion).
//
// A lane is two halves, one per thread on the card, running the same
// code, and a join (the host runs the halves' stages in turn):
//   ECDH, P = G:  each half walks 32 nibbles of k through the fixed-base
//                 comb (affine j * 16^i * G, 64 windows x 15 points);
//   ECDH, other:  k = k1 + k2 * lambda (mod n), |k1|, |k2| < 2^128
//                 (GLV, split by each half); half 0 builds P's 4-bit
//                 window table, which the pair shares, then walks |k1|
//                 over +-P, half 1 |k2| over +-phi(P) = (beta*x, +-y);
//   verify:       u2 * Q as ECDH does k * P, then each half adds its 32
//                 nibbles of u1 through the comb onto its share.
// The join adds the halves; ECDH makes the sum affine with one
// inversion, verify compares X with r * Z^2 (and (r + n) * Z^2 when
// r + n < p) without one.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BM_SECP_INLINE __host__ __device__ __forceinline__
#define BM_SECP_FN __host__ __device__ inline
#else
#define BM_SECP_INLINE static inline
#define BM_SECP_FN static inline
#endif

typedef struct { uint32_t v[8]; } bm_fe;
typedef struct { bm_fe X, Y, Z; uint32_t inf; } bm_jac;
typedef struct { bm_fe x, y; } bm_aff;

//: curve and GLV constants, 8 little-endian 32-bit limbs each: the group
//: order n, G, beta (a cube root of 1 mod p; phi(x, y) = (beta*x, y) is
//: multiplication by lambda), the reduced basis a1, |b1|, a2 (b2 = a1)
//: and g1 = round(2^384 b2 / n), g2 = round(2^384 |b1| / n)
typedef struct {
    uint32_t n[8], gx[8], gy[8], beta[8], a1[8], b1[8], a2[8], g1[8],
        g2[8];
} bm_secp_consts;

#define BM_SECP_CONSTS_INIT {                                               \
    {0xD0364141U, 0xBFD25E8CU, 0xAF48A03BU, 0xBAAEDCE6U, 0xFFFFFFFEU,       \
     0xFFFFFFFFU, 0xFFFFFFFFU, 0xFFFFFFFFU},                                \
    {0x16F81798U, 0x59F2815BU, 0x2DCE28D9U, 0x029BFCDBU, 0xCE870B07U,       \
     0x55A06295U, 0xF9DCBBACU, 0x79BE667EU},                                \
    {0xFB10D4B8U, 0x9C47D08FU, 0xA6855419U, 0xFD17B448U, 0x0E1108A8U,       \
     0x5DA4FBFCU, 0x26A3C465U, 0x483ADA77U},                                \
    {0x719501EEU, 0xC1396C28U, 0x12F58995U, 0x9CF04975U, 0xAC3434E9U,       \
     0x6E64479EU, 0x657C0710U, 0x7AE96A2BU},                                \
    {0x9284EB15U, 0xE86C90E4U, 0xA7D46BCDU, 0x3086D221U, 0, 0, 0, 0},       \
    {0x0ABFE4C3U, 0x6F547FA9U, 0x010E8828U, 0xE4437ED6U, 0, 0, 0, 0},       \
    {0x9D44CFD8U, 0x57C1108DU, 0xA8E2F3F6U, 0x14CA50F7U, 0x00000001U,       \
     0, 0, 0},                                                              \
    {0x45DBB031U, 0xE893209AU, 0x71E8CA7FU, 0x3DAA8A14U, 0x9284EB15U,       \
     0xE86C90E4U, 0xA7D46BCDU, 0x3086D221U},                                \
    {0x8AC47F71U, 0x1571B4AEU, 0x9DF506C6U, 0x221208ACU, 0x0ABFE4C4U,       \
     0x6F547FA9U, 0x010E8828U, 0xE4437ED6U}}

// The constants live in __constant__ memory on the card (every thread
// reads the same words: one broadcast per load); the host build reads a
// plain copy.
#if defined(__CUDACC__)
__constant__ bm_secp_consts bm_secp_c_dev = BM_SECP_CONSTS_INIT;
#endif
static const bm_secp_consts bm_secp_c_host = BM_SECP_CONSTS_INIT;
#if defined(__CUDA_ARCH__)
#define BM_SECP_C bm_secp_c_dev
#else
#define BM_SECP_C bm_secp_c_host
#endif

// 2^256 mod p = 2^32 + 977
#define BM_SECP_R0 977U

//: windows of the fixed-base comb: 15 affine points j * 16^i * G
//: (j = 1..15) each, 16 words a point (x then y, canonical limbs)
#define BM_COMB_WINDOWS 64
//: nibbles a GLV half walks (|k1|, |k2| < 2^128)
#define BM_GLV_NIBBLES 32

// ---------------------------------------------------------------------------
// carry primitives: the only code that differs between card and host
// ---------------------------------------------------------------------------

// The carry (or borrow) flag of a chain: the CC register on the card,
// this word on the host.
typedef struct { uint32_t c; } bm_cc;

#if defined(__CUDA_ARCH__)
#define BM_ASM2(op, a, b)                                                   \
    uint32_t r;                                                             \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
    (void)cc;                                                               \
    return r
#define BM_ASM3(op, a, b, c3)                                               \
    uint32_t r;                                                             \
    asm volatile(op " %0, %1, %2, %3;"                                      \
                 : "=r"(r) : "r"(a), "r"(b), "r"(c3));                      \
    (void)cc;                                                               \
    return r
#endif

// a + b, carry out
BM_SECP_INLINE uint32_t bm_add_cc(bm_cc* cc, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    BM_ASM2("add.cc.u32", a, b);
#else
    uint64_t s = (uint64_t)a + b;
    cc->c = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
}

// a + b + carry, carry out
BM_SECP_INLINE uint32_t bm_addc_cc(bm_cc* cc, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    BM_ASM2("addc.cc.u32", a, b);
#else
    uint64_t s = (uint64_t)a + b + cc->c;
    cc->c = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
}

// a + b + carry, ends the chain
BM_SECP_INLINE uint32_t bm_addc(bm_cc* cc, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    BM_ASM2("addc.u32", a, b);
#else
    return a + b + cc->c;
#endif
}

// a - b, borrow out
BM_SECP_INLINE uint32_t bm_sub_cc(bm_cc* cc, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    BM_ASM2("sub.cc.u32", a, b);
#else
    uint64_t d = (uint64_t)a - b;
    cc->c = (uint32_t)(d >> 63);
    return (uint32_t)d;
#endif
}

// a - b - borrow, borrow out
BM_SECP_INLINE uint32_t bm_subc_cc(bm_cc* cc, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    BM_ASM2("subc.cc.u32", a, b);
#else
    uint64_t d = (uint64_t)a - b - cc->c;
    cc->c = (uint32_t)(d >> 63);
    return (uint32_t)d;
#endif
}

// a - b - borrow, ends the chain
BM_SECP_INLINE uint32_t bm_subc(bm_cc* cc, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    BM_ASM2("subc.u32", a, b);
#else
    return a - b - cc->c;
#endif
}

// lo(a * b) + c, carry out
BM_SECP_INLINE uint32_t bm_mad_lo_cc(bm_cc* cc, uint32_t a, uint32_t b,
                                     uint32_t c) {
#if defined(__CUDA_ARCH__)
    BM_ASM3("mad.lo.cc.u32", a, b, c);
#else
    uint64_t s = (uint64_t)(uint32_t)(a * b) + c;
    cc->c = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
}

// lo(a * b) + c + carry, carry out
BM_SECP_INLINE uint32_t bm_madc_lo_cc(bm_cc* cc, uint32_t a, uint32_t b,
                                      uint32_t c) {
#if defined(__CUDA_ARCH__)
    BM_ASM3("madc.lo.cc.u32", a, b, c);
#else
    uint64_t s = (uint64_t)(uint32_t)(a * b) + c + cc->c;
    cc->c = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
}

// hi(a * b) + c, carry out
BM_SECP_INLINE uint32_t bm_mad_hi_cc(bm_cc* cc, uint32_t a, uint32_t b,
                                     uint32_t c) {
#if defined(__CUDA_ARCH__)
    BM_ASM3("mad.hi.cc.u32", a, b, c);
#else
    uint64_t s = (((uint64_t)a * b) >> 32) + c;
    cc->c = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
}

// hi(a * b) + c + carry, carry out
BM_SECP_INLINE uint32_t bm_madc_hi_cc(bm_cc* cc, uint32_t a, uint32_t b,
                                      uint32_t c) {
#if defined(__CUDA_ARCH__)
    BM_ASM3("madc.hi.cc.u32", a, b, c);
#else
    uint64_t s = (((uint64_t)a * b) >> 32) + c + cc->c;
    cc->c = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
}

// hi(a * b) + c + carry, ends the chain
BM_SECP_INLINE uint32_t bm_madc_hi(bm_cc* cc, uint32_t a, uint32_t b,
                                   uint32_t c) {
#if defined(__CUDA_ARCH__)
    BM_ASM3("madc.hi.u32", a, b, c);
#else
    return (uint32_t)(((uint64_t)a * b) >> 32) + c + cc->c;
#endif
}

// hi(a * b) + c, outside any chain
BM_SECP_INLINE uint32_t bm_mad_hi(bm_cc* cc, uint32_t a, uint32_t b,
                                  uint32_t c) {
#if defined(__CUDA_ARCH__)
    BM_ASM3("mad.hi.u32", a, b, c);
#else
    (void)cc;
    return (uint32_t)(((uint64_t)a * b) >> 32) + c;
#endif
}

// ---------------------------------------------------------------------------
// 256-bit words
// ---------------------------------------------------------------------------

// t[0..15] = a * b: one row a[i] * b per limb of a, its low halves in one
// mad.lo chain and its high halves in one madc.hi chain
BM_SECP_INLINE void bm_mul512(uint32_t* t, const uint32_t* a,
                              const uint32_t* b) {
    bm_cc cc = {0};
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        t[i] = bm_mad_lo_cc(&cc, a[i], b[0], t[i]);
#pragma unroll
        for (int j = 1; j < 8; ++j)
            t[i + j] = bm_madc_lo_cc(&cc, a[i], b[j], t[i + j]);
        t[i + 8] = bm_addc(&cc, 0, 0);
        t[i + 1] = bm_mad_hi_cc(&cc, a[i], b[0], t[i + 1]);
#pragma unroll
        for (int j = 1; j < 7; ++j)
            t[i + j + 1] = bm_madc_hi_cc(&cc, a[i], b[j], t[i + j + 1]);
        // the rows so far fit i + 9 words: no carry out of this one
        t[i + 8] = bm_madc_hi(&cc, a[i], b[7], t[i + 8]);
    }
}

// t[0..15] = a^2: the 28 products a[i] * a[j], i < j, doubled by a shift,
// plus the 8 squares a[i]^2
BM_SECP_INLINE void bm_sqr512(uint32_t* t, const uint32_t* a) {
    bm_cc cc = {0};
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        t[2 * i + 1] = bm_mad_lo_cc(&cc, a[i], a[i + 1], t[2 * i + 1]);
#pragma unroll
        for (int j = i + 2; j < 8; ++j)
            t[i + j] = bm_madc_lo_cc(&cc, a[i], a[j], t[i + j]);
        t[i + 8] = bm_addc(&cc, 0, 0);
        if (i == 6) {
            t[14] = bm_mad_hi(&cc, a[6], a[7], t[14]);
        } else {
            t[2 * i + 2] = bm_mad_hi_cc(&cc, a[i], a[i + 1], t[2 * i + 2]);
#pragma unroll
            for (int j = i + 2; j < 7; ++j)
                t[i + j + 1] = bm_madc_hi_cc(&cc, a[i], a[j], t[i + j + 1]);
            t[i + 8] = bm_madc_hi(&cc, a[i], a[7], t[i + 8]);
        }
    }
    t[15] = t[14] >> 31;
#pragma unroll
    for (int k = 14; k > 1; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
    t[1] <<= 1;
    t[0] = bm_mad_lo_cc(&cc, a[0], a[0], t[0]);
    t[1] = bm_madc_hi_cc(&cc, a[0], a[0], t[1]);
#pragma unroll
    for (int i = 1; i < 7; ++i) {
        t[2 * i] = bm_madc_lo_cc(&cc, a[i], a[i], t[2 * i]);
        t[2 * i + 1] = bm_madc_hi_cc(&cc, a[i], a[i], t[2 * i + 1]);
    }
    t[14] = bm_madc_lo_cc(&cc, a[7], a[7], t[14]);
    t[15] = bm_madc_hi(&cc, a[7], a[7], t[15]);
}

// r = a - b mod 2^256
BM_SECP_INLINE void bm_sub256(uint32_t* r, const uint32_t* a,
                              const uint32_t* b) {
    bm_cc cc = {0};
    r[0] = bm_sub_cc(&cc, a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 7; ++i) r[i] = bm_subc_cc(&cc, a[i], b[i]);
    r[7] = bm_subc(&cc, a[7], b[7]);
}

// 1 if a >= b (the borrow of a - b, which is not kept)
BM_SECP_INLINE uint32_t bm_ge256(const uint32_t* a, const uint32_t* b) {
    bm_cc cc = {0};
    (void)bm_sub_cc(&cc, a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) (void)bm_subc_cc(&cc, a[i], b[i]);
    return 1U - (bm_subc(&cc, 0, 0) & 1U);
}

// a where mask is all ones, b where it is zero
BM_SECP_INLINE void bm_select256(uint32_t* r, const uint32_t* a,
                                 const uint32_t* b, uint32_t mask) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = (a[i] & mask) | (b[i] & ~mask);
}

// 32 big-endian bytes -> 8 little-endian limbs
BM_SECP_INLINE void bm_load256(uint32_t* v, const uint8_t* b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint8_t* w = b + 28 - 4 * i;
        v[i] = ((uint32_t)w[0] << 24) | ((uint32_t)w[1] << 16) |
               ((uint32_t)w[2] << 8) | (uint32_t)w[3];
    }
}

BM_SECP_INLINE void bm_store256(uint8_t* b, const uint32_t* v) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint8_t* w = b + 28 - 4 * i;
        w[0] = (uint8_t)(v[i] >> 24);
        w[1] = (uint8_t)(v[i] >> 16);
        w[2] = (uint8_t)(v[i] >> 8);
        w[3] = (uint8_t)v[i];
    }
}

// nibble i (0 = least significant) of a 256-bit scalar
BM_SECP_INLINE uint32_t bm_nibble(const uint32_t* k, int i) {
    return (k[i >> 3] >> ((i & 7) * 4)) & 15U;
}

// ---------------------------------------------------------------------------
// field arithmetic mod p = 2^256 - 2^32 - 977, values lazily < 2^256
// ---------------------------------------------------------------------------

// t[0..15] (any 512-bit value) -> r < 2^256, r == t (mod p): the high
// half folds in as 977 * h by one mad chain plus h shifted by a word;
// the at most 34 bits above 2^256 that leaves fold once more, and a
// last carry (r < 2^67 then) once more again.
BM_SECP_INLINE void bm_fe_reduce16(bm_fe* r, const uint32_t* t) {
    bm_cc cc = {0};
    const uint32_t* h = t + 8;
    uint32_t x[10];
    x[0] = bm_mad_lo_cc(&cc, h[0], BM_SECP_R0, t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j)
        x[j] = bm_madc_lo_cc(&cc, h[j], BM_SECP_R0, t[j]);
    x[8] = bm_addc(&cc, 0, 0);
    x[1] = bm_mad_hi_cc(&cc, h[0], BM_SECP_R0, x[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j)
        x[j + 1] = bm_madc_hi_cc(&cc, h[j], BM_SECP_R0, x[j + 1]);
    x[8] = bm_madc_hi(&cc, h[7], BM_SECP_R0, x[8]);
    x[1] = bm_add_cc(&cc, x[1], h[0]);
#pragma unroll
    for (int j = 2; j < 9; ++j) x[j] = bm_addc_cc(&cc, x[j], h[j - 1]);
    x[9] = bm_addc(&cc, 0, 0);
    // s = (x[8] + 2^32 x[9]) * (2^32 + 977), three words
    uint32_t s0 = x[8] * BM_SECP_R0;
    uint32_t s1 = bm_mad_hi(&cc, x[8], BM_SECP_R0, 0);
    s1 = bm_add_cc(&cc, s1, x[8]);
    uint32_t s2 = bm_addc(&cc, x[9], 0);
    s1 = bm_add_cc(&cc, s1, x[9] * BM_SECP_R0);
    s2 = bm_addc(&cc, s2, 0);
    r->v[0] = bm_add_cc(&cc, x[0], s0);
    r->v[1] = bm_addc_cc(&cc, x[1], s1);
    r->v[2] = bm_addc_cc(&cc, x[2], s2);
#pragma unroll
    for (int j = 3; j < 8; ++j) r->v[j] = bm_addc_cc(&cc, x[j], 0);
    uint32_t c = bm_addc(&cc, 0, 0);
    r->v[0] = bm_add_cc(&cc, r->v[0], c * BM_SECP_R0);
    r->v[1] = bm_addc_cc(&cc, r->v[1], c);
    r->v[2] = bm_addc(&cc, r->v[2], 0);
}

BM_SECP_INLINE void bm_fe_mul(bm_fe* r, const bm_fe* a, const bm_fe* b) {
    uint32_t t[16];
    bm_mul512(t, a->v, b->v);
    bm_fe_reduce16(r, t);
}

BM_SECP_INLINE void bm_fe_sqr(bm_fe* r, const bm_fe* a) {
    uint32_t t[16];
    bm_sqr512(t, a->v);
    bm_fe_reduce16(r, t);
}

BM_SECP_INLINE void bm_fe_add(bm_fe* r, const bm_fe* a, const bm_fe* b) {
    bm_cc cc = {0};
    uint32_t x[8];
    x[0] = bm_add_cc(&cc, a->v[0], b->v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) x[i] = bm_addc_cc(&cc, a->v[i], b->v[i]);
    uint32_t c = bm_addc(&cc, 0, 0);
    // + 2^256 == + 2^32 + 977; a second carry leaves x < 2^33
    x[0] = bm_add_cc(&cc, x[0], c * BM_SECP_R0);
    x[1] = bm_addc_cc(&cc, x[1], c);
#pragma unroll
    for (int i = 2; i < 8; ++i) x[i] = bm_addc_cc(&cc, x[i], 0);
    c = bm_addc(&cc, 0, 0);
    r->v[0] = bm_add_cc(&cc, x[0], c * BM_SECP_R0);
    r->v[1] = bm_addc(&cc, x[1], c);
#pragma unroll
    for (int i = 2; i < 8; ++i) r->v[i] = x[i];
}

BM_SECP_INLINE void bm_fe_sub(bm_fe* r, const bm_fe* a, const bm_fe* b) {
    bm_cc cc = {0};
    uint32_t x[8];
    x[0] = bm_sub_cc(&cc, a->v[0], b->v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) x[i] = bm_subc_cc(&cc, a->v[i], b->v[i]);
    uint32_t bw = bm_subc(&cc, 0, 0) & 1U;
    // - 2^256 == - (2^32 + 977); a second borrow leaves x >= 2^256 - 2^33
    x[0] = bm_sub_cc(&cc, x[0], bw * BM_SECP_R0);
    x[1] = bm_subc_cc(&cc, x[1], bw);
#pragma unroll
    for (int i = 2; i < 8; ++i) x[i] = bm_subc_cc(&cc, x[i], 0);
    bw = bm_subc(&cc, 0, 0) & 1U;
    r->v[0] = bm_sub_cc(&cc, x[0], bw * BM_SECP_R0);
    r->v[1] = bm_subc(&cc, x[1], bw);
#pragma unroll
    for (int i = 2; i < 8; ++i) r->v[i] = x[i];
}

// the canonical value (< p): a + 2^32 + 977 carries exactly when a >= p,
// and its low words are then a - p
BM_SECP_INLINE void bm_fe_canon(bm_fe* r, const bm_fe* a) {
    bm_cc cc = {0};
    uint32_t t[8];
    t[0] = bm_add_cc(&cc, a->v[0], BM_SECP_R0);
    t[1] = bm_addc_cc(&cc, a->v[1], 1);
#pragma unroll
    for (int i = 2; i < 8; ++i) t[i] = bm_addc_cc(&cc, a->v[i], 0);
    uint32_t ge = 0U - bm_addc(&cc, 0, 0);
    bm_select256(r->v, t, a->v, ge);
}

BM_SECP_INLINE uint32_t bm_fe_is_zero(const bm_fe* a) {
    bm_fe c;
    bm_fe_canon(&c, a);
    uint32_t o = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) o |= c.v[i];
    return o == 0;
}

BM_SECP_INLINE uint32_t bm_fe_eq(const bm_fe* a, const bm_fe* b) {
    bm_fe d;
    bm_fe_sub(&d, a, b);
    return bm_fe_is_zero(&d);
}

BM_SECP_INLINE void bm_fe_neg(bm_fe* r, const bm_fe* a) {
    bm_fe zero = {{0, 0, 0, 0, 0, 0, 0, 0}};
    bm_fe_sub(r, &zero, a);
}

BM_SECP_INLINE void bm_fe_set(bm_fe* r, const uint32_t* w) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r->v[i] = w[i];
}

BM_SECP_INLINE void bm_fe_select(bm_fe* r, const bm_fe* a, const bm_fe* b,
                                 uint32_t cond) {
    bm_select256(r->v, a->v, b->v, 0U - cond);
}

BM_SECP_FN void bm_fe_sqr_n(bm_fe* r, const bm_fe* a, int n) {
    *r = *a;
#pragma unroll 1
    for (int i = 0; i < n; ++i) bm_fe_sqr(r, r);
}

// a^(p-2) by the standard secp256k1 addition chain (255 squarings and
// 15 multiplications); 0 -> 0
BM_SECP_FN void bm_fe_inv(bm_fe* r, const bm_fe* a) {
    bm_fe x2, x3, x6, x9, x11, x22, x44, x88, x176, x220, x223, t;
    bm_fe_sqr(&x2, a);
    bm_fe_mul(&x2, &x2, a);
    bm_fe_sqr(&x3, &x2);
    bm_fe_mul(&x3, &x3, a);
    bm_fe_sqr_n(&x6, &x3, 3);
    bm_fe_mul(&x6, &x6, &x3);
    bm_fe_sqr_n(&x9, &x6, 3);
    bm_fe_mul(&x9, &x9, &x3);
    bm_fe_sqr_n(&x11, &x9, 2);
    bm_fe_mul(&x11, &x11, &x2);
    bm_fe_sqr_n(&x22, &x11, 11);
    bm_fe_mul(&x22, &x22, &x11);
    bm_fe_sqr_n(&x44, &x22, 22);
    bm_fe_mul(&x44, &x44, &x22);
    bm_fe_sqr_n(&x88, &x44, 44);
    bm_fe_mul(&x88, &x88, &x44);
    bm_fe_sqr_n(&x176, &x88, 88);
    bm_fe_mul(&x176, &x176, &x88);
    bm_fe_sqr_n(&x220, &x176, 44);
    bm_fe_mul(&x220, &x220, &x44);
    bm_fe_sqr_n(&x223, &x220, 3);
    bm_fe_mul(&x223, &x223, &x3);
    bm_fe_sqr_n(&t, &x223, 23);
    bm_fe_mul(&t, &t, &x22);
    bm_fe_sqr_n(&t, &t, 5);
    bm_fe_mul(&t, &t, a);
    bm_fe_sqr_n(&t, &t, 3);
    bm_fe_mul(&t, &t, &x2);
    bm_fe_sqr_n(&t, &t, 2);
    bm_fe_mul(r, &t, a);
}

// ---------------------------------------------------------------------------
// scalars: the GLV split
// ---------------------------------------------------------------------------

// round(k * g / 2^384) for k < n, g one of g1, g2 (a value < 2^129)
BM_SECP_INLINE void bm_mul_shift384(uint32_t* c, const uint32_t* k,
                                    const uint32_t* g) {
    uint32_t t[16];
    bm_mul512(t, k, g);
    bm_cc cc = {0};
    c[0] = bm_add_cc(&cc, t[12], t[11] >> 31);
    c[1] = bm_addc_cc(&cc, t[13], 0);
    c[2] = bm_addc_cc(&cc, t[14], 0);
    c[3] = bm_addc_cc(&cc, t[15], 0);
    c[4] = bm_addc(&cc, 0, 0);
#pragma unroll
    for (int i = 5; i < 8; ++i) c[i] = 0;
}

// r = a - b * c mod 2^256
BM_SECP_INLINE void bm_submul256(uint32_t* r, const uint32_t* a,
                                 const uint32_t* b, const uint32_t* c) {
    uint32_t t[16];
    bm_mul512(t, b, c);
    bm_sub256(r, a, t);
}

// |k| and its sign (1 = negative) from a two's complement value mod 2^256
BM_SECP_INLINE uint32_t bm_abs256(uint32_t* k) {
    uint32_t neg = k[7] >> 31, m[8];
    uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    bm_sub256(m, zero, k);
    bm_select256(k, m, k, 0U - neg);
    return neg;
}

// k = k1 + k2 * lambda (mod n), |k1|, |k2| < 2^128 (libsecp256k1's
// scalar_split_lambda, in integers: c1 = round(k b2 / n), c2 =
// round(k (-b1) / n), k1 = k - c1 a1 - c2 a2, k2 = c1 |b1| - c2 b2, with
// b2 = a1).  k is taken over all 256 bits and reduced mod n first.
// Writes |k1|, |k2| and returns their signs as bit 0 and bit 1.
BM_SECP_FN uint32_t bm_glv_split(uint32_t* k1, uint32_t* k2,
                                 const uint32_t* k_in) {
    uint32_t k[8], kn[8], c1[8], c2[8];
    bm_sub256(kn, k_in, BM_SECP_C.n);
    bm_select256(k, kn, k_in, 0U - bm_ge256(k_in, BM_SECP_C.n));
    bm_mul_shift384(c1, k, BM_SECP_C.g1);
    bm_mul_shift384(c2, k, BM_SECP_C.g2);
    bm_submul256(k1, k, c1, BM_SECP_C.a1);
    bm_submul256(k1, k1, c2, BM_SECP_C.a2);
    uint32_t t[16];
    bm_mul512(t, c1, BM_SECP_C.b1);
    bm_submul256(k2, t, c2, BM_SECP_C.a1);
    uint32_t s1 = bm_abs256(k1);
    uint32_t s2 = bm_abs256(k2);
    return s1 | (s2 << 1);
}

// ---------------------------------------------------------------------------
// group operations (a = 0, b = 7)
// ---------------------------------------------------------------------------

BM_SECP_FN uint32_t bm_on_curve(const bm_fe* x, const bm_fe* y) {
    bm_fe y2, x3, seven = {{7, 0, 0, 0, 0, 0, 0, 0}};
    bm_fe_sqr(&y2, y);
    bm_fe_sqr(&x3, x);
    bm_fe_mul(&x3, &x3, x);
    bm_fe_add(&x3, &x3, &seven);
    return bm_fe_eq(&y2, &x3);
}

BM_SECP_INLINE void bm_jac_set_inf(bm_jac* r) {
    bm_fe zero = {{0, 0, 0, 0, 0, 0, 0, 0}};
    r->X = r->Y = r->Z = zero;
    r->inf = 1;
}

BM_SECP_INLINE void bm_jac_from_aff(bm_jac* r, const bm_fe* x,
                                    const bm_fe* y) {
    bm_fe one = {{1, 0, 0, 0, 0, 0, 0, 0}};
    r->X = *x;
    r->Y = *y;
    r->Z = one;
    r->inf = 0;
}

BM_SECP_INLINE void bm_jac_select(bm_jac* r, const bm_jac* a,
                                  const bm_jac* b, uint32_t cond) {
    bm_fe_select(&r->X, &a->X, &b->X, cond);
    bm_fe_select(&r->Y, &a->Y, &b->Y, cond);
    bm_fe_select(&r->Z, &a->Z, &b->Z, cond);
    r->inf = cond ? a->inf : b->inf;
}

// 2a, dbl-2009-l for a = 0 (2 M + 5 S).  No point of the prime-order
// group has Y = 0, so infinity only passes through.
BM_SECP_FN void bm_jac_dbl(bm_jac* r, const bm_jac* a) {
    bm_fe A, B, C, D, E, F, t, x3, y3, z3;
    bm_fe_sqr(&A, &a->X);
    bm_fe_sqr(&B, &a->Y);
    bm_fe_sqr(&C, &B);
    bm_fe_add(&t, &a->X, &B);
    bm_fe_sqr(&t, &t);
    bm_fe_sub(&t, &t, &A);
    bm_fe_sub(&t, &t, &C);
    bm_fe_add(&D, &t, &t);                  // D = 2((X + B)^2 - A - C)
    bm_fe_add(&E, &A, &A);
    bm_fe_add(&E, &E, &A);                  // E = 3A
    bm_fe_sqr(&F, &E);
    bm_fe_sub(&x3, &F, &D);
    bm_fe_sub(&x3, &x3, &D);                // X3 = F - 2D
    bm_fe_add(&C, &C, &C);
    bm_fe_add(&C, &C, &C);
    bm_fe_add(&C, &C, &C);
    bm_fe_sub(&t, &D, &x3);
    bm_fe_mul(&y3, &E, &t);
    bm_fe_sub(&y3, &y3, &C);                // Y3 = E(D - X3) - 8C
    bm_fe_mul(&z3, &a->Y, &a->Z);
    bm_fe_add(&z3, &z3, &z3);               // Z3 = 2 Y Z
    r->X = x3;
    r->Y = y3;
    r->Z = z3;
    r->inf = a->inf;
}

// a + (x2, y2) by the mixed formula alone (8 M + 3 S), for a finite a
// that is not +-(x2, y2); *h = x2 Z1^2 - X1 (so that Z3 = Z1 h) and
// *rr = y2 Z1^3 - Y1
BM_SECP_FN void bm_jac_madd_core(bm_jac* s, bm_fe* h, bm_fe* rr,
                                 const bm_jac* a, const bm_fe* x2,
                                 const bm_fe* y2) {
    bm_fe z1z1, u2, s2, hh, hhh, v, w, t;
    bm_fe_sqr(&z1z1, &a->Z);
    bm_fe_mul(&u2, x2, &z1z1);
    bm_fe_mul(&s2, &a->Z, &z1z1);
    bm_fe_mul(&s2, y2, &s2);
    bm_fe_sub(h, &u2, &a->X);
    bm_fe_sub(rr, &s2, &a->Y);
    bm_fe_sqr(&hh, h);
    bm_fe_mul(&hhh, h, &hh);
    bm_fe_mul(&v, &a->X, &hh);
    bm_fe_mul(&w, &a->Y, &hhh);
    bm_fe_mul(&s->Z, &a->Z, h);             // a is read in full by now: s
    bm_fe_sqr(&s->X, rr);                   // may be a
    bm_fe_sub(&s->X, &s->X, &hhh);
    bm_fe_sub(&s->X, &s->X, &v);
    bm_fe_sub(&s->X, &s->X, &v);            // X3 = r^2 - h^3 - 2 X1 h^2
    bm_fe_sub(&t, &v, &s->X);
    bm_fe_mul(&s->Y, rr, &t);
    bm_fe_sub(&s->Y, &s->Y, &w);            // Y3 = r (X1 h^2 - X3) - Y1 h^3
    s->inf = 0;
}

// a + (x2, y2) for an affine addend (8 M + 3 S); use = 0 keeps a.  Every
// case is a select on the one computed sum: a at infinity gives the
// addend, a == -addend (h = 0, r != 0) infinity, a == addend (h = 0,
// r = 0) the doubling of a, which is the only branch and runs only on a
// lane where a equals its addend.
BM_SECP_FN void bm_jac_madd(bm_jac* r, const bm_jac* a, const bm_fe* x2,
                            const bm_fe* y2, uint32_t use) {
    bm_fe h, rr;
    bm_jac s;
    bm_jac_madd_core(&s, &h, &rr, a, x2, y2);
    uint32_t same = use & (a->inf ^ 1U) & bm_fe_is_zero(&h);
    uint32_t rz = bm_fe_is_zero(&rr);
    if (same & rz) bm_jac_dbl(&s, a);
    s.inf = same & (rz ^ 1U);
    bm_jac p;
    bm_jac_from_aff(&p, x2, y2);
    bm_jac_select(&s, &p, &s, a->inf);
    bm_jac_select(r, &s, a, use);
}

// a + b, complete: either operand at infinity gives the other, a == b
// doubles, a == -b gives infinity (12 M + 4 S; joins a lane's halves)
BM_SECP_FN void bm_jac_add(bm_jac* r, const bm_jac* a, const bm_jac* b) {
    bm_fe z1z1, z2z2, u1, u2, s1, s2, h, rr, hh, hhh, v, t;
    bm_jac s;
    bm_fe_sqr(&z1z1, &a->Z);
    bm_fe_sqr(&z2z2, &b->Z);
    bm_fe_mul(&u1, &a->X, &z2z2);
    bm_fe_mul(&u2, &b->X, &z1z1);
    bm_fe_mul(&s1, &a->Y, &z2z2);
    bm_fe_mul(&s1, &s1, &b->Z);
    bm_fe_mul(&s2, &b->Y, &z1z1);
    bm_fe_mul(&s2, &s2, &a->Z);
    bm_fe_sub(&h, &u2, &u1);
    bm_fe_sub(&rr, &s2, &s1);
    bm_fe_sqr(&hh, &h);
    bm_fe_mul(&hhh, &hh, &h);
    bm_fe_mul(&v, &u1, &hh);
    bm_fe_sqr(&s.X, &rr);
    bm_fe_sub(&s.X, &s.X, &hhh);
    bm_fe_sub(&s.X, &s.X, &v);
    bm_fe_sub(&s.X, &s.X, &v);              // X3 = r^2 - h^3 - 2 u1 h^2
    bm_fe_sub(&t, &v, &s.X);
    bm_fe_mul(&s.Y, &rr, &t);
    bm_fe_mul(&t, &s1, &hhh);
    bm_fe_sub(&s.Y, &s.Y, &t);              // Y3 = r (u1 h^2 - X3) - s1 h^3
    bm_fe_mul(&s.Z, &a->Z, &b->Z);
    bm_fe_mul(&s.Z, &s.Z, &h);
    s.inf = 0;
    uint32_t both = (a->inf | b->inf) ^ 1U;
    uint32_t same = both & bm_fe_is_zero(&h);
    uint32_t rz = bm_fe_is_zero(&rr);
    if (same & rz) bm_jac_dbl(&s, a);
    s.inf = same & (rz ^ 1U);
    bm_jac_select(&s, b, &s, a->inf);
    bm_jac_select(r, a, &s, b->inf);
}

// canonical affine (x, y) of a finite point (the caller checks inf)
BM_SECP_FN void bm_jac_to_aff(bm_fe* x, bm_fe* y, const bm_jac* a) {
    bm_fe zi, zi2;
    bm_fe_inv(&zi, &a->Z);
    bm_fe_sqr(&zi2, &zi);
    bm_fe_mul(x, &a->X, &zi2);
    bm_fe_mul(y, &a->Y, &zi2);
    bm_fe_mul(y, y, &zi);
    bm_fe_canon(x, x);
    bm_fe_canon(y, y);
}

// T[j - 1] = j * P for j = 1..15, for P = (x, y) on the curve, all with
// one Z, *zg, and no inversion (libsecp256k1's global-Z table): 2P by a
// doubling, 3P..15P by mixed additions of P (none is exceptional: P has
// order n), each with Z_{j+1} = Z_j h_j, so each point is brought to
// Z_15 by a product of the later h's.  (x_j, y_j) are then affine points
// of the isomorphic curve y^2 = x^3 + 7 zg^6, where the walk's mixed
// additions and doublings hold unchanged (a = 0 and b does not enter
// them): a sum (X, Y, Z) there is (X, Y, Z zg) on the curve.
BM_SECP_FN void bm_window_table(bm_aff* T, bm_fe* zg, const bm_fe* x,
                                const bm_fe* y) {
    bm_fe h[15], rr, s, s2;
    bm_jac acc;
    bm_jac_from_aff(&acc, x, y);
    T[0].x = *x;
    T[0].y = *y;
    bm_jac_dbl(&acc, &acc);
    T[1].x = acc.X;
    T[1].y = acc.Y;
    h[1] = acc.Z;                           // Z_2 = Z_1 * 2Y
#pragma unroll 1
    for (int j = 2; j < 15; ++j) {
        bm_jac_madd_core(&acc, &h[j], &rr, &acc, x, y);
        T[j].x = acc.X;
        T[j].y = acc.Y;
    }
    *zg = acc.Z;
    // s = Z_15 / Z_{j+1} = h[j + 1] ... h[14], built from the top down
    s = h[14];
#pragma unroll 1
    for (int j = 13; j >= 0; --j) {
        bm_fe_sqr(&s2, &s);
        bm_fe_mul(&T[j].x, &T[j].x, &s2);
        bm_fe_mul(&s2, &s2, &s);
        bm_fe_mul(&T[j].y, &T[j].y, &s2);
        if (j) bm_fe_mul(&s, &s, &h[j]);
    }
}

// acc + the walk over the low BM_GLV_NIBBLES nibbles d of k, most
// significant first: four doublings between windows and one uniform
// mixed addition of T[d - 1] a window (a zero nibble adds by select)
BM_SECP_FN void bm_window_walk(bm_jac* acc, const bm_aff* T,
                               const uint32_t* k) {
#pragma unroll 1
    for (int i = BM_GLV_NIBBLES - 1; i >= 0; --i) {
        if (i != BM_GLV_NIBBLES - 1) {
#pragma unroll 1
            for (int d = 0; d < 4; ++d) bm_jac_dbl(acc, acc);
        }
        uint32_t d = bm_nibble(k, i);
        const bm_aff* e = &T[d ? d - 1 : 0];
        bm_jac_madd(acc, acc, &e->x, &e->y, d != 0);
    }
}

// acc + sum over windows i in [lo, hi) of comb[i][nibble i of k]: no
// doublings, one mixed addition a window
BM_SECP_FN void bm_comb_walk(bm_jac* acc, const uint32_t* comb,
                             const uint32_t* k, int lo, int hi) {
#pragma unroll 1
    for (int i = lo; i < hi; ++i) {
        uint32_t d = bm_nibble(k, i);
        const uint32_t* e = comb + (i * 15 + (d ? d - 1 : 0)) * 16;
        bm_fe x, y;
        bm_fe_set(&x, e);
        bm_fe_set(&y, e + 8);
        bm_jac_madd(acc, acc, &x, &y, d != 0);
    }
}

// ---------------------------------------------------------------------------
// the two lane programs, each as two halves and a join
// ---------------------------------------------------------------------------

BM_SECP_INLINE uint32_t bm_is_g(const bm_fe* x, const bm_fe* y) {
    bm_fe gx, gy;
    bm_fe_set(&gx, BM_SECP_C.gx);
    bm_fe_set(&gy, BM_SECP_C.gy);
    return bm_fe_eq(x, &gx) & bm_fe_eq(y, &gy);
}

// What one half of k * P carries from its first stage to its walk
typedef struct {
    uint32_t k[8];      // the comb's scalar (P = G) or |k1| / |k2|
    uint32_t ok;        // P on the curve
    uint32_t is_g;      // P = G: the comb, no table
    uint32_t neg;       // this half's GLV scalar is negative
} bm_mul_state;

// Stage 1 of half `half` of k * P.  P = G: the comb will walk nibbles
// [32 half, 32 half + 32) of k.  Otherwise GLV: each half splits k;
// half 0 takes |k1| and builds the window table of P into T and its Z
// into *zg, which the pair shares; half 1 takes |k2|.  The caller puts a
// barrier between the stages.
BM_SECP_FN void bm_mul_begin(bm_mul_state* st, int half, const uint8_t* kb,
                             const uint8_t* pxb, const uint8_t* pyb,
                             bm_aff* T, bm_fe* zg) {
    uint32_t k[8];
    bm_fe px, py;
    bm_load256(k, kb);
    bm_load256(px.v, pxb);
    bm_load256(py.v, pyb);
    st->ok = bm_on_curve(&px, &py);
    st->is_g = st->ok && bm_is_g(&px, &py);
    st->neg = 0;
    if (!st->ok) return;
    if (st->is_g) {
#pragma unroll
        for (int i = 0; i < 8; ++i) st->k[i] = k[i];
        return;
    }
    uint32_t k1[8], k2[8];
    uint32_t signs = bm_glv_split(k1, k2, k);
    st->neg = (signs >> half) & 1U;
#pragma unroll
    for (int i = 0; i < 8; ++i) st->k[i] = half ? k2[i] : k1[i];
    if (!half) bm_window_table(T, zg, &px, &py);
}

// Stage 2: this half's partial sum in *acc (infinity off the curve).
// The table of P becomes the half's own: +-P for half 0, +-phi(P) =
// (beta x, +-y) for half 1.
BM_SECP_FN void bm_mul_walk(bm_jac* acc, const bm_mul_state* st, int half,
                            const bm_aff* T, const bm_fe* zg,
                            const uint32_t* comb) {
    bm_jac_set_inf(acc);
    if (!st->ok) return;
    if (st->is_g) {
        bm_comb_walk(acc, comb, st->k, half * 32, half * 32 + 32);
        return;
    }
    bm_aff L[15];
    bm_fe beta;
    bm_fe_set(&beta, BM_SECP_C.beta);
#pragma unroll 1
    for (int j = 0; j < 15; ++j) {
        L[j] = T[j];
        if (half) bm_fe_mul(&L[j].x, &L[j].x, &beta);
        if (st->neg) bm_fe_neg(&L[j].y, &L[j].y);
    }
    bm_window_walk(acc, L, st->k);
    bm_fe_mul(&acc->Z, &acc->Z, zg);
}

// joins the halves: canonical affine x, y as 32 big-endian bytes each
// and 1, or zeros and 0 for an off-curve P or an infinity result
BM_SECP_FN uint32_t bm_ecdh_join(const bm_jac* a0, const bm_jac* a1,
                                 uint32_t ok, uint8_t* xb, uint8_t* yb) {
    bm_jac s;
    bm_fe x = {{0, 0, 0, 0, 0, 0, 0, 0}}, y = x;
    bm_jac_add(&s, a0, a1);
    ok &= s.inf ^ 1U;
    if (ok) bm_jac_to_aff(&x, &y, &s);
    bm_store256(xb, x.v);
    bm_store256(yb, y.v);
    return ok;
}

// Stage 2 of half `half` of u1 * G + u2 * Q, after bm_mul_begin on u2
// and Q: the half's share of u2 * Q, then the comb's nibbles
// [32 half, 32 half + 32) of u1 added onto it (infinity off the curve).
// Both halves run the same code.
BM_SECP_FN void bm_verify_walk(bm_jac* acc, const bm_mul_state* st,
                               int half, const bm_aff* T, const bm_fe* zg,
                               const uint8_t* u1b, const uint32_t* comb) {
    uint32_t u1[8];
    bm_mul_walk(acc, st, half, T, zg, comb);
    if (!st->ok) return;
    bm_load256(u1, u1b);
    bm_comb_walk(acc, comb, u1, half * 32, half * 32 + 32);
}

// x(a) mod n == r for a finite Jacobian a, without an inversion: r < n
// and X == r Z^2, or r + n < p and X == (r + n) Z^2 (x < p < 2n)
BM_SECP_FN uint32_t bm_verify_rcheck(const bm_jac* a, const uint32_t* r) {
    // r >= n never equals x mod n: the contract compares r as given
    if (a->inf || bm_ge256(r, BM_SECP_C.n)) return 0;
    bm_fe zz, t, rf, rn;
    bm_fe_sqr(&zz, &a->Z);
    bm_fe_set(&rf, r);
    bm_fe_mul(&t, &rf, &zz);
    if (bm_fe_eq(&t, &a->X)) return 1;
    bm_cc cc = {0};
    rn.v[0] = bm_add_cc(&cc, r[0], BM_SECP_C.n[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) rn.v[i] = bm_addc_cc(&cc, r[i], BM_SECP_C.n[i]);
    uint32_t carry = bm_addc(&cc, 0, 0);
    // r + n < p: no carry out of 2^256 and canonical (r + n + 2^32 + 977
    // does not carry)
    bm_fe rc;
    bm_fe_canon(&rc, &rn);
    uint32_t below_p = (carry == 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) below_p &= rc.v[i] == rn.v[i];
    if (!below_p) return 0;
    bm_fe_mul(&t, &rn, &zz);
    return bm_fe_eq(&t, &a->X);
}

// joins the halves: 1 when (u1 G + u2 Q).x mod n == r, 0 for an
// off-curve Q or an infinity result
BM_SECP_FN uint32_t bm_verify_join(const bm_jac* a0, const bm_jac* a1,
                                   uint32_t ok, const uint8_t* rb) {
    uint32_t r[8];
    bm_jac s;
    bm_load256(r, rb);
    bm_jac_add(&s, a0, a1);
    return ok & bm_verify_rcheck(&s, r);
}

// One lane on one thread, the halves' stages in order (the host's path)
BM_SECP_FN int bm_secp_verify_lane(const uint8_t* u1b, const uint8_t* u2b,
                                   const uint8_t* qxb, const uint8_t* qyb,
                                   const uint8_t* rb, const uint32_t* comb) {
    bm_mul_state s0, s1;
    bm_aff T[15];
    bm_fe zg;
    bm_jac a0, a1;
    bm_mul_begin(&s0, 0, u2b, qxb, qyb, T, &zg);
    bm_mul_begin(&s1, 1, u2b, qxb, qyb, T, &zg);
    bm_verify_walk(&a0, &s0, 0, T, &zg, u1b, comb);
    bm_verify_walk(&a1, &s1, 1, T, &zg, u1b, comb);
    return (int)bm_verify_join(&a0, &a1, s0.ok, rb);
}

BM_SECP_FN int bm_secp_ecdh_lane(const uint8_t* kb, const uint8_t* pxb,
                                 const uint8_t* pyb, uint8_t* xb,
                                 uint8_t* yb, const uint32_t* comb) {
    bm_mul_state s0, s1;
    bm_aff T[15];
    bm_fe zg;
    bm_jac a0, a1;
    bm_mul_begin(&s0, 0, kb, pxb, pyb, T, &zg);
    bm_mul_begin(&s1, 1, kb, pxb, pyb, T, &zg);
    bm_mul_walk(&a0, &s0, 0, T, &zg, comb);
    bm_mul_walk(&a1, &s1, 1, T, &zg, comb);
    return (int)bm_ecdh_join(&a0, &a1, s0.ok, xb, yb);
}

// ---------------------------------------------------------------------------
// self-test of the primitives on 32-byte big-endian operands
// ---------------------------------------------------------------------------

// op 0 mul, 1 sqr (of a), 2 add, 3 sub, 4 fold (of the 512-bit a || b),
// 5 canonical (of a), 6 inverse (of a): the lazy result in out[0..31].
// op 7 GLV split of the scalar a: k1, k2 as two's complement values mod
// 2^256 in out[0..31] and out[32..63].  Operands are taken as given, not
// reduced, so values in [p, 2^256) reach every primitive.
BM_SECP_FN void bm_secp_selftest_one(int op, const uint8_t* ab,
                                     const uint8_t* bb, uint8_t* out) {
    bm_fe a, b, r;
    bm_load256(a.v, ab);
    bm_load256(b.v, bb);
    uint32_t t[16];
    switch (op) {
        case 0: bm_fe_mul(&r, &a, &b); break;
        case 1: bm_fe_sqr(&r, &a); break;
        case 2: bm_fe_add(&r, &a, &b); break;
        case 3: bm_fe_sub(&r, &a, &b); break;
        case 4:
            for (int i = 0; i < 8; ++i) {
                t[i] = b.v[i];
                t[i + 8] = a.v[i];
            }
            bm_fe_reduce16(&r, t);
            break;
        case 5: bm_fe_canon(&r, &a); break;
        case 6: bm_fe_inv(&r, &a); break;
        default: {
            uint32_t k1[8], k2[8], zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            uint32_t signs = bm_glv_split(k1, k2, a.v);
            bm_sub256(t, zero, k1);
            bm_select256(k1, t, k1, 0U - (signs & 1U));
            bm_sub256(t, zero, k2);
            bm_select256(k2, t, k2, 0U - ((signs >> 1) & 1U));
            bm_store256(out + 32, k2);
            bm_fe_set(&r, k1);
        }
    }
    bm_store256(out, r.v);
}
