// secp256k1 field and group arithmetic for one lane, shared by the CUDA
// kernels (secp256k1_kernels.cu) and a host build of the same source (g++,
// used by the CPU tests to check it against Python integers before any
// card time).
//
// Field elements are 4 x 64-bit little-endian limbs, fully reduced (< p)
// after every operation.  A 64 x 64 -> 128-bit product is __umul64hi plus
// a plain multiply on the device and unsigned __int128 on the host.  The
// field and group code follows native/secp256k1/bmsecp256k1.cpp (fe_reduce8,
// fe_mul, jac_double, jac_add, jac_to_aff), copied here so that the device
// and the host compile the same lines.
//
// Scalars are 4 x 64-bit limbs read from 32 big-endian bytes; bit i of a
// scalar (i = 0 is the MSB of the bytes) is what the ladders walk, MSB
// first, as the reference's _scalar_bit does.  A coordinate at or above p
// is reduced once on load (2^256 < 2p), which is what the reference's
// lazy limbs do to it.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BM_SECP_INLINE __host__ __device__ __forceinline__
#define BM_SECP_FN __host__ __device__ inline
#else
#define BM_SECP_INLINE static inline
#define BM_SECP_FN static inline
#endif

typedef struct { uint64_t v[4]; } bm_fe;
typedef struct { bm_fe X, Y, Z; int inf; } bm_jac;

typedef struct {
    uint64_t p[4], n[4], gx[4], gy[4];
} bm_secp_consts;

#define BM_SECP_CONSTS_INIT {                                               \
    {0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL,   \
     0xFFFFFFFFFFFFFFFFULL},                                                \
    {0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL, 0xFFFFFFFFFFFFFFFEULL,   \
     0xFFFFFFFFFFFFFFFFULL},                                                \
    {0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL, 0x55A06295CE870B07ULL,   \
     0x79BE667EF9DCBBACULL},                                                \
    {0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL, 0x5DA4FBFC0E1108A8ULL,   \
     0x483ADA7726A3C465ULL}}

// p, n and G live in __constant__ memory on the card (every lane reads the
// same words: one broadcast per load); the host build reads a plain copy.
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
#define BM_SECP_RC 0x1000003D1ULL

// ---------------------------------------------------------------------------
// 64-bit words with carries
// ---------------------------------------------------------------------------

BM_SECP_INLINE void bm_mul64(uint64_t a, uint64_t b, uint64_t* lo,
                             uint64_t* hi) {
#if defined(__CUDA_ARCH__)
    *lo = a * b;
    *hi = __umul64hi(a, b);
#else
    unsigned __int128 p = (unsigned __int128)a * b;
    *lo = (uint64_t)p;
    *hi = (uint64_t)(p >> 64);
#endif
}

// a + b + cin (cin in {0, 1}); *cout gets the carry out
BM_SECP_INLINE uint64_t bm_adc(uint64_t a, uint64_t b, uint64_t cin,
                               uint64_t* cout) {
    uint64_t s = a + b;
    uint64_t c = s < a;
    uint64_t r = s + cin;
    *cout = c | (r < s);
    return r;
}

// a - b - bin (bin in {0, 1}); *bout gets the borrow out
BM_SECP_INLINE uint64_t bm_sbb(uint64_t a, uint64_t b, uint64_t bin,
                               uint64_t* bout) {
    uint64_t d = a - b;
    uint64_t w = a < b;
    uint64_t r = d - bin;
    *bout = w | (d < bin);
    return r;
}

// ---------------------------------------------------------------------------
// field arithmetic mod p = 2^256 - 2^32 - 977
// ---------------------------------------------------------------------------

BM_SECP_INLINE int bm_ge4(const uint64_t* a, const uint64_t* b) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return 1;
}

BM_SECP_INLINE void bm_sub4(uint64_t* r, const uint64_t* a,
                            const uint64_t* b) {
    uint64_t bw = 0;
    for (int i = 0; i < 4; ++i) r[i] = bm_sbb(a[i], b[i], bw, &bw);
}

// a < 2^256 -> a mod p (one subtraction is enough: 2^256 < 2p)
BM_SECP_INLINE void bm_fe_norm(bm_fe* a) {
    if (bm_ge4(a->v, BM_SECP_C.p)) bm_sub4(a->v, a->v, BM_SECP_C.p);
}

BM_SECP_INLINE int bm_fe_is_zero(const bm_fe* a) {
    return (a->v[0] | a->v[1] | a->v[2] | a->v[3]) == 0;
}

BM_SECP_INLINE int bm_fe_eq(const bm_fe* a, const bm_fe* b) {
    return a->v[0] == b->v[0] && a->v[1] == b->v[1] &&
           a->v[2] == b->v[2] && a->v[3] == b->v[3];
}

// r += RC after a carry out of 2^256 (value + 2^256 == value + RC mod p)
BM_SECP_INLINE void bm_fe_add_rc(bm_fe* r) {
    uint64_t c;
    r->v[0] = bm_adc(r->v[0], BM_SECP_RC, 0, &c);
    r->v[1] = bm_adc(r->v[1], 0, c, &c);
    r->v[2] = bm_adc(r->v[2], 0, c, &c);
    r->v[3] = bm_adc(r->v[3], 0, c, &c);
}

BM_SECP_INLINE void bm_fe_add(bm_fe* r, const bm_fe* a, const bm_fe* b) {
    uint64_t c = 0;
    for (int i = 0; i < 4; ++i) r->v[i] = bm_adc(a->v[i], b->v[i], c, &c);
    if (c) bm_fe_add_rc(r);         // a + b < 2p: no second carry
    bm_fe_norm(r);
}

BM_SECP_INLINE void bm_fe_sub(bm_fe* r, const bm_fe* a, const bm_fe* b) {
    uint64_t bw = 0;
    for (int i = 0; i < 4; ++i) r->v[i] = bm_sbb(a->v[i], b->v[i], bw, &bw);
    if (bw) {                       // r = a - b + 2^256: subtract RC, = + p
        r->v[0] = bm_sbb(r->v[0], BM_SECP_RC, 0, &bw);
        r->v[1] = bm_sbb(r->v[1], 0, bw, &bw);
        r->v[2] = bm_sbb(r->v[2], 0, bw, &bw);
        r->v[3] = bm_sbb(r->v[3], 0, bw, &bw);
    }
}

// 512-bit t -> t mod p: fold the high half through 2^256 == RC
BM_SECP_INLINE void bm_fe_reduce8(bm_fe* r, const uint64_t* t) {
    uint64_t lo[4], carry = 0, c, ml, mh;
    for (int i = 0; i < 4; ++i) {
        bm_mul64(t[4 + i], BM_SECP_RC, &ml, &mh);
        ml = bm_adc(ml, t[i], 0, &c);
        mh += c;
        ml = bm_adc(ml, carry, 0, &c);
        lo[i] = ml;
        carry = mh + c;
    }
    // carry < 2^34: fold it once more
    bm_mul64(carry, BM_SECP_RC, &ml, &mh);
    r->v[0] = bm_adc(lo[0], ml, 0, &c);
    r->v[1] = bm_adc(lo[1], mh, c, &c);
    r->v[2] = bm_adc(lo[2], 0, c, &c);
    r->v[3] = bm_adc(lo[3], 0, c, &c);
    if (c) bm_fe_add_rc(r);         // at most once more
    bm_fe_norm(r);
}

BM_SECP_INLINE void bm_fe_mul(bm_fe* r, const bm_fe* a, const bm_fe* b) {
    uint64_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint64_t carry = 0, c, lo, hi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            bm_mul64(a->v[i], b->v[j], &lo, &hi);
            lo = bm_adc(lo, t[i + j], 0, &c);
            hi += c;
            lo = bm_adc(lo, carry, 0, &c);
            t[i + j] = lo;
            carry = hi + c;
        }
        t[i + 4] = carry;
    }
    bm_fe_reduce8(r, t);
}

BM_SECP_INLINE void bm_fe_sqr(bm_fe* r, const bm_fe* a) { bm_fe_mul(r, a, a); }

BM_SECP_FN void bm_fe_sqr_n(bm_fe* r, const bm_fe* a, int n) {
    *r = *a;
#pragma unroll 1
    for (int i = 0; i < n; ++i) bm_fe_sqr(r, r);
}

// a^(p-2) by the standard secp256k1 addition chain (258 squarings and
// 14 multiplies, the reference's unrolled f_inv); 0 -> 0
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

// 32 big-endian bytes -> 4 little-endian limbs (no reduction)
BM_SECP_INLINE void bm_load256(uint64_t* v, const uint8_t* b) {
    for (int i = 0; i < 4; ++i) {
        uint64_t w = 0;
        for (int j = 0; j < 8; ++j) w = (w << 8) | b[(3 - i) * 8 + j];
        v[i] = w;
    }
}

BM_SECP_INLINE void bm_store256(uint8_t* b, const uint64_t* v) {
    for (int i = 0; i < 4; ++i) {
        uint64_t w = v[3 - i];
        for (int j = 7; j >= 0; --j) {
            b[i * 8 + j] = (uint8_t)w;
            w >>= 8;
        }
    }
}

// a coordinate: 32 big-endian bytes -> field element (reduced once)
BM_SECP_INLINE void bm_fe_load(bm_fe* r, const uint8_t* b) {
    bm_load256(r->v, b);
    bm_fe_norm(r);
}

// bit i (0 = MSB of the big-endian bytes) of a scalar held as LE limbs
BM_SECP_INLINE int bm_scalar_bit(const uint64_t* k, int i) {
    return (int)((k[3 - (i >> 6)] >> (63 - (i & 63))) & 1);
}

// ---------------------------------------------------------------------------
// group operations (Jacobian coordinates, a = 0, b = 7)
// ---------------------------------------------------------------------------

BM_SECP_FN int bm_on_curve(const bm_fe* x, const bm_fe* y) {
    bm_fe y2, x3, t, seven = {{7, 0, 0, 0}};
    bm_fe_sqr(&y2, y);
    bm_fe_sqr(&t, x);
    bm_fe_mul(&x3, &t, x);
    bm_fe_add(&x3, &x3, &seven);
    return bm_fe_eq(&y2, &x3);
}

BM_SECP_INLINE void bm_jac_set_inf(bm_jac* r) {
    for (int i = 0; i < 4; ++i) r->X.v[i] = r->Y.v[i] = r->Z.v[i] = 0;
    r->inf = 1;
}

BM_SECP_INLINE void bm_jac_from_aff(bm_jac* r, const bm_fe* x,
                                    const bm_fe* y) {
    bm_fe one = {{1, 0, 0, 0}};
    r->X = *x;
    r->Y = *y;
    r->Z = one;
    r->inf = 0;
}

BM_SECP_FN void bm_jac_double(bm_jac* r, const bm_jac* a) {
    if (a->inf || bm_fe_is_zero(&a->Y)) {
        bm_jac_set_inf(r);
        return;
    }
    bm_fe ysq, s, m, t, x3, y3, z3;
    bm_fe_sqr(&ysq, &a->Y);                 // Y^2
    bm_fe_mul(&s, &a->X, &ysq);
    bm_fe_add(&s, &s, &s);
    bm_fe_add(&s, &s, &s);                  // S = 4*X*Y^2
    bm_fe_sqr(&m, &a->X);
    bm_fe_add(&t, &m, &m);
    bm_fe_add(&m, &t, &m);                  // M = 3*X^2
    bm_fe_sqr(&x3, &m);
    bm_fe_sub(&x3, &x3, &s);
    bm_fe_sub(&x3, &x3, &s);                // X' = M^2 - 2S
    bm_fe_sqr(&t, &ysq);                    // Y^4
    bm_fe_add(&t, &t, &t);
    bm_fe_add(&t, &t, &t);
    bm_fe_add(&t, &t, &t);                  // 8*Y^4
    bm_fe_sub(&y3, &s, &x3);
    bm_fe_mul(&y3, &y3, &m);
    bm_fe_sub(&y3, &y3, &t);                // Y' = M*(S-X') - 8*Y^4
    bm_fe_mul(&z3, &a->Y, &a->Z);
    bm_fe_add(&z3, &z3, &z3);               // Z' = 2*Y*Z
    r->X = x3;
    r->Y = y3;
    r->Z = z3;
    r->inf = 0;
}

// Complete addition: an operand at infinity passes the other through,
// equal operands double (h = 0, r = 0), inverse operands give infinity
// (h = 0, r != 0) -- the three cases the reference's jac_add selects.
BM_SECP_FN void bm_jac_add(bm_jac* r, const bm_jac* a, const bm_jac* b) {
    if (a->inf) { *r = *b; return; }
    if (b->inf) { *r = *a; return; }
    bm_fe z1z1, z2z2, u1, u2, s1, s2, h, rr, hh, hhh, u1hh, t;
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
    if (bm_fe_is_zero(&h)) {
        if (bm_fe_is_zero(&rr)) {
            bm_jac_double(r, a);
            return;
        }
        bm_jac_set_inf(r);
        return;
    }
    bm_fe_sqr(&hh, &h);
    bm_fe_mul(&hhh, &hh, &h);
    bm_fe_mul(&u1hh, &u1, &hh);
    bm_fe x3, y3, z3;
    bm_fe_sqr(&x3, &rr);
    bm_fe_sub(&x3, &x3, &hhh);
    bm_fe_sub(&x3, &x3, &u1hh);
    bm_fe_sub(&x3, &x3, &u1hh);             // X3 = r^2 - h^3 - 2*u1*h^2
    bm_fe_sub(&t, &u1hh, &x3);
    bm_fe_mul(&y3, &rr, &t);
    bm_fe_mul(&t, &s1, &hhh);
    bm_fe_sub(&y3, &y3, &t);                // Y3 = r*(u1*h^2 - X3) - s1*h^3
    bm_fe_mul(&z3, &a->Z, &b->Z);
    bm_fe_mul(&z3, &z3, &h);
    r->X = x3;
    r->Y = y3;
    r->Z = z3;
    r->inf = 0;
}

// affine (x, y) of a finite point (the caller checks inf first)
BM_SECP_FN void bm_jac_to_aff(bm_fe* x, bm_fe* y, const bm_jac* a) {
    bm_fe zi, zi2;
    bm_fe_inv(&zi, &a->Z);
    bm_fe_sqr(&zi2, &zi);
    bm_fe_mul(x, &a->X, &zi2);
    bm_fe_mul(y, &a->Y, &zi2);
    bm_fe_mul(y, y, &zi);
}

// ---------------------------------------------------------------------------
// the two lane programs
// ---------------------------------------------------------------------------

// ECDSA acceptance of one lane: (u1*G + u2*Q).x mod n == r.  0 for an
// off-curve Q or an infinity result.  Strauss-Shamir: one doubling chain,
// per bit an addend from {inf, G, Q, G+Q}; G+Q is made affine once.
BM_SECP_FN int bm_secp_verify_lane(const uint8_t* u1b, const uint8_t* u2b,
                                   const uint8_t* qxb, const uint8_t* qyb,
                                   const uint8_t* rb) {
    uint64_t u1[4], u2[4], r[4];
    bm_fe qx, qy, gx, gy;
    bm_load256(u1, u1b);
    bm_load256(u2, u2b);
    bm_load256(r, rb);
    bm_fe_load(&qx, qxb);
    bm_fe_load(&qy, qyb);
    if (!bm_on_curve(&qx, &qy)) return 0;
    for (int i = 0; i < 4; ++i) {
        gx.v[i] = BM_SECP_C.gx[i];
        gy.v[i] = BM_SECP_C.gy[i];
    }
    bm_jac g, q, gq, acc, sum;
    bm_jac_from_aff(&g, &gx, &gy);
    bm_jac_from_aff(&q, &qx, &qy);
    bm_jac_add(&sum, &g, &q);
    if (sum.inf) {
        gq = sum;                           // Q = -G
    } else {
        bm_fe sx, sy;
        bm_jac_to_aff(&sx, &sy, &sum);
        bm_jac_from_aff(&gq, &sx, &sy);
    }
    bm_jac_set_inf(&acc);
#pragma unroll 1
    for (int i = 0; i < 256; ++i) {
        bm_jac_double(&acc, &acc);
        int sel = bm_scalar_bit(u1, i) | (bm_scalar_bit(u2, i) << 1);
        if (sel) {
            const bm_jac* add = sel == 1 ? &g : sel == 2 ? &q : &gq;
            bm_jac_add(&acc, &acc, add);
        }
    }
    if (acc.inf) return 0;
    bm_fe x, y;
    bm_jac_to_aff(&x, &y, &acc);
    // x < p < 2n: one conditional subtraction reduces it mod n
    if (bm_ge4(x.v, BM_SECP_C.n)) bm_sub4(x.v, x.v, BM_SECP_C.n);
    return x.v[0] == r[0] && x.v[1] == r[1] && x.v[2] == r[2] &&
           x.v[3] == r[3];
}

// k*P of one lane by double-and-add: canonical affine x and y as 32
// big-endian bytes each, and 1; zeros and 0 for an off-curve P or an
// infinity result.
BM_SECP_FN int bm_secp_ecdh_lane(const uint8_t* kb, const uint8_t* pxb,
                                 const uint8_t* pyb, uint8_t* xb,
                                 uint8_t* yb) {
    uint64_t k[4];
    bm_fe px, py, x, y;
    bm_load256(k, kb);
    bm_fe_load(&px, pxb);
    bm_fe_load(&py, pyb);
    int ok = bm_on_curve(&px, &py);
    bm_jac p, acc;
    bm_jac_set_inf(&acc);
    if (ok) {
        bm_jac_from_aff(&p, &px, &py);
#pragma unroll 1
        for (int i = 0; i < 256; ++i) {
            bm_jac_double(&acc, &acc);
            if (bm_scalar_bit(k, i)) bm_jac_add(&acc, &acc, &p);
        }
        ok = !acc.inf;
    }
    if (ok) {
        bm_jac_to_aff(&x, &y, &acc);
    } else {
        for (int i = 0; i < 4; ++i) x.v[i] = y.v[i] = 0;
    }
    bm_store256(xb, x.v);
    bm_store256(yb, y.v);
    return ok;
}
