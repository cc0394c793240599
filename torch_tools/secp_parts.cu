// The secp256k1 kernels' design part by part, for the timing bench
// torch_tools/secp_parts_bench.py: each variant adds one part of the
// design of pybitmessage_tpu_torch/csrc/secp256k1_kernels.cu to the one
// before, over the same header (csrc/secp256k1.cuh), one thread per lane
// in 32-thread blocks:
//
//   1  the field core (8 x 32-bit PTX carry chains, a dedicated
//      squaring) under the first port's algorithm: a double-and-add
//      ladder a bit at a time, a Jacobian doubling of 3 M + 4 S and a
//      complete Jacobian addition that branches per lane on the bit and
//      returns early on its exceptional cases (Strauss-Shamir over
//      {G, Q, G + Q} for verify);
//   2  + uniform steps: every bit a doubling for a = 0 and a mixed
//      addition with selects, whatever the bit;
//   3  + the fixed-base comb: u1 * G, and k * G for ECDH with P = G,
//      one mixed addition per nibble;
//   4  + 4-bit windows for the variable base over all 64 nibbles;
//   5  is the shipped kernels (+ GLV, two threads a lane).
//
// The variants are a yardstick for the bench only: no path of the port
// launches them.  Like the header, the file also builds with a host C++
// compiler (nvcc's kernels and launchers left out): bm_part_verify_host
// and bm_part_ecdh_host run a variant's lanes one after another, which
// tests/test_torch_secp.py holds against Python integers.
#include <stddef.h>
#include <stdint.h>
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

#include "secp256k1.cuh"

// -- part 1: the first port's group steps on the new field core ----------

BM_SECP_FN void p1_double(bm_jac* r, const bm_jac* a) {
    if (a->inf || bm_fe_is_zero(&a->Y)) {
        bm_jac_set_inf(r);
        return;
    }
    bm_fe ysq, s, m, t, x3, y3, z3;
    bm_fe_sqr(&ysq, &a->Y);
    bm_fe_mul(&s, &a->X, &ysq);
    bm_fe_add(&s, &s, &s);
    bm_fe_add(&s, &s, &s);
    bm_fe_sqr(&m, &a->X);
    bm_fe_add(&t, &m, &m);
    bm_fe_add(&m, &t, &m);
    bm_fe_sqr(&x3, &m);
    bm_fe_sub(&x3, &x3, &s);
    bm_fe_sub(&x3, &x3, &s);
    bm_fe_sqr(&t, &ysq);
    bm_fe_add(&t, &t, &t);
    bm_fe_add(&t, &t, &t);
    bm_fe_add(&t, &t, &t);
    bm_fe_sub(&y3, &s, &x3);
    bm_fe_mul(&y3, &y3, &m);
    bm_fe_sub(&y3, &y3, &t);
    bm_fe_mul(&z3, &a->Y, &a->Z);
    bm_fe_add(&z3, &z3, &z3);
    r->X = x3;
    r->Y = y3;
    r->Z = z3;
    r->inf = 0;
}

BM_SECP_FN void p1_add(bm_jac* r, const bm_jac* a, const bm_jac* b) {
    if (a->inf) { *r = *b; return; }
    if (b->inf) { *r = *a; return; }
    bm_fe z1z1, z2z2, u1, u2, s1, s2, h, rr, hh, hhh, u1hh, t, x3, y3, z3;
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
            p1_double(r, a);
            return;
        }
        bm_jac_set_inf(r);
        return;
    }
    bm_fe_sqr(&hh, &h);
    bm_fe_mul(&hhh, &hh, &h);
    bm_fe_mul(&u1hh, &u1, &hh);
    bm_fe_sqr(&x3, &rr);
    bm_fe_sub(&x3, &x3, &hhh);
    bm_fe_sub(&x3, &x3, &u1hh);
    bm_fe_sub(&x3, &x3, &u1hh);
    bm_fe_sub(&t, &u1hh, &x3);
    bm_fe_mul(&y3, &rr, &t);
    bm_fe_mul(&t, &s1, &hhh);
    bm_fe_sub(&y3, &y3, &t);
    bm_fe_mul(&z3, &a->Z, &b->Z);
    bm_fe_mul(&z3, &z3, &h);
    r->X = x3;
    r->Y = y3;
    r->Z = z3;
    r->inf = 0;
}

// bit i (0 = most significant) of a 256-bit scalar
BM_SECP_FN uint32_t bit_msb(const uint32_t* k, int i) {
    return (k[7 - (i >> 5)] >> (31 - (i & 31))) & 1U;
}

// x mod n == r for a finite point (affine x, the first port's check)
BM_SECP_FN uint32_t affine_rcheck(const bm_jac* acc, const uint32_t* r) {
    if (acc->inf) return 0;
    bm_fe x, y;
    bm_jac_to_aff(&x, &y, acc);
    uint32_t xn[8];
    bm_sub256(xn, x.v, BM_SECP_C.n);
    bm_select256(x.v, xn, x.v, 0U - bm_ge256(x.v, BM_SECP_C.n));
    uint32_t eq = 1;
    for (int i = 0; i < 8; ++i) eq &= x.v[i] == r[i];
    return eq;
}

// G + Q, affine (its inf flag set when Q = -G)
BM_SECP_FN void g_plus_q(bm_jac* gq, const bm_fe* qx, const bm_fe* qy) {
    bm_fe gx, gy;
    bm_fe_set(&gx, BM_SECP_C.gx);
    bm_fe_set(&gy, BM_SECP_C.gy);
    bm_jac g, q, s;
    bm_jac_from_aff(&g, &gx, &gy);
    bm_jac_from_aff(&q, qx, qy);
    bm_jac_add(&s, &g, &q);
    if (s.inf) {
        *gq = s;
        return;
    }
    bm_fe sx, sy;
    bm_jac_to_aff(&sx, &sy, &s);
    bm_jac_from_aff(gq, &sx, &sy);
}

struct lane_in {
    uint32_t u1[8], u2[8], r[8];
    bm_fe qx, qy;
};

BM_SECP_FN void load_verify(lane_in* in, int i, const uint8_t* u1,
                            const uint8_t* u2, const uint8_t* qx,
                            const uint8_t* qy, const uint8_t* r) {
    const size_t o = (size_t)i * 32;
    bm_load256(in->u1, u1 + o);
    bm_load256(in->u2, u2 + o);
    bm_load256(in->r, r + o);
    bm_load256(in->qx.v, qx + o);
    bm_load256(in->qy.v, qy + o);
}

// -- verify, parts 1-4 ---------------------------------------------------

BM_SECP_FN uint32_t verify_p1(const lane_in* in) {
    bm_fe gx, gy;
    bm_fe_set(&gx, BM_SECP_C.gx);
    bm_fe_set(&gy, BM_SECP_C.gy);
    bm_jac g, q, gq, acc;
    bm_jac_from_aff(&g, &gx, &gy);
    bm_jac_from_aff(&q, &in->qx, &in->qy);
    g_plus_q(&gq, &in->qx, &in->qy);
    bm_jac_set_inf(&acc);
#pragma unroll 1
    for (int i = 0; i < 256; ++i) {
        p1_double(&acc, &acc);
        int sel = bit_msb(in->u1, i) | (bit_msb(in->u2, i) << 1);
        if (sel) p1_add(&acc, &acc, sel == 1 ? &g : sel == 2 ? &q : &gq);
    }
    return affine_rcheck(&acc, in->r);
}

BM_SECP_FN uint32_t verify_p2(const lane_in* in) {
    bm_fe gx, gy;
    bm_fe_set(&gx, BM_SECP_C.gx);
    bm_fe_set(&gy, BM_SECP_C.gy);
    bm_jac gq, acc;
    g_plus_q(&gq, &in->qx, &in->qy);
    bm_jac_set_inf(&acc);
#pragma unroll 1
    for (int i = 0; i < 256; ++i) {
        bm_jac_dbl(&acc, &acc);
        uint32_t b1 = bit_msb(in->u1, i), b2 = bit_msb(in->u2, i);
        bm_fe ax, ay;
        bm_fe_select(&ax, &gx, &in->qx, b1 & (b2 ^ 1U));
        bm_fe_select(&ay, &gy, &in->qy, b1 & (b2 ^ 1U));
        bm_fe_select(&ax, &gq.X, &ax, b1 & b2);
        bm_fe_select(&ay, &gq.Y, &ay, b1 & b2);
        bm_jac_madd(&acc, &acc, &ax, &ay,
                    (b1 | b2) & ((b1 & b2 & gq.inf) ^ 1U));
    }
    return affine_rcheck(&acc, in->r);
}

BM_SECP_FN uint32_t verify_p3(const lane_in* in, const uint32_t* comb) {
    bm_jac acc;
    bm_jac_set_inf(&acc);
#pragma unroll 1
    for (int i = 0; i < 256; ++i) {
        bm_jac_dbl(&acc, &acc);
        bm_jac_madd(&acc, &acc, &in->qx, &in->qy, bit_msb(in->u2, i));
    }
    bm_comb_walk(&acc, comb, in->u1, 0, BM_COMB_WINDOWS);
    return affine_rcheck(&acc, in->r);
}

// the 64-nibble walk over T, a global-Z table with Z = *zg
BM_SECP_FN void walk64(bm_jac* acc, const bm_aff* T, const bm_fe* zg,
                       const uint32_t* k) {
#pragma unroll 1
    for (int i = 63; i >= 0; --i) {
        if (i != 63) {
#pragma unroll 1
            for (int d = 0; d < 4; ++d) bm_jac_dbl(acc, acc);
        }
        uint32_t d = bm_nibble(k, i);
        const bm_aff* e = &T[d ? d - 1 : 0];
        bm_jac_madd(acc, acc, &e->x, &e->y, d != 0);
    }
    bm_fe_mul(&acc->Z, &acc->Z, zg);
}

BM_SECP_FN uint32_t verify_p4(const lane_in* in, const uint32_t* comb) {
    bm_jac acc;
    bm_aff T[15];
    bm_fe zg;
    bm_jac_set_inf(&acc);
    bm_window_table(T, &zg, &in->qx, &in->qy);
    walk64(&acc, T, &zg, in->u2);
    bm_comb_walk(&acc, comb, in->u1, 0, BM_COMB_WINDOWS);
    return affine_rcheck(&acc, in->r);
}

// lane i of a verify variant: ok for (u1 * G + u2 * Q).x mod n == r
template <int part>
BM_SECP_FN uint32_t part_verify_lane(const uint8_t* u1, const uint8_t* u2,
                                     const uint8_t* qx, const uint8_t* qy,
                                     const uint8_t* r, const uint32_t* comb,
                                     int i) {
    lane_in in;
    load_verify(&in, i, u1, u2, qx, qy, r);
    uint32_t good = bm_on_curve(&in.qx, &in.qy);
    if (good) {
        if (part == 1) good = verify_p1(&in);
        if (part == 2) good = verify_p2(&in);
        if (part == 3) good = verify_p3(&in, comb);
        if (part == 4) good = verify_p4(&in, comb);
    }
    return good;
}

// -- ECDH, parts 1-4 -----------------------------------------------------

// lane i of an ECDH variant: k * P into x, y (zeros off the curve or at
// infinity) and ok
template <int part>
BM_SECP_FN uint32_t part_ecdh_lane(const uint8_t* kb, const uint8_t* pxb,
                                   const uint8_t* pyb, const uint32_t* comb,
                                   uint8_t* xb, uint8_t* yb, int i) {
    const size_t o = (size_t)i * 32;
    uint32_t k[8];
    bm_fe px, py, x = {{0, 0, 0, 0, 0, 0, 0, 0}}, y = x;
    bm_load256(k, kb + o);
    bm_load256(px.v, pxb + o);
    bm_load256(py.v, pyb + o);
    uint32_t good = bm_on_curve(&px, &py);
    bm_jac acc;
    bm_jac_set_inf(&acc);
    if (good) {
        if (part >= 3 && bm_is_g(&px, &py)) {
            bm_comb_walk(&acc, comb, k, 0, BM_COMB_WINDOWS);
        } else if (part == 1) {
            bm_jac p;
            bm_jac_from_aff(&p, &px, &py);
#pragma unroll 1
            for (int b = 0; b < 256; ++b) {
                p1_double(&acc, &acc);
                if (bit_msb(k, b)) p1_add(&acc, &acc, &p);
            }
        } else if (part <= 3) {
#pragma unroll 1
            for (int b = 0; b < 256; ++b) {
                bm_jac_dbl(&acc, &acc);
                bm_jac_madd(&acc, &acc, &px, &py, bit_msb(k, b));
            }
        } else {
            bm_aff T[15];
            bm_fe zg;
            bm_window_table(T, &zg, &px, &py);
            walk64(&acc, T, &zg, k);
        }
        good = acc.inf ^ 1U;
    }
    if (good) bm_jac_to_aff(&x, &y, &acc);
    bm_store256(xb + o, x.v);
    bm_store256(yb + o, y.v);
    return good;
}

#if defined(__CUDACC__)

template <int part>
__global__ void __launch_bounds__(32)
verify_part_kernel(const uint8_t* __restrict__ u1,
                   const uint8_t* __restrict__ u2,
                   const uint8_t* __restrict__ qx,
                   const uint8_t* __restrict__ qy,
                   const uint8_t* __restrict__ r,
                   const uint32_t* __restrict__ comb,
                   uint8_t* __restrict__ ok, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ok[i] = (uint8_t)part_verify_lane<part>(u1, u2, qx, qy, r, comb, i);
}

template <int part>
__global__ void __launch_bounds__(32)
ecdh_part_kernel(const uint8_t* __restrict__ kb,
                 const uint8_t* __restrict__ pxb,
                 const uint8_t* __restrict__ pyb,
                 const uint32_t* __restrict__ comb,
                 uint8_t* __restrict__ xb, uint8_t* __restrict__ yb,
                 uint8_t* __restrict__ ok, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ok[i] = (uint8_t)part_ecdh_lane<part>(kb, pxb, pyb, comb, xb, yb, i);
}

typedef void (*verify_fn)(const uint8_t*, const uint8_t*, const uint8_t*,
                          const uint8_t*, const uint8_t*, const uint32_t*,
                          uint8_t*, int);
typedef void (*ecdh_fn)(const uint8_t*, const uint8_t*, const uint8_t*,
                        const uint32_t*, uint8_t*, uint8_t*, uint8_t*, int);
static const verify_fn kVerify[4] = {verify_part_kernel<1>,
                                     verify_part_kernel<2>,
                                     verify_part_kernel<3>,
                                     verify_part_kernel<4>};
static const ecdh_fn kEcdh[4] = {ecdh_part_kernel<1>, ecdh_part_kernel<2>,
                                 ecdh_part_kernel<3>, ecdh_part_kernel<4>};

// Launchers (part 1..4): device pointers, the lane count and the stream;
// each returns cudaGetLastError() (0 = launched).
extern "C" int bm_part_verify(int part, const void* u1, const void* u2,
                              const void* qx, const void* qy, const void* r,
                              const void* comb, void* ok, int n,
                              void* stream) {
    if (n <= 0 || part < 1 || part > 4) return n <= 0 ? 0 : -1;
    kVerify[part - 1]<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)u1, (const uint8_t*)u2, (const uint8_t*)qx,
        (const uint8_t*)qy, (const uint8_t*)r, (const uint32_t*)comb,
        (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}

extern "C" int bm_part_ecdh(int part, const void* k, const void* px,
                            const void* py, const void* comb, void* x,
                            void* y, void* ok, int n, void* stream) {
    if (n <= 0 || part < 1 || part > 4) return n <= 0 ? 0 : -1;
    kEcdh[part - 1]<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)k, (const uint8_t*)px, (const uint8_t*)py,
        (const uint32_t*)comb, (uint8_t*)x, (uint8_t*)y, (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}

#else  // the host build: a variant's lanes one after another

extern "C" int bm_part_verify_host(int part, const uint8_t* u1,
                                   const uint8_t* u2, const uint8_t* qx,
                                   const uint8_t* qy, const uint8_t* r,
                                   const uint32_t* comb, uint8_t* ok,
                                   int n) {
    if (part < 1 || part > 4) return -1;
    for (int i = 0; i < n; ++i)
        ok[i] = (uint8_t)(
            part == 1 ? part_verify_lane<1>(u1, u2, qx, qy, r, comb, i)
            : part == 2 ? part_verify_lane<2>(u1, u2, qx, qy, r, comb, i)
            : part == 3 ? part_verify_lane<3>(u1, u2, qx, qy, r, comb, i)
                        : part_verify_lane<4>(u1, u2, qx, qy, r, comb, i));
    return 0;
}

extern "C" int bm_part_ecdh_host(int part, const uint8_t* k,
                                 const uint8_t* px, const uint8_t* py,
                                 const uint32_t* comb, uint8_t* x,
                                 uint8_t* y, uint8_t* ok, int n) {
    if (part < 1 || part > 4) return -1;
    for (int i = 0; i < n; ++i)
        ok[i] = (uint8_t)(
            part == 1 ? part_ecdh_lane<1>(k, px, py, comb, x, y, i)
            : part == 2 ? part_ecdh_lane<2>(k, px, py, comb, x, y, i)
            : part == 3 ? part_ecdh_lane<3>(k, px, py, comb, x, y, i)
                        : part_ecdh_lane<4>(k, px, py, comb, x, y, i));
    return 0;
}

#endif
