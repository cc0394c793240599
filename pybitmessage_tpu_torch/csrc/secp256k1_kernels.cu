// The two secp256k1 kernels of the receive path, for sm_90a.
//
// Each replaces one Pallas kernel of pybitmessage_tpu/ops/secp256k1_pallas.py
// and keeps its output contract, not its geometry:
//
//   bm_secp_verify_kernel  <- _verify_kernel (pallas_verify; verify_core)
//   bm_secp_ecdh_kernel    <- _ecdh_kernel   (pallas_ecdh; ecdh_core)
//
// Contract.  Lane i reads 32-byte big-endian values at offset 32*i of each
// input.  verify: ok[i] = 1 when (u1*G + u2*Q).x mod n == r, 0 for an
// off-curve Q or an infinity result (the scalars arrive reduced mod n from
// the host's batch inversion; r is compared as given).  ecdh: x[i], y[i] are
// the canonical affine coordinates of k*P and ok[i] = 1, or zeros and 0 for
// an off-curve P or an infinity result; with P = G it is the fixed-base
// multiply.  Scalars are taken over all 256 bits.
//
// What bounds them.  The work is a chain of 256-bit modular
// multiplications and squarings, 144 and 88 32-bit IMAD issue slots each
// (64 or 36 distinct partial products and 8 for the fold by 977, low and
// high halves), over 161 bytes of input and output a lane: 32-bit integer
// multiply issue, not memory, bounds them.  chip_smoke.py counts the
// least work its lanes' data needs (secp_field_ops: one GLV walk whose
// halves share each window's doublings, u1 * G's 64 comb additions, the
// table, the split, the conversion or the r check), takes that count's
// time as the bound, and measures the times (PERF.md, section 6).  This
// design's two threads each double their own sum, ~124 doublings a lane
// more, and join the halves: ~1.3-1.4x the least work, printed beside
// it.
//
// What the design does about it (secp256k1.cuh has the arithmetic):
//   - carries are PTX carry chains on 8 x 32-bit limbs, not compares and
//     selects, and a squaring has its own 36-product core;
//   - the group steps are uniform: a doubling for a = 0 (2 M + 5 S) and a
//     mixed addition (8 M + 3 S) whose exceptional cases are selects, so a
//     warp runs one path whatever its lanes' scalar bits;
//   - G goes through a fixed-base comb (comb[i][j] = j * 16^i * G, built
//     once per device by the wrapper and passed as a pointer): u1 * G and
//     ECDH with P = G take one mixed addition per nibble and no doubling;
//   - a variable base goes through a per-lane table of 1..15 * P that
//     shares one Z (libsecp256k1's global-Z table, no inversion), walked
//     on the isomorphic curve where those points are affine: one mixed
//     addition per 4 bits, not one per set bit;
//   - GLV, k = k1 + k2 * lambda with |k1|, |k2| < 2^128, halves the
//     doublings.  A lane is two threads, each walking 128 bits, over one
//     window table in shared memory (30 KB a block): both threads split
//     the scalar and keep their own half, thread 0 then builds the
//     table, and both read it after a barrier.  Verify walks u2 * Q so, and each thread then adds half of
//     u1 * G's comb nibbles onto its share.  A block is two warps over
//     the same 32 lanes, warp 0 taking the halves 0 and warp 1 the halves
//     1: both run the same code (warps running different code were
//     measured slower: a lone warp waits on its instruction fetches too).
//     Warp 1 hands its sums over in shared memory and warp 0 joins them
//     with one complete addition.  A 4,096-lane drain is 8,192 threads,
//     two warps on each of 128 SMs;
//   - verify tests x mod n == r projectively (X == r Z^2 or (r + n) Z^2),
//     without an inversion.
// A thread's copy of the table (15 points, 960 bytes, indexed by data)
// lives in local memory, which L1 holds at this occupancy.
#include <cuda_runtime.h>
#include <stdint.h>

#include "secp256k1.cuh"

//: threads per block: warp 0 takes half 0 and warp 1 half 1 of 32 lanes
static constexpr int kSecpThreads = 64;
static constexpr int kSecpLanes = 32;

__global__ void __launch_bounds__(kSecpThreads)
bm_secp_verify_kernel(const uint8_t* __restrict__ u1,
                      const uint8_t* __restrict__ u2,
                      const uint8_t* __restrict__ qx,
                      const uint8_t* __restrict__ qy,
                      const uint8_t* __restrict__ r,
                      const uint32_t* __restrict__ comb,
                      uint8_t* __restrict__ ok, int n) {
    __shared__ bm_aff table[kSecpLanes][15];
    __shared__ bm_fe zg[kSecpLanes];
    __shared__ bm_jac part[kSecpLanes];
    const int j = threadIdx.x % kSecpLanes, half = threadIdx.x / kSecpLanes;
    const int i = blockIdx.x * kSecpLanes + j;
    const size_t o = (size_t)i * 32;
    bm_mul_state st;
    bm_jac acc;
    st.ok = st.is_g = 0;
    if (i < n)
        bm_mul_begin(&st, half, u2 + o, qx + o, qy + o, table[j], &zg[j]);
    __syncthreads();
    bm_verify_walk(&acc, &st, half, table[j], &zg[j], u1 + o, comb);
    if (half) part[j] = acc;
    __syncthreads();
    if (i < n && !half)
        ok[i] = (uint8_t)bm_verify_join(&acc, &part[j], st.ok, r + o);
}

__global__ void __launch_bounds__(kSecpThreads)
bm_secp_ecdh_kernel(const uint8_t* __restrict__ k,
                    const uint8_t* __restrict__ px,
                    const uint8_t* __restrict__ py,
                    const uint32_t* __restrict__ comb,
                    uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    uint8_t* __restrict__ ok, int n) {
    __shared__ bm_aff table[kSecpLanes][15];
    __shared__ bm_fe zg[kSecpLanes];
    __shared__ bm_jac part[kSecpLanes];
    const int j = threadIdx.x % kSecpLanes, half = threadIdx.x / kSecpLanes;
    const int i = blockIdx.x * kSecpLanes + j;
    const size_t o = (size_t)i * 32;
    bm_mul_state st;
    bm_jac acc;
    st.ok = st.is_g = 0;
    if (i < n)
        bm_mul_begin(&st, half, k + o, px + o, py + o, table[j], &zg[j]);
    __syncthreads();
    bm_mul_walk(&acc, &st, half, table[j], &zg[j], comb);
    if (half) part[j] = acc;
    __syncthreads();
    if (i < n && !half)
        ok[i] = (uint8_t)bm_ecdh_join(&acc, &part[j], st.ok, x + o, y + o);
}

// The primitives on the card, one operand pair a thread (the PTX carry
// chains are the one thing a host build of the header cannot check)
__global__ void bm_secp_selftest_kernel(int op, const uint8_t* __restrict__ a,
                                        const uint8_t* __restrict__ b,
                                        uint8_t* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bm_secp_selftest_one(op, a + (size_t)i * 32, b + (size_t)i * 32,
                         out + (size_t)i * 64);
}

// Launchers: device pointers, the lane count and the stream; each returns
// cudaGetLastError() (0 = launched).  None synchronises.  comb is the
// 64 x 15 x 16-word fixed-base table (secp256k1_cuda.comb_words).

static int bm_secp_blocks(int n) {
    return (n + kSecpLanes - 1) / kSecpLanes;
}

extern "C" int bm_secp_verify(const void* u1, const void* u2, const void* qx,
                              const void* qy, const void* r, const void* comb,
                              void* ok, int n, void* stream) {
    if (n <= 0) return 0;
    bm_secp_verify_kernel<<<bm_secp_blocks(n), kSecpThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)u1, (const uint8_t*)u2, (const uint8_t*)qx,
        (const uint8_t*)qy, (const uint8_t*)r, (const uint32_t*)comb,
        (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}

extern "C" int bm_secp_ecdh(const void* k, const void* px, const void* py,
                            const void* comb, void* x, void* y, void* ok,
                            int n, void* stream) {
    if (n <= 0) return 0;
    bm_secp_ecdh_kernel<<<bm_secp_blocks(n), kSecpThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)k, (const uint8_t*)px, (const uint8_t*)py,
        (const uint32_t*)comb, (uint8_t*)x, (uint8_t*)y, (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}

extern "C" int bm_secp_selftest(int op, const void* a, const void* b,
                                void* out, int n, void* stream) {
    if (n <= 0) return 0;
    bm_secp_selftest_kernel<<<(n + 127) / 128, 128, 0,
                              (cudaStream_t)stream>>>(
        op, (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}
