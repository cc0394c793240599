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
// multiply.  Scalars are walked over all 256 bits, MSB first.
//
// What bounds them.  The work a lane needs is a chain of about 2,300
// modular multiplications and 2,100 squarings (verify) or 1,800 and 1,600
// (ECDH; both depend on the scalars' bits): 256 doublings of 3 M + 4 S, a
// mixed addition of 8 M + 3 S per step with a set bit (every addend, G, Q,
// G+Q and P, has Z = 1), and conversions to affine of 18 M + 256 S (two for
// verify).  A multiplication is 64 32x32->64 partial products plus 8 for
// the fold of the high half by 977, 144 IMAD issue slots; a squaring
// 36 + 8, 88 slots.  Inputs and outputs are 161 bytes a lane, so the work
// is bound by 32-bit integer multiply issue, not by memory.  This code does
// more than that bound charges: complete Jacobian additions (12 M + 4 S)
// and squarings through the general multiply.  A drain of the main path
// holds at most 4,096 lanes: one thread per lane then fills 128 warps on
// 132 SMs, and a launch takes one thread's serial chain, not the card's
// multiply rate.  Each 64-bit carry is a compare and a select (ISETP +
// SEL, ~30% of the SASS) on that chain.  chip_smoke.py measures the times
// and their share of the bound (PERF.md, section 6, keeps them).  The gap
// is recorded, not fixed, here: PTX carry chains, several threads per
// lane, a fixed-base table for G, mixed affine additions and a dedicated
// squaring are the levers.
//
// What the design does about it.  One thread per lane on 4 x 64-bit limbs
// (secp256k1.cuh): __umul64hi gives the high half of each product, so a
// field multiplication is 16 wide products instead of the TPU's 400 13-bit
// partials.  The ladders branch per lane where the TPU selected between
// computed results (a SIMT lane may diverge; only divergent warps pay), and
// the 256-step loops and the inversion chain's squaring runs stay rolled
// (#pragma unroll 1) to keep ptxas time and registers bounded.  p, n and G
// sit in __constant__ memory.  Blocks of 32 threads spread a 4,096-lane
// drain over 128 SMs instead of packing it onto fewer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "secp256k1.cuh"

static constexpr int kSecpThreads = 32;

__global__ void __launch_bounds__(kSecpThreads)
bm_secp_verify_kernel(const uint8_t* __restrict__ u1,
                      const uint8_t* __restrict__ u2,
                      const uint8_t* __restrict__ qx,
                      const uint8_t* __restrict__ qy,
                      const uint8_t* __restrict__ r,
                      uint8_t* __restrict__ ok, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t o = (size_t)i * 32;
    ok[i] = (uint8_t)bm_secp_verify_lane(u1 + o, u2 + o, qx + o, qy + o,
                                         r + o);
}

__global__ void __launch_bounds__(kSecpThreads)
bm_secp_ecdh_kernel(const uint8_t* __restrict__ k,
                    const uint8_t* __restrict__ px,
                    const uint8_t* __restrict__ py,
                    uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                    uint8_t* __restrict__ ok, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t o = (size_t)i * 32;
    ok[i] = (uint8_t)bm_secp_ecdh_lane(k + o, px + o, py + o, x + o, y + o);
}

// Launchers: device pointers, the lane count and the stream; each returns
// cudaGetLastError() (0 = launched).  None synchronises.

extern "C" int bm_secp_verify(const void* u1, const void* u2, const void* qx,
                              const void* qy, const void* r, void* ok, int n,
                              void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kSecpThreads - 1) / kSecpThreads;
    bm_secp_verify_kernel<<<blocks, kSecpThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)u1, (const uint8_t*)u2, (const uint8_t*)qx,
        (const uint8_t*)qy, (const uint8_t*)r, (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}

extern "C" int bm_secp_ecdh(const void* k, const void* px, const void* py,
                            void* x, void* y, void* ok, int n, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kSecpThreads - 1) / kSecpThreads;
    bm_secp_ecdh_kernel<<<blocks, kSecpThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)k, (const uint8_t*)px, (const uint8_t*)py,
        (uint8_t*)x, (uint8_t*)y, (uint8_t*)ok, n);
    return (int)cudaGetLastError();
}
