// The packed nonce search's design, part by part, for
// torch_tools/pow_packed_bench.py.  Every variant keeps the packed
// kernel's contract (the lowest hit offset of each object) and its
// scratch layout: best[objs], next[objs], then packed_claims.cuh's launch
// counters, so the bench reads the same counters from each.
//
//   variant 0: the first port's kernel (one step-major slot counter that
//              hands a warp 256 slots at a time, (step, group, object,
//              lane) order, every read of best an atomicOr) with the
//              counters added: its "next" is next[0], the slot counter;
//   variant 1: per-object claims by single warps (32 offsets a claim),
//              reads atomic read-modify-writes;
//   variant 2: as 1 with plain loads, registers capped so that three
//              blocks fit an SM (the first port's occupancy);
//   variant 3: as 1 with plain loads and a probe of each warp's time;
//   variant 4: as 3 without the probe, the object's words read from
//              memory every round instead of held in registers;
//   variant 5: as 3 with the warps of an SM started out of step;
//   variant 6: per-object claims by blocks whose 8 warps hash in step
//              (the shipped kernel's loop), reads atomic;
//   then plain loads: the shipped kernel (pow_kernels.cu), which the
//              bench calls through the port's own library.
//
// The bench builds it with the port's nvcc flags, -shared, and
// -I pybitmessage_tpu_torch/csrc.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_claims.cuh"
#include "sha512_pow.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr u64 kWarpChunk = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
// words of a probed warp's record (variants 3 and 5)
constexpr int kProbeWords = 6;

__device__ __forceinline__ unsigned lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ u64 grab_slots(u64* counter) {
    u64 first = 0;
    if (lane_id() == 0) first = atomicAdd(counter, kWarpChunk);
    return __shfl_sync(kFullWarp, first, 0);
}

__device__ __forceinline__ u64 read_shared(u64* word) {
    u64 value = 0;
    if (lane_id() == 0) value = atomicOr(word, 0ULL);
    return __shfl_sync(kFullWarp, value, 0);
}

__device__ __forceinline__ void flush(u64* counters, const u64* counts) {
    if (lane_id() == 0)
        for (int c = kBmHashed; c < kBmCounters; ++c)
            if (counts[c]) atomicAdd(counters + c, counts[c]);
}

__device__ __forceinline__ u64 global_ns() {
    u64 t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Variant 0: the first port's bm_packed_search_kernel, counters added.
__global__ void __launch_bounds__(kThreads)
part0_kernel(const u64* __restrict__ ih, const u64* __restrict__ bases,
             const u64* __restrict__ targets, u64 pack, u64 groups,
             u64 span, u64 total, u64* scratch) {
    const u64 objs = groups * pack;
    u64* best = scratch;
    u64* counter = scratch + objs;
    u64* counters = scratch + 2 * objs;
    u64 counts[kBmCounters] = {0, 0, 0, 0, 0};
    for (;;) {
        if (read_shared(counters + kBmSolved) >= objs) break;
        const u64 first = grab_slots(counter);
        ++counts[kBmClaims];
        bool end = false;
        for (u64 round = 0; round < kWarpChunk; round += 32) {
            const u64 i0 = first + round;
            if (i0 >= total) {
                end = true;
                break;
            }
            u64 q = i0 / span;
            const u64 local0 = i0 - q * span;
            const u64 k = q % pack;
            q /= pack;
            const u64 obj = (q % groups) * pack + k;
            const u64 off0 = (q / groups) * span + local0;
            if (off0 > read_shared(best + obj)) {
                ++counts[kBmSkipped];
                continue;
            }
            ++counts[kBmHashed];
            uint64_t words[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) words[i] = ih[8 * obj + i];
            const u64 off = off0 + lane_id();
            if (bm_pow_trial(bases[obj] + off, words) <= targets[obj])
                if (atomicMin(best + obj, off) == ~0ULL)
                    atomicAdd(counters + kBmSolved, 1ULL);
        }
        if (end) break;
    }
    flush(counters, counts);
}

// Variants 1-5: each warp claims for itself, 32 offsets a claim.
// kReload: the object's words, base and target are read from memory
// every round instead of held in registers.  kStagger: the warps of an
// SM start out of step.  probe: each warp writes kProbeWords words, its
// start and exit on the global timer (ns), the SM cycles it spent picking
// objects (with loading their words), claiming and hashing, and its
// rounds.
template <bool kPlainLoads, bool kReload, bool kStagger>
__device__ __forceinline__ void warp_claims(
        const u64* __restrict__ ih, const u64* __restrict__ bases,
        const u64* __restrict__ targets, u64 objs, u64 n, u64* scratch,
        u64* probe) {
    const BmDeviceOps<kPlainLoads, kBmRound> ops = {scratch, scratch + objs,
                                                    scratch + 2 * objs};
    const unsigned lane = lane_id();
    const u64 warp = ((u64)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    BmPackedClaimer w = bm_packed_claimer(warp);
    const u64 start = probe ? global_ns() : 0;
    if (kStagger) {
        const long long t = clock64();
        while (clock64() - t < (long long)(warp % 16) * 4000) {
        }
    }
    u64 pick = 0, claim = 0, hash = 0;
    for (;;) {
        u64 c0 = clock64();
        const uint64_t obj = bm_packed_pick(w, ops, objs, n);
        if (obj == kBmNoObject) {
            pick += clock64() - c0;
            break;
        }
        uint64_t words[8];
        u64 base = 0, target = 0;
        if (!kReload) {
#pragma unroll
            for (int i = 0; i < 8; ++i) words[i] = ih[8 * obj + i];
            base = bases[obj];
            target = targets[obj];
        }
        pick += clock64() - c0;
        for (;;) {
            c0 = clock64();
            uint64_t off0;
            if (!bm_packed_claim(w, ops, n, &off0)) {
                claim += clock64() - c0;
                break;
            }
            const u64 c1 = clock64();
            claim += c1 - c0;
            if (kReload) {
#pragma unroll
                for (int i = 0; i < 8; ++i) words[i] = ih[8 * obj + i];
                base = bases[obj];
                target = targets[obj];
            }
            const u64 off = off0 + lane;
            const unsigned hits = __ballot_sync(
                kFullWarp, bm_pow_trial(base + off, words) <= target);
            if (hits && lane == bm_lowest_bit(hits)) ops.hit(obj, off);
            hash += clock64() - c1;
        }
    }
    flush(scratch + 2 * objs, (const u64*)w.counts);
    if (probe && lane == 0) {
        u64* rec = probe + kProbeWords * warp;
        rec[0] = start;
        rec[1] = global_ns();
        rec[2] = pick;
        rec[3] = claim;
        rec[4] = hash;
        rec[5] = w.counts[kBmHashed];
    }
}

template <bool kPlainLoads, bool kReload, bool kStagger, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
warp_kernel(const u64* __restrict__ ih, const u64* __restrict__ bases,
            const u64* __restrict__ targets, u64 objs, u64 n, u64* scratch,
            u64* probe) {
    warp_claims<kPlainLoads, kReload, kStagger>(ih, bases, targets, objs, n,
                                                scratch, probe);
}

// Variant 6: the shipped loop with atomic reads.
__global__ void __launch_bounds__(kThreads)
block_kernel(const u64* __restrict__ ih, const u64* __restrict__ bases,
             const u64* __restrict__ targets, u64 objs, u64 n,
             u64* scratch, u64*) {
    bm_packed_search_block<false>((const uint64_t*)ih, (const uint64_t*)bases,
                                  (const uint64_t*)targets, objs, n, scratch);
}

typedef void (*Kernel)(const u64*, const u64*, const u64*, u64, u64, u64*,
                       u64*);

// Variants 1-6 by number.
Kernel claims_variant(int variant) {
    switch (variant) {
        case 1: return warp_kernel<false, false, false, 1>;
        case 2: return warp_kernel<true, false, false, 3>;
        case 3: return warp_kernel<true, false, false, 1>;
        case 4: return warp_kernel<true, true, false, 1>;
        case 5: return warp_kernel<true, false, true, 1>;
        default: return block_kernel;
    }
}

template <typename K>
cudaError_t grid_for(K kernel, u64 total, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            kThreads, 0);
    if (err != cudaSuccess) return err;
    const u64 want = (total + kThreads - 1) / kThreads;
    const u64 cap = (u64)sms * (u64)(per_sm > 0 ? per_sm : 1);
    *blocks = (int)(want < cap ? want : cap);
    return cudaSuccess;
}

}  // namespace

// The packed kernel's C entry (bm_pow_packed_search's arguments) with the
// variant first; scratch has 2 * objs + kBmCounters words.  probe
// (variants 3 and 5): kProbeWords words for each warp the launch can
// hold, else null.
extern "C" int bm_part_packed_search(int variant, const void* ih,
                                     const void* bases, const void* targets,
                                     int groups, int pack, u64 steps,
                                     u64 span, void* scratch, void* probe,
                                     void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (span % 32 || variant < 0 || variant > 6 ||
        ((variant == 3 || variant == 5) && !probe))
        return (int)cudaErrorInvalidValue;
    const u64 objs = (u64)groups * (u64)pack;
    const u64 n = steps * span;
    cudaError_t err =
        cudaMemsetAsync(scratch, 0xFF, sizeof(u64) * (size_t)objs, s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync((u64*)scratch + objs, 0,
                              sizeof(u64) * (size_t)(objs + kBmCounters), s);
    int blocks = 0;
    const u64 total = objs * n;
    const Kernel kernel = claims_variant(variant);
    if (err == cudaSuccess && total > 0)
        err = variant == 0 ? grid_for(part0_kernel, total, &blocks)
                           : grid_for(kernel, total, &blocks);
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0) {
        const u64* a = (const u64*)ih;
        const u64* b = (const u64*)bases;
        const u64* t = (const u64*)targets;
        u64* w = (u64*)scratch;
        if (variant == 0)
            part0_kernel<<<blocks, kThreads, 0, s>>>(
                a, b, t, (u64)pack, (u64)groups, span, total, w);
        else
            kernel<<<blocks, kThreads, 0, s>>>(a, b, t, objs, n, w,
                                               (u64*)probe);
    }
    return (int)cudaGetLastError();
}
