// How the packed nonce search (bm_packed_search_kernel in pow_kernels.cu)
// hands out its work: per-object claims.  Shared by the kernel, by the
// design variants of torch_tools/pow_packed_parts.cu and by a host build
// (g++) that the CPU tests drive under random interleavings of many
// claimers.  A claimer is a block of the kernel (its warp 0 decides for
// its kBmBlockWarps warps) or, in the variants, a single warp.
// Everything a claimer does to the launch's shared words goes through an
// `Ops` object passed in:
//
//   ops.kClaim                    offsets a claim hands out (a multiple
//                                 of 32)
//   ops.solved()                  count of objects with a hit
//   ops.live_mask(first, objs, n) bit i set iff object (first + i) % objs
//                                 looks live (bm_live on its next and best)
//   ops.claim(obj, &best)         atomicAdd(next[obj], kClaim): the
//                                 claim's first offset; best: a read of
//                                 best[obj]
//   ops.hit(obj, off)             atomicMin(best[obj], off), and the first
//                                 hit of an object counts it solved
//
// The contract.  Object o searches offsets [0, n) (n a multiple of 32)
// and reports the lowest one whose trial value is <= its target.  next[o]
// hands out claims of kClaim offsets in increasing order, one atomicAdd
// each; a claim is hashed (up to n) iff its first offset is <= the
// object's best, and a claim is never abandoned.  So every offset below
// the final best is hashed by the claimer that claimed it: the lowest hit
// is found whatever the interleaving.  An object is finished once
// next[o] > best[o] or next[o] >= n; nothing visits its offsets again.
//
// Reads may be stale.  best[] only falls and next[] and solved only rise,
// so a stale read makes a finished object look live (a wasted claim,
// never a skipped one) and never the reverse: reads of best and next need
// no read-modify-write.
#pragma once

#include <stdint.h>

#include "sha512_pow.cuh"

// The decisions run on the device only under nvcc (the Ops they call are
// device code) and as plain functions under g++.
#if defined(__CUDACC__)
#define BM_WARP __device__ __forceinline__
#else
#define BM_WARP static inline
#endif

constexpr uint64_t kBmRound = 32;
constexpr uint64_t kBmNoObject = ~0ULL;
// Warps of a block of the kernel; a claim is one offset for each thread.
constexpr uint64_t kBmBlockWarps = 8;
constexpr uint64_t kBmClaim = kBmRound * kBmBlockWarps;

// Words of the launch's scratch after best[objs] and next[objs].  Each
// claimer adds its own counts once, at exit.
enum BmPackedCounter {
    kBmSolved,      // objects with a hit (lowered by no claimer)
    kBmHashed,      // rounds of 32 offsets hashed
    kBmSkipped,     // claims that found their object finished
    kBmClaims,      // atomicAdds on next[]
    kBmSwitches,    // objects picked
    kBmCounters
};

struct BmPackedClaimer {
    uint64_t id;                     // the claimer's index in the launch
    uint64_t obj;                    // its object, or kBmNoObject
    uint64_t counts[kBmCounters];    // [kBmSolved] unused
};

BM_WARP BmPackedClaimer bm_packed_claimer(uint64_t id) {
    BmPackedClaimer c = {id, kBmNoObject, {0, 0, 0, 0, 0}};
    return c;
}

BM_WARP bool bm_live(uint64_t next, uint64_t best, uint64_t n) {
    return next < n && next <= best;
}

// splitmix64's finaliser: a start that differs from claimer to claimer
// and from one switch to the next.
BM_WARP uint64_t bm_mix64(uint64_t x) {
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ULL;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

BM_WARP unsigned bm_lowest_bit(uint32_t mask) {
#if defined(__CUDA_ARCH__)
    return (unsigned)__ffs(mask) - 1;
#else
    return (unsigned)__builtin_ctz(mask);
#endif
}

// The claimer's next object: the first live one from a start of its own,
// 32 objects a look.  Its first start is id % objs (an even spread); a
// freed claimer starts from a mixed point, so the claimers freed together
// spread over the objects still live instead of herding onto the next
// one in index order.  kBmNoObject: every object is finished (or has a
// hit), and so the claimer is done.
template <class Ops>
BM_WARP uint64_t bm_packed_pick(BmPackedClaimer& c, Ops& ops, uint64_t objs,
                                uint64_t n) {
    c.obj = kBmNoObject;
    if (ops.solved() >= objs) return kBmNoObject;
    const uint64_t switches = c.counts[kBmSwitches];
    const uint64_t start =
        (switches ? bm_mix64(c.id * 0x9E3779B97F4A7C15ULL + switches) : c.id)
        % objs;
    for (uint64_t first = start; first < start + objs; first += kBmRound) {
        const uint32_t mask = ops.live_mask(first, objs, n);
        if (mask) {
            c.obj = (first + bm_lowest_bit(mask)) % objs;
            ++c.counts[kBmSwitches];
            return c.obj;
        }
    }
    return kBmNoObject;
}

// Claim the next ops.kClaim offsets of the claimer's object.  True: hash
// offsets [*off0, min(*off0 + kClaim, n)).  False: the object is
// finished; the claimer picks another.
template <class Ops>
BM_WARP bool bm_packed_claim(BmPackedClaimer& c, Ops& ops, uint64_t n,
                             uint64_t* off0) {
    uint64_t best = 0;
    *off0 = ops.claim(c.obj, &best);
    ++c.counts[kBmClaims];
    if (*off0 < n && *off0 <= best) {
        const uint64_t end = *off0 + ops.kClaim;
        c.counts[kBmHashed] += ((end < n ? end : n) - *off0) / kBmRound;
        return true;
    }
    ++c.counts[kBmSkipped];
    return false;
}

#if defined(__CUDACC__)

// A read of a word other claimers change: relaxed at gpu scope, a plain
// load that L1 does not serve stale.
__device__ __forceinline__ uint64_t bm_load_relaxed(const uint64_t* p) {
    uint64_t v;
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

// A warp's view of the launch's scratch: scratch[0, objs) best,
// [objs, 2 objs) next, then the BmPackedCounter words.  Lane 0 claims,
// lane 1 reads best, both at once; every result is the same in all
// lanes.  kPlainLoads = false reads with atomicOr(p, 0), a
// read-modify-write at L2 (the design variant that isolates what plain
// loads save).
template <bool kPlainLoads, uint64_t kClaimOffsets = kBmClaim>
struct BmDeviceOps {
    static constexpr uint64_t kClaim = kClaimOffsets;
    unsigned long long* best;
    unsigned long long* next;
    unsigned long long* counters;

    __device__ uint64_t load(unsigned long long* p) const {
        if (kPlainLoads) return bm_load_relaxed((const uint64_t*)p);
        return atomicOr(p, 0ULL);
    }
    __device__ uint64_t solved() const {
        uint64_t v = 0;
        if ((threadIdx.x & 31) == 0) v = load(counters + kBmSolved);
        return __shfl_sync(0xffffffffu, v, 0);
    }
    __device__ uint32_t live_mask(uint64_t first, uint64_t objs,
                                  uint64_t n) const {
        const uint64_t o = (first + (threadIdx.x & 31)) % objs;
        return __ballot_sync(0xffffffffu,
                             bm_live(load(next + o), load(best + o), n));
    }
    __device__ uint64_t claim(uint64_t obj, uint64_t* best_seen) const {
        const unsigned lane = threadIdx.x & 31;
        uint64_t v = 0;
        if (lane == 0)
            v = atomicAdd(next + obj, (unsigned long long)kClaim);
        else if (lane == 1)
            v = load(best + obj);
        *best_seen = __shfl_sync(0xffffffffu, v, 1);
        return __shfl_sync(0xffffffffu, v, 0);
    }
    __device__ void hit(uint64_t obj, uint64_t off) const {
        if (atomicMin(best + obj, (unsigned long long)off) == ~0ULL)
            atomicAdd(counters + kBmSolved, 1ULL);
    }
};

// One block of the packed search over `objs` objects of n offsets each
// (n a multiple of 32), kBmBlockWarps warps.  Warp 0 picks and claims for
// the block and a barrier hands the claim on: warp k hashes the 32
// offsets [off0 + 32 k, off0 + 32 k + 32) below n, all warps on the same
// object and in step.  While the block stays on an object, the object's
// words, base and target sit in registers.
template <bool kPlainLoads>
__device__ __forceinline__ void bm_packed_search_block(
        const uint64_t* __restrict__ ih, const uint64_t* __restrict__ bases,
        const uint64_t* __restrict__ targets, uint64_t objs, uint64_t n,
        unsigned long long* scratch) {
    const BmDeviceOps<kPlainLoads> ops = {scratch, scratch + objs,
                                          scratch + 2 * objs};
    __shared__ uint64_t s_obj, s_off0;
    const unsigned lane = threadIdx.x & 31;
    const unsigned warp = threadIdx.x / 32;
    BmPackedClaimer c = bm_packed_claimer(blockIdx.x);
    uint64_t words[8];
    uint64_t base = 0, target = 0, cur = kBmNoObject;
    for (;;) {
        if (warp == 0) {
            uint64_t off0 = 0;
            while ((c.obj != kBmNoObject ||
                    bm_packed_pick(c, ops, objs, n) != kBmNoObject) &&
                   !bm_packed_claim(c, ops, n, &off0))
                c.obj = kBmNoObject;
            if (lane == 0) {
                s_obj = c.obj;
                s_off0 = off0;
            }
        }
        __syncthreads();
        const uint64_t obj = s_obj;
        const uint64_t off = s_off0 + kBmRound * warp + lane;
        __syncthreads();
        if (obj == kBmNoObject) break;
        if (obj != cur) {
            cur = obj;
#pragma unroll
            for (int i = 0; i < 8; ++i) words[i] = ih[8 * obj + i];
            base = bases[obj];
            target = targets[obj];
        }
        if (off - lane < n) {
            const unsigned hits = __ballot_sync(
                0xffffffffu, bm_pow_trial(base + off, words) <= target);
            if (hits && lane == bm_lowest_bit(hits)) ops.hit(obj, off);
        }
    }
    if (warp == 0 && lane == 0)
        for (int k = kBmHashed; k < kBmCounters; ++k)
            if (c.counts[k])
                atomicAdd(ops.counters + k, (unsigned long long)c.counts[k]);
}

#endif  // __CUDACC__
