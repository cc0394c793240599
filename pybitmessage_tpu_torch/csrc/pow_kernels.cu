// The three PoW nonce-search kernels of the send path, for sm_90a.
//
// Each replaces one Pallas kernel of pybitmessage_tpu/ops/sha512_pallas.py
// and keeps its output contract, not its geometry:
//
//   bm_search_kernel         <- _kernel         (pallas_search, one object)
//   bm_batch_search_kernel   <- _batch_kernel   (pallas_batch_search)
//   bm_packed_search_kernel  <- _packed_kernel  (pallas_packed_search)
//
// Contract.  Object b searches the contiguous nonce range
// [base_b, base_b + n) mod 2^64 and reports the LOWEST offset whose trial
// value is <= target_b (every tier of the reference returns the lowest
// valid nonce >= its start).  best[b] starts at UINT64_MAX ("no hit") and
// is lowered with atomicMin; the Python wrapper rebuilds the reference's
// per-step outputs from it (hit step = offset / trials-per-grid-step).
//
// What bounds them.  A trial is two 80-round SHA-512 compressions on u64
// words: about 6.8k 32-bit integer instructions (a 64-bit add of three
// terms is an IADD3 pair, a rotate two funnel shifts, a three-way
// xor/and/not one LOP3 per half) for 8 bytes of input.  So the kernels are
// bound by 32-bit integer issue, not by memory: inputs are a few hundred
// bytes per launch.
//
// What the design does about it.  One thread per nonce; all 80 rounds
// unrolled (sha512_pow.cuh) so the message window and the state stay in
// registers and rotates are single SHF instructions; no shared memory, no
// block barriers.  The grid is what fits on the card at once.
//
// Early exit without losing the lowest hit.  The TPU grid ran in order, so
// "first hit step, lowest lane" came for free there and later steps were
// skipped.  Here blocks run concurrently and in no order.
//
// Kernels 1 and 2: a counter in global memory hands each warp the next
// 256 slots of the launch, in increasing order, whatever blocks happen to
// be resident: the card always works on the lowest slots still open.
// Slots are numbered so that each object's offsets rise with the counter.
// Before each 32 slots a warp reads the object's best hit (an atomic
// read) and skips them when they lie ABOVE it; a slot below the best is
// always hashed, which keeps the lowest-nonce contract.  Kernel 1 (one
// object) ends a warp whose round starts above the best; kernel 2
// (object-major slots) moves the counter past a solved object's slots
// and returns once every object has a hit.
//
// Kernel 3 (storms: many tiny objects, most solved within a few thousand
// nonces, the slowest several times later) claims per object instead
// (packed_claims.cuh).  Each object has its own counter; a block claims
// the next 256 offsets of its object with one atomicAdd and its 8 warps
// hash them side by side, in step, until a claim finds the object
// finished (the claim above its best or past its range); then the block
// moves to a live object from a start of its own.  No slot of a finished
// object is visited again (the first port walked 8.7 skipped rounds, each
// an atomic read at L2, for every round it hashed on the storm's targets),
// and the last object gets every block.  Reads of best and next are plain
// loads.  Why blocks: warps that each claim for themselves drift out of
// step and then hash a round about a fifth slower; a barrier that hands
// each claim to the block's warps keeps them in step
// (torch_tools/pow_packed_bench.py times both).  What bounds it: the
// integer instruction rate, as for kernels 1 and 2, over the trials the
// data needs plus the ones in flight on an object when its hit is found
// (the claims above the hit and the rest of the hit's own claim): on the
// storm's targets about 1.45x the needed trials.
//
// Hoisting the schedule words that depend only on the initial hash, and
// more instruction-level parallelism per thread, are left to later tuning.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_claims.cuh"
#include "sha512_pow.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
// Slots a warp takes from the counter at a time (8 rounds of 32 lanes).
constexpr u64 kWarpChunk = 256;
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ unsigned lane_id() { return threadIdx.x & 31; }

// The warp's next kWarpChunk slots, the same value in every lane.
__device__ __forceinline__ u64 grab_slots(u64* counter) {
    u64 first = 0;
    if (lane_id() == 0) first = atomicAdd(counter, kWarpChunk);
    return __shfl_sync(kFullWarp, first, 0);
}

// A word of the launch's state (an object's best offset, the count of
// solved objects), read atomically by lane 0 and shared with the warp.
__device__ __forceinline__ u64 read_shared(u64* word) {
    u64 value = 0;
    if (lane_id() == 0) value = atomicOr(word, 0ULL);
    return __shfl_sync(kFullWarp, value, 0);
}

// Lower an object's best offset to `off`; the first hit of the object
// adds one to the launch's count of solved objects.
__device__ __forceinline__ void record_hit(u64* best, u64* solved, u64 off) {
    if (atomicMin(best, off) == ~0ULL) atomicAdd(solved, 1ULL);
}

__device__ __forceinline__ void load_words(const u64* __restrict__ src,
                                           uint64_t dst[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = src[i];
}

// Kernel 1: one object, offsets [0, n).  Once a round starts above the
// best hit, every later round does too: the warp is done.
__global__ void __launch_bounds__(kThreads)
bm_search_kernel(const u64* __restrict__ ih, u64 base, u64 target, u64 n,
                 u64* best, u64* counter) {
    uint64_t words[8];
    load_words(ih, words);
    for (;;) {
        const u64 first = grab_slots(counter);
        for (u64 round = 0; round < kWarpChunk; round += 32) {
            const u64 off0 = first + round;
            if (off0 >= n || off0 > read_shared(best)) return;
            const u64 off = off0 + lane_id();
            if (off < n && bm_pow_trial(base + off, words) <= target)
                atomicMin(best, off);
        }
    }
}

// Kernel 2: `total` = objs * n slots laid out object-major (the order the
// TPU grid (objects, chunks) walked them).  n is a multiple of 32, so the
// 32 slots of a round belong to one object.
__global__ void __launch_bounds__(kThreads)
bm_batch_search_kernel(const u64* __restrict__ ih,
                       const u64* __restrict__ bases,
                       const u64* __restrict__ targets, u64 n, u64 objs,
                       u64 total, u64* best, u64* counter, u64* solved) {
    for (;;) {
        if (read_shared(solved) >= objs) return;
        const u64 first = grab_slots(counter);
        for (u64 round = 0; round < kWarpChunk; round += 32) {
            const u64 i0 = first + round;
            if (i0 >= total) return;
            const u64 obj = i0 / n;
            const u64 off0 = i0 - obj * n;
            if (off0 > read_shared(best + obj)) {
                // the object's later slots lie above its best too
                if (lane_id() == 0) atomicMax(counter, (obj + 1) * n);
                continue;
            }
            uint64_t words[8];
            load_words(ih + 8 * obj, words);
            const u64 off = off0 + lane_id();
            if (bm_pow_trial(bases[obj] + off, words) <= targets[obj])
                record_hit(best + obj, solved, off);
        }
    }
}

// Kernel 3: `objs` objects, each over offsets [0, n), n a multiple of 32.
// The TPU tiles (groups of `pack` objects, rows/pack*128 nonces an object
// a sub-step) are only the output geometry, which the wrapper rebuilds;
// the order of work is packed_claims.cuh's.  scratch: best[objs],
// next[objs], then the launch counters (BmPackedCounter).
static_assert(kThreads == 32 * kBmBlockWarps, "a claim is a block's");

__global__ void __launch_bounds__(kThreads)
bm_packed_search_kernel(const u64* __restrict__ ih,
                        const u64* __restrict__ bases,
                        const u64* __restrict__ targets, u64 objs, u64 n,
                        u64* scratch) {
    bm_packed_search_block<true>((const uint64_t*)ih, (const uint64_t*)bases,
                                 (const uint64_t*)targets, objs, n, scratch);
}

// Blocks for `total` slots: no more than fit on the card at once.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, u64 total, int* blocks) {
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

// best[0..objs) = UINT64_MAX (no hit); the `zeros` words after them = 0
// (kernels 1 and 2: the slot counter and the count of solved objects).
cudaError_t reset(void* best, u64 objs, cudaStream_t stream, u64 zeros = 2) {
    cudaError_t err =
        cudaMemsetAsync(best, 0xFF, sizeof(u64) * (size_t)objs, stream);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync((u64*)best + objs, 0, sizeof(u64) * zeros,
                           stream);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers
// of contiguous int64 tensors holding u64 bit patterns; `best` has objs + 2
// words (then the kernel's slot counter and its count of solved objects;
// the packed kernel's scratch is larger, see its entry); `stream` is the
// caller's cudaStream_t.  Each resets best[], launches, and returns
// cudaGetLastError() (0 = launched).  None synchronises.

extern "C" int bm_pow_search(const void* ih, u64 base, u64 target, u64 n,
                             void* best, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = reset(best, 1, s);
    int blocks = 0;
    if (err == cudaSuccess && n > 0)
        err = grid_for(bm_search_kernel, n, &blocks);
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0)
        bm_search_kernel<<<blocks, kThreads, 0, s>>>(
            (const u64*)ih, base, target, n, (u64*)best, (u64*)best + 1);
    return (int)cudaGetLastError();
}

extern "C" int bm_pow_batch_search(const void* ih, const void* bases,
                                   const void* targets, u64 n, int objs,
                                   void* best, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n % 32) return (int)cudaErrorInvalidValue;
    cudaError_t err = reset(best, objs, s);
    const u64 total = n * (u64)objs;
    int blocks = 0;
    if (err == cudaSuccess && total > 0)
        err = grid_for(bm_batch_search_kernel, total, &blocks);
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0)
        bm_batch_search_kernel<<<blocks, kThreads, 0, s>>>(
            (const u64*)ih, (const u64*)bases, (const u64*)targets, n,
            (u64)objs, total, (u64*)best, (u64*)best + objs,
            (u64*)best + objs + 1);
    return (int)cudaGetLastError();
}

// `best` here is the packed kernel's scratch: 2 * objs + kBmCounters
// words (best[], next[], the launch counters), reset on the stream.
extern "C" int bm_pow_packed_search(const void* ih, const void* bases,
                                    const void* targets, int groups,
                                    int pack, u64 steps, u64 span,
                                    void* best, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (span % 32) return (int)cudaErrorInvalidValue;
    const u64 objs = (u64)groups * (u64)pack;
    const u64 n = steps * span;
    cudaError_t err = reset(best, objs, s, objs + kBmCounters);
    int blocks = 0;
    if (err == cudaSuccess && objs * n > 0)
        err = grid_for(bm_packed_search_kernel, objs * n, &blocks);
    if (err != cudaSuccess) return (int)err;
    if (blocks > 0)
        bm_packed_search_kernel<<<blocks, kThreads, 0, s>>>(
            (const u64*)ih, (const u64*)bases, (const u64*)targets, objs, n,
            (u64*)best);
    return (int)cudaGetLastError();
}

extern "C" const char* bm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
