// Host simulation of the packed kernel's claimers (g++, for
// tests/test_torch_packed.py).
//
// `claimers` simulated claimers (the kernel's blocks) run
// packed_claims.cuh's decisions over shared best[], next[] and solved
// words.  Each step takes one claimer at random and moves it by one
// action: pick an object, claim kBmClaim offsets, or finish hashing a
// claim it made earlier (so others claim, hit and switch while a claim is
// in flight, as on the card).  With `stale` > 0 a
// read of best, next or solved may return any of the word's last `stale`
// earlier values, as a load on the card may lag a write; the atomics
// (claim, hit) always see the latest.
#include <algorithm>
#include <random>
#include <vector>

#include "packed_claims.cuh"

namespace {

struct Word {
    std::vector<uint64_t> history;  // oldest first; back() is current

    explicit Word(uint64_t v) : history{v} {}
    uint64_t now() const { return history.back(); }
    void set(uint64_t v) { history.push_back(v); }
};

struct Shared {
    std::vector<Word> best, next;
    Word solved{0};
    std::mt19937_64 rng;
    unsigned stale;

    uint64_t read(const Word& w) {
        const size_t depth = std::min<size_t>(stale, w.history.size() - 1);
        const size_t back = depth ? rng() % (depth + 1) : 0;
        return w.history[w.history.size() - 1 - back];
    }
};

struct HostOps {
    static constexpr uint64_t kClaim = kBmClaim;
    Shared* s;

    uint64_t solved() { return s->read(s->solved); }
    uint32_t live_mask(uint64_t first, uint64_t objs, uint64_t n) {
        uint32_t mask = 0;
        for (unsigned i = 0; i < 32; ++i) {
            const uint64_t o = (first + i) % objs;
            if (bm_live(s->read(s->next[o]), s->read(s->best[o]), n))
                mask |= 1u << i;
        }
        return mask;
    }
    uint64_t claim(uint64_t obj, uint64_t* best) {
        const uint64_t off0 = s->next[obj].now();
        s->next[obj].set(off0 + kClaim);
        *best = s->read(s->best[obj]);
        return off0;
    }
    void hit(uint64_t obj, uint64_t off) {
        const uint64_t old = s->best[obj].now();
        if (off < old) s->best[obj].set(off);
        if (old == ~0ULL) s->solved.set(s->solved.now() + 1);
    }
};

struct SimClaimer {
    BmPackedClaimer c;
    bool has_object = false;
    bool in_flight = false;  // a claim not hashed yet
    uint64_t off0 = 0;
};

}  // namespace

// Runs the launch to its end; best_out[objs] gets each object's lowest
// hit offset (UINT64_MAX: none), counters_out[kBmCounters] the launch
// counters (solved, then the claimers' sums).  Returns the steps taken.
extern "C" uint64_t bm_sim_packed(const uint64_t* ih, const uint64_t* bases,
                                  const uint64_t* targets, uint64_t objs,
                                  uint64_t n, uint64_t claimers,
                                  uint64_t seed, unsigned stale,
                                  uint64_t* best_out,
                                  uint64_t* counters_out) {
    Shared s{std::vector<Word>(objs, Word(~0ULL)),
             std::vector<Word>(objs, Word(0)), Word(0),
             std::mt19937_64(seed), stale};
    HostOps ops{&s};
    std::vector<SimClaimer> sim(claimers);
    std::vector<size_t> alive(claimers);
    for (size_t i = 0; i < claimers; ++i) {
        sim[i].c = bm_packed_claimer(i);
        alive[i] = i;
    }
    uint64_t steps = 0;
    while (!alive.empty()) {
        ++steps;
        const size_t k = s.rng() % alive.size();
        SimClaimer& sc = sim[alive[k]];
        if (sc.in_flight) {
            // each warp's ballot: the lowest lane with a hit records it,
            // warps in a random order
            const uint64_t obj = sc.c.obj;
            uint64_t order[kBmBlockWarps];
            for (uint64_t w = 0; w < kBmBlockWarps; ++w) order[w] = w;
            std::shuffle(order, order + kBmBlockWarps, s.rng);
            for (uint64_t w : order) {
                const uint64_t first = sc.off0 + kBmRound * w;
                for (uint64_t off = first; off < first + kBmRound && off < n;
                     ++off) {
                    if (bm_pow_trial(bases[obj] + off, ih + 8 * obj) <=
                        targets[obj]) {
                        ops.hit(obj, off);
                        break;
                    }
                }
            }
            sc.in_flight = false;
        } else if (!sc.has_object) {
            sc.has_object =
                bm_packed_pick(sc.c, ops, objs, n) != kBmNoObject;
            if (!sc.has_object) {
                for (int c = kBmHashed; c < kBmCounters; ++c)
                    counters_out[c] += sc.c.counts[c];
                alive[k] = alive.back();
                alive.pop_back();
            }
        } else {
            sc.in_flight = bm_packed_claim(sc.c, ops, n, &sc.off0);
            sc.has_object = sc.in_flight;
        }
    }
    for (uint64_t o = 0; o < objs; ++o) best_out[o] = s.best[o].now();
    counters_out[kBmSolved] = s.solved.now();
    return steps;
}
