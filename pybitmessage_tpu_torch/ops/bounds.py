"""The least work the kernels' data needs, counted in Hopper instructions,
and the least card time that work takes.

One count serves two readers: ``chip_smoke.py``'s bound column (each
kernel's ``bound_ms`` beside its measured time) and the device-telemetry
plane's ``device_mfu_ratio`` (``observability/devicetelemetry.py``: work
items times the least seconds per item, over the busy seconds of the
launches).  The card's SM count and SM clock come from the card at the
caller's side, never from a constant here.

- :func:`ops_per_trial` / :func:`trial_seconds`: one double-SHA512 trial
  of the nonce-search kernels, as (shift and logic, add) instructions;
- :func:`secp_field_ops`: the field multiplications and squarings that
  secp256k1 verify / ECDH lanes need (one GLV walk whose halves share
  their doublings), :data:`IMAD_PER_FIELD_MUL` / ``_SQR`` IMAD slots
  each; :func:`ladder_field_ops` the first port's double-and-add ladder
  for the same lanes;
- :data:`POW_TRIAL`, :data:`SECP_VERIFY_LANE`, :data:`SECP_ECDH_LANE`:
  the per-item cost models the telemetry registers, a secp lane at an
  average scalar (the mean over :data:`AVERAGE_LANES` seeded scalars
  against a point other than G).
"""

from __future__ import annotations

import functools
import random

from ..crypto import fallback

#: Hopper SM issue rates, 32-bit lanes per clock (NVIDIA H100 white
#: paper; CUDA C programming guide throughput table, compute capability
#: 9.0): 64 integer lanes (shifts, logic, adds) and 64 integer
#: multiply-add lanes (IMAD, which also adds), four schedulers issuing
#: one 32-lane warp instruction each per clock
INT_ALU_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
#: HBM rate of an H100 SXM (NVIDIA data sheet), bytes/s
MEMORY_BYTES_PER_S = 3.35e12

@functools.lru_cache(maxsize=None)
def ops_per_trial() -> tuple[int, int]:
    """32-bit integer instructions one double-SHA512 trial needs on
    Hopper, for the kernels' bound, as (shifts and logic, adds).

    A u64 word is two 32-bit halves.  A word is one of three kinds:
    ``var`` changes with the nonce (the nonce and all it feeds); ``obj``
    is fixed for an object (its initial-hash words, and what only they
    and constants feed: sigma0 of w1..w8, the schedule words w17, w19
    and w21), so it is computed once per object, not per trial; a
    constant is known when the kernel is compiled (padding, lengths, K,
    H0).  Only operations on ``var`` words are counted, and the ``obj``
    and constant terms of a sum fold into one term:

    * a rotate is 2 funnel shifts; Sigma0/Sigma1 are 3 rotates plus a
      3-input xor (1 LOP3 per half): 8; sigma0/sigma1 are 2 rotates, a
      shift (2) and a LOP3 per half: 8;
    * ch and maj are 1 LOP3 per half: 2;
    * a sum of t terms is 2*ceil((t-1)/2): IADD3 adds three terms per
      half and carries two bits into the high half's IADD3.X.

    Shifts and logic run on the integer ALU only; an add can also issue
    as an IMAD.  Only the first output word of the second compression is
    needed.
    """
    shift_logic = adds = 0
    var = ("var", False)
    obj = ("obj", False)

    def const(zero: bool = False):
        return ("const", zero)

    def add(*terms):
        nonlocal adds
        n_var = sum(1 for t in terms if t[0] == "var")
        folded = any(t[0] == "obj" or (t[0] == "const" and not t[1])
                     for t in terms)
        if n_var == 0:
            if any(t[0] == "obj" for t in terms):
                return obj
            return const(all(t[1] for t in terms))
        t = n_var + folded
        adds += 2 * (t // 2) if t >= 2 else 0
        return var

    def mix(*words, cost: int):
        nonlocal shift_logic
        if any(w[0] == "var" for w in words):
            shift_logic += cost
            return var
        return obj if any(w[0] == "obj" for w in words) else const()

    def compress(w, outputs):
        w = list(w)
        a = b = c = d = e = f = g = h = const()
        for t in range(80):
            if t >= 16:
                w[t % 16] = add(mix(w[(t - 2) % 16], cost=8),
                                w[(t - 7) % 16],
                                mix(w[(t - 15) % 16], cost=8), w[t % 16])
            t1 = add(h, mix(e, cost=8), mix(e, f, g, cost=2), const(),
                     w[t % 16])
            new_a = add(t1, mix(a, cost=8), mix(a, b, c, cost=2))
            h, g, f, e, d, c, b, a = g, f, e, add(d, t1), c, b, a, new_a
        return [add(const(), s) for s in (a, b, c, d, e, f, g, h)[:outputs]]

    block1 = [var] + [obj] * 8 + [const()] + [const(True)] * 5 + [const()]
    block2 = compress(block1, 8) + [const()] + [const(True)] * 6 + [const()]
    compress(block2, 1)
    return shift_logic, adds


def trial_seconds(sms: int, clock_hz: float,
                  ops: tuple[int, int] | None = None) -> float:
    """Least card time per trial on ``sms`` SMs at ``clock_hz``: shifts
    and logic need the integer ALU (64 lanes a clock per SM); adds can
    share it with the IMAD lanes, and all of it passes the schedulers'
    128 lanes a clock."""
    shift_logic, adds = ops or ops_per_trial()
    lanes_per_s = sms * clock_hz
    return max(shift_logic / (INT_ALU_LANES_PER_SM * lanes_per_s),
               (shift_logic + adds) / (ISSUE_LANES_PER_SM * lanes_per_s))


def trial_seconds_bound(env: dict) -> float:
    """:func:`trial_seconds` for an environment record holding ``sms``,
    ``clock_mhz`` and ``ops_per_trial``."""
    return trial_seconds(env["sms"], env["clock_mhz"] * 1e6,
                         tuple(env["ops_per_trial"]))


#: 32-bit IMAD issue slots per 256-bit modular multiplication and
#: squaring: the 64 (a squaring: 36 distinct) 32x32->64 partial products
#: and the 8 of the fold of the high half by 977 (the 2^32 part of
#: 2^256 mod p is adds), each a low and a high half
IMAD_PER_FIELD_MUL = 2 * (64 + 8)
IMAD_PER_FIELD_SQR = 2 * (36 + 8)
#: (multiplications, squarings) of each step of the kernels' algorithm
#: (csrc/secp256k1.cuh): a doubling for a = 0 (dbl-2009-l); a mixed
#: addition of an affine addend (comb entries, window tables); the
#: complete addition that joins a lane's two halves; a conversion to
#: affine (the Fermat chain: 255 squarings and 15 multiplications, and
#: 3 M + 1 S more); the curve check; the GLV split (six 256 x 256-bit
#: products, counted as multiplications); a window table of 1..15 * P
#: with one Z (a doubling, 13 mixed additions, then 3 M + 1 S to bring
#: each of 14 points to the last Z and 13 M for the running product),
#: and the multiplication of the walk's Z by it; the projective r check
#: (Z^2 and r * Z^2)
FE_DOUBLE, FE_MIXED_ADD, FE_JAC_ADD = (2, 5), (8, 3), (12, 4)
FE_TO_AFFINE, FE_ON_CURVE, FE_GLV_SPLIT = (18, 256), (1, 2), (6, 0)
FE_WINDOW_TABLE = (2 + 13 * 8 + 14 * 3 + 13 + 1, 5 + 13 * 3 + 14)
FE_R_CHECK = (1, 1)
#: the double-and-add ladder of the first port of these kernels (a
#: doubling of 3 M + 4 S and a mixed addition per set bit, G + Q from two
#: affine points), kept beside the count above so the fall in work and
#: the rise in speed read apart
FE_LADDER_DOUBLE, FE_AFFINE_ADD = (3, 4), (4, 2)
#: bytes one lane reads and writes: five 32-byte inputs and ok (verify);
#: three inputs, x, y and ok (ECDH)
SECP_LANE_BYTES = {"secp_verify": 5 * 32 + 1, "secp_ecdh": 5 * 32 + 1}
GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8


def _fe_plus(total, step, times: int = 1):
    return (total[0] + step[0] * times, total[1] + step[1] * times)


def glv_split(k: int) -> tuple:
    """The kernels' GLV split on Python integers: (k1, k2), signed, with
    k1 + k2 * lambda == k (mod n) and |k1|, |k2| < 2^128."""
    n = fallback.N
    k %= n
    g1 = ((GLV_A1 << 384) + n // 2) // n
    g2 = ((-GLV_B1 << 384) + n // 2) // n
    c1 = (k * g1 + (1 << 383)) >> 384
    c2 = (k * g2 + (1 << 383)) >> 384
    return k - c1 * GLV_A1 - c2 * GLV_A2, -c1 * GLV_B1 - c2 * GLV_A1


def _nibbles(k: int, count: int) -> list:
    """k's low ``count`` nibbles, most significant first."""
    return [(k >> (4 * i)) & 15 for i in reversed(range(count))]


def _ladder_ops(windows, step=FE_DOUBLE, bits: int = 4,
                finite: bool = False) -> tuple:
    """(multiplications, squarings) of a walk over ``windows``, one tuple
    of digits per window (most significant first), from infinity unless
    ``finite``: ``bits`` doublings a window once the sum is finite and a
    mixed addition per nonzero digit (one landing on infinity is a
    select).  ``bits=0`` is the comb: additions only."""
    ops = (0, 0)
    for digits in windows:
        if finite:
            ops = _fe_plus(ops, step, bits)
        for d in digits:
            if d:
                if finite:
                    ops = _fe_plus(ops, FE_MIXED_ADD)
                finite = True
    return ops, finite


def _mul_walks(k: int, point, joined: bool) -> tuple:
    """k * P as a walk: the comb over k's 64 nibbles for P = G, else the
    GLV split, one window table of P, its copy as phi(P) (15 M), the
    walk of |k1| and |k2| and the scaling of the sum's Z by the table's
    (1 M).  ``joined``: one Strauss walk whose halves share each
    window's doublings (the least work).  Otherwise the kernels' two
    threads: each half walks alone, the comb's 32 nibbles or |k1| or
    |k2|.  Returns (ops, [finite after each walk])."""
    if point == (fallback.GX, fallback.GY):
        halves = [_nibbles(k, 64)] if joined else \
            [_nibbles(k >> (128 * h), 32) for h in (0, 1)]
        walks = [_ladder_ops([(d,) for d in h], bits=0) for h in halves]
        extra = []
    else:
        k1, k2 = (_nibbles(abs(kh), 32) for kh in glv_split(k))
        walks = [_ladder_ops(list(zip(k1, k2)))] if joined else \
            [_ladder_ops([(d,) for d in h]) for h in (k1, k2)]
        extra = [FE_GLV_SPLIT, FE_WINDOW_TABLE, (16, 0)]
    total = (0, 0)
    for ops in [w[0] for w in walks] + extra:
        total = _fe_plus(total, ops)
    return total, [w[1] for w in walks]


def secp_field_ops(kind: str, lanes, design: bool = False) -> tuple:
    """(multiplications, squarings) that these lanes' data needs: verify
    lanes are (u1, u2, (qx, qy), r), ECDH lanes (k, (px, py)).  The
    least work, the bound's: k * P as one walk (u2 * Q for verify, which
    then adds u1 * G's 64 comb nibbles onto it), then for ECDH a
    conversion to affine, for verify the projective r check.
    ``design``: the kernels' own count instead, two threads a lane, each
    walking its half alone (verify's adding 32 of the comb's nibbles),
    joined by a complete addition."""
    P = fallback.P
    total = (0, 0)
    for lane in lanes:
        if kind == "secp_verify":
            u1, k, (x, y), _ = lane
        else:
            k, (x, y) = lane
        point = (x % P, y % P)
        total = _fe_plus(total, FE_ON_CURVE)
        if not fallback.on_curve(*point):
            continue
        ops, finite = _mul_walks(k, point, joined=not design)
        total = _fe_plus(total, ops)
        if kind == "secp_verify":
            combs = [_nibbles(u1, 64)] if not design else \
                [_nibbles(u1 >> (128 * h), 32) for h in (0, 1)]
            for h, nibbles in enumerate(combs):
                ops, finite[h] = _ladder_ops([(d,) for d in nibbles],
                                             bits=0, finite=finite[h])
                total = _fe_plus(total, ops)
        if design and all(finite):
            total = _fe_plus(total, FE_JAC_ADD)
        if any(finite) or design:
            total = _fe_plus(total, FE_R_CHECK if kind == "secp_verify"
                             else FE_TO_AFFINE)
    return total


def ladder_field_ops(kind: str, lanes) -> tuple:
    """(multiplications, squarings) of the double-and-add ladders the
    first port of these kernels ran (Strauss-Shamir over {G, Q, G + Q}
    for verify, a bit at a time), for the same lanes."""
    P = fallback.P
    total = (0, 0)
    for lane in lanes:
        if kind == "secp_verify":
            u1, u2, (qx, qy), _ = lane
            q = (qx % P, qy % P)
            total = _fe_plus(total, FE_ON_CURVE)
            if not fallback.on_curve(*q):
                continue
            gq_inf = (q[0], q[1]) == (fallback.GX, P - fallback.GY)
            total = _fe_plus(total, FE_AFFINE_ADD)
            if not gq_inf:
                total = _fe_plus(total, FE_TO_AFFINE)
            bits = [((u1 >> (255 - i)) & 1, (u2 >> (255 - i)) & 1)
                    for i in range(256)]
            # G + Q at infinity adds nothing when both bits are set
            bits = [(1,) if b1 or b2 else (0,) for b1, b2 in bits] \
                if not gq_inf else \
                [(1,) if b1 != b2 else (0,) for b1, b2 in bits]
            ops, finite = _ladder_ops(bits, step=FE_LADDER_DOUBLE, bits=1)
        else:
            k, (px, py) = lane
            total = _fe_plus(total, FE_ON_CURVE)
            if not fallback.on_curve(px % P, py % P):
                continue
            ops, finite = _ladder_ops(
                [((k >> (255 - i)) & 1,) for i in range(256)],
                step=FE_LADDER_DOUBLE, bits=1)
        total = _fe_plus(total, ops)
        if finite:
            total = _fe_plus(total, FE_TO_AFFINE)
    return total


#: seeded lanes the secp per-item cost is averaged over
AVERAGE_LANES = 64


@functools.lru_cache(maxsize=None)
def average_lane_slots(kind: str) -> float:
    """IMAD slots one ``kind`` lane (``secp_verify`` or ``secp_ecdh``)
    needs at an average scalar: the mean of :func:`secp_field_ops` over
    :data:`AVERAGE_LANES` seeded scalars against the point 2G."""
    prng = random.Random(0x5EC9)
    point = fallback.point_mult(2, (fallback.GX, fallback.GY))
    lanes = []
    for _ in range(AVERAGE_LANES):
        k = prng.randrange(1, fallback.N)
        if kind == "secp_verify":
            lanes.append((prng.randrange(1, fallback.N), k, point, 1))
        else:
            lanes.append((k, point))
    mults, sqrs = secp_field_ops(kind, lanes)
    return (mults * IMAD_PER_FIELD_MUL
            + sqrs * IMAD_PER_FIELD_SQR) / AVERAGE_LANES


class ItemCost:
    """The least work of one item of a device program: ``instructions()``
    per item, and ``seconds(sms, clock_hz)``, the least card time of one
    item on a card with ``sms`` SMs at ``clock_hz``."""

    def __init__(self, kind: str):
        self.kind = kind

    def instructions(self) -> float:
        if self.kind == "pow_trial":
            return float(sum(ops_per_trial()))
        return average_lane_slots(self.kind)

    def seconds(self, sms: int, clock_hz: float) -> float:
        if self.kind == "pow_trial":
            return trial_seconds(sms, clock_hz)
        return self.instructions() / (INT_ALU_LANES_PER_SM * sms * clock_hz)


#: one double-SHA512 trial (the PoW programs)
POW_TRIAL = ItemCost("pow_trial")
#: one ECDSA verify lane / one ECDH (or P = G) lane at an average scalar
SECP_VERIFY_LANE = ItemCost("secp_verify")
SECP_ECDH_LANE = ItemCost("secp_ecdh")
