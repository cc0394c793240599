"""Invertible Bloom lookup table over salted 64-bit short IDs (copy of
``pybitmessage_tpu.sync.sketch``).

The reconciliation primitive: each side encodes its
pending announcement set into a fixed-size cell table; cell-wise
subtraction cancels every element both sides hold, and peeling the
difference table recovers exactly the symmetric difference — the
bandwidth cost scales with the *difference*, not the set size
(Eppstein et al., "What's the Difference?", SIGCOMM 2011; applied to
tx relay by Erlay/Graphene).

Short IDs are 64-bit mixes of the first 16 bytes of the inventory
hash, salted per reconciliation session so a peer cannot grind
colliding object hashes that permanently poison one victim's sketches
(the Erlay salting argument).  ID computation over thousands of
hashes is embarrassingly batchable: the numpy path mixes all hashes
in one vectorized sweep; small sets take the scalar path.  Both paths
are bit-exact (tested).  The table stays on the host: unsigned 64-bit
cells are Python ints or numpy ``uint64``, never signed torch tensors.
"""

from __future__ import annotations

import struct

import numpy as _np

_MASK = 0xFFFFFFFFFFFFFFFF
#: splitmix64 finalizer constants
_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB
#: per-partition index seeds and the cell-checksum tweak
_PART_SEEDS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9)
_CHECK_SEED = 0x27D4EB2F165667C5
#: hash-to-cell partitions (k): each id lands in one cell per partition
K_PARTITIONS = 3
#: smallest sketch ever sent — tiny diffs still need peeling slack
MIN_CELLS = 15
#: refuse to decode absurd sketches (memory guard on the wire path)
MAX_CELLS = 1 << 16
#: bytes per serialized cell: u8 count + u64 id_sum + u32 check_sum.
#: Counts travel mod 256: purity only ever needs count == +-1 and the
#: checksum guards against aliased ghosts, so full sets can load a
#: cell far past 255 before subtraction cancels the commons.  The
#: 32-bit checksum keeps cells at 13 bytes; a false-pure cell
#: (~cells/2^32 per decode) yields a bogus short ID that maps to no
#: snapshot entry and is simply skipped downstream.
CELL_BYTES = 13
#: IBLT space overhead: cells per expected-difference element.  1.5 is
#: comfortable for k=3 at the small capacities sync rounds use (the
#: asymptotic 1.22 threshold needs thousands of cells to kick in).
_OVERHEAD = 1.5


class SketchDecodeError(Exception):
    """Peeling stalled: the difference exceeded the sketch capacity
    (or a colliding/corrupt cell) — the round must fall back."""


def _mix64(x: int) -> int:
    """splitmix64 finalizer — the scalar reference implementation."""
    x &= _MASK
    x = ((x ^ (x >> 30)) * _C1) & _MASK
    x = ((x ^ (x >> 27)) * _C2) & _MASK
    return x ^ (x >> 31)


def short_id(hash_: bytes, salt: int) -> int:
    """64-bit salted short ID of one 32-byte inventory hash."""
    w0, w1 = struct.unpack_from("<QQ", hash_)
    return _mix64(_mix64(w0 ^ (salt & _MASK)) ^ w1)


def short_ids(hashes, salt: int) -> list[int]:
    """Salted short IDs for many hashes — one vectorized numpy sweep
    when available, bit-identical scalar loop otherwise."""
    hashes = list(hashes)
    if len(hashes) >= 16:
        buf = b"".join(hashes)
        words = _np.frombuffer(buf, dtype="<u8").reshape(-1, 4)
        x = _np_mix64(words[:, 0] ^ _np.uint64(salt & _MASK))
        x = _np_mix64(x ^ words[:, 1])
        return [int(v) for v in x]
    return [short_id(h, salt) for h in hashes]


def _np_mix64(x):
    """splitmix64 finalizer over a ``uint64`` array (wraps mod 2**64,
    bit-identical to :func:`_mix64`)."""
    x = (x ^ (x >> _np.uint64(30))) * _np.uint64(_C1)
    x = (x ^ (x >> _np.uint64(27))) * _np.uint64(_C2)
    return x ^ (x >> _np.uint64(31))


def short_id_map(hashes, salt: int) -> dict[int, bytes]:
    """``short_id -> hash`` for a set of inventory hashes.  The
    (negligible-probability) 64-bit collision inside one set simply
    drops one entry — the round then under-announces by one object and
    the next round (different salt) delivers it."""
    hashes = list(hashes)
    return dict(zip(short_ids(hashes, salt), hashes))


def _check(id_: int) -> int:
    """32-bit cell checksum keyed independently of the index seeds."""
    return _mix64(id_ ^ _CHECK_SEED) & 0xFFFFFFFF


def normalize_cells(cells: int) -> int:
    """Clamp an arbitrary cell count (e.g. straight off the wire) onto
    the constructor invariant: a multiple of ``K_PARTITIONS`` within
    ``[MIN_CELLS, MAX_CELLS]``.  Rounds down so the ceiling stays
    legal."""
    cells = max(MIN_CELLS, min(int(cells), MAX_CELLS))
    rem = cells % K_PARTITIONS
    if rem:
        cells -= rem
        if cells < MIN_CELLS:
            cells += K_PARTITIONS
    return cells


def capacity_for(expected_diff: float) -> int:
    """Cell count for an expected symmetric-difference size, with the
    IBLT space overhead and a floor."""
    return normalize_cells(
        int(expected_diff * _OVERHEAD) + K_PARTITIONS)


class Sketch:
    """A k-partition IBLT keyed by 64-bit short IDs.

    ``cells`` is split into ``K_PARTITIONS`` equal sub-tables; an id
    occupies exactly one cell per partition (guaranteed-distinct cells
    without rejection sampling).  ``subtract`` is cell-wise, so two
    sketches built with the same ``(salt, cells)`` over mostly-equal
    sets cancel to a table containing only the difference.
    """

    __slots__ = ("cells", "salt", "counts", "id_sums", "check_sums")

    def __init__(self, cells: int, salt: int):
        if cells % K_PARTITIONS or not MIN_CELLS <= cells <= MAX_CELLS:
            raise ValueError("bad cell count %d" % cells)
        self.cells = cells
        self.salt = salt & _MASK
        self.counts = [0] * cells
        self.id_sums = [0] * cells
        self.check_sums = [0] * cells

    # -- construction --------------------------------------------------------

    def _indices(self, id_: int) -> tuple[int, ...]:
        per = self.cells // K_PARTITIONS
        return tuple(per * j + _mix64(id_ ^ _PART_SEEDS[j]) % per
                     for j in range(K_PARTITIONS))

    def insert_id(self, id_: int, sign: int = 1) -> None:
        chk = _check(id_)
        for idx in self._indices(id_):
            self.counts[idx] += sign
            self.id_sums[idx] ^= id_
            self.check_sums[idx] ^= chk

    def insert_ids(self, ids) -> None:
        ids = list(ids)
        if len(ids) >= 64:
            self._insert_ids_np(ids)
            return
        for id_ in ids:
            self.insert_id(id_)

    def _insert_ids_np(self, ids: list[int]) -> None:
        """Vectorized bulk insert: one scatter per partition."""
        arr = _np.array(ids, dtype=_np.uint64)
        chks = _np_mix64(arr ^ _np.uint64(_CHECK_SEED)) \
            & _np.uint64(0xFFFFFFFF)
        per = self.cells // K_PARTITIONS
        counts = _np.zeros(self.cells, dtype=_np.int64)
        id_sums = _np.zeros(self.cells, dtype=_np.uint64)
        chk_sums = _np.zeros(self.cells, dtype=_np.uint64)
        for j in range(K_PARTITIONS):
            idx = (_np_mix64(arr ^ _np.uint64(_PART_SEEDS[j]))
                   % _np.uint64(per)) + _np.uint64(per * j)
            idx = idx.astype(_np.int64)
            _np.add.at(counts, idx, 1)
            _np.bitwise_xor.at(id_sums, idx, arr)
            _np.bitwise_xor.at(chk_sums, idx, chks)
        for i in range(self.cells):
            self.counts[i] += int(counts[i])
            self.id_sums[i] ^= int(id_sums[i])
            self.check_sums[i] ^= int(chk_sums[i])

    @classmethod
    def encode(cls, hashes, salt: int, cells: int) -> "Sketch":
        """Build a sketch over a set of 32-byte inventory hashes."""
        sk = cls(cells, salt)
        sk.insert_ids(short_ids(hashes, salt))
        return sk

    # -- set algebra ---------------------------------------------------------

    def subtract(self, other: "Sketch") -> "Sketch":
        """Cell-wise ``self - other``; both must share salt + size."""
        if (other.cells, other.salt) != (self.cells, self.salt):
            raise ValueError("sketch shape/salt mismatch")
        out = Sketch(self.cells, self.salt)
        for i in range(self.cells):
            out.counts[i] = self.counts[i] - other.counts[i]
            out.id_sums[i] = self.id_sums[i] ^ other.id_sums[i]
            out.check_sums[i] = self.check_sums[i] ^ other.check_sums[i]
        return out

    def decode(self) -> tuple[set[int], set[int]]:
        """Peel a subtracted sketch into ``(ours_only, theirs_only)``
        short-id sets (ours = positive count side, i.e. the minuend).

        Raises :class:`SketchDecodeError` when peeling stalls before
        every cell returns to zero — the difference overflowed the
        capacity, or a corrupt/colliding cell poisoned the table.
        """
        ours: set[int] = set()
        theirs: set[int] = set()
        queue = [i for i in range(self.cells) if self._pure(i)]
        # each peel removes one element from K cells; bound the loop
        # defensively against a crafted self-sustaining cycle
        budget = self.cells * 4 + 16
        while queue and budget:
            budget -= 1
            i = queue.pop()
            if not self._pure(i):
                continue  # became impure/empty since queued
            sign = 1 if self.counts[i] % 256 == 1 else -1
            id_ = self.id_sums[i]
            (ours if sign == 1 else theirs).add(id_)
            chk = _check(id_)
            for idx in self._indices(id_):
                self.counts[idx] -= sign
                self.id_sums[idx] ^= id_
                self.check_sums[idx] ^= chk
                if self._pure(idx):
                    queue.append(idx)
        if any(c % 256 for c in self.counts) or any(self.id_sums) \
                or any(self.check_sums):
            raise SketchDecodeError(
                "peeling stalled with %d cells unresolved"
                % sum(1 for c in self.id_sums if c))
        return ours, theirs

    def _pure(self, i: int) -> bool:
        return self.counts[i] % 256 in (1, 255) and \
            self.check_sums[i] == _check(self.id_sums[i])

    # -- wire ----------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Packed cells: ``u8 count (mod 256) | u64 id_sum |
        u64 check_sum`` per cell (big-endian); the wire codec frames
        salt/kind/size around this blob."""
        out = bytearray()
        for i in range(self.cells):
            out += struct.pack(">BQI", self.counts[i] % 256,
                               self.id_sums[i], self.check_sums[i])
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes, salt: int) -> "Sketch":
        if len(data) % CELL_BYTES:
            raise ValueError("truncated sketch cells")
        cells = len(data) // CELL_BYTES
        sk = cls(cells, salt)
        for i in range(cells):
            c, ids, chk = struct.unpack_from(">BQI", data, i * CELL_BYTES)
            sk.counts[i] = c
            sk.id_sums[i] = ids
            sk.check_sums[i] = chk
        return sk

    def __len__(self) -> int:
        return self.cells
