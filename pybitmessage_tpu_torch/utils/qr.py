"""Self-contained QR encoder (byte mode, EC level L, versions 1-10; copy
of ``pybitmessage_tpu.utils.qr``).

Role of the reference's ``plugins/menu_qrcode.py``, which renders an
address QR in a Qt dialog using the third-party ``qrcode`` package.
That package isn't a dependency here, and the need is narrow — encode
a ~40-80 char bitmessage address URI — so this is a from-scratch
ISO/IEC 18004 subset: byte mode, level L, fixed mask 0, versions 1-10
(up to 271 data bytes, far beyond any address string).

The Reed-Solomon arithmetic is over GF(2^8) mod 0x11D; tests verify
codewords by checking that all syndromes of data‖ecc vanish, and the
format/version BCH words against the published constants.
"""

from __future__ import annotations

# ---- GF(256) ---------------------------------------------------------------

_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def rs_generator(n: int) -> list[int]:
    """Generator polynomial coefficients for n ECC codewords."""
    g = [1]
    for i in range(n):
        ng = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            ng[j] ^= _gf_mul(c, _EXP[i])
            ng[j + 1] ^= c
        g = ng
    return g


def rs_encode(data: list[int], n_ecc: int) -> list[int]:
    """n_ecc Reed-Solomon codewords for the data block."""
    gen = rs_generator(n_ecc)
    rem = [0] * n_ecc
    for byte in data:
        factor = byte ^ rem[0]
        rem = rem[1:] + [0]
        for i in range(n_ecc):     # synthetic division step
            rem[i] ^= _gf_mul(factor, gen[n_ecc - 1 - i])
    return rem


def rs_syndromes(codeword: list[int], n_ecc: int) -> list[int]:
    """Syndromes S_i = C(α^i); all zero iff the codeword is valid."""
    out = []
    for i in range(n_ecc):
        acc = 0
        for c in codeword:
            acc = _gf_mul(acc, _EXP[i]) ^ c
        out.append(acc)
    return out


# ---- tables (level L, versions 1-10) ---------------------------------------

#: version -> (ecc_per_block, [data codewords per block])
_BLOCKS = {
    1: (7, [19]), 2: (10, [34]), 3: (15, [55]), 4: (20, [80]),
    5: (26, [108]), 6: (18, [68, 68]), 7: (20, [78, 78]),
    8: (24, [97, 97]), 9: (30, [116, 116]),
    10: (18, [68, 68, 69, 69]),
}

_ALIGN = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30], 6: [6, 34],
    7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46], 10: [6, 28, 50],
}


def _bch(value: int, poly: int, bits: int, total: int) -> int:
    """Append (total-bits) BCH remainder bits to value."""
    deg = poly.bit_length() - 1            # == total - bits
    rem = value << deg
    for shift in range(total - 1, deg - 1, -1):
        if rem >> shift & 1:
            rem ^= poly << (shift - deg)
    return (value << deg) | rem


def format_bits(mask: int, ec_level_bits: int = 0b01) -> int:
    """15-bit format info for (level, mask); level L = 0b01."""
    data = (ec_level_bits << 3) | mask
    return _bch(data, 0b10100110111, 5, 15) ^ 0b101010000010010


def version_bits(version: int) -> int:
    """18-bit version info (versions >= 7)."""
    return _bch(version, 0b1111100100101, 6, 18)


# ---- matrix construction ---------------------------------------------------

def _fits(version: int, nbytes: int) -> bool:
    ecc, blocks = _BLOCKS[version]
    cap = sum(blocks)
    header = 4 + (16 if version >= 10 else 8)       # mode + count bits
    return nbytes * 8 + header <= cap * 8


def encode(data: bytes | str) -> list[list[bool]]:
    """Encode to a square module matrix (True = dark)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    for version in range(1, 11):
        if _fits(version, len(data)):
            break
    else:
        raise ValueError("payload too long for QR version 10-L")

    ecc_per_block, block_sizes = _BLOCKS[version]
    total_data = sum(block_sizes)

    # bit stream: mode 0100, length, payload, terminator, pads
    bits: list[int] = []

    def put(value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            bits.append(value >> i & 1)

    put(0b0100, 4)
    put(len(data), 16 if version >= 10 else 8)
    for byte in data:
        put(byte, 8)
    put(0, min(4, total_data * 8 - len(bits)))          # terminator
    while len(bits) % 8:
        bits.append(0)
    codewords = [int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8)]
    pad = (0xEC, 0x11)
    for i in range(total_data - len(codewords)):
        codewords.append(pad[i % 2])

    # split into blocks, compute ECC, interleave
    blocks, pos = [], 0
    for size in block_sizes:
        blocks.append(codewords[pos:pos + size])
        pos += size
    eccs = [rs_encode(b, ecc_per_block) for b in blocks]
    stream: list[int] = []
    for i in range(max(block_sizes)):
        for b in blocks:
            if i < len(b):
                stream.append(b[i])
    for i in range(ecc_per_block):
        for e in eccs:
            stream.append(e[i])

    # build matrix
    n = 17 + 4 * version
    M = [[None] * n for _ in range(n)]                  # None = free

    def set_square(r, c, size, dark):
        for dr in range(size):
            for dc in range(size):
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n:
                    M[rr][cc] = dark

    def finder(r, c):
        set_square(r - 1, c - 1, 9, False)              # separator halo
        set_square(r, c, 7, True)
        set_square(r + 1, c + 1, 5, False)
        set_square(r + 2, c + 2, 3, True)

    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)
    for i in range(8, n - 8):                           # timing
        M[6][i] = M[i][6] = (i % 2 == 0)
    centers = _ALIGN[version]
    for r in centers:
        for c in centers:
            # skip only the three finder-corner overlaps; centers on
            # the timing row/column (v7+: e.g. (6,22)) are REQUIRED and
            # drawn over the timing pattern per the spec
            if (r - 2 <= 7 and c - 2 <= 7) \
                    or (r - 2 <= 7 and c + 2 >= n - 8) \
                    or (r + 2 >= n - 8 and c - 2 <= 7):
                continue
            set_square(r - 2, c - 2, 5, True)
            set_square(r - 1, c - 1, 3, False)
            M[r][c] = True
    M[n - 8][8] = True                                  # dark module
    # reserve format areas
    for i in range(9):
        if M[8][i] is None:
            M[8][i] = False
        if M[i][8] is None:
            M[i][8] = False
    for i in range(8):
        if M[8][n - 1 - i] is None:
            M[8][n - 1 - i] = False
        if M[n - 1 - i][8] is None:
            M[n - 1 - i][8] = False
    if version >= 7:                                    # version info areas
        vb = version_bits(version)
        for i in range(18):
            bit = bool(vb >> i & 1)
            M[n - 11 + i % 3][i // 3] = bit
            M[i // 3][n - 11 + i % 3] = bit

    # zigzag data placement with mask 0 ((r+c) % 2 == 0)
    bit_iter = iter(
        b for byte in stream for b in
        ((byte >> 7 & 1), (byte >> 6 & 1), (byte >> 5 & 1), (byte >> 4 & 1),
         (byte >> 3 & 1), (byte >> 2 & 1), (byte >> 1 & 1), (byte & 1)))
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:                                    # skip timing col
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if M[r][c] is None:
                    bit = next(bit_iter, 0)
                    M[r][c] = bool(bit ^ (1 if (r + c) % 2 == 0 else 0))
        col -= 2
        upward = not upward

    # format info (level L, mask 0) in both locations
    fb = format_bits(0)
    fbits = [bool(fb >> (14 - i) & 1) for i in range(15)]
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
                (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8),
                (0, 8)]
    coords_b = [(n - 1, 8), (n - 2, 8), (n - 3, 8), (n - 4, 8), (n - 5, 8),
                (n - 6, 8), (n - 7, 8), (8, n - 8), (8, n - 7), (8, n - 6),
                (8, n - 5), (8, n - 4), (8, n - 3), (8, n - 2), (8, n - 1)]
    for (r, c), bit in zip(coords_a, fbits):
        M[r][c] = bit
    for (r, c), bit in zip(coords_b, fbits):
        M[r][c] = bit
    return [[bool(v) for v in row] for row in M]


# ---- rendering -------------------------------------------------------------

def render_text(matrix: list[list[bool]], *, border: int = 2) -> str:
    """Terminal rendering, two half-height rows per character line."""
    n = len(matrix)
    size = n + 2 * border

    def at(r, c):
        r -= border
        c -= border
        return matrix[r][c] if 0 <= r < n and 0 <= c < n else False

    glyphs = {(False, False): " ", (True, False): "▀",
              (False, True): "▄", (True, True): "█"}
    lines = []
    for r in range(0, size, 2):
        lines.append("".join(
            glyphs[(at(r, c), at(r + 1, c))] for c in range(size)))
    return "\n".join(lines)


def render_svg(matrix: list[list[bool]], *, scale: int = 4,
               border: int = 2) -> str:
    n = len(matrix)
    size = (n + 2 * border) * scale
    rects = []
    for r, row in enumerate(matrix):
        for c, dark in enumerate(row):
            if dark:
                rects.append(
                    f'<rect x="{(c + border) * scale}"'
                    f' y="{(r + border) * scale}"'
                    f' width="{scale}" height="{scale}"/>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg"'
            f' viewBox="0 0 {size} {size}">'
            f'<rect width="{size}" height="{size}" fill="#fff"/>'
            f'<g fill="#000">{"".join(rects)}</g></svg>')
