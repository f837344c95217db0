"""AV1's DCT networks, written out from the specification, and the
analysis tier's transform matrices derived from them.

The inverse DCT is the specification's process (section 7.13.2.3): the
bit-reversal permutation, then a fixed list of butterfly rotations B and
Hadamard rotations H over the array T, each rotation rounding its two
outputs by the cosine's bits. The forward DCT (libaom's av1_fdct*, which
the specification does not define) is the same network transposed: the
steps in reverse order, each rotation's matrix transposed (a Hadamard is
its own transpose) and the permutation last.

`fwd_mats(n)` / `inv_mats(n)` are the networks' linear maps, probed
column by column with basis vectors at amplitude 2^20 in integer
arithmetic (the roundings stay, 2^-20 of the amplitude), with the 2D
drivers' shifts folded in, as float32 matrices: coeffs[:cn, :cn] =
F_col @ resid @ F_row.T and resid = G_col @ dq @ G_row.T, cn = min(n,
32). Nothing here reads the program: the cosines are
round(2^bits * cos(i * pi / 128)), the shifts and cosine bits AV1's.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

AMP = 1 << 20
INV_COS_BIT = 12
# forward cosine bits of square blocks (column pass, row pass) and the
# 2D drivers' shifts: forward (before the columns, between, after the
# rows), inverse (after the rows, after the columns)
FWD_COS_BIT = {4: (13, 13), 8: (13, 13), 16: (13, 12), 32: (12, 12),
               64: (13, 10)}
FWD_SHIFT = {4: (2, 0, 0), 8: (2, -1, 0), 16: (2, -2, 0), 32: (2, -4, 0),
             64: (0, -2, -2)}
INV_SHIFT = {4: (0, -4), 8: (-1, -4), 16: (-2, -4), 32: (-2, -4),
             64: (-2, -4)}


def cos128(angle: int, bits: int) -> int:
    """round(2^bits * cos(angle * pi / 128)), by the specification's
    symmetries from the first quadrant."""
    a = angle & 255

    def q(i):
        return round((1 << bits) * math.cos(i * math.pi / 128))

    if a <= 64:
        return q(a)
    if a <= 128:
        return -q(128 - a)
    if a <= 192:
        return -q(a - 128)
    return q(256 - a)


def sin128(angle: int, bits: int) -> int:
    return cos128(angle - 64, bits)


def brev(bits: int, x: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def inverse_steps(n: int) -> list:
    """The specification's inverse DCT of 2^n points after the
    permutation, as ("B", a, b, angle, flip) and ("H", a, b, flip)."""
    s: list = []

    def B(a, b, angle, flip):
        s.append(("B", a, b, angle, flip))

    def H(a, b, flip):
        s.append(("H", a, b, flip))

    if n == 6:
        for i in range(16):
            B(32 + i, 63 - i, 63 - 4 * brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            H(32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            H(16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                B(62 - i * 4 - j, 33 + i * 4 + j,
                  60 - 16 * brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            B(4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            H(8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(30 - 4 * i - j, 17 + 4 * i + j,
                  24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                H(32 + i * 4 + j, 35 + i * 4 - j, i & 1)
    for i in range(2):
        B(2 * i, 2 * i + 1, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            H(4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            B(14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                H(16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                B(61 - i * 8 - j, 34 + i * 8 + j,
                  56 - i * 32 + (j >> 1) * 64, 1)
    for i in range(2):
        H(i, 3 - i, 0)
    if n >= 3:
        B(6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                H(8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(4):
            B(29 - i, 18 + i, 48 + 64 * (i >> 1), 1)
    if n == 6:
        for i in range(4):
            for j in range(4):
                H(32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            H(i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            B(13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                H(16 + 8 * i + j, 23 + 8 * i - j, i)
    if n == 6:
        for i in range(8):
            B(59 - i, 36 + i, 48 if i < 4 else 112, 1)
    if n >= 4:
        for i in range(8):
            H(i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            B(27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(8):
            H(32 + i, 47 - i, 0)
            H(48 + i, 63 - i, 1)
    if n >= 5:
        for i in range(16):
            H(i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            B(55 - i, 40 + i, 32, 1)
    if n == 6:
        for i in range(32):
            H(i, 63 - i, 0)
    return s


def _round2(x: np.ndarray, bits: int) -> np.ndarray:
    return (x + (1 << (bits - 1))) >> bits


def _rotation(step, bits: int) -> tuple:
    """(a, b, 2x2 integer matrix M): (T[a], T[b]) <- M @ (T[a], T[b])
    before rounding."""
    _, a, b, angle, flip = step
    c, s = cos128(angle, bits), sin128(angle, bits)
    m = np.array([[c, -s], [s, c]], np.int64)
    if flip:
        m = m[::-1]
    return a, b, m


def _hadamard(step) -> tuple:
    _, a, b, flip = step
    m = np.array([[1, 1], [1, -1]], np.int64)
    if flip:    # H(b, a, 0): T[b] = T[b] + T[a], T[a] = T[b] - T[a]
        m = np.array([[-1, 1], [1, 1]], np.int64)
    return a, b, m


def run_inverse(t: np.ndarray, n: int, bits: int = INV_COS_BIT):
    """The inverse DCT of each row of t ((B, 2^n) int64), rounding each
    rotation's outputs by `bits`, with no clamping."""
    t = t[:, [brev(n, i) for i in range(1 << n)]].copy()
    for st in inverse_steps(n):
        if st[0] == "B":
            a, b, m = _rotation(st, bits)
            x, y = t[:, a].copy(), t[:, b].copy()
            t[:, a] = _round2(m[0, 0] * x + m[0, 1] * y, bits)
            t[:, b] = _round2(m[1, 0] * x + m[1, 1] * y, bits)
        else:
            a, b, m = _hadamard(st)
            x, y = t[:, a].copy(), t[:, b].copy()
            t[:, a] = m[0, 0] * x + m[0, 1] * y
            t[:, b] = m[1, 0] * x + m[1, 1] * y
    return t


def run_forward(t: np.ndarray, n: int, bits: int):
    """The forward DCT of each row of t ((B, 2^n) int64): the inverse
    network transposed, each rotation rounding its outputs by `bits`."""
    t = t.copy()
    for st in reversed(inverse_steps(n)):
        a, b, m = _rotation(st, bits) if st[0] == "B" else _hadamard(st)
        m = m.T
        x, y = t[:, a].copy(), t[:, b].copy()
        u, v = m[0, 0] * x + m[0, 1] * y, m[1, 0] * x + m[1, 1] * y
        if st[0] == "B":
            u, v = _round2(u, bits), _round2(v, bits)
        t[:, a], t[:, b] = u, v
    return t[:, [brev(n, i) for i in range(1 << n)]]


@lru_cache(maxsize=None)
def dct1d_map(size: int, bits: int, inverse: bool) -> np.ndarray:
    """(size, size) float64 L with network(v) ~= L @ v, probed with the
    basis vectors at amplitude 2^20."""
    n = size.bit_length() - 1
    x = np.eye(size, dtype=np.int64) * AMP
    y = run_inverse(x, n, bits) if inverse else run_forward(x, n, bits)
    return y.astype(np.float64).T / AMP


@lru_cache(maxsize=None)
def fwd_mats(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(F_col (cn, size), F_row (cn, size)) float32, shifts folded in."""
    cb_col, cb_row = FWD_COS_BIT[size]
    s0, s1, s2 = FWD_SHIFT[size]
    cn = min(size, 32)
    fc = dct1d_map(size, cb_col, False)[:cn] * (2.0 ** (s0 + s1))
    fr = dct1d_map(size, cb_row, False)[:cn] * (2.0 ** s2)
    return (np.ascontiguousarray(fc, np.float32),
            np.ascontiguousarray(fr, np.float32))


@lru_cache(maxsize=None)
def inv_mats(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(G_col (size, cn), G_row (size, cn)) float32, shifts folded in."""
    s0, s1 = INV_SHIFT[size]
    cn = min(size, 32)
    li = dct1d_map(size, INV_COS_BIT, True)
    return (np.ascontiguousarray(li[:, :cn] * (2.0 ** s1), np.float32),
            np.ascontiguousarray(li[:, :cn] * (2.0 ** s0), np.float32))
