"""AV1's constants that the reference reads, each made here from its
definition: the DCT matrices (dct.py, from the specification's
networks), the default scan of square transforms (the zig-zag over
anti-diagonals), SMOOTH's weights (the specification's Sm_Weights
arrays) and the 8x8 Hadamard matrix (Sylvester's). Nothing is read from
the program; benchmark/tests/test_bench_reference.py holds each against
the port's as a cross-check.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import dct

SM_WEIGHTS = {
    8: [255, 197, 146, 105, 73, 50, 37, 32],
    16: [255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17,
         16],
    32: [255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101,
         92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9,
         8, 8],
    64: [255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169,
         163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106, 101, 96, 91,
         86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32, 29,
         27, 25, 22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4,
         4],
}


def scan_pos(n: int) -> np.ndarray:
    """(n*n,) int32: the default-scan position of each coefficient
    (row-major). The scan walks the anti-diagonals r + c = s, the odd
    ones from the top row down, the even ones from the bottom up."""
    pos = np.zeros(n * n, np.int32)
    i = 0
    for s in range(2 * n - 1):
        cells = [(r, s - r) for r in range(n) if 0 <= s - r < n]
        for r, c in (cells if s % 2 else cells[::-1]):
            pos[r * n + c] = i
            i += 1
    return pos


def hadamard8() -> np.ndarray:
    h = np.array([[1.0]], np.float32)
    for _ in range(3):
        h = np.kron(np.array([[1, 1], [1, -1]], np.float32), h)
    return h


@lru_cache(maxsize=None)
def numpy_tables() -> dict:
    out = {}
    for n in (4, 8, 16, 32, 64):
        out[f"fwd_col_{n}"], out[f"fwd_row_{n}"] = dct.fwd_mats(n)
        out[f"inv_col_{n}"], out[f"inv_row_{n}"] = dct.inv_mats(n)
    for n in (4, 8, 16, 32):
        out[f"scan_pos_{n}"] = scan_pos(n)
    for n, w in SM_WEIGHTS.items():
        out[f"sm_weights_{n}"] = np.array(w, np.int32)
    out["had8"] = hadamard8()
    return out
