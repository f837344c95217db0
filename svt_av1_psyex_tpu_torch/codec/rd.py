"""Rate-distortion cost machinery: lambda, CDF bit-cost tables.

Counterpart: md_rate_estimation.c (CDF -> per-symbol fractional-bit cost
tables) and rd_cost.c (lambda computation). Costs are in 1/512-bit units
(PROB_COST_SHIFT = 9). RD constants steer quality only — conformance is
unaffected — so the formulas follow the libaom-family shape without
needing bit-exactness.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.tables import dc_q, trim

PROB_COST_SHIFT = 9
RDDIV_BITS = 7


def cdf_costs(cdf_row: np.ndarray) -> np.ndarray:
    """Per-symbol cost (1/512 bit) from a spec-orientation CDF row."""
    cdf = trim(np.asarray(cdf_row))
    prev = np.concatenate([[0], cdf[:-1]])
    p = np.maximum((cdf.astype(np.int64) - prev), 1) / 32768.0
    return np.round(-np.log2(p) * (1 << PROB_COST_SHIFT)).astype(np.int64)


class CostTables:
    """Lazy per-frame symbol cost tables derived from the initial CDFs
    (the reference snapshots rate tables per frame the same way)."""

    def __init__(self, cdfs):
        self.cdfs = cdfs
        self._cache: dict = {}

    def get(self, name: str, *idx) -> np.ndarray:
        key = (name, idx)
        if key not in self._cache:
            values = getattr(self.cdfs, name)
            if isinstance(values, dict):  # eob_flag family keyed by size
                values = values[idx[0]]
                idx = idx[1:]
            arr = values[0]
            row = arr[idx] if idx else arr
            self._cache[key] = cdf_costs(row)
        return self._cache[key]


def compute_rdmult(qindex: int, bit_depth: int = 8) -> int:
    """Lambda for rdcost() below: libaom's av1_compute_rd_mult
    (88 * q^2 / 24, q = dc_q in Q3 units) divided by 16 because libaom
    pairs that rdmult with distortions scaled <<4 (its block errors are
    in the 8x-orthonormal transform domain >> 2*shift, i.e. sse << 4)
    while rdcost() here takes RAW pixel-domain SSE. Keeping the raw-SSE
    convention and folding the 16 into the lambda gives identical RD
    trade-offs with one fewer shift on the hot dist path.

    (Validated on a band-limited-texture keyframe: the uncorrected
    lambda chose 3.3KB @ 31.4dB at q57 where the reference's RD curve
    sits at ~6.5KB @ 42dB — rate over-penalized 16x.)"""
    q = dc_q(qindex, bit_depth) >> (bit_depth - 8)
    return max(1, (88 * q * q) // 384)


def rdcost(rdmult: int, rate_512: int, dist: int) -> int:
    """J = rate * rdmult >> 9 + dist << 7 (RDCOST shape)."""
    return ((rate_512 * rdmult) >> PROB_COST_SHIFT) + (dist << RDDIV_BITS)
