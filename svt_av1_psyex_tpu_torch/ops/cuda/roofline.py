"""The least time an NVIDIA H100 SXM could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's memory
rate, and its operations over the card's peak rate for their type. The
peaks are NVIDIA's data-sheet numbers for the SXM part at its 700 W limit;
a card set below that limit runs slower under load, so a share of the
bound is stated beside the card's power limit.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FMA_PER_S = 66.9e12 / 2   # CUDA cores, outside the tensor cores
# int32 lanes: 64 per SM (half the fp32 lanes), 132 SMs at 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _bound(nbytes: float, ops_s: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def fullloop_bound(b: int, n: int, want_inv: bool = False,
                   in_bytes: int = 4) -> dict:
    """fullloop on B blocks of n x n: reads B n^2 samples, writes B rows
    of 8 float32 metrics (and the B n^2 float32 inverse); four 1-D passes
    of n FMAs per coefficient."""
    nbytes = b * n * n * in_bytes + b * 32 + (b * n * n * 4 if want_inv
                                              else 0)
    return _bound(nbytes, b * n * n * 4 * n / FP32_FMA_PER_S)


def sad_bound(nsb: int) -> dict:
    """sad_lattice on nSB superblocks: reads a 64x64 tile and an 80x80
    window of int32 per superblock, writes 289 x 8 x 8 int32 sums; each of
    the 289 x 64 x 64 differences is an absolute difference and an add,
    two int32 operations."""
    nbytes = nsb * (64 * 64 + 80 * 80 + 289 * 64) * 4
    return _bound(nbytes, nsb * 289 * 64 * 64 * 2 / INT32_OPS_PER_S)


# one constrained CDEF tap: the difference, its absolute value, the
# damping shift, the subtraction, the clamps to 0 and to the strength,
# the sign, the weighted add, and the tap's share of the min / max clamp
CDEF_OPS_PER_TAP = 10


def _cdef_taps(gi):
    """The taps a sample of strength index gi = pri * 4 + sec reads: the
    4 primary taps where pri is set, the 8 secondary where sec is."""
    gi = np.asarray(gi)
    return 4 * (gi >> 2 > 0) + 8 * (gi & 3 > 0)


def cdef_bound(coded, searched: int, cands, y_gi, uv_gi,
               chroma: bool) -> dict:
    """The CDEF kernel's three launches on one frame of `coded` (h, w)
    luma samples: `searched` 8x8 units searched over the strength indices
    `cands`, then the apply with the chosen y_gi / uv_gi of each filtered
    unit (0 where a unit is not filtered). int32 samples; 4:2:0 chroma.

    dirs reads the luma plane and writes a direction and a variance per
    unit; per sample a shift, a subtraction and 8 line-sum adds, per unit
    8 x 15 squared line sums, each a multiply and an add. search reads
    each searched unit's recon and source samples (64 luma, 2 x 16 chroma)
    and writes two int64 tables of (filter block, candidate); per sample
    and candidate the taps of its nominal strength, plus the luma statistics (5 sums, 3 of them of
    products) or the chroma error and its square. apply reads each plane
    and writes it once; per filtered sample its taps."""
    h, w = coded
    units = (-(-h // 8)) * (-(-w // 8))
    n_fb = (-(-h // 64)) * (-(-w // 64))
    cands = np.asarray(cands)
    planes = h * w * (1.5 if chroma else 1)
    uv = 32 if chroma else 0   # chroma samples of a unit, both planes
    dirs = _bound(h * w * 4 + units * 8,
                  (h * w * 10 + units * 8 * 15 * 2) / INT32_OPS_PER_S)
    tap_ops = CDEF_OPS_PER_TAP * _cdef_taps(cands)
    search = _bound(
        searched * ((64 + uv) * 2 * 4 + 12) + 2 * n_fb * cands.size * 8,
        searched * float(np.sum(64 * (tap_ops + 8) + uv * (tap_ops + 3)))
        / INT32_OPS_PER_S)
    apply = _bound(
        2 * planes * 4 + units * 17,
        float(np.sum(64 * CDEF_OPS_PER_TAP * _cdef_taps(y_gi))
              + (np.sum(uv * CDEF_OPS_PER_TAP * _cdef_taps(uv_gi))
                 if chroma else 0)) / INT32_OPS_PER_S)
    return {"dirs": dirs, "search": search, "apply": apply}
