"""Super-resolution resize kernels (spec 7.16 superres upscaling).

Reference behavior: Source/Lib/Codec/super_res.c (svt_av1_upscale_normative_rows,
av1_convolve_horiz_rs_c) and resize.c (encode-side downscaling).  The
upscaler here is the NORMATIVE horizontal-only superres resampler — it
must match the decoder bit-exactly (validated by the dav1d round-trip
tests).  The downscaler is NON-normative (the reference uses the
av1_resize_plane filtered-interp banks, resize.c); ours is a clean-room
polyphase resampler over the same 64-phase normative bank with a small
binomial antialias prefilter — any downscaler yields a conformant
stream, only quality differs.

Both are batched numpy row ops (whole plane at once): the gather /
multiply-accumulate vectorizes over (rows x out_width x 8 taps).
"""
from __future__ import annotations

import numpy as np

SCALE_NUMERATOR = 8
SUPERRES_DENOM_MIN = 9
SUPERRES_DENOM_MAX = 16
RS_SCALE_SUBPEL_BITS = 14
RS_SCALE_SUBPEL_MASK = (1 << RS_SCALE_SUBPEL_BITS) - 1
RS_SCALE_EXTRA_BITS = 8  # 14 - 6 phase bits
RS_SCALE_EXTRA_OFF = 1 << (RS_SCALE_EXTRA_BITS - 1)
FILTER_BITS = 7
TAPS = 8

# Normative 64-phase 8-tap upscale filter (AV1 spec av1_resize_filter /
# Upscale_Filter table; super_res.h av1_resize_filter_normative).
UPSCALE_FILTER = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, -1, 128, 2, -1, 0, 0],
    [0, 1, -3, 127, 4, -2, 1, 0], [0, 1, -4, 127, 6, -3, 1, 0],
    [0, 2, -6, 126, 8, -3, 1, 0], [0, 2, -7, 125, 11, -4, 1, 0],
    [-1, 2, -8, 125, 13, -5, 2, 0], [-1, 3, -9, 124, 15, -6, 2, 0],
    [-1, 3, -10, 123, 18, -6, 2, -1], [-1, 3, -11, 122, 20, -7, 3, -1],
    [-1, 4, -12, 121, 22, -8, 3, -1], [-1, 4, -13, 120, 25, -9, 3, -1],
    [-1, 4, -14, 118, 28, -9, 3, -1], [-1, 4, -15, 117, 30, -10, 4, -1],
    [-1, 5, -16, 116, 32, -11, 4, -1], [-1, 5, -16, 114, 35, -12, 4, -1],
    [-1, 5, -17, 112, 38, -12, 4, -1], [-1, 5, -18, 111, 40, -13, 5, -1],
    [-1, 5, -18, 109, 43, -14, 5, -1], [-1, 6, -19, 107, 45, -14, 5, -1],
    [-1, 6, -19, 105, 48, -15, 5, -1], [-1, 6, -19, 103, 51, -16, 5, -1],
    [-1, 6, -20, 101, 53, -16, 6, -1], [-1, 6, -20, 99, 56, -17, 6, -1],
    [-1, 6, -20, 97, 58, -17, 6, -1], [-1, 6, -20, 95, 61, -18, 6, -1],
    [-2, 7, -20, 93, 64, -18, 6, -2], [-2, 7, -20, 91, 66, -19, 6, -1],
    [-2, 7, -20, 88, 69, -19, 6, -1], [-2, 7, -20, 86, 71, -19, 6, -1],
    [-2, 7, -20, 84, 74, -20, 7, -2], [-2, 7, -20, 81, 76, -20, 7, -1],
    [-2, 7, -20, 79, 79, -20, 7, -2], [-1, 7, -20, 76, 81, -20, 7, -2],
    [-2, 7, -20, 74, 84, -20, 7, -2], [-1, 6, -19, 71, 86, -20, 7, -2],
    [-1, 6, -19, 69, 88, -20, 7, -2], [-1, 6, -19, 66, 91, -20, 7, -2],
    [-2, 6, -18, 64, 93, -20, 7, -2], [-1, 6, -18, 61, 95, -20, 6, -1],
    [-1, 6, -17, 58, 97, -20, 6, -1], [-1, 6, -17, 56, 99, -20, 6, -1],
    [-1, 6, -16, 53, 101, -20, 6, -1], [-1, 5, -16, 51, 103, -19, 6, -1],
    [-1, 5, -15, 48, 105, -19, 6, -1], [-1, 5, -14, 45, 107, -19, 6, -1],
    [-1, 5, -14, 43, 109, -18, 5, -1], [-1, 5, -13, 40, 111, -18, 5, -1],
    [-1, 4, -12, 38, 112, -17, 5, -1], [-1, 4, -12, 35, 114, -16, 5, -1],
    [-1, 4, -11, 32, 116, -16, 5, -1], [-1, 4, -10, 30, 117, -15, 4, -1],
    [-1, 3, -9, 28, 118, -14, 4, -1], [-1, 3, -9, 25, 120, -13, 4, -1],
    [-1, 3, -8, 22, 121, -12, 4, -1], [-1, 3, -7, 20, 122, -11, 3, -1],
    [-1, 2, -6, 18, 123, -10, 3, -1], [0, 2, -6, 15, 124, -9, 3, -1],
    [0, 2, -5, 13, 125, -8, 2, -1], [0, 1, -4, 11, 125, -7, 2, 0],
    [0, 1, -3, 8, 126, -6, 2, 0], [0, 1, -3, 6, 127, -4, 1, 0],
    [0, 1, -2, 4, 127, -3, 1, 0], [0, 0, -1, 2, 128, -1, 0, 0],
], np.int32)


def _cdiv(n: int, d: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(n) // d
    return -q if (n < 0) != (d < 0) else q


def scaled_size(dim: int, denom: int) -> int:
    """Downscaled dimension for a superres denominator
    (super_res.c calculate_scaled_size_helper: round-to-nearest with the
    spec Appendix-A >=16 clamp)."""
    if denom == SCALE_NUMERATOR:
        return dim
    assert SUPERRES_DENOM_MIN <= denom <= SUPERRES_DENOM_MAX, denom
    min_dim = min(16, dim)
    return max((dim * SCALE_NUMERATOR + denom // 2) // denom, min_dim)


def upscale_normative(plane: np.ndarray, out_w: int, bit_depth: int = 8,
                      coded_w: int | None = None) -> np.ndarray:
    """Spec 7.16 horizontal superres upscale of one plane (all rows).

    Bit-exact mirror of av1_convolve_horiz_rs_c driven with the
    single-tile x0/step derivation of svt_av1_upscale_normative_rows
    (super_res.c:43-92,214).  `coded_w` is the coded (downscaled) plane
    width the x0/step derivation uses; `plane` itself should extend to
    the MI-ALIGNED width (downscaled_x1 = mi_col_end << 2 in the
    reference) — the convolve reads REAL decoded pixels in the
    alignment padding and only replicates beyond it (dav1d does the
    same; replicating at coded_w gives +-1 edge diffs)."""
    h, avail_w = plane.shape
    in_w = avail_w if coded_w is None else coded_w
    if out_w == in_w:
        return plane[:, :in_w].copy()
    step = ((in_w << RS_SCALE_SUBPEL_BITS) + out_w // 2) // out_w
    err = out_w * step - (in_w << RS_SCALE_SUBPEL_BITS)
    x0 = (_cdiv(-((out_w - in_w) << (RS_SCALE_SUBPEL_BITS - 1))
                + out_w // 2, out_w)
          + RS_SCALE_EXTRA_OFF - _cdiv(err, 2)) & RS_SCALE_SUBPEL_MASK
    xq = x0 + step * np.arange(out_w, dtype=np.int64)
    base = (xq >> RS_SCALE_SUBPEL_BITS).astype(np.int64)
    phase = ((xq & RS_SCALE_SUBPEL_MASK) >> RS_SCALE_EXTRA_BITS)
    pad = TAPS
    padded = np.pad(plane, ((0, 0), (pad, pad)), mode="edge")
    # convolve is fed input-1 and itself backs up TAPS/2-1 more
    first = base - 1 - (TAPS // 2 - 1) + pad
    idx = first[:, None] + np.arange(TAPS)[None, :]
    win = padded[:, idx].astype(np.int32)          # (h, out_w, 8)
    taps = UPSCALE_FILTER[phase]                   # (out_w, 8)
    s = (win * taps[None]).sum(axis=-1)
    out = (s + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(plane.dtype)


def downscale_horiz(plane: np.ndarray, out_w: int,
                    bit_depth: int = 8) -> np.ndarray:
    """NON-normative encode-side horizontal downscale (reference role:
    av1_resize_and_extend_frame, resize.c).  Polyphase resample over the
    normative 64-phase bank at centered sample positions, with a [1 2 1]
    binomial antialias prefilter for ratios below ~3/4."""
    h, in_w = plane.shape
    if out_w == in_w:
        return plane.copy()
    assert out_w < in_w
    src = plane
    if out_w * 4 <= in_w * 3:  # ratio <= 0.75: light antialias
        p = np.pad(plane.astype(np.int32), ((0, 0), (1, 1)), mode="edge")
        src = ((p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:] + 2) >> 2).astype(
            plane.dtype)
    # centered mapping: src_pos = (x + 0.5) * in/out - 0.5, Q14
    xq = (((2 * np.arange(out_w, dtype=np.int64) + 1) * in_w)
          << (RS_SCALE_SUBPEL_BITS - 1)) // out_w - (1 << (RS_SCALE_SUBPEL_BITS - 1))
    base = xq >> RS_SCALE_SUBPEL_BITS
    phase = (xq & RS_SCALE_SUBPEL_MASK) >> RS_SCALE_EXTRA_BITS
    pad = TAPS
    padded = np.pad(src, ((0, 0), (pad, pad)), mode="edge")
    first = base - (TAPS // 2 - 1) + pad  # tap 3 lands on floor(src_pos)
    idx = first[:, None] + np.arange(TAPS)[None, :]
    win = padded[:, idx].astype(np.int32)
    taps = UPSCALE_FILTER[phase]
    s = (win * taps[None]).sum(axis=-1)
    out = (s + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(plane.dtype)
