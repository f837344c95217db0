"""Motion compensation: spec-exact sub-pel convolve (single reference).

Mirrors the normative inter prediction process (spec 7.11.3): the 2D
8-tap separable convolve with round_0=3 / round_1=11 intermediate
rounding for 8-bit (svt_av1_convolve_2d_sr_c semantics,
inter_prediction.c:311), plus the x-only / y-only / copy fast paths.
Kernels are the normative Subpel_Filters (extracted tables).

Out-of-frame reference samples are handled by clamping sample
coordinates to the frame (spec 7.11.3.3), implemented as clipped index
gathers — correct for arbitrarily large MVs.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.tables import get

FILTER_BITS = 7
ROUND0 = 3  # 8-bit single-ref
SUBPEL_MASK = 15

# interp_filter enum: 0 REGULAR, 1 SMOOTH, 2 SHARP, 3 BILINEAR
_FILTER_TABLES_8 = ("sub_pel_filters_8", "sub_pel_filters_8smooth",
                    "sub_pel_filters_8sharp", "bilinear_filters")
_FILTER_TABLES_4 = ("sub_pel_filters_4", "sub_pel_filters_4smooth",
                    "sub_pel_filters_4", "bilinear_filters")


def filter_kernel(interp_filter: int, subpel: int, block_dim: int) -> np.ndarray:
    """Kernel for one phase; 4-tap variants for dims <= 4 (stored 8-wide)."""
    names = _FILTER_TABLES_4 if block_dim <= 4 else _FILTER_TABLES_8
    return get(names[interp_filter])[subpel & SUBPEL_MASK]


def _rp2(x, n: int):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _patch(ref: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Gather a w x h patch with spec coordinate clamping."""
    rh, rw = ref.shape
    rows = np.clip(np.arange(y0, y0 + h), 0, rh - 1)
    cols = np.clip(np.arange(x0, x0 + w), 0, rw - 1)
    return ref[rows[:, None], cols[None, :]].astype(np.int64)


def mc_block(ref: np.ndarray, x: int, y: int, w: int, h: int,
             mv_row: int, mv_col: int, ss_x: int, ss_y: int,
             interp_x: int = 0, interp_y: int = 0,
             bit_depth: int = 8) -> np.ndarray:
    """Predict a w x h block at plane position (x, y) with a luma-units MV
    (1/8 pel). For chroma planes pass ss_x/ss_y=1 (1/16-pel phases).
    `ref` is the unpadded reference plane.
    """
    if ss_x:
        ix = x + (mv_col >> 4)
        subx = mv_col & 15
    else:
        ix = x + (mv_col >> 3)
        subx = (mv_col & 7) << 1
    if ss_y:
        iy = y + (mv_row >> 4)
        suby = mv_row & 15
    else:
        iy = y + (mv_row >> 3)
        suby = (mv_row & 7) << 1

    bd = bit_depth
    maxv = (1 << bd) - 1
    if subx == 0 and suby == 0:
        return _patch(ref, ix, iy, w, h).astype(np.int32)

    if suby == 0:  # x only
        kx = filter_kernel(interp_x, subx, w).astype(np.int64)
        sl = _patch(ref, ix - 3, iy, w + 7, h)
        res = sum(kx[k] * sl[:, k : k + w] for k in range(8))
        res = _rp2(res, ROUND0)
        return np.clip(_rp2(res, FILTER_BITS - ROUND0), 0, maxv).astype(np.int32)
    if subx == 0:  # y only
        ky = filter_kernel(interp_y, suby, h).astype(np.int64)
        sl = _patch(ref, ix, iy - 3, w, h + 7)
        res = sum(ky[k] * sl[k : k + h, :] for k in range(8))
        return np.clip(_rp2(res, FILTER_BITS), 0, maxv).astype(np.int32)

    # 2D: horizontal into intermediate then vertical
    round1 = 2 * FILTER_BITS - ROUND0  # 11
    kx = filter_kernel(interp_x, subx, w).astype(np.int64)
    ky = filter_kernel(interp_y, suby, h).astype(np.int64)
    im_h = h + 7
    sl = _patch(ref, ix - 3, iy - 3, w + 7, im_h)
    horiz = sum(kx[k] * sl[:, k : k + w] for k in range(8))
    horiz = _rp2(horiz + (1 << (bd + FILTER_BITS - 1)), ROUND0)
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    vert = sum(ky[k] * horiz[k : k + h, :] for k in range(8))
    res = _rp2(vert + (1 << offset_bits), round1) - (
        (1 << (offset_bits - round1)) + (1 << (offset_bits - round1 - 1)))
    return np.clip(res, 0, maxv).astype(np.int32)


# ---- compound (two-reference) prediction ---------------------------------------
# Counterpart: svt_av1_jnt_convolve_{2d,x,y,2d_copy}_c
# (inter_prediction.c:494-660). Each prediction is kept in the high-
# precision CONV buffer domain (round_0 = 3, round_1 = COMPOUND_ROUND1_BITS
# = 7 for 8-bit); the pair is averaged (compound_idx = 1, enable_jnt_comp
# off) and rounded to pixels.

_COMP_ROUND1 = 7


def mc_block_convbuf(ref: np.ndarray, x: int, y: int, w: int, h: int,
                     mv_row: int, mv_col: int, ss_x: int, ss_y: int,
                     interp_x: int = 0, interp_y: int = 0,
                     bit_depth: int = 8) -> np.ndarray:
    """One compound prediction in the CONV buffer domain (int32, offset)."""
    if ss_x:
        ix = x + (mv_col >> 4)
        subx = mv_col & 15
    else:
        ix = x + (mv_col >> 3)
        subx = (mv_col & 7) << 1
    if ss_y:
        iy = y + (mv_row >> 4)
        suby = mv_row & 15
    else:
        iy = y + (mv_row >> 3)
        suby = (mv_row & 7) << 1

    bd = bit_depth
    r0, r1 = ROUND0, _COMP_ROUND1
    offset_bits = bd + 2 * FILTER_BITS - r0
    round_offset = (1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1))

    if subx == 0 and suby == 0:  # jnt_convolve_2d_copy
        bits = 2 * FILTER_BITS - r0 - r1
        sl = _patch(ref, ix, iy, w, h)
        return (sl << bits) + round_offset

    if suby == 0:  # jnt_convolve_x
        kx = filter_kernel(interp_x, subx, w).astype(np.int64)
        sl = _patch(ref, ix - 3, iy, w + 7, h)
        res = sum(kx[k] * sl[:, k : k + w] for k in range(8))
        bits = FILTER_BITS - r1
        return ((_rp2(res, r0)) << bits) + round_offset

    if subx == 0:  # jnt_convolve_y
        ky = filter_kernel(interp_y, suby, h).astype(np.int64)
        sl = _patch(ref, ix, iy - 3, w, h + 7)
        res = sum(ky[k] * sl[k : k + h, :] for k in range(8))
        bits = FILTER_BITS - r0
        return _rp2(res << bits, r1) + round_offset

    # 2D
    kx = filter_kernel(interp_x, subx, w).astype(np.int64)
    ky = filter_kernel(interp_y, suby, h).astype(np.int64)
    sl = _patch(ref, ix - 3, iy - 3, w + 7, h + 7)
    horiz = sum(kx[k] * sl[:, k : k + w] for k in range(8))
    horiz = _rp2(horiz + (1 << (bd + FILTER_BITS - 1)), r0)
    vert = sum(ky[k] * horiz[k : k + h, :] for k in range(8))
    return _rp2(vert + (1 << offset_bits), r1)


def compound_average(buf0: np.ndarray, buf1: np.ndarray,
                     bit_depth: int = 8) -> np.ndarray:
    """Average two CONV-buffer predictions to pixels (compound_idx=1)."""
    bd = bit_depth
    r0, r1 = ROUND0, _COMP_ROUND1
    offset_bits = bd + 2 * FILTER_BITS - r0
    round_offset = (1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1))
    round_bits = 2 * FILTER_BITS - r0 - r1
    tmp = ((buf0 + buf1) >> 1) - round_offset
    return np.clip(_rp2(tmp, round_bits), 0, (1 << bd) - 1).astype(np.int32)


# ---- distance-weighted compound (compound_idx = 0) ------------------------
# Counterpart: svt_av1_dist_wtd_comp_weight_assign + the jnt convolve
# accumulation `tmp = p0*fwd + p1*bck >> DIST_PRECISION_BITS`
# (inter_prediction.c:267-308, :467-480). order_idx is always 0 at the
# reference's call sites (enc_inter_prediction.c:1983).

MAX_FRAME_DISTANCE = 31
_DIST_PRECISION_BITS = 4
_QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7), (1, MAX_FRAME_DISTANCE))
_QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))


def rel_dist(order_hint_bits: int, ref_hint: int, order_hint: int) -> int:
    """Signed wrap-around order-hint distance (spec get_relative_dist)."""
    diff = ref_hint - order_hint
    m = 1 << (order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def dist_wtd_weights(order_hint_bits: int, cur_hint: int, bck_hint: int,
                     fwd_hint: int) -> tuple[int, int]:
    """(fwd_offset, bck_offset) weights for the dist-wtd blend; fwd
    scales the FIRST (list-0) conv buffer, matching the reference's
    accumulation order. bck_hint/fwd_hint are the order hints of
    ref_frame[0] / ref_frame[1]."""
    d0 = min(abs(rel_dist(order_hint_bits, fwd_hint, cur_hint)),
             MAX_FRAME_DISTANCE)
    d1 = min(abs(rel_dist(order_hint_bits, cur_hint, bck_hint)),
             MAX_FRAME_DISTANCE)
    order = 1 if d0 <= d1 else 0
    if d0 == 0 or d1 == 0:
        i = 3
    else:
        for i in range(3):
            c0 = _QUANT_DIST_WEIGHT[i][order]
            c1 = _QUANT_DIST_WEIGHT[i][1 - order]
            d0_c0 = d0 * c0
            d1_c1 = d1 * c1
            if (d0 > d1 and d0_c0 < d1_c1) or (d0 <= d1 and d0_c0 > d1_c1):
                break
        else:
            i = 3
    return (_QUANT_DIST_LOOKUP[i][order], _QUANT_DIST_LOOKUP[i][1 - order])


def compound_dist_wtd(buf0: np.ndarray, buf1: np.ndarray, fwd_offset: int,
                      bck_offset: int, bit_depth: int = 8) -> np.ndarray:
    """Distance-weighted blend of two CONV-buffer predictions
    (compound_idx = 0): p0*fwd + p1*bck >> 4, then the compound
    round/offset removal shared with compound_average."""
    bd = bit_depth
    r0, r1 = ROUND0, _COMP_ROUND1
    offset_bits = bd + 2 * FILTER_BITS - r0
    round_offset = (1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1))
    round_bits = 2 * FILTER_BITS - r0 - r1
    tmp = ((buf0 * fwd_offset + buf1 * bck_offset)
           >> _DIST_PRECISION_BITS) - round_offset
    return np.clip(_rp2(tmp, round_bits), 0, (1 << bd) - 1).astype(np.int32)


def mc_block_compound(ref0: np.ndarray, ref1: np.ndarray, x: int, y: int,
                      w: int, h: int, mv0, mv1, ss_x: int, ss_y: int,
                      bit_depth: int = 8, interp: int = 0,
                      weights: tuple[int, int] | None = None) -> np.ndarray:
    """weights: None = plain average (compound_idx 1); (fwd, bck) =
    distance-weighted blend (compound_idx 0)."""
    b0 = mc_block_convbuf(ref0, x, y, w, h, mv0[0], mv0[1], ss_x, ss_y,
                          interp, interp, bit_depth=bit_depth)
    b1 = mc_block_convbuf(ref1, x, y, w, h, mv1[0], mv1[1], ss_x, ss_y,
                          interp, interp, bit_depth=bit_depth)
    if weights is not None:
        return compound_dist_wtd(b0, b1, weights[0], weights[1], bit_depth)
    return compound_average(b0, b1, bit_depth)
