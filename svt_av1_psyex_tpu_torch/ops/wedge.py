"""Masked compound prediction: wedge masks, diff-weighted masks, and the
a64 conv-domain blend.

Counterparts: the reference's wedge machinery (inter_prediction.c:
init_wedge_primary_masks :1982, get_wedge_mask_inplace :2076,
wedge codebooks :1853-1935), the diff-wtd d16 mask builder
(C_DEFAULT/inter_prediction_c.c:15 diffwtd_mask_d16) and the masked
conv-domain blend (blend_a64_mask.c:34 lowbd/highbd_blend_a64_d16_mask).
The 1-D primary ramps and per-size sign flips are normative constants
(the AV1 spec's Wedge_Master_Oblique_* / Wedge_Signs tables).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .mc import FILTER_BITS, ROUND0, _rp2

MASK_PRIMARY_SIZE = 64
WEDGE_WEIGHT_BITS = 6
MAX_ALPHA = 1 << WEDGE_WEIGHT_BITS  # 64
_BLEND_ROUND_BITS = 6
_COMP_ROUND1 = 7
DIFF_FACTOR = 16

# directions (internal enum; codebooks below use these indices)
OBLIQUE27, OBLIQUE63, OBLIQUE117, OBLIQUE153, HORIZONTAL, VERTICAL = range(6)

# spec Wedge_Master_Oblique_Even / _Odd / _Vertical (64-tap ramps)
_OBLIQUE_EVEN = np.array(
    [0] * 28 + [1, 4, 11, 27, 46, 58, 62, 63] + [64] * 28, np.uint8)
_OBLIQUE_ODD = np.array(
    [0] * 28 + [1, 2, 6, 18, 37, 53, 60, 63] + [64] * 28, np.uint8)
_VERTICAL = np.array(
    [0] * 29 + [2, 7, 21, 43, 57, 62] + [64] * 29, np.uint8)

# 16-entry codebooks (direction, x_offset, y_offset) in units of w/8, h/8
_CB_HGTW = ((OBLIQUE27, 4, 4), (OBLIQUE63, 4, 4), (OBLIQUE117, 4, 4),
            (OBLIQUE153, 4, 4), (HORIZONTAL, 4, 2), (HORIZONTAL, 4, 4),
            (HORIZONTAL, 4, 6), (VERTICAL, 4, 4), (OBLIQUE27, 4, 2),
            (OBLIQUE27, 4, 6), (OBLIQUE153, 4, 2), (OBLIQUE153, 4, 6),
            (OBLIQUE63, 2, 4), (OBLIQUE63, 6, 4), (OBLIQUE117, 2, 4),
            (OBLIQUE117, 6, 4))
_CB_HLTW = ((OBLIQUE27, 4, 4), (OBLIQUE63, 4, 4), (OBLIQUE117, 4, 4),
            (OBLIQUE153, 4, 4), (VERTICAL, 2, 4), (VERTICAL, 4, 4),
            (VERTICAL, 6, 4), (HORIZONTAL, 4, 4), (OBLIQUE27, 4, 2),
            (OBLIQUE27, 4, 6), (OBLIQUE153, 4, 2), (OBLIQUE153, 4, 6),
            (OBLIQUE63, 2, 4), (OBLIQUE63, 6, 4), (OBLIQUE117, 2, 4),
            (OBLIQUE117, 6, 4))
_CB_HEQW = ((OBLIQUE27, 4, 4), (OBLIQUE63, 4, 4), (OBLIQUE117, 4, 4),
            (OBLIQUE153, 4, 4), (HORIZONTAL, 4, 2), (HORIZONTAL, 4, 6),
            (VERTICAL, 2, 4), (VERTICAL, 6, 4), (OBLIQUE27, 4, 2),
            (OBLIQUE27, 4, 6), (OBLIQUE153, 4, 2), (OBLIQUE153, 4, 6),
            (OBLIQUE63, 2, 4), (OBLIQUE63, 6, 4), (OBLIQUE117, 2, 4),
            (OBLIQUE117, 6, 4))

# per-bsize codebook + normative sign flips (wedge_signflip_lookup);
# bsizes without wedge support map to None
_SF_HEQW = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)
_SF_HXX = (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)
_SF_8X32 = (1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 1)
_SF_32X8 = (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 0, 1, 0, 1)
_WEDGE_PARAMS = {
    3: (_CB_HEQW, _SF_HEQW),    # 8x8
    4: (_CB_HGTW, _SF_HXX),     # 8x16
    5: (_CB_HLTW, _SF_HXX),     # 16x8
    6: (_CB_HEQW, _SF_HEQW),    # 16x16
    7: (_CB_HGTW, _SF_HXX),     # 16x32
    8: (_CB_HLTW, _SF_HXX),     # 32x16
    9: (_CB_HEQW, _SF_HEQW),    # 32x32
    18: (_CB_HGTW, _SF_8X32),   # 8x32
    19: (_CB_HLTW, _SF_32X8),   # 32x8
}


def _shift_copy(src: np.ndarray, shift: int) -> np.ndarray:
    n = len(src)
    dst = np.empty(n, np.uint8)
    if shift >= 0:
        dst[shift:] = src[: n - shift]
        dst[:shift] = src[0]
    else:
        shift = -shift
        dst[: n - shift] = src[shift:]
        dst[n - shift:] = src[n - 1]
    return dst


@lru_cache(maxsize=1)
def _primary_masks() -> np.ndarray:
    """(2, 6, 64, 64) uint8: [negative][direction] primary masks."""
    s = MASK_PRIMARY_SIZE
    obl = np.zeros((2, 6, s, s), np.uint8)
    shift = s // 4
    for i in range(0, s, 2):
        obl[0, OBLIQUE63, i] = _shift_copy(_OBLIQUE_EVEN, shift)
        shift -= 1
        obl[0, OBLIQUE63, i + 1] = _shift_copy(_OBLIQUE_ODD, shift)
        obl[0, VERTICAL, i] = _VERTICAL
        obl[0, VERTICAL, i + 1] = _VERTICAL
    m63 = obl[0, OBLIQUE63].astype(np.int32)
    obl[0, OBLIQUE27] = m63.T
    obl[0, OBLIQUE117] = (MAX_ALPHA - m63)[:, ::-1]
    obl[0, OBLIQUE153] = ((MAX_ALPHA - m63)[:, ::-1]).T
    obl[1, OBLIQUE63] = MAX_ALPHA - m63
    obl[1, OBLIQUE27] = (MAX_ALPHA - m63).T
    obl[1, OBLIQUE117] = m63[:, ::-1]
    obl[1, OBLIQUE153] = (m63[:, ::-1]).T
    mv = obl[0, VERTICAL].astype(np.int32)
    obl[0, HORIZONTAL] = mv.T
    obl[1, VERTICAL] = MAX_ALPHA - mv
    obl[1, HORIZONTAL] = (MAX_ALPHA - mv).T
    return obl


@lru_cache(maxsize=128)
def wedge_mask(bsize: int, wedge_index: int, wedge_sign: int) -> np.ndarray:
    """(bh, bw) uint8 0..64 mask scaling the list-0 prediction."""
    from ..codec.constants import BLOCK_H, BLOCK_W

    cb, sf = _WEDGE_PARAMS[bsize]
    bw, bh = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    direction, xo, yo = cb[wedge_index]
    woff = (xo * bw) >> 3
    hoff = (yo * bh) >> 3
    neg = wedge_sign ^ sf[wedge_index]
    base = _primary_masks()[neg, direction]
    r0 = MASK_PRIMARY_SIZE // 2 - hoff
    c0 = MASK_PRIMARY_SIZE // 2 - woff
    return base[r0 : r0 + bh, c0 : c0 + bw].copy()


def diffwtd_mask_d16(buf0: np.ndarray, buf1: np.ndarray, mask_type: int,
                     bit_depth: int = 8) -> np.ndarray:
    """DIFFWTD_38 / _INV mask from the two luma CONV buffers
    (svt_av1_build_compound_diffwtd_mask_d16_c)."""
    rnd = 2 * FILTER_BITS - ROUND0 - _COMP_ROUND1 + (bit_depth - 8)
    diff = _rp2(np.abs(buf0.astype(np.int64) - buf1.astype(np.int64)), rnd)
    m = np.clip(38 + diff // DIFF_FACTOR, 0, MAX_ALPHA).astype(np.uint8)
    return (MAX_ALPHA - m) if mask_type else m


def _sub_mask(mask: np.ndarray, subw: int, subh: int) -> np.ndarray:
    """Collapse the luma-size mask onto a subsampled plane grid
    (blend_a64_mask.c subw/subh arms)."""
    m = mask.astype(np.int32)
    if subw and subh:
        return _rp2(m[0::2, 0::2] + m[1::2, 0::2]
                    + m[0::2, 1::2] + m[1::2, 1::2], 2)
    if subw:
        return _rp2(m[:, 0::2] + m[:, 1::2], 1)
    if subh:
        return _rp2(m[0::2, :] + m[1::2, :], 1)
    return m


# ---- inter-intra (COMPOUND_INTRA) blending -------------------------------
# ii_weights1d / ii_size_scales (inter_prediction.c:2126-2142) +
# build_smooth_interintra_mask (:2144); INTERINTRA_WEDGE_SIGN = 0.

II_DC, II_V, II_H, II_SMOOTH = range(4)

II_WEIGHTS_1D = np.array(
    [60, 58, 56, 54, 52, 50, 48, 47, 45, 44, 42, 41, 39, 38, 37, 35, 34,
     33, 32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 22, 21, 20, 19, 19,
     18, 18, 17, 16, 16, 15, 15, 14, 14, 13, 13, 12, 12, 12, 11, 11, 10,
     10, 10, 9, 9, 9, 8, 8, 8, 8, 7, 7, 7, 7, 6, 6, 6, 6, 6, 5, 5, 5, 5,
     5, 4, 4, 4, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1], np.uint8)
assert len(II_WEIGHTS_1D) == 128

_II_SIZE_SCALES = (32, 16, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2,
                   2, 1, 1, 1, 8, 8, 4, 4, 2, 2)


@lru_cache(maxsize=128)
def smooth_ii_mask(plane_bsize: int, mode: int) -> np.ndarray:
    """(bh, bw) uint8 mask scaling the INTRA prediction."""
    from ..codec.constants import BLOCK_H, BLOCK_W

    bw, bh = int(BLOCK_W[plane_bsize]), int(BLOCK_H[plane_bsize])
    sc = _II_SIZE_SCALES[plane_bsize]
    if mode == II_V:
        return np.repeat(II_WEIGHTS_1D[np.arange(bh) * sc][:, None], bw, 1)
    if mode == II_H:
        return np.repeat(II_WEIGHTS_1D[np.arange(bw) * sc][None, :], bh, 0)
    if mode == II_SMOOTH:
        idx = np.minimum(np.arange(bh)[:, None], np.arange(bw)[None, :])
        return II_WEIGHTS_1D[idx * sc]
    return np.full((bh, bw), 32, np.uint8)


def blend_a64_pixel(src0: np.ndarray, src1: np.ndarray, mask: np.ndarray,
                    subw: int, subh: int) -> np.ndarray:
    """Pixel-domain a64 blend (blend_a64_mask.c:201): mask scales src0
    (the intra prediction for inter-intra)."""
    m = _sub_mask(mask, subw, subh).astype(np.int32)
    return _rp2(m * src0 + (MAX_ALPHA - m) * src1,
                _BLEND_ROUND_BITS).astype(np.int32)


def blend_a64_d16(buf0: np.ndarray, buf1: np.ndarray, mask: np.ndarray,
                  subw: int, subh: int, bit_depth: int = 8) -> np.ndarray:
    """Masked conv-domain blend to pixels; mask is luma-sized, buf0/1
    are this plane's CONV buffers (lowbd/highbd_blend_a64_d16_mask)."""
    bd = bit_depth
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    round_offset = ((1 << (offset_bits - _COMP_ROUND1))
                    + (1 << (offset_bits - _COMP_ROUND1 - 1)))
    round_bits = 2 * FILTER_BITS - ROUND0 - _COMP_ROUND1
    m = _sub_mask(mask, subw, subh).astype(np.int64)
    res = ((m * buf0 + (MAX_ALPHA - m) * buf1) >> _BLEND_ROUND_BITS) \
        - round_offset
    return np.clip(_rp2(res, round_bits), 0, (1 << bd) - 1).astype(np.int32)
