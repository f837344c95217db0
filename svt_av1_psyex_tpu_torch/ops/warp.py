"""Warped motion compensation (AV1 spec 7.11.3.5-7.11.3.8).

Spec-exact integer warp: an affine model in 1/65536-pel units
(``mat[6]``: x' = m2*x + m3*y + m0, y' = m4*x + m5*y + m1) is applied
per 8x8 subblock as a separable 8-tap filter pass whose fractional
position advances by the shear parameters (alpha, beta) horizontally
and (gamma, delta) vertically.  The filter bank is the normative
Warp_Filters table (spec 7.11.3.7), extracted into av1_tables.npz.

Counterpart: ``svt_av1_warp_affine_c`` / ``svt_aom_get_shear_params``
(Source/Lib/Codec/warped_motion.c:569,520) — this
implementation is vectorized numpy over each subblock's 15x8 tap
lattice instead of the reference's scalar quad loop; bit-exactness is
pinned by the oracle fuzz test (tests/test_warp.py).

Fixed-point layout (spec constants):
  WARPEDMODEL_PREC_BITS = 16   model units (1/65536 pel)
  WARPEDPIXEL_PREC_BITS = 6    filter phase units (64 phases/pel)
  WARP_PARAM_REDUCE_BITS = 6   shear params are multiples of 64
"""

from __future__ import annotations

import numpy as np

WARPEDMODEL_PREC_BITS = 16
WARPEDMODEL_TRANS_CLAMP = 1 << 23
WARPEDMODEL_NONDIAG_CLAMP = 1 << 13
WARPEDPIXEL_PREC_BITS = 6
WARPEDPIXEL_PREC_SHIFTS = 1 << WARPEDPIXEL_PREC_BITS
WARPEDDIFF_PREC_BITS = WARPEDMODEL_PREC_BITS - WARPEDPIXEL_PREC_BITS
WARP_PARAM_REDUCE_BITS = 6
FILTER_BITS = 7

DIV_LUT_PREC_BITS = 14
DIV_LUT_BITS = 8
DIV_LUT_NUM = 1 << DIV_LUT_BITS

# Div_Lut (spec 7.11.3.7): Div_Lut[f] = round(2^14 * 2^8 / (2^8 + f))
_DIV_LUT = np.floor((1 << (DIV_LUT_PREC_BITS + DIV_LUT_BITS))
                    / (DIV_LUT_NUM + np.arange(DIV_LUT_NUM + 1)) + 0.5
                    ).astype(np.int64)

_WARP_FILTER = None


def warp_filter_table() -> np.ndarray:
    """(193, 8) int32 normative warp kernels."""
    global _WARP_FILTER
    if _WARP_FILTER is None:
        from ..bitstream.tables import get

        _WARP_FILTER = get("warped_filter").astype(np.int64)
    return _WARP_FILTER


def _round_pot(x, n):
    """ROUND_POWER_OF_TWO on arrays/ints (x nonneg or any: arithmetic)."""
    return (x + (1 << (n - 1))) >> n


def _round_pot_signed(x, n):
    x = np.asarray(x, np.int64)
    return np.where(x < 0, -_round_pot(-x, n), _round_pot(x, n))


def resolve_divisor(d: int) -> tuple[int, int]:
    """(1/d) as (mult, shift): 1/d ~= mult >> shift (spec 7.11.3.7).
    d must be positive."""
    n = int(d).bit_length() - 1  # floor(log2(d))
    e = d - (1 << n)
    if n > DIV_LUT_BITS:
        f = _round_pot(e, n - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - n)
    return int(_DIV_LUT[f]), n + DIV_LUT_PREC_BITS


def get_shear_params(mat) -> tuple[bool, int, int, int, int]:
    """(valid, alpha, beta, gamma, delta) from model matrix
    (spec 7.11.3.6 setup shear; warped_motion.c:520)."""
    m2, m3, m4, m5 = int(mat[2]), int(mat[3]), int(mat[4]), int(mat[5])
    if m2 <= 0:
        return False, 0, 0, 0, 0
    clamp16 = lambda v: int(np.clip(v, -32768, 32767))
    alpha = clamp16(m2 - (1 << WARPEDMODEL_PREC_BITS))
    beta = clamp16(m3)
    mult, shift = resolve_divisor(abs(m2))
    mult = mult if m2 >= 0 else -mult
    v = (m4 << WARPEDMODEL_PREC_BITS) * mult
    gamma = clamp16(int(_round_pot_signed(v, shift)))
    w = (m3 * m4) * mult
    delta = clamp16(m5 - int(_round_pot_signed(w, shift))
                    - (1 << WARPEDMODEL_PREC_BITS))

    rb = WARP_PARAM_REDUCE_BITS
    red = lambda v: int(_round_pot_signed(v, rb)) * (1 << rb)
    alpha, beta, gamma, delta = red(alpha), red(beta), red(gamma), red(delta)

    valid = (4 * abs(alpha) + 7 * abs(beta) < (1 << WARPEDMODEL_PREC_BITS)
             and 4 * abs(gamma) + 4 * abs(delta)
             < (1 << WARPEDMODEL_PREC_BITS))
    return valid, alpha, beta, gamma, delta


def warp_valid(mat) -> bool:
    return get_shear_params(mat)[0]


def warp_plane(plane: np.ndarray, mat, shear, x0: int, y0: int,
               w: int, h: int, sub_x: int = 0, sub_y: int = 0,
               bd: int = 8, is_compound: bool = False) -> np.ndarray:
    """Warp-predict an (h, w) block whose top-left sits at plane
    coordinate (x0, y0) of `plane` (the full reference plane for this
    sub-sampled plane).  w, h multiples of 8.

    Returns uint8/uint16 pixels, or the intermediate compound buffer
    (int32, offset convention of ops/mc.py's compound path) when
    is_compound.  Spec 7.11.3.5 / warped_motion.c:569."""
    alpha, beta, gamma, delta = shear
    height, width = plane.shape
    ref = plane.astype(np.int64)
    fil = warp_filter_table()

    # reduce_bits_horiz = round_0 + max(bd + FILTER_BITS - round_0 - 14, 0)
    # (highbd warp, warped_motion.c:720): 3 at 8 AND 10 bit, 5 only at 12
    # (a 10-bit ±2 recon divergence on warp blocks until round 5)
    round0 = 3 + max(bd - 10, 0)
    reduce_vert = 7 if is_compound else 2 * FILTER_BITS - round0
    offs_h = bd + FILTER_BITS - 1
    offs_v = bd + 2 * FILTER_BITS - round0

    out = np.zeros((h, w), np.int64)
    ks = np.arange(-7, 8)                      # 15 rows
    ls = np.arange(-4, 4)                      # 8 cols
    ms = np.arange(8)

    for by in range(0, h, 8):
        for bx in range(0, w, 8):
            src_x = (x0 + bx + 4) << sub_x
            src_y = (y0 + by + 4) << sub_y
            dst_x = int(mat[2]) * src_x + int(mat[3]) * src_y + int(mat[0])
            dst_y = int(mat[4]) * src_x + int(mat[5]) * src_y + int(mat[1])
            x4 = dst_x >> sub_x
            y4 = dst_y >> sub_y
            ix4, sx4 = x4 >> WARPEDMODEL_PREC_BITS, x4 & 0xFFFF
            iy4, sy4 = y4 >> WARPEDMODEL_PREC_BITS, y4 & 0xFFFF
            sx4 += alpha * (-4) + beta * (-4)
            sy4 += gamma * (-4) + delta * (-4)
            sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
            sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)

            # horizontal: tmp[k+7, l+4], k in [-7,8), l in [-4,4)
            sx = sx4 + alpha * (ls + 4)[None, :] + beta * (ks + 4)[:, None]
            # plain ROUND_POWER_OF_TWO: arithmetic shift (floor) on negatives
            offs = _round_pot(sx, WARPEDDIFF_PREC_BITS) \
                + WARPEDPIXEL_PREC_SHIFTS                       # (15, 8)
            coeffs = fil[offs]                                  # (15, 8, 8)
            iy = np.clip(iy4 + ks, 0, height - 1)               # (15,)
            sample_x = np.clip(ix4 + (ls - 3)[:, None] + ms[None, :],
                               0, width - 1)                    # (8, 8)
            samples = ref[iy[:, None, None], sample_x[None]]    # (15, 8, 8)
            tmp = (1 << offs_h) + np.einsum("klm,klm->kl", samples, coeffs)
            tmp = _round_pot(tmp, round0)                       # (15, 8)

            # vertical: out[k+4, l+4], k in [-4,4)
            kv = np.arange(-4, 4)
            sy = sy4 + gamma * (ls + 4)[None, :] + delta * (kv + 4)[:, None]
            offs = _round_pot(sy, WARPEDDIFF_PREC_BITS) \
                + WARPEDPIXEL_PREC_SHIFTS                       # (8, 8)
            coeffs = fil[offs]                                  # (8, 8, 8)
            # sum_m tmp[k+m+4, l] * coeffs[k, l, m]
            kk = (kv + 4)[:, None, None] + ms[None, None, :]    # (8, 1, 8)
            stack = tmp[kk, (ls + 4)[None, :, None]]            # (8, 8, 8)
            s = (1 << offs_v) + np.einsum("klm,klm->kl", stack, coeffs)
            s = _round_pot(s, reduce_vert)
            out[by:by + 8, bx:bx + 8] = s

    if is_compound:
        return out.astype(np.int32)
    out = out - (1 << (bd - 1)) - (1 << bd)
    return np.clip(out, 0, (1 << bd) - 1).astype(
        np.uint8 if bd == 8 else np.uint16)


def project_mv(mat, gm_type: int, mi_row: int, mi_col: int, bw: int,
               bh: int, allow_hp: bool, force_int: bool) -> tuple[int, int]:
    """Global-motion MV for a block (spec 7.10.2.10 gm_get_motion_vector):
    returns (row, col) in 1/8 pel.  mat in model units; bw/bh pixels."""
    from .warp import WARPEDMODEL_PREC_BITS as P  # self, clarity

    def conv(v):
        # convert_to_trans_prec: !allow_hp rounds at (P-2) THEN doubles —
        # not round-at-(P-3)-then-lower-to-even (differs on half-units)
        if allow_hp:
            v = int(_round_pot_signed(v, P - 3))
        else:
            v = int(_round_pot_signed(v, P - 2)) * 2
        if force_int:
            v = int(_round_pot_signed(v, 3)) * 8
        return int(np.clip(v, -(1 << 14) + 1, (1 << 14) - 1))

    if gm_type == 0:                              # IDENTITY
        return 0, 0
    if gm_type == 1:                              # TRANSLATION
        # libaom/dav1d convention: TRANSLATION stores (row, col) in
        # mat[0], mat[1] — the REVERSE of the affine (x, y) layout
        # (adaptive_mv_pred.c:975 svt_aom_gm_get_motion_vector_enc)
        return conv(int(mat[0])), conv(int(mat[1]))
    x = mi_col * 4 + bw // 2 - 1
    y = mi_row * 4 + bh // 2 - 1
    xc = (int(mat[2]) - (1 << P)) * x + int(mat[3]) * y + int(mat[0])
    yc = int(mat[4]) * x + (int(mat[5]) - (1 << P)) * y + int(mat[1])
    return conv(yc), conv(xc)


# Local warp (WARPED_CAUSAL) parameter derivation -----------------------------
# Spec 7.11.3.8 warp estimation: the DECODER re-derives the affine model
# from neighbor samples + the block MV, so every step below is normative
# and must be bit-exact (oracle: svt_find_projection /
# svt_aom_select_samples, warped_motion.c:472,924).
LS_MV_MAX = 256          # max sample mvd, 1/8 pel
LS_STEP = 8
LEAST_SQUARES_SAMPLES_MAX = 8


def _ls_square(a: int) -> int:
    return (a * a * 4 + a * 4 * LS_STEP + LS_STEP * LS_STEP * 2) >> 4


def _ls_prod1(a: int, b: int) -> int:
    return (a * b * 4 + (a + b) * 2 * LS_STEP + LS_STEP * LS_STEP) >> 4


def _ls_prod2(a: int, b: int) -> int:
    return (a * b * 4 + (a + b) * 2 * LS_STEP + LS_STEP * LS_STEP * 2) >> 4


def select_samples(mv, pts, pts_inref, bw: int, bh: int):
    """Trim samples whose mvd exceeds the block-size threshold, keeping
    source order by back-filling (warped_motion.c:924). mv = (row, col)
    1/8 pel; pts/pts_inref: lists of (x, y) 1/8-pel pairs. Returns the
    trimmed (pts, pts_inref)."""
    thresh = int(np.clip(max(bw, bh), 16, 112))
    mvd = [abs(pi[0] - p[0] - mv[1]) + abs(pi[1] - p[1] - mv[0])
           for p, pi in zip(pts, pts_inref)]
    keep = [d <= thresh for d in mvd]
    ret = sum(keep)
    if ret == 0:
        return pts[:1], pts_inref[:1]
    pts = [list(p) for p in pts]
    pts_inref = [list(p) for p in pts_inref]
    i, j = 0, len(pts) - 1
    for _ in range(len(pts) - ret):
        while keep[i]:
            i += 1
        while j >= 0 and not keep[j]:
            j -= 1
        if j < 0 or i > j:
            break
        keep[i] = keep[j]
        pts[i] = pts[j]
        pts_inref[i] = pts_inref[j]
        i += 1
        j -= 1
    return ([tuple(p) for p in pts[:ret]],
            [tuple(p) for p in pts_inref[:ret]])


def _mult_shift(p_x: int, i_det: int, shift: int, diag: bool) -> int:
    v = p_x * i_det
    v = int(_round_pot_signed(v, shift))
    c = WARPEDMODEL_NONDIAG_CLAMP
    if diag:
        one = 1 << WARPEDMODEL_PREC_BITS
        return int(np.clip(v, one - c + 1, one + c - 1))
    return int(np.clip(v, -c + 1, c - 1))


def find_affine_int(pts, pts_inref, bw: int, bh: int, mv, mi_row: int,
                    mi_col: int):
    """Integer LS affine fit (warped_motion.c:365 find_affine_int).
    pts/pts_inref: (x, y) 1/8-pel sample pairs (current / reference
    coords relative to the block's top-left). mv = (row, col) 1/8 pel.
    Returns mat6 or None (degenerate)."""
    a00 = a01 = a11 = bx0 = bx1 = by0 = by1 = 0
    rsuy = max(bh, 8) // 2 - 1
    rsux = max(bw, 8) // 2 - 1
    suy, sux = rsuy * 8, rsux * 8
    duy, dux = suy + int(mv[0]), sux + int(mv[1])
    isuy = mi_row * 4 + rsuy
    isux = mi_col * 4 + rsux

    for (px, py), (qx, qy) in zip(pts, pts_inref):
        dx, dy = qx - dux, qy - duy
        sx, sy = px - sux, py - suy
        if abs(sx - dx) < LS_MV_MAX and abs(sy - dy) < LS_MV_MAX:
            a00 += _ls_square(sx)
            a01 += _ls_prod1(sx, sy)
            a11 += _ls_square(sy)
            bx0 += _ls_prod2(sx, dx)
            bx1 += _ls_prod1(sy, dx)
            by0 += _ls_prod1(sx, dy)
            by1 += _ls_prod2(sy, dy)

    det = a00 * a11 - a01 * a01
    if det == 0:
        return None
    i_det, shift = resolve_divisor(abs(det))
    i_det = i_det if det >= 0 else -i_det
    shift -= WARPEDMODEL_PREC_BITS
    if shift < 0:
        i_det <<= -shift
        shift = 0

    p_x0 = a11 * bx0 - a01 * bx1
    p_x1 = -a01 * bx0 + a00 * bx1
    p_y0 = a11 * by0 - a01 * by1
    p_y1 = -a01 * by0 + a00 * by1

    mat = [0] * 6
    mat[2] = _mult_shift(p_x0, i_det, shift, True)
    mat[3] = _mult_shift(p_x1, i_det, shift, False)
    mat[4] = _mult_shift(p_y0, i_det, shift, False)
    mat[5] = _mult_shift(p_y1, i_det, shift, True)

    one = 1 << WARPEDMODEL_PREC_BITS
    vx = (int(mv[1]) * (1 << (WARPEDMODEL_PREC_BITS - 3))
          - (isux * (mat[2] - one) + isuy * mat[3]))
    vy = (int(mv[0]) * (1 << (WARPEDMODEL_PREC_BITS - 3))
          - (isux * mat[4] + isuy * (mat[5] - one)))
    mat[0] = int(np.clip(vx, -WARPEDMODEL_TRANS_CLAMP,
                         WARPEDMODEL_TRANS_CLAMP - 1))
    mat[1] = int(np.clip(vy, -WARPEDMODEL_TRANS_CLAMP,
                         WARPEDMODEL_TRANS_CLAMP - 1))
    return tuple(mat)


def find_projection(pts, pts_inref, bw: int, bh: int, mv, mi_row: int,
                    mi_col: int):
    """find_affine_int + shear validation (svt_find_projection,
    warped_motion.c:472). Returns (mat6, shear4) or None."""
    mat = find_affine_int(pts, pts_inref, bw, bh, mv, mi_row, mi_col)
    if mat is None:
        return None
    ok, *shear = get_shear_params(mat)
    if not ok:
        return None
    return mat, tuple(shear)
