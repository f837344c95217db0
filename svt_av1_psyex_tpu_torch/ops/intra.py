"""Intra predictors — spec-exact, batched over blocks of one tx size.

Implements the AV1 prediction processes (spec 7.11.2): DC (with
left-only/top-only/128 fallbacks handled by neighbor fill + availability),
V, H, SMOOTH/SMOOTH_V/SMOOTH_H (spec Sm_Weights), PAETH. Directional
modes land with the edge-filter work. Counterpart:
Source/Lib/Codec/intra_prediction.c (dc_predictor:1060, smooth_*:1090+,
paeth), neighbor fill per enc_intra_prediction.c build_intra_predictors:60.

Batched layout: above (B, w+1) with above[:,0] = top-left, left (B, h).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.tables import get
from ..codec.constants import IntraMode

SM_WEIGHT_LOG2 = 8


def _sm_weights(n: int) -> np.ndarray:
    # spec Sm_Weights, stored in av1_tables.npz via sm_weight_arrays
    return get("sm_weight_arrays")[n : 2 * n]


def predict(mode: int, above: np.ndarray, left: np.ndarray, w: int, h: int,
            have_above: bool = True, have_left: bool = True,
            bit_depth: int = 8) -> np.ndarray:
    """above: (B, w+1) int32 incl. top-left at [:,0]; left: (B, h).

    Neighbor arrays must already be filled per the spec fill rules
    (fill_neighbors below). Returns (B, h, w) int32.
    """
    b = above.shape[0]
    ar = above[:, 1 : w + 1]
    tl = above[:, 0:1]
    if mode == IntraMode.DC:
        if have_above and have_left:
            s = ar.sum(axis=1) + left.sum(axis=1)
            dc = (s + ((w + h) >> 1)) // (w + h)
        elif have_above:
            dc = (ar.sum(axis=1) + (w >> 1)) >> int(np.log2(w))
        elif have_left:
            dc = (left.sum(axis=1) + (h >> 1)) >> int(np.log2(h))
        else:
            dc = np.full(b, 1 << (bit_depth - 1), np.int64)
        return np.broadcast_to(dc[:, None, None], (b, h, w)).astype(np.int32)
    if mode == IntraMode.V:
        return np.broadcast_to(ar[:, None, :], (b, h, w)).astype(np.int32)
    if mode == IntraMode.H:
        return np.broadcast_to(left[:, :, None], (b, h, w)).astype(np.int32)
    if mode == IntraMode.SMOOTH:
        wh = _sm_weights(h).astype(np.int64)  # (h,)
        ww = _sm_weights(w).astype(np.int64)  # (w,)
        below = left[:, h - 1].astype(np.int64)[:, None, None]
        right = ar[:, w - 1].astype(np.int64)[:, None, None]
        a = ar.astype(np.int64)[:, None, :]
        l = left.astype(np.int64)[:, :, None]
        scale = 1 << SM_WEIGHT_LOG2
        p = (wh[None, :, None] * a + (scale - wh)[None, :, None] * below
             + ww[None, None, :] * l + (scale - ww)[None, None, :] * right)
        return ((p + (1 << SM_WEIGHT_LOG2)) >> (SM_WEIGHT_LOG2 + 1)).astype(np.int32)
    if mode == IntraMode.SMOOTH_V:
        wh = _sm_weights(h).astype(np.int64)
        below = left[:, h - 1].astype(np.int64)[:, None, None]
        a = ar.astype(np.int64)[:, None, :]
        scale = 1 << SM_WEIGHT_LOG2
        p = wh[None, :, None] * a + (scale - wh)[None, :, None] * below
        return ((p + (scale >> 1)) >> SM_WEIGHT_LOG2).astype(np.int32)
    if mode == IntraMode.SMOOTH_H:
        ww = _sm_weights(w).astype(np.int64)
        right = ar[:, w - 1].astype(np.int64)[:, None, None]
        l = left.astype(np.int64)[:, :, None]
        scale = 1 << SM_WEIGHT_LOG2
        p = ww[None, None, :] * l + (scale - ww)[None, None, :] * right
        return ((p + (scale >> 1)) >> SM_WEIGHT_LOG2).astype(np.int32)
    if mode == IntraMode.PAETH:
        a = ar.astype(np.int32)[:, None, :]
        l = left.astype(np.int32)[:, :, None]
        t = tl.astype(np.int32)[:, :, None]
        base = a + l - t
        pa = np.abs(base - a)
        pl = np.abs(base - l)
        pt = np.abs(base - t)
        # spec: left if pLeft<=pTop and pLeft<=pTopLeft; else top if
        # pTop<=pTopLeft; else topleft
        out = np.where((pl <= pa) & (pl <= pt), np.broadcast_to(l, base.shape),
                       np.where(pa <= pt, np.broadcast_to(a, base.shape),
                                np.broadcast_to(t, base.shape)))
        return out.astype(np.int32)
    raise NotImplementedError(f"intra mode {mode}")


# spec NEED_* per mode (extend_modes); used by the neighbor fill
_NEEDS = {
    IntraMode.DC: (True, True),
    IntraMode.V: (True, False),
    IntraMode.H: (False, True),
    IntraMode.SMOOTH: (True, True),
    IntraMode.SMOOTH_V: (True, True),
    IntraMode.SMOOTH_H: (True, True),
    IntraMode.PAETH: (True, True),
}

# spec Mode_To_Angle
MODE_TO_ANGLE = {
    IntraMode.V: 90, IntraMode.H: 180, IntraMode.D45: 45, IntraMode.D135: 135,
    IntraMode.D113: 113, IntraMode.D157: 157, IntraMode.D203: 203, IntraMode.D67: 67,
}
ANGLE_STEP = 3


def _dr_derivative(angle: int) -> int:
    return int(get("dr_intra_derivative")[angle])


def get_dx(angle: int) -> int:
    if 0 < angle < 90:
        return _dr_derivative(angle)
    if 90 < angle < 180:
        return _dr_derivative(180 - angle)
    return 1


def get_dy(angle: int) -> int:
    if 90 < angle < 180:
        return _dr_derivative(angle - 90)
    if 180 < angle < 270:
        return _dr_derivative(270 - angle)
    return 1


def dr_predict(p_angle: int, above_full: np.ndarray, left_full: np.ndarray,
               top_left: int, w: int, h: int, bit_depth: int = 8) -> np.ndarray:
    """Directional prediction (spec 7.11.2.4) for one block, upsample/edge
    filter disabled (seq.enable_intra_edge_filter = 0 in the stream).

    above_full: w+h entries (above row extended right);
    left_full: w+h entries (left col extended down); top_left scalar.
    """
    assert 0 < p_angle < 270
    if p_angle == 90:
        return np.broadcast_to(above_full[None, :w], (h, w)).astype(np.int32)
    if p_angle == 180:
        return np.broadcast_to(left_full[:h, None], (h, w)).astype(np.int32)
    maxv = (1 << bit_depth) - 1
    rr = np.arange(h)[:, None]
    cc = np.arange(w)[None, :]
    if p_angle < 90:  # zone 1: above only
        dx = get_dx(p_angle)
        x = (rr + 1) * dx
        base = (x >> 6) + cc
        shift = (x & 0x3F) >> 1
        max_base = w + h - 1
        b = np.minimum(base, max_base)
        b1 = np.minimum(base + 1, max_base)
        val = (above_full[b] * (32 - shift) + above_full[b1] * shift + 16) >> 5
        out = np.where(base >= max_base, above_full[max_base], val)
        return np.clip(out, 0, maxv).astype(np.int32)
    if p_angle > 180:  # zone 3: left only
        dy = get_dy(p_angle)
        y = (cc + 1) * dy
        base = (y >> 6) + rr
        shift = (y & 0x3F) >> 1
        max_base = w + h - 1
        b = np.minimum(base, max_base)
        b1 = np.minimum(base + 1, max_base)
        val = (left_full[b] * (32 - shift) + left_full[b1] * shift + 16) >> 5
        out = np.where(base >= max_base, left_full[max_base], val)
        return np.clip(out, 0, maxv).astype(np.int32)
    # zone 2: 90 < angle < 180, both edges + top-left
    dx = get_dx(p_angle)
    dy = get_dy(p_angle)
    # arrays indexed from -1: prepend top-left
    above_m1 = np.concatenate([[top_left], above_full[:w]]).astype(np.int64)
    left_m1 = np.concatenate([[top_left], left_full[:h]]).astype(np.int64)
    x = -(rr + 1) * dx
    base1 = (x >> 6) + cc  # >= -1 region uses above
    shift1 = (x & 0x3F) >> 1
    y = (rr << 6) - (cc + 1) * dy
    base2 = y >> 6
    shift2 = (y & 0x3F) >> 1
    ab = np.clip(base1, -1, w - 1) + 1
    ab1 = np.clip(base1 + 1, -1, w - 1) + 1
    va = (above_m1[ab] * (32 - np.broadcast_to(shift1, ab.shape))
          + above_m1[ab1] * np.broadcast_to(shift1, ab.shape) + 16) >> 5
    lb = np.clip(base2, -1, h - 1) + 1
    lb1 = np.clip(base2 + 1, -1, h - 1) + 1
    vl = (left_m1[lb] * (32 - shift2) + left_m1[lb1] * shift2 + 16) >> 5
    out = np.where(base1 >= -1, va, vl)
    return np.clip(out, 0, maxv).astype(np.int32)


def intra_has_top_right(bsize: int, mi_row: int, mi_col: int, have_top: bool,
                        right_available: bool, tx_size: int,
                        ss_x: int, ss_y: int, sb_mi: int = 16,
                        row_off: int = 0, col_off: int = 0,
                        vert_part: bool = False) -> bool:
    """Per-TU top-right availability — mirrors svt_aom_intra_has_top_right
    (intra_prediction.c:695) for the 64x64-SB case.
    row_off/col_off are the TU offsets within the block in plane 4px
    units (0,0 for whole-block TUs). `vert_part` selects the
    has_tr_vert_* order tables used for square blocks produced by
    PARTITION_VERT_A/VERT_B (intra_prediction.c:683-692)."""
    from ..codec.constants import BLOCK_H, BLOCK_W, TX_W

    if not have_top or not right_available:
        return False
    plane_bw_unit = max((int(BLOCK_W[bsize]) >> 2) >> ss_x, 1)
    tr_count = int(TX_W[tx_size]) >> 2
    if row_off > 0:
        # sub-64 blocks: just need enough already-coded pixels within the
        # block row above (intra_prediction.c:707-720)
        return col_off + tr_count < plane_bw_unit
    if col_off + tr_count < plane_bw_unit:
        return True
    bw_log2 = (int(BLOCK_W[bsize]) >> 2).bit_length() - 1
    bh_log2 = (int(BLOCK_H[bsize]) >> 2).bit_length() - 1
    blk_row = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_row == 0:
        return True
    if ((blk_col + 1) << bw_log2) >= sb_mi:
        return False
    idx = (blk_row << (5 - bw_log2)) + blk_col  # MAX_MIB_SIZE_LOG2 = 5
    w_px, h_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    pre = ("has_tr_vert_" if (vert_part and w_px == h_px and w_px <= 64)
           else "has_tr_")
    t = get(f"{pre}{w_px}x{h_px}")
    return bool((int(t[idx // 8]) >> (idx % 8)) & 1)


def intra_has_bottom_left(bsize: int, mi_row: int, mi_col: int,
                          bottom_available: bool, have_left: bool, tx_size: int,
                          ss_x: int, ss_y: int, sb_mi: int = 16,
                          row_off: int = 0, col_off: int = 0,
                          vert_part: bool = False) -> bool:
    """Mirrors svt_aom_intra_has_bottom_left (intra_prediction.c:950);
    row_off/col_off are TU offsets within the block in plane 4px units."""
    from ..codec.constants import BLOCK_H, BLOCK_W, TX_H

    if not bottom_available or not have_left:
        return False
    if col_off > 0:
        # bottom-left of an off-column TU is in the not-yet-coded
        # bottom-left TU (intra_prediction.c:973-975)
        return False
    plane_bh_unit = max((int(BLOCK_H[bsize]) >> 2) >> ss_y, 1)
    bl_count = int(TX_H[tx_size]) >> 2
    if row_off + bl_count < plane_bh_unit:
        return True
    bw_log2 = (int(BLOCK_W[bsize]) >> 2).bit_length() - 1
    bh_log2 = (int(BLOCK_H[bsize]) >> 2).bit_length() - 1
    blk_row = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_col == 0:
        row_off_in_sb = ((blk_row << bh_log2) >> ss_y) + row_off
        return row_off_in_sb + bl_count < (sb_mi >> ss_y)
    if ((blk_row + 1) << bh_log2) >= sb_mi:
        return False
    idx = (blk_row << (5 - bw_log2)) + blk_col
    w_px, h_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    pre = ("has_bl_vert_" if (vert_part and w_px == h_px and w_px <= 64)
           else "has_bl_")
    t = get(f"{pre}{w_px}x{h_px}")
    return bool((int(t[idx // 8]) >> (idx % 8)) & 1)


def fill_neighbors_dr(recon: np.ndarray, x: int, y: int, w: int, h: int,
                      have_above: bool, have_left: bool, have_tr: bool,
                      have_bl: bool, p_angle: int, bit_depth: int = 8):
    """Extended neighbor fill for directional modes (build_intra_predictors
    rules, edge filter/upsample off). Returns (above(w+h), left(w+h), tl)
    or a flat fill value via the early-exit rule."""
    base = 1 << (bit_depth - 1)
    need_above = p_angle < 180
    need_left = p_angle > 90
    n_top = w if have_above else 0
    n_left = h if have_left else 0
    ph, pw = recon.shape
    n_tr = min(w, max(pw - (x + w), 0)) if have_tr else 0
    n_bl = min(h, max(ph - (y + h), 0)) if have_bl else 0

    if (not need_above and n_left == 0) or (not need_left and n_top == 0):
        if need_left:
            val = int(recon[y - 1, x]) if n_top > 0 else base + 1
        else:
            val = int(recon[y, x - 1]) if n_left > 0 else base - 1
        return None, None, val

    need_bottom = p_angle > 180
    need_right = p_angle < 90
    left = np.empty(w + h, np.int64)
    above = np.empty(w + h, np.int64)
    num_left_needed = h + (w if need_bottom else 0)
    num_top_needed = w + (h if need_right else 0)
    if need_left:
        if n_left > 0:
            left[:h] = recon[y : y + h, x - 1]
            i = h
            if need_bottom and n_bl > 0:
                k = min(n_bl, w)  # only h+w entries are ever read
                left[h : h + k] = recon[y + h : y + h + k, x - 1]
                i += k
            if i < num_left_needed:
                left[i:num_left_needed] = left[i - 1]
        else:
            left[:num_left_needed] = recon[y - 1, x] if n_top > 0 else base + 1
    if need_above:
        if n_top > 0:
            above[:w] = recon[y - 1, x : x + w]
            i = w
            if need_right and n_tr > 0:
                k = min(n_tr, h)  # only w+h entries are ever read
                above[w : w + k] = recon[y - 1, x + w : x + w + k]
                i += k
            if i < num_top_needed:
                above[i:num_top_needed] = above[i - 1]
        else:
            above[:num_top_needed] = recon[y, x - 1] if n_left > 0 else base - 1
    # above-left (always needed for directional)
    if n_top > 0 and n_left > 0:
        tl = int(recon[y - 1, x - 1])
    elif n_top > 0:
        tl = int(recon[y - 1, x])
    elif n_left > 0:
        tl = int(recon[y, x - 1])
    else:
        tl = base
    return above, left, tl


def fill_neighbors(recon: np.ndarray, x: int, y: int, w: int, h: int,
                   have_above: bool, have_left: bool, mode: int,
                   bit_depth: int = 8) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Build (above(w+1 incl TL), left(h)) arrays per the spec fill rules
    for one tx block at (x, y) in `recon` (2D plane array).

    Returns (above, left, flat_fill) — if flat_fill is not None, the
    prediction is a constant fill (early-exit rule) with that value.
    """
    base = 1 << (bit_depth - 1)
    need_above, need_left = _NEEDS[IntraMode(mode)]
    n_top = w if have_above else 0
    n_left = h if have_left else 0

    # early exit: missing everything the mode needs on one side
    if (not need_above and n_left == 0) or (not need_left and n_top == 0):
        if need_left:
            val = int(recon[y - 1, x]) if n_top > 0 else base + 1
        else:
            val = int(recon[y, x - 1]) if n_left > 0 else base - 1
        return None, None, val

    above = np.empty(w + 1, np.int32)
    left = np.empty(h, np.int32)
    if n_left > 0:
        left[:] = recon[y : y + h, x - 1]
    else:
        left[:] = recon[y - 1, x] if n_top > 0 else base + 1
    if n_top > 0:
        above[1:] = recon[y - 1, x : x + w]
    else:
        above[1:] = recon[y, x - 1] if n_left > 0 else base - 1
    if n_top > 0 and n_left > 0:
        above[0] = recon[y - 1, x - 1]
    elif n_top > 0:
        above[0] = recon[y - 1, x]
    elif n_left > 0:
        above[0] = recon[y, x - 1]
    else:
        above[0] = base
    return above, left, None


# ---- recursive filter intra (spec 7.11.2.3) ---------------------------------

FILTER_INTRA_MODES = 5
# Filter_Intra_Mode_To_Intra_Dir (spec): direction used for tx-type
# derivation and the ext-tx CDF context when use_filter_intra is set
FI_MODE_TO_INTRA_DIR = (IntraMode.DC, IntraMode.V, IntraMode.H,
                        IntraMode.D157, IntraMode.DC)

_FI_TAPS = None


def _fi_taps() -> np.ndarray:
    global _FI_TAPS
    if _FI_TAPS is None:
        from ..bitstream.tables import load_tables

        _FI_TAPS = load_tables()["filter_intra_taps"].astype(np.int64)
    return _FI_TAPS


def filter_intra_predict(above: np.ndarray, left: np.ndarray, fi_mode: int,
                         w: int, h: int, bit_depth: int = 8) -> np.ndarray:
    """Recursive filter-intra prediction of one (h, w) block
    (svt_av1_filter_intra_predictor_c, C_DEFAULT/filterintra_c.c:70).

    above: (w+1,) incl top-left at [0]; left: (h,). 4x2 patches computed
    in raster order, each from 7 already-computed neighbors via the
    normative tap table."""
    taps = _fi_taps()[fi_mode][:, :7]  # (8, 7)
    buf = np.zeros((h + 1, w + 1), np.int64)
    buf[0, :] = above
    buf[1:, 0] = left
    maxv = (1 << bit_depth) - 1
    p = np.empty(7, np.int64)
    for r in range(1, h + 1, 2):
        row_a = buf[r - 1]
        for c in range(1, w + 1, 4):
            p[0:5] = row_a[c - 1 : c + 4]
            p[5] = buf[r, c - 1]
            p[6] = buf[r + 1, c - 1]
            v = taps @ p
            # ROUND_POWER_OF_TWO_SIGNED(v, FILTER_INTRA_SCALE_BITS=4)
            out = np.where(v < 0, -((-v + 8) >> 4), (v + 8) >> 4)
            buf[r : r + 2, c : c + 4] = np.clip(out, 0, maxv).reshape(2, 4)
    return buf[1:, 1:].astype(np.int32)


# ---- chroma from luma (spec 7.11.5) -----------------------------------------

UV_CFL = 13  # UV_CFL_PRED

def cfl_ac(luma_region: np.ndarray, cw: int, ch: int,
           ss_x: int, ss_y: int) -> np.ndarray:
    """Subsampled, <<3-scaled, average-removed luma (the CfL "AC"
    contribution; spec 7.11.5.2 luma AC process / cfl.c subsample +
    subtract_average). luma_region: (ch<<ss_y, cw<<ss_x) co-located
    reconstructed luma."""
    l64 = luma_region.astype(np.int64)
    if ss_x and ss_y:
        t = (l64[0::2, 0::2] + l64[0::2, 1::2]
             + l64[1::2, 0::2] + l64[1::2, 1::2]) << 1
    elif ss_x:
        t = (l64[:, 0::2] + l64[:, 1::2]) << 2
    else:
        t = l64 << 3
    npel_log2 = int(np.log2(cw * ch))
    avg = (int(t.sum()) + (1 << (npel_log2 - 1))) >> npel_log2
    return (t - avg).astype(np.int32)


def cfl_predict(dc_pred: np.ndarray, ac: np.ndarray, alpha_q3: int,
                bit_depth: int = 8) -> np.ndarray:
    """dc_pred + ROUND_POWER_OF_TWO_SIGNED(alpha_q3 * ac, 6), clipped
    (spec 7.11.5.3 / cfl.c cfl_predict)."""
    scaled = alpha_q3 * ac.astype(np.int64)
    v = np.where(scaled < 0, -((-scaled + 32) >> 6), (scaled + 32) >> 6)
    return np.clip(dc_pred.astype(np.int64) + v, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def cfl_joint_sign(alpha_u: int, alpha_v: int) -> int:
    """(signU * 3 + signV) - 1 with signs ZERO=0 NEG=1 POS=2."""
    def sgn(a):
        return 0 if a == 0 else (1 if a < 0 else 2)
    return sgn(alpha_u) * 3 + sgn(alpha_v) - 1


def cfl_context_u(joint_sign: int) -> int:
    return joint_sign + 1 - 3


def cfl_context_v(joint_sign: int) -> int:
    return ((joint_sign + 1) % 3) * 3 + ((joint_sign + 1) // 3) - 3
