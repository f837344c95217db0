"""OBMC (OBMC_CAUSAL) causal-neighbor prediction blending.

Counterpart: av1_build_obmc_inter_prediction + foreach_overlappable_nb_*
(Source/Lib/Codec/enc_inter_prediction.c:666-1545).
The decoder rebuilds the same neighbor predictions from its recon refs,
so neighbor iteration, per-plane skip rules and blend order (above pass
then left pass, in place) are normative.
"""

from __future__ import annotations

import numpy as np

from ..ops.obmc import OBMC_MASKS, blend_hmask, blend_vmask
from .constants import BLOCK_H, BLOCK_W
from .mvp import MiState

# input: log2 of length/4 (0->4px .. 5->128px); enc_inter_prediction.c:668
MAX_NEIGHBOR_OBMC = (0, 1, 2, 3, 4, 4)


def _nb_above(mi: MiState, mi_row: int, mi_col: int, n4_w: int, nb_max: int):
    """[(rel_mi_col, nb_mi_width, probe_rr, probe_cc)] overlappable above
    neighbors (foreach_overlappable_nb_above)."""
    out = []
    if mi_row == 0:
        return out
    rr = mi_row - 1
    end = min(mi_col + n4_w, mi.mi_cols)
    cc = mi_col
    while cc < end and len(out) < nb_max:
        step = min(int(BLOCK_W[int(mi.bsize[rr, cc])]) >> 2, 16)
        probe = cc
        if step == 1:
            cc &= ~1
            probe = cc + 1
            step = 2
        if int(mi.ref_frame[rr, probe]) >= 1:
            out.append((cc - mi_col, min(n4_w, step), rr, probe))
        cc += step
    return out


def _nb_left(mi: MiState, mi_row: int, mi_col: int, n4_h: int, nb_max: int):
    out = []
    if mi_col == 0:
        return out
    cc = mi_col - 1
    end = min(mi_row + n4_h, mi.mi_rows)
    rr = mi_row
    while rr < end and len(out) < nb_max:
        step = min(int(BLOCK_H[int(mi.bsize[rr, cc])]) >> 2, 16)
        probe = rr
        if step == 1:
            rr &= ~1
            probe = rr + 1
            step = 2
        if int(mi.ref_frame[probe, cc]) >= 1:
            out.append((rr - mi_row, min(n4_h, step), probe, cc))
        rr += step
    return out


def _skip_u4x4(bsize: int, dir_: int, ss_x: int, ss_y: int) -> bool:
    """svt_av1_skip_u4x4_pred_in_obmc (one-sided chroma OBMC)."""
    pw = max(int(BLOCK_W[bsize]) >> ss_x, 4)
    ph = max(int(BLOCK_H[bsize]) >> ss_y, 4)
    if (pw, ph) in ((4, 4), (8, 4), (4, 8)):
        return dir_ == 0
    return False


def obmc_blend_plane(pred: np.ndarray, plane: int, mi: MiState,
                     mi_row: int, mi_col: int, bsize: int,
                     ref_planes: dict, bd: int, ss: tuple = (1, 1),
                     x_off: int = 0) -> np.ndarray:
    """Blend OBMC neighbor predictions into a copy of one plane's base
    prediction. ref_planes: {ref_id: plane list}; ss = chroma
    subsampling; x_off = tile x offset in luma px."""
    from ..ops.mc import mc_block

    bw, bh = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    n4_w, n4_h = bw >> 2, bh >> 2
    out = pred.astype(np.int64).copy()
    ssx = 0 if plane == 0 else ss[0]
    ssy = 0 if plane == 0 else ss[1]

    def nb_pred(ref_id, flt, mv, px, py, w, h):
        ref = ref_planes[ref_id][plane]
        return mc_block(ref, px, py, w, h, mv[0], mv[1], ssx, ssy,
                        flt, flt, bit_depth=bd).astype(np.int64)

    # above pass
    overlap = min(bh, 64) >> 1
    if not (plane > 0 and _skip_u4x4(bsize, 0, ssx, ssy)):
        for rel, nbw, rr, cc in _nb_above(mi, mi_row, mi_col, n4_w,
                                          MAX_NEIGHBOR_OBMC[
                                              (n4_w * 4).bit_length() - 3]):
            ref_id = int(mi.ref_frame[rr, cc])
            mv = (int(mi.mv_row[rr, cc]), int(mi.mv_col[rr, cc]))
            flt = int(mi.flt[rr, cc])
            w = (nbw * 4) >> ssx
            h = overlap >> ssy
            px = ((mi_col + rel) * 4 + x_off) >> ssx
            py = (mi_row * 4) >> ssy
            tmp = nb_pred(ref_id, flt, mv, px, py, w, h)
            reg = out[0:h, (rel * 4) >> ssx:((rel * 4) >> ssx) + w]
            blend_vmask(reg, tmp, OBMC_MASKS[h])

    # left pass (reads the above-blended result — order is normative)
    overlap = min(bw, 64) >> 1
    if not (plane > 0 and _skip_u4x4(bsize, 1, ssx, ssy)):
        for rel, nbh, rr, cc in _nb_left(mi, mi_row, mi_col, n4_h,
                                         MAX_NEIGHBOR_OBMC[
                                             (n4_h * 4).bit_length() - 3]):
            ref_id = int(mi.ref_frame[rr, cc])
            mv = (int(mi.mv_row[rr, cc]), int(mi.mv_col[rr, cc]))
            flt = int(mi.flt[rr, cc])
            w = overlap >> ssx
            h = (nbh * 4) >> ssy
            px = (mi_col * 4 + x_off) >> ssx
            py = ((mi_row + rel) * 4) >> ssy
            tmp = nb_pred(ref_id, flt, mv, px, py, w, h)
            reg = out[(rel * 4) >> ssy:((rel * 4) >> ssy) + h, 0:w]
            blend_hmask(reg, tmp, OBMC_MASKS[w])
    return out.astype(np.int32)
