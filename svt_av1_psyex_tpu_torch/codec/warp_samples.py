"""Warp sample collection + overlappable-neighbor counting.

Counterparts: av1_find_samples / record_samples
(adaptive_mv_pred.c:1388-1545) and svt_av1_count_overlappable_neighbors
(:1818) — the normative inputs to WARPED_CAUSAL parameter derivation
(spec 7.10.4) and to motion_mode coding eligibility. The decoder
re-runs both, so the scan rules must match exactly; dav1d round-trips
in tests/test_lwarp.py pin them.
"""

from __future__ import annotations

from .constants import BLOCK_H, BLOCK_W
from .mvp import MiState, _mvp_has_top_right

LEAST_SQUARES_SAMPLES_MAX = 8


def _record(mi: MiState, rr: int, cc: int, row_off: int, sign_r: int,
            col_off: int, sign_c: int, pts, pts_inref) -> None:
    b = int(mi.bsize[rr, cc])
    bw, bh = int(BLOCK_W[b]), int(BLOCK_H[b])
    x = col_off * 4 + sign_c * max(bw, 4) // 2 - 1
    y = row_off * 4 + sign_r * max(bh, 4) // 2 - 1
    pts.append((x * 8, y * 8))
    pts_inref.append((x * 8 + int(mi.mv_col[rr, cc]),
                      y * 8 + int(mi.mv_row[rr, cc])))


def find_warp_samples(mi: MiState, mi_row: int, mi_col: int, bsize: int,
                      rf0: int):
    """(pts, pts_inref) 1/8-pel sample pairs for a block (spec 7.10.4 /
    av1_find_samples). Neighbors qualify when single-ref == rf0."""
    n4_w = int(BLOCK_W[bsize]) >> 2
    n4_h = int(BLOCK_H[bsize]) >> 2
    pts: list = []
    ptsr: list = []
    do_tl = do_tr = True

    def qual(rr, cc):
        return (int(mi.ref_frame[rr, cc]) == rf0
                and int(mi.ref_frame1[rr, cc]) < 1)

    if mi_row > 0:
        rr = mi_row - 1
        nb_w = int(BLOCK_W[int(mi.bsize[rr, mi_col])]) >> 2
        if n4_w <= nb_w:
            col_off = -(mi_col % nb_w)
            if col_off < 0:
                do_tl = False
            if col_off + nb_w > n4_w:
                do_tr = False
            if qual(rr, mi_col):
                _record(mi, rr, mi_col, 0, -1, col_off, 1, pts, ptsr)
        else:
            i = 0
            while i < min(n4_w, mi.mi_cols - mi_col) \
                    and len(pts) < LEAST_SQUARES_SAMPLES_MAX:
                cc = mi_col + i
                nb_w = int(BLOCK_W[int(mi.bsize[rr, cc])]) >> 2
                if qual(rr, cc):
                    _record(mi, rr, cc, 0, -1, i, 1, pts, ptsr)
                i += min(n4_w, nb_w)
    if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
        return pts[:8], ptsr[:8]

    if mi_col > 0:
        cc = mi_col - 1
        nb_h = int(BLOCK_H[int(mi.bsize[mi_row, cc])]) >> 2
        if n4_h <= nb_h:
            row_off = -(mi_row % nb_h)
            if row_off < 0:
                do_tl = False
            if qual(mi_row, cc):
                _record(mi, mi_row, cc, row_off, 1, 0, -1, pts, ptsr)
        else:
            i = 0
            while i < min(n4_h, mi.mi_rows - mi_row) \
                    and len(pts) < LEAST_SQUARES_SAMPLES_MAX:
                rr = mi_row + i
                nb_h = int(BLOCK_H[int(mi.bsize[rr, cc])]) >> 2
                if qual(rr, cc):
                    _record(mi, rr, cc, i, 1, 0, -1, pts, ptsr)
                i += min(n4_h, nb_h)
    if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
        return pts[:8], ptsr[:8]

    if do_tl and mi_row > 0 and mi_col > 0:
        if qual(mi_row - 1, mi_col - 1):
            _record(mi, mi_row - 1, mi_col - 1, 0, -1, 0, -1, pts, ptsr)
    if len(pts) >= LEAST_SQUARES_SAMPLES_MAX:
        return pts[:8], ptsr[:8]

    if (do_tr and mi_row > 0
            and _mvp_has_top_right(mi_row, mi_col, max(n4_w, n4_h),
                                   n4_w, n4_h)
            and mi_col + n4_w < mi.mi_cols):
        rr, cc = mi_row - 1, mi_col + n4_w
        if qual(rr, cc):
            _record(mi, rr, cc, 0, -1, n4_w, 1, pts, ptsr)
    return pts[:8], ptsr[:8]


def count_overlappable(mi: MiState, mi_row: int, mi_col: int,
                       bsize: int) -> int:
    """Inter neighbors along the top row / left col (spec
    has_overlappable_candidates; adaptive_mv_pred.c:1758). 4-wide/tall
    neighbors are treated as chroma pairs (step 2, odd member)."""
    n4_w = int(BLOCK_W[bsize]) >> 2
    n4_h = int(BLOCK_H[bsize]) >> 2
    count = 0
    if mi_row > 0:
        rr = mi_row - 1
        end = min(mi_col + n4_w, mi.mi_cols)
        cc = mi_col
        while cc < end:
            step = min(int(BLOCK_W[int(mi.bsize[rr, cc])]) >> 2, 16)
            probe = cc
            if step == 1:
                probe = (cc & ~1) + 1
                step = 2
            if int(mi.ref_frame[rr, probe]) >= 1:
                count += 1
            cc += step
    if mi_col > 0:
        cc = mi_col - 1
        end = min(mi_row + n4_h, mi.mi_rows)
        rr = mi_row
        while rr < end:
            step = min(int(BLOCK_H[int(mi.bsize[rr, cc])]) >> 2, 16)
            probe = rr
            if step == 1:
                probe = (rr & ~1) + 1
                step = 2
            if int(mi.ref_frame[probe, cc]) >= 1:
                count += 1
            rr += step
    return count
