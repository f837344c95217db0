"""Motion vector predictor stack (spec 7.10.2 find_mv_stack) — single and
compound reference paths, no temporal MVs (seq.enable_ref_frame_mvs = 0).

Mirrors the normative derivation the decoder performs
(adaptive_mv_pred.c setup_ref_mv_list:637): row/col scans with weights,
top-right/top-left block scans, REF_CAT_LEVEL promotion, mode-context
derivation, bubble sort, relaxed rescan (single: sign-bias-flipped
extension, adaptive_mv_pred.c:570; compound: ref_id/ref_diff comp_list,
:470), MV clamping. Any divergence desynchronizes NEWMV coding —
validated by dav1d e2e.

Candidates are (mv0, mv1) pairs throughout; single-ref stacks carry a
zero mv1. Blocks record both references (compound neighbors feed single
stacks through either component).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import BLOCK_H, BLOCK_W

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
REF_CAT_LEVEL = 640
MVREF_ROWS = 3
MV_BORDER = 16 << 3

# mode context bit layout
GLOBALMV_OFFSET = 3
REFMV_OFFSET = 4
NEWMV_CTX_MASK = (1 << GLOBALMV_OFFSET) - 1
GLOBALMV_CTX_MASK = (1 << (REFMV_OFFSET - GLOBALMV_OFFSET)) - 1
REFMV_CTX_MASK = (1 << (8 - REFMV_OFFSET)) - 1

ZERO = (0, 0)


@dataclass
class MvStack:
    mvs: list = field(default_factory=list)  # [(row, col)] in 1/8 pel (ref0)
    comp_mvs: list = field(default_factory=list)  # ref1 component (compound)
    weights: list = field(default_factory=list)
    mode_context: int = 0
    # true refmv_count: the single-ref gm padding fills stack slots WITHOUT
    # incrementing the count (scan_row_col_light tail), and DRL coding
    # depends on the true count
    count: int = 0

    def drl_ctx(self, idx: int) -> int:
        """av1_drl_ctx: context for the drl bit between idx and idx+1."""
        if self.weights[idx] >= REF_CAT_LEVEL and self.weights[idx + 1] >= REF_CAT_LEVEL:
            return 0
        if self.weights[idx] >= REF_CAT_LEVEL and self.weights[idx + 1] < REF_CAT_LEVEL:
            return 1
        return 2


class MiState:
    """Per-4x4 inter mode info grids (MD-local and writer-local copies)."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.ref_frame = np.full((mi_rows, mi_cols), -1, np.int8)  # -1 = intra
        self.ref_frame1 = np.full((mi_rows, mi_cols), -1, np.int8)
        self.mv_row = np.zeros((mi_rows, mi_cols), np.int16)
        self.mv_col = np.zeros((mi_rows, mi_cols), np.int16)
        self.mv_row1 = np.zeros((mi_rows, mi_cols), np.int16)
        self.mv_col1 = np.zeros((mi_rows, mi_cols), np.int16)
        self.is_newmv = np.zeros((mi_rows, mi_cols), np.int8)
        # block coded GLOBALMV/GLOBAL_GLOBALMV (is_global_mv_block input)
        self.is_gmv = np.zeros((mi_rows, mi_cols), np.int8)
        # interpolation filter per block (OBMC neighbor predictions)
        self.flt = np.zeros((mi_rows, mi_cols), np.int8)
        self.bsize = np.zeros((mi_rows, mi_cols), np.int8)
        # RefFrameSignBias per named ref (spec 5.9.2 set_frame_refs /
        # 7.8: bias = ref order hint after the current frame); used by the
        # relaxed rescan to flip opposite-direction candidate MVs
        self.sign_bias = np.zeros(8, bool)
        # MFMV (spec 7.9): projected temporal motion field + per-named-ref
        # cur-frame order-hint offsets (codec/mfmv.py); None = mfmv off
        self.tpl = None
        self.tpl_cur_off = np.zeros(8, np.int32)

    _GRIDS = ("ref_frame", "ref_frame1", "mv_row", "mv_col", "mv_row1",
              "mv_col1", "is_newmv", "is_gmv", "flt", "bsize")

    def set_block(self, r: int, c: int, bsize: int, ref_frame: int,
                  mv: tuple[int, int], is_newmv: bool,
                  ref_frame1: int = -1, mv1: tuple[int, int] = ZERO,
                  is_gmv: bool = False, interp_filter: int = 0) -> None:
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        r1 = min(r + bh4, self.mi_rows)
        c1 = min(c + bw4, self.mi_cols)
        self.ref_frame[r:r1, c:c1] = ref_frame
        self.ref_frame1[r:r1, c:c1] = ref_frame1
        self.mv_row[r:r1, c:c1] = mv[0]
        self.mv_col[r:r1, c:c1] = mv[1]
        self.mv_row1[r:r1, c:c1] = mv1[0]
        self.mv_col1[r:r1, c:c1] = mv1[1]
        self.is_newmv[r:r1, c:c1] = 1 if is_newmv else 0
        self.is_gmv[r:r1, c:c1] = 1 if is_gmv else 0
        self.flt[r:r1, c:c1] = interp_filter
        self.bsize[r:r1, c:c1] = bsize

    def save(self, r, c, bsize):
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        r1 = min(r + bh4, self.mi_rows)
        c1 = min(c + bw4, self.mi_cols)
        return tuple(getattr(self, g)[r:r1, c:c1].copy() for g in self._GRIDS)

    def restore(self, r, c, bsize, st):
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        r1 = min(r + bh4, self.mi_rows)
        c1 = min(c + bw4, self.mi_cols)
        for g, s in zip(self._GRIDS, st):
            getattr(self, g)[r:r1, c:c1] = s

    def cand_refs(self, rr: int, cc: int):
        """[(ref, (mvr, mvc))] for both components of the candidate.
        ref 0 = INTRA_FRAME (intra-BC blocks carrying a DV); plain intra
        blocks store -1 and never match."""
        out = []
        r0 = int(self.ref_frame[rr, cc])
        if r0 >= 0:
            out.append((r0, (int(self.mv_row[rr, cc]), int(self.mv_col[rr, cc]))))
        r1 = int(self.ref_frame1[rr, cc])
        if r1 >= 1:
            out.append((r1, (int(self.mv_row1[rr, cc]), int(self.mv_col1[rr, cc]))))
        return out


def _mvp_has_top_right(mi_row: int, mi_col: int, bs: int, n8_w: int, n8_h: int,
                       sb_mi: int = 16) -> bool:
    """MVP-specific has_top_right (adaptive_mv_pred.c:266)."""
    if bs > 16:  # mi_size_wide[BLOCK_64X64]
        return False
    # is_sec_rect: the later-coded rect of a HORZ/VERT pair (libaom rule:
    # derived from position within the enclosing square)
    if n8_w != n8_h:
        is_sec_rect = False
        # vertical rects: only the child whose RIGHT edge aligns to the
        # enclosing square is second (VERT_4 gives 0,0,0,1 — libaom
        # is_sec_rect rule, mi_col + width, not mi_col)
        if n8_w < n8_h and not ((mi_col + n8_w) & (n8_h - 1)):
            is_sec_rect = True
        if n8_w > n8_h and (mi_row & (n8_w - 1)):
            is_sec_rect = True
        if n8_w > n8_h and is_sec_rect:
            return False  # bottom of two horizontal rects: no TR
        if n8_w < n8_h and not is_sec_rect:
            return True  # left of two vertical rects: always TR
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    while bs < sb_mi:
        if mask_col & bs:
            if (mask_col & (2 * bs)) and (mask_row & (2 * bs)):
                has_tr = False
                break
        else:
            break
        bs <<= 1
    return has_tr


_MVP_LIB = None  # resolved lazily; False = unavailable / disabled


def _mvp_lib():
    global _MVP_LIB
    if _MVP_LIB is None:
        import ctypes
        import os

        from ..native.ecenc import get_lib

        lib = get_lib()
        if (lib is None or not hasattr(lib, "svt_find_mv_stack")
                or os.environ.get("SVT_TPU_PY_MVP") == "1"):
            _MVP_LIB = False
        else:
            lib.svt_find_mv_stack.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
                + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
            _MVP_LIB = lib
    return _MVP_LIB


def find_mv_stack(mi: MiState, mi_row: int, mi_col: int, bsize: int,
                  ref_frame, gm_mv=None, gm_warp: bool = False) -> MvStack:
    """MVP stack for a single ref (int) or a compound pair (tuple).
    gm_mv: ((row0, col0), (row1, col1)) 1/8-pel GLOBALMV candidates of
    THIS block per ref list (spec 7.10.2.2 padding uses GlobalMvs);
    None = identity gm -> (0, 0).

    Dispatches to the C port (native/mvp.c) when built; the Python body
    below is the oracle (SVT_TPU_PY_MVP=1), fuzzed for equality by
    tests/test_native_mvp.py."""
    lib = _mvp_lib()
    g0, g1 = (gm_mv if gm_mv is not None else (ZERO, ZERO))
    if ref_frame == 0:
        lib = None  # INTRA_FRAME (intra-BC DV stack): python path only
    if lib:
        is_comp = isinstance(ref_frame, tuple)
        rf0, rf1 = ref_frame if is_comp else (int(ref_frame), -1)
        out = np.empty(43, np.int32)
        tpl = mi.tpl
        if tpl is not None:
            if not hasattr(tpl, "_valid_u8"):
                tpl._valid_u8 = tpl.valid.astype(np.uint8)
            tv = tpl._valid_u8.ctypes.data
            tr = tpl.mfmv_row.ctypes.data
            tc = tpl.mfmv_col.ctypes.data
            to = tpl.ref_off.ctypes.data
            co0 = int(mi.tpl_cur_off[rf0])
            co1 = int(mi.tpl_cur_off[rf1]) if is_comp else 0
        else:
            tv = tr = tc = to = None
            co0 = co1 = 0
        lib.svt_find_mv_stack(
            mi.ref_frame.ctypes.data, mi.ref_frame1.ctypes.data,
            mi.mv_row.ctypes.data, mi.mv_col.ctypes.data,
            mi.mv_row1.ctypes.data, mi.mv_col1.ctypes.data,
            mi.is_newmv.ctypes.data, mi.is_gmv.ctypes.data,
            mi.bsize.ctypes.data,
            mi.sign_bias.ctypes.data, mi.mi_rows, mi.mi_cols,
            mi_row, mi_col, int(bsize), rf0, rf1,
            int(g0[0]), int(g0[1]), int(g1[0]), int(g1[1]),
            1 if gm_warp else 0, tv, tr, tc, to, co0, co1,
            out.ctypes.data)
        slots = int(out[42])
        ent = out[2 : 2 + 40].reshape(8, 5)
        return MvStack(
            mvs=[(int(ent[i, 0]), int(ent[i, 1])) for i in range(slots)],
            comp_mvs=[(int(ent[i, 2]), int(ent[i, 3]))
                      for i in range(slots)],
            weights=[int(ent[i, 4]) for i in range(slots)],
            mode_context=int(out[1]), count=int(out[0]))
    return _find_mv_stack_py(mi, mi_row, mi_col, bsize, ref_frame,
                             (g0, g1), gm_warp)


def _find_mv_stack_py(mi: MiState, mi_row: int, mi_col: int, bsize: int,
                      ref_frame, gm_mv=(ZERO, ZERO),
                      gm_warp: bool = False) -> MvStack:
    """Pure-Python MVP stack derivation (the conformance oracle)."""
    is_comp = isinstance(ref_frame, tuple)
    rf = ref_frame if is_comp else (int(ref_frame), -1)
    n8_w = int(BLOCK_W[bsize]) >> 2
    n8_h = int(BLOCK_H[bsize]) >> 2
    bs = max(n8_w, n8_h)

    stack: list[tuple] = []  # entries: (mv0, mv1)
    weights: list[int] = []

    up_avail = mi_row > 0
    left_avail = mi_col > 0
    max_row_offset = 0
    max_col_offset = 0
    # sub-8x8 blocks at odd mi positions shift the outer-scan offsets
    # (adaptive_mv_pred.c:645-671 row_adj/col_adj + the n8<2 clamp to -4)
    row_adj = 1 if (n8_h < 2 and (mi_row & 1)) else 0
    col_adj = 1 if (n8_w < 2 and (mi_col & 1)) else 0
    if up_avail:
        max_row_offset = -(MVREF_ROWS << 1) + row_adj
        if n8_h < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = max(max_row_offset, -mi_row)
    if left_avail:
        max_col_offset = -(MVREF_ROWS << 1) + col_adj
        if n8_w < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = max(max_col_offset, -mi_col)

    counts = {"row_match": 0, "col_match": 0, "newmv": 0}
    processed = {"rows": 0, "cols": 0}

    def push(entry, weight):
        for i, e in enumerate(stack):
            if e == entry:
                weights[i] += weight
                return
        if len(stack) < MAX_REF_MV_STACK_SIZE:
            stack.append(entry)
            weights.append(weight)

    def add_candidate(rr: int, cc: int, length: int, weight: int, newmv_key: str,
                      count_newmv: bool = True):
        if mi.ref_frame[rr, cc] < 0:
            return
        # is_global_mv_block: GLOBAL-mode neighbors >= 8x8 contribute the
        # CURRENT block's GlobalMvs when GmType[rf[0]] > TRANSLATION
        cb = int(mi.bsize[rr, cc])
        sub = (gm_warp and mi.is_gmv[rr, cc]
               and min(int(BLOCK_W[cb]), int(BLOCK_H[cb])) >= 8)
        matched = False
        if is_comp:
            if (int(mi.ref_frame[rr, cc]) == rf[0]
                    and int(mi.ref_frame1[rr, cc]) == rf[1]):
                mv0 = gm_mv[0] if sub else (int(mi.mv_row[rr, cc]),
                                            int(mi.mv_col[rr, cc]))
                mv1 = gm_mv[1] if sub else (int(mi.mv_row1[rr, cc]),
                                            int(mi.mv_col1[rr, cc]))
                push((mv0, mv1), weight * length)
                matched = True
        else:
            for can_rf, mv in mi.cand_refs(rr, cc):
                if can_rf == rf[0]:
                    push((gm_mv[0] if sub else mv, ZERO), weight * length)
                    matched = True
        if matched:
            if count_newmv and mi.is_newmv[rr, cc]:
                counts["newmv"] += 1
            counts[newmv_key] += 1

    def scan_row(row_offset: int, count_newmv: bool = True):
        end_mi = min(n8_w, mi.mi_cols - mi_col, 16)
        # distant rows read one column right, except 4-wide blocks at odd
        # mi_col (adaptive_mv_pred.c scan_row_mbmi:135-139)
        col_off = 1 if abs(row_offset) > 1 else 0
        if col_off and (mi_col & 1) and n8_w < 2:
            col_off = 0
        use_step_16 = n8_w >= 16
        i = 0
        rr = mi_row + row_offset
        while i < end_mi:
            cc = mi_col + col_off + i
            if cc >= mi.mi_cols:  # spec is_inside break
                break
            cand_bsize = int(mi.bsize[rr, cc])
            cand_w = int(BLOCK_W[cand_bsize]) >> 2
            length = min(n8_w, cand_w)
            if use_step_16:
                length = max(4, length)
            elif abs(row_offset) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= n8_w <= cand_w:
                inc = min(-max_row_offset + row_offset + 1,
                          int(BLOCK_H[cand_bsize]) >> 2)
                weight = max(weight, inc)
                processed["rows"] = inc - row_offset - 1
            add_candidate(rr, cc, length, weight, "row_match", count_newmv)
            i += length

    def scan_col(col_offset: int, count_newmv: bool = True):
        end_mi = min(n8_h, mi.mi_rows - mi_row, 16)
        # mirror of scan_row's odd-position adjustment for 4-tall blocks
        # (adaptive_mv_pred.c scan_col_mbmi:194-198)
        row_off = 1 if abs(col_offset) > 1 else 0
        if row_off and (mi_row & 1) and n8_h < 2:
            row_off = 0
        use_step_16 = n8_h >= 16
        i = 0
        cc = mi_col + col_offset
        while i < end_mi:
            rr = mi_row + row_off + i
            if rr >= mi.mi_rows:  # spec is_inside break
                break
            cand_bsize = int(mi.bsize[rr, cc])
            cand_h = int(BLOCK_H[cand_bsize]) >> 2
            length = min(n8_h, cand_h)
            if use_step_16:
                length = max(4, length)
            elif abs(col_offset) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= n8_h <= cand_h:
                inc = min(-max_col_offset + col_offset + 1,
                          int(BLOCK_W[cand_bsize]) >> 2)
                weight = max(weight, inc)
                processed["cols"] = inc - col_offset - 1
            add_candidate(rr, cc, length, weight, "col_match", count_newmv)
            i += length

    def scan_blk(row_offset: int, col_offset: int, key: str, count_newmv: bool = True):
        rr, cc = mi_row + row_offset, mi_col + col_offset
        if rr < 0 or cc < 0 or rr >= mi.mi_rows or cc >= mi.mi_cols:
            return
        add_candidate(rr, cc, 2, 2, key, count_newmv)  # len = 8x8 mi width

    if abs(max_row_offset) >= 1:
        scan_row(-1)
    if abs(max_col_offset) >= 1:
        scan_col(-1)
    if _mvp_has_top_right(mi_row, mi_col, bs, n8_w, n8_h):
        scan_blk(-1, n8_w, "row_match")

    nearest_match = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    newmv_count = counts["newmv"]
    for i in range(len(weights)):
        weights[i] += REF_CAT_LEVEL

    # temporal MV scan (MFMV, add_tpl_ref_mv adaptive_mv_pred.c:340):
    # projected weight-2 candidates after the REF_CAT_LEVEL boost
    gm_ctx_bit = 0
    if mi.tpl is not None:
        from .mfmv import MAX_FRAME_DISTANCE, lower_mv_precision, mv_projection

        tpl = mi.tpl
        cur_off0 = int(mi.tpl_cur_off[rf[0]])
        cur_off1 = int(mi.tpl_cur_off[rf[1]]) if is_comp else 0

        def tpl_mv(blk_row: int, blk_col: int, cur_off: int):
            """Projected MV at one sample position, or None."""
            pos_r = blk_row if (mi_row & 1) else blk_row + 1
            pos_c = blk_col if (mi_col & 1) else blk_col + 1
            rr, cc = mi_row + pos_r, mi_col + pos_c
            if rr < 0 or cc < 0 or rr >= mi.mi_rows or cc >= mi.mi_cols:
                return None
            t_r, t_c = rr >> 1, cc >> 1
            if not tpl.valid[t_r, t_c]:
                return None
            pr, pc = mv_projection(
                np.array([int(tpl.mfmv_row[t_r, t_c])]),
                np.array([int(tpl.mfmv_col[t_r, t_c])]),
                cur_off, np.array([int(tpl.ref_off[t_r, t_c])]))
            return lower_mv_precision(int(pr[0]), int(pc[0]), False)

        def add_tpl(blk_row: int, blk_col: int) -> bool:
            nonlocal gm_ctx_bit
            this = tpl_mv(blk_row, blk_col, cur_off0)
            if this is None:
                return False
            if not is_comp:
                if blk_row == 0 and blk_col == 0:
                    if (abs(this[0] - gm_mv[0][0]) >= 16
                            or abs(this[1] - gm_mv[0][1]) >= 16):
                        gm_ctx_bit = 1
                push((this, ZERO), 2)
            else:
                comp = tpl_mv(blk_row, blk_col, cur_off1)
                if blk_row == 0 and blk_col == 0:
                    if (abs(this[0] - gm_mv[0][0]) >= 16
                            or abs(this[1] - gm_mv[0][1]) >= 16
                            or abs(comp[0] - gm_mv[1][0]) >= 16
                            or abs(comp[1] - gm_mv[1][1]) >= 16):
                        gm_ctx_bit = 1
                push((this, comp), 2)
            return True

        blk_row_end = min(n8_h, 16)
        blk_col_end = min(n8_w, 16)
        step_h = 4 if n8_h >= 16 else 2
        step_w = 4 if n8_w >= 16 else 2
        is_available = False
        for blk_row in range(0, blk_row_end, step_h):
            for blk_col in range(0, blk_col_end, step_w):
                ret = add_tpl(blk_row, blk_col)
                if blk_row == 0 and blk_col == 0:
                    is_available = ret
        if not is_available:
            gm_ctx_bit = 1
        if 2 <= n8_h < 16 and 2 <= n8_w < 16:
            voff = max(2, n8_h)
            hoff = max(2, n8_w)
            for blk_row, blk_col in ((voff, -2), (voff, hoff),
                                     (voff - 2, hoff)):
                # check_sb_border (64x64 SB bounds)
                row = (mi_row & 15) + blk_row
                col = (mi_col & 15) + blk_col
                if 0 <= row < 16 and 0 <= col < 16:
                    add_tpl(blk_row, blk_col)

    # top-left + outer scans use a dummy newmv counter (setup_ref_mv_list:841)
    scan_blk(-1, -1, "row_match", count_newmv=False)
    for idx in range(2, MVREF_ROWS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if abs(row_offset) <= abs(max_row_offset) and abs(row_offset) > processed["rows"]:
            scan_row(row_offset, count_newmv=False)
        if abs(col_offset) <= abs(max_col_offset) and abs(col_offset) > processed["cols"]:
            scan_col(col_offset, count_newmv=False)

    ref_match_count = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    mode_context = gm_ctx_bit << GLOBALMV_OFFSET
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_context |= 1
        if ref_match_count == 1:
            mode_context |= 1 << REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 2 << REFMV_OFFSET
    elif nearest_match == 1:
        mode_context |= 2 if newmv_count > 0 else 3
        if ref_match_count == 1:
            mode_context |= 3 << REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 4 << REFMV_OFFSET
    else:
        mode_context |= 4 if newmv_count >= 1 else 5
        mode_context |= 5 << REFMV_OFFSET

    # bubble-sort by weight (stable order identical to sort_mvp_table)
    length = len(stack)
    while length > 0:
        nr_len = 0
        for idx in range(1, length):
            if weights[idx - 1] < weights[idx]:
                stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                weights[idx - 1], weights[idx] = weights[idx], weights[idx - 1]
                nr_len = idx
        length = nr_len

    true_count = len(stack)
    mi_width = min(16, n8_w, mi.mi_cols - mi_col)
    mi_height = min(16, n8_h, mi.mi_rows - mi_row)
    mi_size = min(mi_width, mi_height)

    if is_comp and true_count < MAX_MV_REF_CANDIDATES:
        # compound relaxed rescan (adaptive_mv_pred.c:470): collect same-ref
        # (ref_id) and other-ref sign-adjusted (ref_diff) components, build
        # comp_list, top up the stack
        ref_id = [[], []]
        ref_diff = [[], []]

        def collect(rr, cc):
            for can_rf, mv in mi.cand_refs(rr, cc):
                for cmp_idx in range(2):
                    if can_rf == rf[cmp_idx] and len(ref_id[cmp_idx]) < 2:
                        ref_id[cmp_idx].append(mv)
                    elif len(ref_diff[cmp_idx]) < 2:
                        # flip into a local: the raw mv must stay intact for
                        # the other component's pass (adaptive_mv_pred.c:497
                        # uses a local this_mv)
                        if bool(mi.sign_bias[can_rf]) != bool(mi.sign_bias[rf[cmp_idx]]):
                            ref_diff[cmp_idx].append((-mv[0], -mv[1]))
                        else:
                            ref_diff[cmp_idx].append(mv)

        if abs(max_row_offset) >= 1:
            i = 0
            while i < mi_size:
                rr, cc = mi_row - 1, mi_col + i
                collect(rr, cc)
                i += int(BLOCK_W[int(mi.bsize[rr, cc])]) >> 2
        if abs(max_col_offset) >= 1:
            i = 0
            while i < mi_size:
                rr, cc = mi_row + i, mi_col - 1
                collect(rr, cc)
                i += int(BLOCK_H[int(mi.bsize[rr, cc])]) >> 2

        comp_list = [[ZERO, ZERO] for _ in range(MAX_MV_REF_CANDIDATES + 1)]
        for idx in range(2):
            ci = 0
            for mv in ref_id[idx]:
                if ci >= MAX_MV_REF_CANDIDATES:
                    break
                comp_list[ci][idx] = mv
                ci += 1
            for mv in ref_diff[idx]:
                if ci >= MAX_MV_REF_CANDIDATES:
                    break
                comp_list[ci][idx] = mv
                ci += 1
            while ci < MAX_MV_REF_CANDIDATES:
                comp_list[ci][idx] = gm_mv[idx]  # gm candidate
                ci += 1

        if true_count == 1:
            if (comp_list[0][0], comp_list[0][1]) == stack[0]:
                stack.append((comp_list[1][0], comp_list[1][1]))
            else:
                stack.append((comp_list[0][0], comp_list[0][1]))
            weights.append(2)
            true_count = 2
        elif true_count == 0:
            for idx in range(MAX_MV_REF_CANDIDATES):
                stack.append((comp_list[idx][0], comp_list[idx][1]))
                weights.append(2)
            true_count = MAX_MV_REF_CANDIDATES
    elif not is_comp and true_count < MAX_MV_REF_CANDIDATES:
        # single-ref relaxed rescan (adaptive_mv_pred.c:570)
        bias_us = bool(mi.sign_bias[rf[0]])

        def extend(rr, cc):
            # BOTH components of the candidate are processed even when
            # the stack reaches 2 mid-block: the `< MAX_MV_REF_CANDIDATES`
            # gate is per BLOCK (the outer scan loop), not per component
            # (adaptive_mv_pred.c:1007-1037) — a compound neighbor can
            # push the count to 3, which changes the decoder's DRL read
            # (found by tools/mvp_fuzz.py; the 720p p8 compound desync)
            for can_rf, mv in mi.cand_refs(rr, cc):
                if len(stack) >= MAX_REF_MV_STACK_SIZE:
                    return
                if bool(mi.sign_bias[can_rf]) != bias_us:
                    mv = (-mv[0], -mv[1])
                entry = (mv, ZERO)
                if entry not in stack:
                    stack.append(entry)
                    weights.append(2)

        if abs(max_row_offset) >= 1:
            i = 0
            while i < mi_size and len(stack) < MAX_MV_REF_CANDIDATES:
                rr, cc = mi_row - 1, mi_col + i
                extend(rr, cc)
                i += int(BLOCK_W[int(mi.bsize[rr, cc])]) >> 2
        if abs(max_col_offset) >= 1:
            i = 0
            while i < mi_size and len(stack) < MAX_MV_REF_CANDIDATES:
                rr, cc = mi_row + i, mi_col - 1
                extend(rr, cc)
                i += int(BLOCK_H[int(mi.bsize[rr, cc])]) >> 2
        true_count = len(stack)  # relaxed rescan DOES increment count
        while len(stack) < MAX_MV_REF_CANDIDATES:
            # slot filled with GlobalMvs[0], count NOT incremented
            stack.append((gm_mv[0], ZERO))
            weights.append(0)

    # clamp (spec clamp_mv_ref: within frame + border, block-relative),
    # applied to the true-count entries only
    bw_px = n8_w * 4
    bh_px = n8_h * 4
    lo_col = -(mi_col * 4 * 8) - bw_px * 8 - MV_BORDER
    hi_col = (mi.mi_cols - n8_w - mi_col) * 4 * 8 + bw_px * 8 + MV_BORDER
    lo_row = -(mi_row * 4 * 8) - bh_px * 8 - MV_BORDER
    hi_row = (mi.mi_rows - n8_h - mi_row) * 4 * 8 + bh_px * 8 + MV_BORDER

    def cl(mv):
        return (int(np.clip(mv[0], lo_row, hi_row)),
                int(np.clip(mv[1], lo_col, hi_col)))

    mvs0 = [cl(e[0]) if i < true_count else e[0] for i, e in enumerate(stack)]
    mvs1 = [cl(e[1]) if i < true_count else e[1] for i, e in enumerate(stack)]

    return MvStack(mvs=mvs0, comp_mvs=mvs1, weights=weights,
                   mode_context=mode_context, count=true_count)


# ---- intra block copy (DV) helpers -----------------------------------------

INTRABC_DELAY_PIXELS = 256
INTRABC_DELAY_SB64 = INTRABC_DELAY_PIXELS // 64


def find_dv_ref(mi: MiState, mi_row: int, mi_col: int, bsize: int,
                mi_rows: int, mi_cols: int, sb_mi: int = 16):
    """DV prediction (mode_decision.c:3415-3423 + svt_aom_find_ref_dv):
    nearest nonzero of the INTRA_FRAME stack, else the near candidate,
    else the fixed fallback DV (one SB up, or one SB + delay left when
    on the first SB row). Units: 1/8 pel."""
    stack = find_mv_stack(mi, mi_row, mi_col, bsize, 0)
    nearest = tuple(stack.mvs[0])
    near = tuple(stack.mvs[1]) if stack.count >= 2 else (0, 0)
    dv = nearest if nearest != (0, 0) else near
    if dv == (0, 0):
        if mi_row - sb_mi < 0:
            dv = (0, (-4 * sb_mi - INTRABC_DELAY_PIXELS) * 8)
        else:
            dv = (-4 * sb_mi * 8, 0)
    return dv


def dv_valid(dv, mi_row: int, mi_col: int, bsize: int,
             mi_rows: int, mi_cols: int, has_chroma: bool = True) -> bool:
    """av1_is_dv_valid mirror (adaptive_mv_pred.c:1832-1903), 64px SBs,
    single tile spanning the frame. dv in 1/8-pel (row, col)."""
    from .constants import BLOCK_H, BLOCK_W

    bw = int(BLOCK_W[bsize])
    bh = int(BLOCK_H[bsize])
    if (dv[0] | dv[1]) & 7:
        return False  # DVs are full-pel
    s = 8
    src_top = mi_row * 4 * s + dv[0]
    src_left = mi_col * 4 * s + dv[1]
    if src_top < 0 or src_left < 0:
        return False
    src_bottom = (mi_row * 4 + bh) * s + dv[0]
    src_right = (mi_col * 4 + bw) * s + dv[1]
    if src_bottom > mi_rows * 4 * s or src_right > mi_cols * 4 * s:
        return False
    if has_chroma:
        if bw < 8 and src_left < 4 * s:
            return False
        if bh < 8 and src_top < 4 * s:
            return False
    active_sb_row = mi_row >> 4
    active_sb64_col = (mi_col * 4) >> 6
    src_sb_row = ((src_bottom >> 3) - 1) // 64
    src_sb64_col = ((src_right >> 3) - 1) >> 6
    total = ((mi_cols - 1) >> 4) + 1
    active_sb64 = active_sb_row * total + active_sb64_col
    src_sb64 = src_sb_row * total + src_sb64_col
    if src_sb64 >= active_sb64 - INTRABC_DELAY_SB64:
        return False
    gradient = 1 + INTRABC_DELAY_SB64
    wf = gradient * (active_sb_row - src_sb_row)
    if (src_sb_row > active_sb_row
            or src_sb64_col >= active_sb64_col - INTRABC_DELAY_SB64 + wf):
        return False
    if src_sb64_col > active_sb64_col + (active_sb_row - src_sb_row):
        return False
    return True
