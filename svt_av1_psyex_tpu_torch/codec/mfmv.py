"""Temporal MV prediction (MFMV, spec 7.9 motion field estimation).

Counterpart: av1_setup_motion_field / motion_field_projection
(md_config_process.c:453-591), av1_copy_frame_mvs (coding_loop.c:1208)
and add_tpl_ref_mv (adaptive_mv_pred.c:340). Each inter frame projects
the 8x8-granularity motion fields saved with its reference frames into
the current frame's TplMvs grid; the MVP stack derivation then injects
the projected MVs as weight-2 candidates after the spatial nearest
scans (codec/mvp.py).

The per-frame save and the five projection passes are vectorized over
the whole 8x8 grid (numpy; the grids are a few thousand entries — host
arithmetic, no device round-trip warranted). Scatter collisions follow
the reference's raster write order (later source blocks win), which
numpy fancy assignment reproduces for raster-flattened indices — the
scalar oracle in tests/test_mfmv.py fuzz-checks this.
"""

from __future__ import annotations

import numpy as np

MAX_FRAME_DISTANCE = 31          # (1 << FRAME_OFFSET_BITS) - 1
REFMVS_LIMIT = (1 << 12) - 1
MFMV_STACK_SIZE = 3
MAX_OFFSET_WIDTH = 64            # pixels (common_utils.h:20)
MAX_OFFSET_HEIGHT = 0

# div_mult[den]: 14-bit reciprocals for the mv projection
# (inter_prediction.h:204; normative libaom table)
DIV_MULT = np.array([
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638,
    1489, 1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780,
    744, 712, 682, 655, 630, 606, 585, 564, 546, 528], np.int64)

# named refs (LAST..ALTREF = 1..7)
LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(1, 8)


def rel_dist(bits: int, a: int, b: int) -> int:
    """get_relative_dist with order-hint wraparound (spec 5.9.3)."""
    m = 1 << (bits - 1)
    diff = (a - b) & ((1 << bits) - 1)
    return (diff & (m - 1)) - (diff & m)


def _round_pow2_signed(x, n: int):
    """ROUND_POWER_OF_TWO_SIGNED, vectorized."""
    pos = (np.abs(x) + (1 << (n - 1))) >> n
    return np.where(x < 0, -pos, pos)


def mv_projection(mv_row, mv_col, num: int, den):
    """get_mv_projection (inter_prediction.h:244), vectorized over the
    grid. mv in 1/8 pel; returns int16-range clamped components."""
    den = np.minimum(den, MAX_FRAME_DISTANCE)
    num = max(min(num, MAX_FRAME_DISTANCE), -MAX_FRAME_DISTANCE)
    mult = DIV_MULT[np.clip(den, 0, 31)]
    r = _round_pow2_signed(mv_row.astype(np.int64) * num * mult, 14)
    c = _round_pow2_signed(mv_col.astype(np.int64) * num * mult, 14)
    lim = (1 << 14) - 1  # MV_UPP - 1 (MV_IN_USE_BITS = 14); the decoder
    # clamps projected candidates here — a wider clamp desyncs the MVP
    # stack whenever a projection exceeds +-16383 (448x256 crf46 repro)
    return (np.clip(r, -lim, lim).astype(np.int32),
            np.clip(c, -lim, lim).astype(np.int32))


def lower_mv_precision(row: int, col: int, allow_hp: bool) -> tuple:
    """lower_mv_precision (is_integer=0 path)."""
    if not allow_hp:
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return row, col


def compute_ref_frame_side(fr, bits: int) -> np.ndarray:
    """ref_frame_side[1..7]: 1 if the ref displays after the current
    frame, -1 if same order hint, else 0 (av1_setup_motion_field)."""
    side = np.zeros(8, np.int8)
    if fr.frame_is_intra:
        return side
    for name in range(1, 8):
        hint = fr.ref_order_hints[name - 1]
        d = rel_dist(bits, hint, fr.order_hint)
        if d > 0:
            side[name] = 1
        elif hint == fr.order_hint:
            side[name] = -1
    return side


def save_frame_mvs(mi, ref_frame_side: np.ndarray) -> dict:
    """Per-8x8 saved motion field (av1_copy_frame_mvs semantics).

    In coding order the block containing the bottom-right 4x4 of each
    8x8 cell is written last, so sampling the grids at the odd mi
    positions reproduces the reference's last-writer-wins buffer.
    For each cell the SECOND valid component wins (the C loops idx 0
    then 1 without break); refs on the current frame's future side and
    over-limit MVs are skipped."""
    h8 = (mi.mi_rows + 1) >> 1
    w8 = (mi.mi_cols + 1) >> 1
    rr = np.minimum(2 * np.arange(h8) + 1, mi.mi_rows - 1)
    cc = np.minimum(2 * np.arange(w8) + 1, mi.mi_cols - 1)
    ref = np.zeros((h8, w8), np.int8)
    mv_r = np.zeros((h8, w8), np.int16)
    mv_c = np.zeros((h8, w8), np.int16)
    side = ref_frame_side.astype(np.int8)
    for ref_g, r_g, c_g in ((mi.ref_frame, mi.mv_row, mi.mv_col),
                            (mi.ref_frame1, mi.mv_row1, mi.mv_col1)):
        rf = ref_g[np.ix_(rr, cc)].astype(np.int32)
        r = r_g[np.ix_(rr, cc)].astype(np.int32)
        c = c_g[np.ix_(rr, cc)].astype(np.int32)
        ok = ((rf >= 1) & (side[np.clip(rf, 0, 7)] == 0)
              & (np.abs(r) <= REFMVS_LIMIT) & (np.abs(c) <= REFMVS_LIMIT))
        ref = np.where(ok, rf, ref).astype(np.int8)
        mv_r = np.where(ok, r, mv_r).astype(np.int16)
        mv_c = np.where(ok, c, mv_c).astype(np.int16)
    return {"ref": ref, "mv_row": mv_r, "mv_col": mv_c}


def projection_safe(fr, slots, bits: int) -> bool:
    """Conservative per-frame gate for use_ref_frame_mvs: False when any
    projection source holds saved MVs large enough that the temporal
    projection would run into the +-(1<<14)-1 clamp region. Encoders
    may legally skip temporal MVP per frame; near that region our
    derivation still disagrees with dav1d on rare streams (448x256 p6
    crf46 blobs repro, round 5) — until that residual divergence is
    root-caused, frames with such wild source motion code
    use_ref_frame_mvs=0 so encoder and decoder agree by construction."""
    for name in (LAST, BWDREF, ALTREF2, ALTREF, LAST2):
        slot = slots[fr.ref_frame_idx[name - 1]]
        if slot is None or slot.get("saved_mvs") is None:
            continue
        if slot.get("frame_is_intra", True):
            continue
        num = abs(rel_dist(bits, slot["order_hint"], fr.order_hint))
        sv = slot["saved_mvs"]
        m = max(int(np.abs(sv["mv_row"]).max(initial=0)),
                int(np.abs(sv["mv_col"]).max(initial=0)))
        if m * min(num, MAX_FRAME_DISTANCE) >= (1 << 14):
            return False
    return True


class TplMvs:
    """Projected motion field of the current frame (pcs->tpl_mvs)."""

    def __init__(self, h8: int, w8: int):
        self.valid = np.zeros((h8, w8), bool)
        self.mfmv_row = np.zeros((h8, w8), np.int16)
        self.mfmv_col = np.zeros((h8, w8), np.int16)
        self.ref_off = np.zeros((h8, w8), np.int16)


def _project_one(tpl: TplMvs, saved: dict, saved_ref_hints,
                 start_hint: int, cur_hint: int, direction: int,
                 bits: int) -> bool:
    """motion_field_projection (md_config_process.c:453) for one start
    frame. direction 2 = past ref (project forward), 0 = future ref."""
    h8, w8 = tpl.valid.shape
    start_to_cur = rel_dist(bits, start_hint, cur_hint)
    if direction == 2:
        start_to_cur = -start_to_cur
    if abs(start_to_cur) > MAX_FRAME_DISTANCE:
        return True  # pass counted, nothing projectable
    ref_offset = np.zeros(8, np.int32)
    for i in range(1, 8):
        ref_offset[i] = rel_dist(bits, start_hint, saved_ref_hints[i - 1])

    rf = saved["ref"].astype(np.int32)
    fwd_r = saved["mv_row"].astype(np.int32)
    fwd_c = saved["mv_col"].astype(np.int32)
    roff = ref_offset[np.clip(rf, 0, 7)]
    ok = (rf >= 1) & (np.abs(roff) <= MAX_FRAME_DISTANCE) & (roff > 0)
    pr, pc = mv_projection(fwd_r, fwd_c, start_to_cur, np.maximum(roff, 1))

    # get_block_position: offsets in 8x8 units, +-1 row / +-8 col window
    # around the 64-aligned base, sign flipped for past refs
    row_off = np.where(pr >= 0, pr >> 6, -((-pr) >> 6))
    col_off = np.where(pc >= 0, pc >> 6, -((-pc) >> 6))
    sign = 1 if (direction >> 1) == 1 else -1
    blk_r = np.arange(h8)[:, None]
    blk_c = np.arange(w8)[None, :]
    row = blk_r - sign * row_off
    col = blk_c - sign * col_off
    base_r = (blk_r >> 3) << 3
    base_c = (blk_c >> 3) << 3
    ok &= (row >= 0) & (row < h8) & (col >= 0) & (col < w8)
    ok &= ((row >= base_r - (MAX_OFFSET_HEIGHT >> 3))
           & (row < base_r + 8 + (MAX_OFFSET_HEIGHT >> 3))
           & (col >= base_c - (MAX_OFFSET_WIDTH >> 3))
           & (col < base_c + 8 + (MAX_OFFSET_WIDTH >> 3)))

    idx = np.flatnonzero(ok.ravel())
    if idx.size:
        tgt = (row.ravel()[idx] * w8 + col.ravel()[idx])
        # raster order == the reference's write order; numpy fancy
        # assignment keeps the LAST duplicate, matching last-writer-wins
        tpl.valid.ravel()[tgt] = True
        tpl.mfmv_row.ravel()[tgt] = fwd_r.ravel()[idx].astype(np.int16)
        tpl.mfmv_col.ravel()[tgt] = fwd_c.ravel()[idx].astype(np.int16)
        tpl.ref_off.ravel()[tgt] = roff.ravel()[idx].astype(np.int16)
    return True


def setup_motion_field(fr, slots, mi_rows: int, mi_cols: int,
                       bits: int) -> TplMvs | None:
    """av1_setup_motion_field (md_config_process.c:525): run up to
    MFMV_STACK_SIZE projections in the normative order LAST(past),
    BWDREF, ALTREF2, ALTREF, LAST2(past). Returns None when nothing
    could be projected (header should then code use_ref_frame_mvs=0 —
    legal either way; we keep it on and the grid stays invalid)."""
    h8 = (mi_rows + 1) >> 1
    w8 = (mi_cols + 1) >> 1
    tpl = TplMvs(h8, w8)

    def slot_of(name):
        s = slots[fr.ref_frame_idx[name - 1]]
        if s is None or s.get("saved_mvs") is None:
            return None
        if s.get("frame_is_intra", True):
            return None
        return s

    def project(name, direction):
        s = slot_of(name)
        if s is None:
            return False
        return _project_one(tpl, s["saved_mvs"], s["ref_order_hints"],
                            s["order_hint"], fr.order_hint, direction,
                            bits)

    ref_stamp = MFMV_STACK_SIZE - 1
    lst = slots[fr.ref_frame_idx[LAST - 1]]
    if lst is not None:
        # overlay check: LAST's saved ALTREF hint == our GOLDEN hint
        alt_of_lst = (lst.get("ref_order_hints", (0,) * 7)[ALTREF - 1])
        is_lst_overlay = alt_of_lst == fr.ref_order_hints[GOLDEN - 1]
        if not is_lst_overlay:
            project(LAST, 2)
        ref_stamp -= 1
    if rel_dist(bits, fr.ref_order_hints[BWDREF - 1], fr.order_hint) > 0:
        if project(BWDREF, 0):
            ref_stamp -= 1
    if rel_dist(bits, fr.ref_order_hints[ALTREF2 - 1], fr.order_hint) > 0:
        if project(ALTREF2, 0):
            ref_stamp -= 1
    if (rel_dist(bits, fr.ref_order_hints[ALTREF - 1], fr.order_hint) > 0
            and ref_stamp >= 0):
        if project(ALTREF, 0):
            ref_stamp -= 1
    if ref_stamp >= 0:
        project(LAST2, 2)
    return tpl
