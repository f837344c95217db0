/* One superblock's tile syntax in one call: the C counterpart of the
 * block walk in bitstream/tile_writer.py (TileWriter._write_block and
 * what it calls), for the syntax the device mode decision produces.
 *
 * Python walks the partition tree (TileWriter._coding_order) and packs
 * the walk into ops (TileWriter._write_sb_native): a partition op codes
 * the partition symbol of a node, a block op codes one leaf's mode info,
 * transform sizes and coefficients and updates the neighbour state. All
 * state lives in the arrays the Python writer owns (its context grids,
 * the coefficient writer's entropy contexts, the MiState grids) and in
 * the frame's CDF arrays, so superblocks written here and by the Python
 * walk interleave freely within a tile. Palette and intra block copy
 * leaves stay with the Python walk.
 *
 * Every symbol is coded in the order, with the contexts and adaptation
 * of the Python walk; tests/test_torch_tile_writer_native.py holds the
 * two walks to the same bytes and the same state.
 */

#include <stdint.h>
#include <string.h>

#include "ecenc.h"

void svt_find_mv_stack(const int8_t *ref_frame, const int8_t *ref_frame1,
                       const int16_t *mv_row, const int16_t *mv_col,
                       const int16_t *mv_row1, const int16_t *mv_col1,
                       const int8_t *is_newmv, const int8_t *is_gmv,
                       const int8_t *bsize_g, const uint8_t *sign_bias,
                       int mi_rows, int mi_cols, int mi_row, int mi_col,
                       int bsize, int rf0, int rf1, int gm_row0, int gm_col0,
                       int gm_row1, int gm_col1, int gm_warp,
                       const uint8_t *tpl_valid, const int16_t *tpl_row,
                       const int16_t *tpl_col, const int16_t *tpl_off,
                       int cur_off0, int cur_off1, int32_t *out);
int32_t svt_txb_skip_ctx(const uint8_t *above, const uint8_t *left,
                         int tw_units, int th_units, int is_luma,
                         int same_size, int ctx_offset);

/* ---- tables (codec/constants.py) ---------------------------------------- */
static const uint8_t BW[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32,
                               64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
static const uint8_t BH[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64,
                               32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};
static const uint8_t SIZE_GROUP[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3,
                                       3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2};
static const uint8_t WEDGE_BITS[22] = {0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0,
                                       0, 0, 0, 0, 0, 0, 0, 4, 4, 0, 0};
static const uint8_t MAX_TX_RECT[22] = {0, 5, 6, 1, 7, 8, 2, 9, 10, 3, 11,
                                        12, 4, 4, 4, 4, 13, 14, 15, 16, 17, 18};
static const int8_t TX_CAT[22] = {-1, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3,
                                  3, 3, 3, 3, 3, 1, 1, 2, 2, 3, 3};
static const uint8_t TXW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16,
                                32, 32, 64, 4, 16, 8, 32, 16, 64};
static const uint8_t TXH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32,
                                16, 64, 32, 16, 4, 32, 8, 64, 16};
static const uint8_t SPLIT_TX[19] = {0, 0, 1, 2, 3, 0, 0, 1, 1, 2,
                                     2, 3, 3, 5, 6, 7, 8, 9, 10};
static const uint8_t TX_SQR[19] = {0, 1, 2, 3, 4, 0, 0, 1, 1, 2,
                                   2, 3, 3, 0, 0, 1, 1, 2, 2};
static const uint8_t TX_SQR_UP[19] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3,
                                      3, 4, 4, 2, 2, 3, 3, 4, 4};
static const uint8_t INTRA_MODE_CTX[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
/* tx type -> class: 0 2-D, 1 horizontal, 2 vertical (coeff_writer.py) */
static const uint8_t TX_CLASS[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                     2, 1, 2, 1, 2, 1};
/* filter intra mode -> intra direction (ops/intra.py FI_MODE_TO_INTRA_DIR) */
static const uint8_t FI_TO_DIR[5] = {0, 1, 2, 6, 0};
/* tx type -> symbol per extended set; -1 = not in the set */
static const int8_t INTER_SET3[16] = {1, -1, -1, -1, -1, -1, -1, -1, -1, 0,
                                      -1, -1, -1, -1, -1, -1};
static const int8_t INTER_SET2[16] = {3, 4, 5, 8, 6, 7, 9, 10, 11, 0,
                                      1, 2, -1, -1, -1, -1};
static const int8_t INTER_SET1[16] = {7, 8, 9, 12, 10, 11, 13, 14, 15, 0,
                                      1, 2, 3, 4, 5, 6};
static const int8_t INTRA_SET2[16] = {1, 3, 4, 2, -1, -1, -1, -1, -1, 0,
                                      -1, -1, -1, -1, -1, -1};
static const int8_t INTRA_SET1[16] = {1, 5, 6, 4, -1, -1, -1, -1, -1, 0,
                                      2, 3, -1, -1, -1, -1};
static const uint8_t EOB_TO_POS_SMALL[33] = {0, 1, 2, 3, 3, 4, 4, 4, 4,
                                             5, 5, 5, 5, 5, 5, 5, 5,
                                             6, 6, 6, 6, 6, 6, 6, 6,
                                             6, 6, 6, 6, 6, 6, 6, 6};
static const uint8_t EOB_TO_POS_LARGE[17] = {6, 7, 8, 8, 9, 9, 9, 9, 10,
                                             10, 10, 10, 10, 10, 10, 10, 11};
static const int16_t EOB_GROUP_START[12] = {0, 1, 2, 3, 5, 9, 17, 33,
                                            65, 129, 257, 513};
static const uint8_t EOB_OFFSET_BITS[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
static const uint8_t COMP_MODE_CTX_MAP[3][5] = {
    {0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};
/* compound mode (17..24) -> its two single modes (constants.py _COMP_SUB) */
static const uint8_t COMP_SUB[8][2] = {{13, 13}, {14, 14}, {13, 16}, {16, 13},
                                       {14, 16}, {16, 14}, {15, 15}, {16, 16}};

enum { NEARESTMV = 13, NEARMV = 14, GLOBALMV = 15, NEWMV = 16,
       GLOBAL_GLOBALMV = 23, NEW_NEWMV = 24 };
enum { P_NONE = 0, P_HORZ, P_VERT, P_SPLIT, P_HORZ_A, P_HORZ_B, P_VERT_A,
       P_VERT_B, P_HORZ_4, P_VERT_4 };

/* ---- the descriptor (TileWriter._native_desc builds it in this order) --- */
enum {
    D_MI_ROWS, D_MI_COLS, D_R0, D_R1, D_C0, D_C1, D_ADAPT, D_SB128,
    D_FRAME_IS_INTRA, D_DELTA_Q_PRESENT, D_DELTA_Q_RES, D_CDEF_BITS,
    D_TX_MODE_SELECT, D_REDUCED_TX_SET, D_BASE_Q_IDX, D_SCREEN_CONTENT,
    D_MM_SWITCHABLE, D_ALLOW_WARPED, D_INTERP_FILTER, D_REFERENCE_SELECT,
    D_ORDER_HINT, D_ORDER_HINT_BITS, D_REF_HINTS, /* 7 */
    D_MONO = D_REF_HINTS + 7, D_SS_X, D_SS_Y, D_FILTER_INTRA, D_INTERINTRA,
    D_MASKED, D_JNT,
    D_GM, /* 7 refs x (type, mat[6]) */
    D_Y_MODES = D_GM + 49, D_SKIPS, D_INTERS, D_FLT, D_REF0G, D_REF1G,
    D_CGIG, D_CPIG, D_PAL_SIZE, D_ABOVE_PART, D_LEFT_PART, D_TXI_ABOVE,
    D_TXI_LEFT, D_TXP_ABOVE, D_TXP_LEFT, D_SEG_MAP, D_SEG_TARGET,
    D_SEG_LAST_ACTIVE, D_CDEF_MAP, D_CDEF_MAP_COLS, D_QMAP, D_QMAP_COLS,
    D_CTX_ABOVE, /* 3 planes */
    D_CTX_LEFT = D_CTX_ABOVE + 3, D_CTX_ABOVE_LEN = D_CTX_LEFT + 3,
    D_CTX_LEFT_LEN = D_CTX_ABOVE_LEN + 3,
    D_MI = D_CTX_LEFT_LEN + 3, /* 0 = no MiState */
    D_MI_REF0, D_MI_REF1, D_MI_MVR, D_MI_MVC, D_MI_MVR1, D_MI_MVC1,
    D_MI_NEWMV, D_MI_GMV, D_MI_FLT, D_MI_BSIZE, D_MI_SIGN_BIAS,
    D_TPL_VALID, D_TPL_ROW, D_TPL_COL, D_TPL_OFF, D_TPL_CUR_OFF,
    D_SCANS, D_NZ_OFFS, /* int64[19 * 3] each, by tx size and class */
    D_FAMS /* N_FAM x (values, counters, nsyms, row length, d0, d1, d2) */
};

/* CDF families, in the order of TileWriter._NATIVE_FAMS */
enum {
    F_PARTITION, F_SKIP, F_SPATIAL_SEG, F_DELTA_Q, F_KF_Y_MODE, F_ANGLE_DELTA,
    F_UV_MODE, F_CFL_SIGN, F_CFL_ALPHA, F_Y_MODE, F_INTRA_INTER, F_COMP_INTER,
    F_COMP_REF_TYPE, F_COMP_REF, F_COMP_BWDREF, F_SINGLE_REF,
    F_INTER_COMPOUND_MODE, F_NEWMV, F_ZEROMV, F_REFMV, F_DRL, F_NMV_JOINTS,
    F_NMV_SIGN, F_NMV_CLASSES, F_NMV_CLASS0, F_NMV_BITS, F_NMV_CLASS0_FP,
    F_NMV_FP, F_INTERINTRA, F_INTERINTRA_MODE, F_WEDGE_INTERINTRA,
    F_WEDGE_IDX, F_OBMC, F_MOTION_MODE, F_COMP_GROUP_IDX, F_COMPOUND_IDX,
    F_COMPOUND_TYPE, F_SWITCHABLE_INTERP, F_PALETTE_Y_MODE,
    F_PALETTE_UV_MODE, F_FILTER_INTRA, F_FILTER_INTRA_MODE, F_TX_SIZE,
    F_TXFM_PARTITION, F_INTER_EXT_TX, F_INTRA_EXT_TX, F_TXB_SKIP,
    F_EOB_EXTRA, F_DC_SIGN, F_COEFF_BR, F_COEFF_BASE, F_COEFF_BASE_EOB,
    F_EOB_FLAG16, /* 16, 32, ... 1024: 7 families */
    N_FAM = F_EOB_FLAG16 + 7
};
#define FAM_SLOTS 7

/* ---- one op: a partition node or a leaf (TileWriter._write_sb_native) - */
enum {
    O_KIND, O_R, O_C, O_BSIZE, O_PARTITION, O_LEAF_BSIZE, O_SKIP, O_Y_MODE,
    O_UV_MODE, O_ANGLE_Y, O_ANGLE_UV, O_IS_INTER, O_REF0, O_REF1, O_MODE,
    O_MV_R, O_MV_C, O_MV1_R, O_MV1_C, O_DRL, O_TX_DEPTH, O_FILTER_INTRA,
    O_FI_MODE, O_CFL_U, O_CFL_V, O_INTERP_FILTER, O_MOTION_MODE, O_CGI,
    O_CPI, O_COMP_TYPE, O_WEDGE_INDEX, O_WEDGE_SIGN, O_MASK_TYPE,
    O_II_MODE, O_WEDGE_II, O_TXB0, O_NTXB, O_WIDTH
};
/* one transform block */
enum { T_PLANE, T_PLANE_BSIZE, T_TX_SIZE, T_TX_TYPE, T_EOB, T_UX, T_UY,
       T_QCOEFF, T_WIDTH };

/* what a failed check returns (the Python walk asserts the same) */
enum { E_PARTITION = 1, E_CDEF = 2, E_MOTION_MODE = 3, E_TX_TYPE = 4,
       E_DRL = 5, E_MODE_CTX = 6, E_PROBE = 7 };

typedef struct {
    int32_t *v, *c;
    const int32_t *n;
    int64_t len, d1, d2;
} Fam;

typedef struct {
    EcEnc *e;
    const int64_t *d;
    int adapt, mi_rows, mi_cols, r0, c0, err;
    int sb_r, sb_c, cdef_coded, prev_qindex;
    int8_t *y_modes, *skips, *inters, *flt, *ref0g, *ref1g, *cgig, *cpig,
        *pal_size, *seg_map;
    const int8_t *seg_target;
    const int32_t *cdef_map, *qmap;
    uint8_t *above_part, *left_part, *txi_above, *txi_left, *txp_above,
        *txp_left;
    uint8_t *ctx_above[3], *ctx_left[3];
    int ctx_above_len[3], ctx_left_len[3];
    int has_mi;
    int8_t *mi_ref0, *mi_ref1, *mi_newmv, *mi_gmv, *mi_flt, *mi_bsize;
    int16_t *mi_mvr, *mi_mvc, *mi_mvr1, *mi_mvc1;
    Fam fam[N_FAM];
} W;

#define PTR(T, slot) ((T)(intptr_t)w->d[slot])
#define AT(g, r, c) ((g)[(int64_t)(r) * w->mi_cols + (c)])

static inline void sym(W *w, int f, int s, int i0, int i1, int i2) {
    const Fam *F = &w->fam[f];
    const int64_t k = ((int64_t)i0 * F->d1 + i1) * F->d2 + i2;
    ec_symbol(w->e, F->v + k * F->len, F->c + k, F->n[k], s, w->adapt);
}

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int iabs(int a) { return a < 0 ? -a : a; }

/* grid[r0:r1, c0:c1] = v, clipped to the frame as numpy slices are */
static void fill_i8(W *w, int8_t *g, int r, int c, int h4, int w4, int v) {
    const int r1 = imin(r + h4, w->mi_rows), c1 = imin(c + w4, w->mi_cols);
    for (int rr = r; rr < r1; rr++)
        for (int cc = c; cc < c1; cc++) AT(g, rr, cc) = (int8_t)v;
}

static void fill_i16(W *w, int16_t *g, int r, int c, int h4, int w4, int v) {
    const int r1 = imin(r + h4, w->mi_rows), c1 = imin(c + w4, w->mi_cols);
    for (int rr = r; rr < r1; rr++)
        for (int cc = c; cc < c1; cc++) AT(g, rr, cc) = (int16_t)v;
}

static void fill_u8(uint8_t *a, int len, int start, int n, int v) {
    const int end = imin(start + n, len);
    for (int i = start; i < end; i++) a[i] = (uint8_t)v;
}

static int directional(int mode) { return mode >= 1 && mode <= 8; }

static int gm_type(W *w, int ref) {
    if (ref < 1 || ref > 7) return 0;
    return (int)w->d[D_GM + (ref - 1) * 7];
}

static int conv_gm(int64_t v) {
    /* round_pot_signed(v, WARPEDMODEL_PREC_BITS - 2) * 2, clipped */
    const int n = 14;
    int64_t a = v < 0 ? -v : v;
    a = (a + ((int64_t)1 << (n - 1))) >> n;
    v = (v < 0 ? -a : a) * 2;
    const int64_t lim = (1 << 14) - 1;
    return (int)(v < -lim ? -lim : (v > lim ? lim : v));
}

/* GLOBALMV of this block for one reference (ops/warp.py project_mv) */
static void gm_mv(W *w, int ref, int r, int c, int bsize, int *row, int *col) {
    *row = *col = 0;
    const int t = gm_type(w, ref);
    if (t == 0) return;
    const int64_t *m = w->d + D_GM + (ref - 1) * 7 + 1;
    if (t == 1) {
        *row = conv_gm(m[0]);
        *col = conv_gm(m[1]);
        return;
    }
    const int64_t x = (int64_t)c * 4 + BW[bsize] / 2 - 1;
    const int64_t y = (int64_t)r * 4 + BH[bsize] / 2 - 1;
    const int64_t one = (int64_t)1 << 16;
    const int64_t xc = (m[2] - one) * x + m[3] * y + m[0];
    const int64_t yc = m[4] * x + (m[5] - one) * y + m[1];
    *row = conv_gm(yc);
    *col = conv_gm(xc);
}

static int rel_dist(int bits, int a, int b) {
    const int diff = a - b, m = 1 << (bits - 1);
    return (diff & (m - 1)) - (diff & m);
}

/* ---- partition ----------------------------------------------------------- */
static void write_partition(W *w, int p, int r, int c, int bsize) {
    const int bw4 = BW[bsize] >> 2, bh4 = BH[bsize] >> 2;
    if (bw4 <= 1) {
        if (p != P_NONE) w->err = E_PARTITION;
        return;
    }
    const int has_rows = (r + bh4 / 2) < w->mi_rows;
    const int has_cols = (c + bw4 / 2) < w->mi_cols;
    const int bsl = bitlen((uint32_t)bw4) - 2;
    const int above = r > w->r0 ? (w->above_part[c] >> bsl) & 1 : 0;
    const int left = c > w->c0 ? (w->left_part[r] >> bsl) & 1 : 0;
    const int ctx = left * 2 + above + bsl * 4;
    if (!has_rows && !has_cols) {
        if (p != P_SPLIT) w->err = E_PARTITION;
        return;
    }
    if (has_rows && has_cols) {
        sym(w, F_PARTITION, p, ctx, 0, 0);
        return;
    }
    /* an edge: split-or-horz / split-or-vert over the gathered CDF */
    const Fam *F = &w->fam[F_PARTITION];
    const int32_t *row = F->v + (int64_t)ctx * F->len;
    const int n = F->n[ctx];
    int gather[6], ng = 0;
    if (has_cols) { /* bottom edge */
        if (p != P_SPLIT && p != P_HORZ) { w->err = E_PARTITION; return; }
        gather[ng++] = P_VERT; gather[ng++] = P_SPLIT; gather[ng++] = P_HORZ_A;
        gather[ng++] = P_VERT_A; gather[ng++] = P_VERT_B;
        if (bsize != 15) gather[ng++] = P_VERT_4;
    } else { /* right edge */
        if (p != P_SPLIT && p != P_VERT) { w->err = E_PARTITION; return; }
        gather[ng++] = P_HORZ; gather[ng++] = P_SPLIT; gather[ng++] = P_HORZ_A;
        gather[ng++] = P_HORZ_B; gather[ng++] = P_VERT_A;
        if (bsize != 15) gather[ng++] = P_HORZ_4;
    }
    int s = 0;
    for (int i = 0; i < ng; i++) {
        const int g = gather[i];
        if (g < n) s += row[g] - (g > 0 ? row[g - 1] : 0);
    }
    const int32_t cdf[2] = {PROB_TOP - s, PROB_TOP};
    enc_symbol(w->e, cdf, 2, p == P_SPLIT);
}

/* ---- segment id, cdef index, delta q ------------------------------------- */
static int neg_interleave(int x, int ref, int max_n) {
    const int diff = x - ref;
    if (ref == 0) return x;
    if (ref >= max_n - 1) return -x + max_n - 1;
    if (2 * ref < max_n) {
        if (iabs(diff) <= ref) return diff > 0 ? (diff << 1) - 1 : (-diff) << 1;
        return x;
    }
    if (iabs(diff) < max_n - ref)
        return diff > 0 ? (diff << 1) - 1 : (-diff) << 1;
    return (max_n - x) - 1;
}

static void write_segment_id(W *w, int r, int c, int bsize, int au, int al,
                             int skip) {
    if (!w->seg_target) return;
    const int target = AT(w->seg_target, r, c);
    const int ul = (au && al) ? AT(w->seg_map, r - 1, c - 1) : -1;
    const int u = au ? AT(w->seg_map, r - 1, c) : -1;
    const int l = al ? AT(w->seg_map, r, c - 1) : -1;
    int pred;
    if (u == -1) pred = l == -1 ? 0 : l;
    else if (l == -1) pred = u;
    else pred = ul == u ? u : l;
    int ctx;
    if (ul < 0 || u < 0 || l < 0) ctx = 0;
    else if (ul == u && ul == l) ctx = 2;
    else if (ul == u || ul == l || u == l) ctx = 1;
    else ctx = 0;
    const int h4 = BH[bsize] >> 2, w4 = BW[bsize] >> 2;
    if (skip) {
        fill_i8(w, w->seg_map, r, c, h4, w4, pred);
        return;
    }
    const int last = (int)w->d[D_SEG_LAST_ACTIVE];
    sym(w, F_SPATIAL_SEG, neg_interleave(target, pred, last + 1), ctx, 0, 0);
    fill_i8(w, w->seg_map, r, c, h4, w4, target);
}

static void write_cdef(W *w, int r, int c, int skip) {
    if (!w->cdef_map || skip || w->cdef_coded) return;
    const int gi = w->cdef_map[(int64_t)(r >> 4) * w->d[D_CDEF_MAP_COLS] + (c >> 4)];
    if (gi < 0) { w->err = E_CDEF; return; }
    if (w->d[D_CDEF_BITS]) ec_literal(w->e, (uint32_t)gi, (int)w->d[D_CDEF_BITS]);
    w->cdef_coded = 1;
}

static int floor_div(int a, int b) {
    int q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q--;
    return q;
}

static void write_delta_q(W *w, int r, int c, int bsize, int skip) {
    if (!w->d[D_DELTA_Q_PRESENT] || !w->qmap) return;
    if (r != w->sb_r || c != w->sb_c) return;
    const int sb128 = (int)w->d[D_SB128];
    if (bsize == (sb128 ? 15 : 12) && skip) return;
    const int sb_mi = sb128 ? 32 : 16;
    const int q = w->qmap[(int64_t)(r / sb_mi) * w->d[D_QMAP_COLS] + c / sb_mi];
    const int reduced = floor_div(q - w->prev_qindex, (int)w->d[D_DELTA_Q_RES]);
    w->prev_qindex = q;
    const int sign = reduced < 0, av = iabs(reduced);
    sym(w, F_DELTA_Q, imin(av, 3), 0, 0, 0);
    if (av >= 3) {
        const int rem_bits = bitlen((uint32_t)(av - 1)) - 1;
        const int thr = (1 << rem_bits) + 1;
        ec_literal(w->e, (uint32_t)(rem_bits - 1), 3);
        ec_literal(w->e, (uint32_t)(av - thr), rem_bits);
    }
    if (av > 0) ec_literal(w->e, (uint32_t)sign, 1);
}

/* ---- intra modes --------------------------------------------------------- */
static void write_uv_mode(W *w, const int32_t *o, int bsize, int use_angle) {
    const int cfl_allowed = BW[bsize] <= 32 && BH[bsize] <= 32;
    const int uv = o[O_UV_MODE];
    sym(w, F_UV_MODE, uv, cfl_allowed, o[O_Y_MODE], 0);
    if (uv == 13) { /* UV_CFL_PRED */
        const int au = o[O_CFL_U], av = o[O_CFL_V];
        const int su = au == 0 ? 0 : (au < 0 ? 1 : 2);
        const int sv = av == 0 ? 0 : (av < 0 ? 1 : 2);
        const int js = su * 3 + sv - 1;
        sym(w, F_CFL_SIGN, js, 0, 0, 0);
        if (au) sym(w, F_CFL_ALPHA, iabs(au) - 1, js + 1 - 3, 0, 0);
        if (av)
            sym(w, F_CFL_ALPHA, iabs(av) - 1,
                ((js + 1) % 3) * 3 + (js + 1) / 3 - 3, 0, 0);
    }
    if (use_angle && directional(uv))
        sym(w, F_ANGLE_DELTA, o[O_ANGLE_UV] + 3, uv - 1, 0, 0);
}

/* ---- references ---------------------------------------------------------- */
static int cmp_ctx(int a, int b) { return a == b ? 1 : (a < b ? 0 : 2); }

static int comp_mode_ctx(W *w, int r, int c, int au, int al) {
#define BWD(rr, cc) (AT(w->mi_ref0, rr, cc) >= 5)
#define CMP(rr, cc) (AT(w->mi_ref1, rr, cc) >= 1)
#define INT(rr, cc) (!AT(w->inters, rr, cc))
    if (au && al) {
        const int ar = r - 1, ac = c, lr = r, lc = c - 1;
        if (!CMP(ar, ac) && !CMP(lr, lc))
            return (BWD(ar, ac) && !INT(ar, ac)) ^ (BWD(lr, lc) && !INT(lr, lc));
        if (!CMP(ar, ac)) return 2 + (BWD(ar, ac) || INT(ar, ac));
        if (!CMP(lr, lc)) return 2 + (BWD(lr, lc) || INT(lr, lc));
        return 4;
    }
    if (au || al) {
        const int er = au ? r - 1 : r, ec = au ? c : c - 1;
        if (!CMP(er, ec)) return BWD(er, ec) && !INT(er, ec);
        return 3;
    }
    return 1;
}

static int comp_ref_type_ctx(W *w, int r, int c, int au, int al) {
    if (au && al) {
        const int ar = r - 1, ac = c, lr = r, lc = c - 1;
        const int ai = INT(ar, ac), li = INT(lr, lc);
        if (ai && li) return 2;
        if (ai || li) {
            const int er = ai ? lr : ar, ec = ai ? lc : ac;
            return !CMP(er, ec) ? 2 : 1;
        }
        const int a_sg = !CMP(ar, ac), l_sg = !CMP(lr, lc);
        if (a_sg && l_sg) return 1 + 2 * !(BWD(ar, ac) ^ BWD(lr, lc));
        if (a_sg || l_sg) return 1;
        return 0;
    }
    if (au || al) {
        const int er = au ? r - 1 : r, ec = au ? c : c - 1;
        if (INT(er, ec) || !CMP(er, ec)) return 2;
        return 0;
    }
    return 2;
#undef BWD
#undef CMP
#undef INT
}

static void write_ref_frames(W *w, const int32_t *o, int r, int c, int au,
                             int al) {
    int n[8] = {0};
    for (int k = 0; k < 2; k++) {
        const int av = k == 0 ? au : al;
        const int rr = k == 0 ? r - 1 : r, cc = k == 0 ? c : c - 1;
        if (av && AT(w->inters, rr, cc)) {
            n[(AT(w->mi_ref0, rr, cc) + 8) & 7]++;
            const int r1 = AT(w->mi_ref1, rr, cc);
            if (r1 >= 1) n[r1 & 7]++;
        }
    }
    const int is_comp = o[O_REF1] >= 1;
    if (w->d[D_REFERENCE_SELECT])
        sym(w, F_COMP_INTER, is_comp, comp_mode_ctx(w, r, c, au, al), 0, 0);
    if (is_comp) {
        sym(w, F_COMP_REF_TYPE, 1, comp_ref_type_ctx(w, r, c, au, al), 0, 0);
        const int fwd = o[O_REF0], bwd = o[O_REF1];
        const int bit = fwd == 3 || fwd == 4;
        sym(w, F_COMP_REF, bit, cmp_ctx(n[1] + n[2], n[3] + n[4]), 0, 0);
        if (!bit) sym(w, F_COMP_REF, fwd == 2, cmp_ctx(n[1], n[2]), 1, 0);
        else sym(w, F_COMP_REF, fwd == 4, cmp_ctx(n[3], n[4]), 2, 0);
        const int bit_b = bwd == 7;
        sym(w, F_COMP_BWDREF, bit_b, cmp_ctx(n[5] + n[6], n[7]), 0, 0);
        if (!bit_b) sym(w, F_COMP_BWDREF, bwd == 6, cmp_ctx(n[5], n[6]), 1, 0);
        return;
    }
    const int ref = o[O_REF0];
    const int bit0 = ref >= 5;
    sym(w, F_SINGLE_REF, bit0,
        cmp_ctx(n[1] + n[2] + n[3] + n[4], n[5] + n[6] + n[7]), 0, 0);
    if (bit0) {
        const int bit1 = ref == 7;
        sym(w, F_SINGLE_REF, bit1, cmp_ctx(n[5] + n[6], n[7]), 1, 0);
        if (!bit1) sym(w, F_SINGLE_REF, ref == 6, cmp_ctx(n[5], n[6]), 5, 0);
    } else {
        const int bit2 = ref == 3 || ref == 4;
        sym(w, F_SINGLE_REF, bit2, cmp_ctx(n[1] + n[2], n[3] + n[4]), 2, 0);
        if (!bit2) sym(w, F_SINGLE_REF, ref != 1, cmp_ctx(n[1], n[2]), 3, 0);
        else sym(w, F_SINGLE_REF, ref != 3, cmp_ctx(n[3], n[4]), 4, 0);
    }
}

/* ---- motion vectors ------------------------------------------------------ */
typedef struct {
    int count, mode_ctx, slots;
    int mv[8][2], mv1[8][2], weight[8];
} Stack;

static int drl_ctx(const Stack *s, int idx) {
    const int a = s->weight[idx] >= 640, b = s->weight[idx + 1] >= 640;
    if (a && b) return 0;
    if (a && !b) return 1;
    return 2;
}

static void write_drl(W *w, int drl, const Stack *s, int has_new, int near_like) {
    if (has_new) {
        for (int idx = 0; idx < 2; idx++)
            if (s->count > idx + 1) {
                sym(w, F_DRL, drl != idx, drl_ctx(s, idx), 0, 0);
                if (drl == idx) break;
            }
    } else if (near_like) {
        for (int idx = 1; idx < 3; idx++)
            if (s->count > idx + 1) {
                sym(w, F_DRL, drl != idx - 1, drl_ctx(s, idx), 0, 0);
                if (drl == idx - 1) break;
            }
    }
}

static void write_mv_component(W *w, int comp, int ci) {
    const int sign = comp < 0, z = iabs(comp) - 1;
    int cls, offset;
    if (z < 16) {
        cls = 0;
        offset = z;
    } else {
        cls = imin(10, bitlen((uint32_t)(z >> 3)) - 1);
        offset = z - (2 << (cls + 2));
    }
    const int d = offset >> 3, fr = (offset >> 1) & 3;
    sym(w, F_NMV_SIGN, sign, ci, 0, 0);
    sym(w, F_NMV_CLASSES, cls, ci, 0, 0);
    if (cls == 0) {
        sym(w, F_NMV_CLASS0, d, ci, 0, 0);
        sym(w, F_NMV_CLASS0_FP, fr, ci, d, 0);
    } else {
        for (int i = 0; i < cls; i++) sym(w, F_NMV_BITS, (d >> i) & 1, ci, i, 0);
        sym(w, F_NMV_FP, fr, ci, 0, 0);
    }
}

static void write_mv(W *w, int mr, int mc, const int *ref) {
    const int d0 = mr - ref[0], d1 = mc - ref[1];
    const int joint = d0 == 0 ? (d1 == 0 ? 0 : 1) : (d1 == 0 ? 2 : 3);
    sym(w, F_NMV_JOINTS, joint, 0, 0, 0);
    if (d0) write_mv_component(w, d0, 0);
    if (d1) write_mv_component(w, d1, 1);
}

/* ---- motion mode allowance (codec/warp_samples.py) ----------------------- */
static int count_overlappable(W *w, int r, int c, int bsize) {
    const int n4_w = BW[bsize] >> 2, n4_h = BH[bsize] >> 2;
    int count = 0;
    if (r > 0) {
        const int rr = r - 1, end = imin(c + n4_w, w->mi_cols);
        for (int cc = c; cc < end;) {
            int step = imin(BW[AT(w->mi_bsize, rr, cc)] >> 2, 16), probe = cc;
            if (step == 1) {
                probe = (cc & ~1) + 1;
                step = 2;
                if (probe >= w->mi_cols) { w->err = E_PROBE; return 0; }
            }
            if (AT(w->mi_ref0, rr, probe) >= 1) count++;
            cc += step;
        }
    }
    if (c > 0) {
        const int cc = c - 1, end = imin(r + n4_h, w->mi_rows);
        for (int rr = r; rr < end;) {
            int step = imin(BH[AT(w->mi_bsize, rr, cc)] >> 2, 16), probe = rr;
            if (step == 1) {
                probe = (rr & ~1) + 1;
                step = 2;
                if (probe >= w->mi_rows) { w->err = E_PROBE; return 0; }
            }
            if (AT(w->mi_ref0, probe, cc) >= 1) count++;
            rr += step;
        }
    }
    return count;
}

static int mvp_has_top_right(int mi_row, int mi_col, int bs, int n8_w, int n8_h) {
    const int sb_mi = 16;
    if (bs > 16) return 0;
    if (n8_w != n8_h) {
        int is_sec_rect = 0;
        if (n8_w < n8_h && !((mi_col + n8_w) & (n8_h - 1))) is_sec_rect = 1;
        if (n8_w > n8_h && (mi_row & (n8_w - 1))) is_sec_rect = 1;
        if (n8_w > n8_h && is_sec_rect) return 0;
        if (n8_w < n8_h && !is_sec_rect) return 1;
    }
    const int mask_row = mi_row & (sb_mi - 1), mask_col = mi_col & (sb_mi - 1);
    int has_tr = !((mask_row & bs) && (mask_col & bs));
    while (bs < sb_mi) {
        if (mask_col & bs) {
            if ((mask_col & (2 * bs)) && (mask_row & (2 * bs))) {
                has_tr = 0;
                break;
            }
        } else
            break;
        bs <<= 1;
    }
    return has_tr;
}

/* whether find_warp_samples finds at least one sample */
static int has_warp_sample(W *w, int r, int c, int bsize, int rf0) {
#define QUAL(rr, cc) (AT(w->mi_ref0, rr, cc) == rf0 && AT(w->mi_ref1, rr, cc) < 1)
    const int n4_w = BW[bsize] >> 2, n4_h = BH[bsize] >> 2;
    int do_tl = 1, do_tr = 1;
    if (r > 0) {
        const int rr = r - 1;
        int nb_w = BW[AT(w->mi_bsize, rr, c)] >> 2;
        if (n4_w <= nb_w) {
            const int col_off = -(c % nb_w);
            if (col_off < 0) do_tl = 0;
            if (col_off + nb_w > n4_w) do_tr = 0;
            if (QUAL(rr, c)) return 1;
        } else {
            for (int i = 0; i < imin(n4_w, w->mi_cols - c);) {
                const int cc = c + i;
                nb_w = BW[AT(w->mi_bsize, rr, cc)] >> 2;
                if (QUAL(rr, cc)) return 1;
                i += imin(n4_w, nb_w);
            }
        }
    }
    if (c > 0) {
        const int cc = c - 1;
        int nb_h = BH[AT(w->mi_bsize, r, cc)] >> 2;
        if (n4_h <= nb_h) {
            const int row_off = -(r % nb_h);
            if (row_off < 0) do_tl = 0;
            if (QUAL(r, cc)) return 1;
        } else {
            for (int i = 0; i < imin(n4_h, w->mi_rows - r);) {
                const int rr = r + i;
                nb_h = BH[AT(w->mi_bsize, rr, cc)] >> 2;
                if (QUAL(rr, cc)) return 1;
                i += imin(n4_h, nb_h);
            }
        }
    }
    if (do_tl && r > 0 && c > 0 && QUAL(r - 1, c - 1)) return 1;
    if (do_tr && r > 0 && mvp_has_top_right(r, c, imax(n4_w, n4_h), n4_w, n4_h) &&
        c + n4_w < w->mi_cols && QUAL(r - 1, c + n4_w))
        return 1;
    return 0;
#undef QUAL
}

static void write_motion_mode(W *w, const int32_t *o, int r, int c, int bsize) {
    const int mode = o[O_MODE], mm = o[O_MOTION_MODE];
    int kind = 0; /* 0 none, 1 obmc, 2 full */
    if (w->d[D_MM_SWITCHABLE] && imin(BW[bsize], BH[bsize]) >= 8 &&
        !((mode == GLOBALMV || mode == GLOBAL_GLOBALMV) &&
          gm_type(w, o[O_REF0]) >= 2) &&
        o[O_REF1] < 1) {
        const int nov = count_overlappable(w, r, c, bsize);
        if (w->err) return;
        if (nov)
            kind = (!has_warp_sample(w, r, c, bsize, o[O_REF0]) ||
                    !w->d[D_ALLOW_WARPED]) ? 1 : 2;
    }
    if (kind == 0) {
        if (mm != 0) w->err = E_MOTION_MODE;
    } else if (kind == 1) {
        sym(w, F_OBMC, mm == 1, bsize, 0, 0);
    } else {
        sym(w, F_MOTION_MODE, mm, bsize, 0, 0);
    }
}

/* ---- compound type, inter-intra, interpolation filter -------------------- */
static int cgi_nb(W *w, int rr, int cc) {
    if (AT(w->ref1g, rr, cc) >= 1) return AT(w->cgig, rr, cc);
    return AT(w->ref0g, rr, cc) == 7 ? 3 : 0;
}

static int cpi_nb(W *w, int rr, int cc) {
    if (AT(w->ref1g, rr, cc) >= 1) return AT(w->cpig, rr, cc);
    return AT(w->ref0g, rr, cc) == 7 ? 1 : 0;
}

static void write_compound_type(W *w, const int32_t *o, int r, int c,
                                int bsize, int au, int al) {
    if (w->d[D_MASKED] && imin(BW[bsize], BH[bsize]) >= 8) {
        const int ctx = imin(5, (au ? cgi_nb(w, r - 1, c) : 0) +
                                    (al ? cgi_nb(w, r, c - 1) : 0));
        sym(w, F_COMP_GROUP_IDX, o[O_CGI], ctx, 0, 0);
    }
    if (o[O_CGI] == 0) {
        if (w->d[D_JNT]) {
            const int bits = (int)w->d[D_ORDER_HINT_BITS];
            const int cur = (int)w->d[D_ORDER_HINT];
            const int fwd = iabs(rel_dist(bits, (int)w->d[D_REF_HINTS + o[O_REF1] - 1], cur));
            const int bck = iabs(rel_dist(bits, cur, (int)w->d[D_REF_HINTS + o[O_REF0] - 1]));
            const int ctx = (au ? cpi_nb(w, r - 1, c) : 0) +
                            (al ? cpi_nb(w, r, c - 1) : 0) + (fwd == bck ? 3 : 0);
            sym(w, F_COMPOUND_IDX, o[O_CPI], ctx, 0, 0);
        }
        return;
    }
    if (WEDGE_BITS[bsize]) sym(w, F_COMPOUND_TYPE, o[O_COMP_TYPE] - 2, bsize, 0, 0);
    if (o[O_COMP_TYPE] == 2) { /* COMPOUND_WEDGE */
        sym(w, F_WEDGE_IDX, o[O_WEDGE_INDEX], bsize, 0, 0);
        ec_literal(w->e, (uint32_t)o[O_WEDGE_SIGN], 1);
    } else {
        ec_literal(w->e, (uint32_t)o[O_MASK_TYPE], 1);
    }
}

static int write_interintra(W *w, const int32_t *o, int bsize) {
    if (!w->d[D_INTERINTRA]) return 0;
    if (!(BW[bsize] >= 8 && BW[bsize] <= 32 && BH[bsize] >= 8 && BH[bsize] <= 32))
        return 0;
    if (!(o[O_MODE] >= NEARESTMV && o[O_MODE] <= NEWMV)) return 0;
    const int grp = SIZE_GROUP[bsize], ii = o[O_II_MODE] >= 0;
    sym(w, F_INTERINTRA, ii, grp, 0, 0);
    if (!ii) return 1;
    sym(w, F_INTERINTRA_MODE, o[O_II_MODE], grp, 0, 0);
    if (WEDGE_BITS[bsize]) {
        sym(w, F_WEDGE_INTERINTRA, o[O_WEDGE_II], bsize, 0, 0);
        if (o[O_WEDGE_II]) sym(w, F_WEDGE_IDX, o[O_WEDGE_INDEX], bsize, 0, 0);
    }
    return 1;
}

static void write_interp_filter(W *w, const int32_t *o, int r, int c, int au,
                                int al) {
    if (w->d[D_INTERP_FILTER] != 4) return; /* SWITCHABLE */
    if (o[O_MOTION_MODE] == 2) return;
    const int lb = o[O_LEAF_BSIZE], mode = o[O_MODE];
    const int large = imin(BW[lb], BH[lb]) >= 8;
    if (large && mode == GLOBALMV) {
        if (gm_type(w, o[O_REF0]) != 1) return;
    } else if (large && mode == GLOBAL_GLOBALMV) {
        if (gm_type(w, o[O_REF0]) != 1 && gm_type(w, o[O_REF1]) != 1) return;
    }
    const int rf0 = o[O_REF0];
    int ctx = o[O_REF1] >= 1 ? 4 : 0;
    int left = 3, above = 3;
    if (al && (AT(w->ref0g, r, c - 1) == rf0 || AT(w->ref1g, r, c - 1) == rf0))
        left = AT(w->flt, r, c - 1);
    if (au && (AT(w->ref0g, r - 1, c) == rf0 || AT(w->ref1g, r - 1, c) == rf0))
        above = AT(w->flt, r - 1, c);
    if (left == above) ctx += left;
    else if (left == 3) ctx += above;
    else if (above == 3) ctx += left;
    else ctx += 3;
    sym(w, F_SWITCHABLE_INTERP, o[O_INTERP_FILTER], ctx, 0, 0);
}

/* ---- inter mode info ----------------------------------------------------- */
static void write_inter_mode_info(W *w, const int32_t *o, int r, int c,
                                  int bsize, int au, int al, int use_angle,
                                  int has_chroma) {
    const int a_int = au ? AT(w->inters, r - 1, c) : -1;
    const int l_int = al ? AT(w->inters, r, c - 1) : -1;
    int ctx;
    if (au && al) ctx = (a_int == 0 && l_int == 0) ? 3 : (a_int == 0) + (l_int == 0);
    else if (au || al) ctx = 2 * ((au ? a_int : l_int) == 0);
    else ctx = 0;
    sym(w, F_INTRA_INTER, o[O_IS_INTER] ? 1 : 0, ctx, 0, 0);
    if (!o[O_IS_INTER]) {
        sym(w, F_Y_MODE, o[O_Y_MODE], SIZE_GROUP[bsize], 0, 0);
        if (use_angle && directional(o[O_Y_MODE]))
            sym(w, F_ANGLE_DELTA, o[O_ANGLE_Y] + 3, o[O_Y_MODE] - 1, 0, 0);
        if (has_chroma) write_uv_mode(w, o, bsize, use_angle);
        return;
    }
    write_ref_frames(w, o, r, c, au, al);
    const int ref0 = o[O_REF0], ref1 = o[O_REF1], is_comp = ref1 >= 1;

    int g0r, g0c, g1r, g1c;
    gm_mv(w, ref0, r, c, bsize, &g0r, &g0c);
    gm_mv(w, ref1, r, c, bsize, &g1r, &g1c);
    const int rf1 = is_comp ? ref1 : -1;
    const uint8_t *tv = PTR(const uint8_t *, D_TPL_VALID);
    const int32_t *cur_off = PTR(const int32_t *, D_TPL_CUR_OFF);
    const int co0 = tv ? cur_off[ref0 & 7] : 0;
    const int co1 = (tv && is_comp) ? cur_off[ref1 & 7] : 0;
    int32_t out[43];
    svt_find_mv_stack(w->mi_ref0, w->mi_ref1, w->mi_mvr, w->mi_mvc, w->mi_mvr1,
                      w->mi_mvc1, w->mi_newmv, w->mi_gmv, w->mi_bsize,
                      PTR(const uint8_t *, D_MI_SIGN_BIAS), w->mi_rows,
                      w->mi_cols, r, c, bsize, ref0, rf1, g0r, g0c, g1r, g1c,
                      gm_type(w, ref0) >= 2, tv,
                      PTR(const int16_t *, D_TPL_ROW),
                      PTR(const int16_t *, D_TPL_COL),
                      PTR(const int16_t *, D_TPL_OFF), co0, co1, out);
    Stack s;
    s.count = out[0];
    s.mode_ctx = out[1];
    s.slots = out[42];
    for (int i = 0; i < 8; i++) {
        const int32_t *en = out + 2 + 5 * i;
        s.mv[i][0] = en[0];
        s.mv[i][1] = en[1];
        s.mv1[i][0] = en[2];
        s.mv1[i][1] = en[3];
        s.weight[i] = en[4];
    }
    const int mode = o[O_MODE], drl = o[O_DRL];
    /* the stack entry a NEW component codes its residual against */
#define REF_OK() if (drl < 0 || drl >= s.slots) { w->err = E_DRL; return; }

    if (is_comp) {
        const int newmv_ctx = s.mode_ctx & 7, refmv_ctx = (s.mode_ctx >> 4) & 15;
        if ((refmv_ctx >> 1) > 2 || mode < 17 || mode > 24) { w->err = E_MODE_CTX; return; }
        sym(w, F_INTER_COMPOUND_MODE, mode - 17,
            COMP_MODE_CTX_MAP[refmv_ctx >> 1][imin(newmv_ctx, 4)], 0, 0);
        const int sub0 = COMP_SUB[mode - 17][0], sub1 = COMP_SUB[mode - 17][1];
        write_drl(w, drl, &s, mode == NEW_NEWMV, sub0 == NEARMV || sub1 == NEARMV);
        if (sub0 == NEWMV) { REF_OK(); write_mv(w, o[O_MV_R], o[O_MV_C], s.mv[drl]); }
        if (sub1 == NEWMV) { REF_OK(); write_mv(w, o[O_MV1_R], o[O_MV1_C], s.mv1[drl]); }
        write_compound_type(w, o, r, c, bsize, au, al);
        write_interp_filter(w, o, r, c, au, al);
        return;
    }
    sym(w, F_NEWMV, mode != NEWMV, s.mode_ctx & 7, 0, 0);
    if (mode != NEWMV) {
        sym(w, F_ZEROMV, mode != GLOBALMV, (s.mode_ctx >> 3) & 1, 0, 0);
        if (mode != GLOBALMV)
            sym(w, F_REFMV, mode != NEARESTMV, (s.mode_ctx >> 4) & 15, 0, 0);
    }
    write_drl(w, drl, &s, mode == NEWMV, mode == NEARMV);
    if (mode == NEWMV) { REF_OK(); write_mv(w, o[O_MV_R], o[O_MV_C], s.mv[drl]); }
#undef REF_OK
    const int ii_coded = write_interintra(w, o, bsize);
    if (!ii_coded || o[O_II_MODE] < 0) write_motion_mode(w, o, r, c, bsize);
    if (w->err) return;
    write_interp_filter(w, o, r, c, au, al);
}

/* ---- transform sizes ----------------------------------------------------- */
static void set_txi(W *w, int r, int c, int w4, int h4, int wpx, int hpx) {
    fill_u8(w->txi_above, w->mi_cols, c, w4, wpx);
    fill_u8(w->txi_left, w->mi_rows, r, h4, hpx);
}

static void set_txp(W *w, int r, int c, int w4, int h4, int wpx, int hpx) {
    fill_u8(w->txp_above, w->mi_cols, c, w4, wpx);
    fill_u8(w->txp_left, w->mi_rows, r, h4, hpx);
}

static int txfm_partition_ctx(int above_v, int left_v, int tx, int bw_px,
                              int bh_px) {
    if (tx == 0) return 0;
    const int above = above_v < TXW[tx], left = left_v < TXH[tx];
    const int mx = imax(bw_px, bh_px);
    const int max_sq = mx == 64 ? 4 : mx == 32 ? 3 : mx == 16 ? 2 : mx == 8 ? 1 : 0;
    int category = 0;
    if (max_sq >= 1)
        category = (TX_SQR_UP[tx] != max_sq && max_sq > 1) + (5 - 1 - max_sq) * 2;
    return category * 3 + above + left;
}

static void write_vartx(W *w, int r, int c, int tx, int target, int depth,
                        int bw_px, int bh_px) {
    if (r >= w->mi_rows || c >= w->mi_cols) return;
    const int txw = TXW[tx], txh = TXH[tx];
    if (depth == 2) {
        set_txp(w, r, c, txw >> 2, txh >> 2, txw, txh);
        return;
    }
    const int ctx = txfm_partition_ctx(w->txp_above[c], w->txp_left[r], tx,
                                       bw_px, bh_px);
    if (tx == target) {
        sym(w, F_TXFM_PARTITION, 0, ctx, 0, 0);
        set_txp(w, r, c, txw >> 2, txh >> 2, txw, txh);
        return;
    }
    sym(w, F_TXFM_PARTITION, 1, ctx, 0, 0);
    const int sub = SPLIT_TX[tx];
    if (sub == 0) {
        set_txp(w, r, c, txw >> 2, txh >> 2, 4, 4);
        return;
    }
    const int sw4 = TXW[sub] >> 2, sh4 = TXH[sub] >> 2;
    for (int dr = 0; dr < (txh >> 2); dr += sh4)
        for (int dc = 0; dc < (txw >> 2); dc += sw4)
            write_vartx(w, r + dr, c + dc, sub, target, depth + 1, bw_px, bh_px);
}

static void code_tx_size(W *w, const int32_t *o, int r, int c, int bsize) {
    const int bw4 = BW[bsize] >> 2, bh4 = BH[bsize] >> 2;
    const int max_tx = MAX_TX_RECT[bsize];
    int tx = max_tx;
    for (int i = 0; i < o[O_TX_DEPTH]; i++) tx = SPLIT_TX[tx];
    const int txw = TXW[tx], txh = TXH[tx], bw_px = BW[bsize], bh_px = BH[bsize];
    const int is_int = o[O_IS_INTER], skip = o[O_SKIP];
    if (bsize > 0 && !(is_int && skip)) {
        if (is_int) {
            write_vartx(w, r, c, max_tx, tx, 0, bw_px, bh_px);
            set_txi(w, r, c, bw4, bh4, bw_px, bh_px);
            return;
        }
        const int above = r > w->r0 ? w->txi_above[c] >= TXW[max_tx] : 0;
        const int left = c > w->c0 ? w->txi_left[r] >= TXH[max_tx] : 0;
        sym(w, F_TX_SIZE, o[O_TX_DEPTH], TX_CAT[bsize], above + left, 0);
        set_txi(w, r, c, bw4, bh4, txw, txh);
        set_txp(w, r, c, bw4, bh4, txw, txh);
        return;
    }
    if (is_int) {
        set_txi(w, r, c, bw4, bh4, bw_px, bh_px);
        if (skip) set_txp(w, r, c, bw4, bh4, bw_px, bh_px);
        else set_txp(w, r, c, bw4, bh4, txw, txh);
    } else {
        set_txi(w, r, c, bw4, bh4, txw, txh);
        set_txp(w, r, c, bw4, bh4, txw, txh);
    }
}

/* ---- coefficients (coeff_writer.py write_txb) ---------------------------- */
static void write_tx_type(W *w, const int32_t *o, int tx, int tx_type) {
    if (w->d[D_BASE_Q_IDX] == 0) return;
    const int squ = TX_SQR_UP[tx], sqr = TX_SQR[tx];
    if (squ > 3) return;
    const int reduced = (int)w->d[D_REDUCED_TX_SET];
    if (tx_type < 0 || tx_type > 15) { w->err = E_TX_TYPE; return; }
    if (o[O_IS_INTER]) {
        int eset, ind;
        if (reduced || squ == 3) { eset = 3; ind = INTER_SET3[tx_type]; }
        else if (sqr == 2) { eset = 2; ind = INTER_SET2[tx_type]; }
        else { eset = 1; ind = INTER_SET1[tx_type]; }
        if (ind < 0) { w->err = E_TX_TYPE; return; }
        sym(w, F_INTER_EXT_TX, ind, eset, sqr, 0);
        return;
    }
    if (squ == 3) return;
    int eset, ind;
    if (reduced || sqr == 2) { eset = 2; ind = INTRA_SET2[tx_type]; }
    else { eset = 1; ind = INTRA_SET1[tx_type]; }
    if (ind < 0) { w->err = E_TX_TYPE; return; }
    const int dir = o[O_FILTER_INTRA] ? FI_TO_DIR[o[O_FI_MODE]] : o[O_Y_MODE];
    sym(w, F_INTRA_EXT_TX, ind, eset, sqr, dir);
}

static void set_coeff_ctx(W *w, int plane, int tx, int ux, int uy, int v) {
    fill_u8(w->ctx_above[plane], w->ctx_above_len[plane], ux, TXW[tx] >> 2, v);
    fill_u8(w->ctx_left[plane], w->ctx_left_len[plane], uy, TXH[tx] >> 2, v);
}

static void write_txb(W *w, const int32_t *o, const int64_t *t) {
    const int plane = (int)t[T_PLANE], pbs = (int)t[T_PLANE_BSIZE];
    const int tx = (int)t[T_TX_SIZE], tx_type = (int)t[T_TX_TYPE];
    const int eob = (int)t[T_EOB], ux = (int)t[T_UX], uy = (int)t[T_UY];
    const int32_t *q = (const int32_t *)(intptr_t)t[T_QCOEFF];
    const int cw = imin(TXW[tx], 32), ch = imin(TXH[tx], 32);
    const int ts = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1;
    const int ptype = plane > 0;
    const uint8_t *a = w->ctx_above[plane], *l = w->ctx_left[plane];
    const int tw_n = imin(TXW[tx] >> 2, w->ctx_above_len[plane] - ux);
    const int th_n = imin(TXH[tx] >> 2, w->ctx_left_len[plane] - uy);
    int32_t packed;
    if (plane == 0)
        packed = svt_txb_skip_ctx(a + ux, l + uy, tw_n, th_n, 1,
                                  BW[pbs] == TXW[tx] && BH[pbs] == TXH[tx], 0);
    else
        packed = svt_txb_skip_ctx(a + ux, l + uy, tw_n, th_n, 0, 0,
                                  BW[pbs] * BH[pbs] > TXW[tx] * TXH[tx] ? 10 : 7);
    const int skip_ctx = packed & 0xFF, dc_sign_ctx = packed >> 8;
    sym(w, F_TXB_SKIP, eob == 0, ts, skip_ctx, 0);
    if (eob == 0) {
        set_coeff_ctx(w, plane, tx, ux, uy, 0);
        return;
    }
    if (plane == 0) {
        write_tx_type(w, o, tx, tx_type);
        if (w->err) return;
    }
    if (tx_type < 0 || tx_type > 15) { w->err = E_TX_TYPE; return; }
    const int tx_class = TX_CLASS[tx_type];
    const int eob_pt = eob < 33 ? EOB_TO_POS_SMALL[eob]
                                : EOB_TO_POS_LARGE[imin((eob - 1) >> 5, 16)];
    const int extra = eob - EOB_GROUP_START[eob_pt];
    const int multi = (bitlen((uint32_t)cw) - 1) + (bitlen((uint32_t)ch) - 1) - 4;
    sym(w, F_EOB_FLAG16 + multi, eob_pt - 1, ptype, tx_class != 0, 0);
    const int ob = EOB_OFFSET_BITS[eob_pt];
    if (ob > 0) {
        sym(w, F_EOB_EXTRA, (extra >> (ob - 1)) & 1, ts, ptype, eob_pt);
        for (int i = 1; i < ob; i++)
            ec_literal(w->e, (uint32_t)((extra >> (ob - 1 - i)) & 1), 1);
    }
    const Fam *base = &w->fam[F_COEFF_BASE], *beob = &w->fam[F_COEFF_BASE_EOB];
    const Fam *br = &w->fam[F_COEFF_BR], *dcs = &w->fam[F_DC_SIGN];
    const int64_t kb = ((int64_t)ts * base->d1 + ptype) * base->d2;
    const int64_t ke = ((int64_t)ts * beob->d1 + ptype) * beob->d2;
    const int64_t kr = ((int64_t)imin(ts, 3) * br->d1 + ptype) * br->d2;
    const int64_t kd = (int64_t)ptype * dcs->d1 * dcs->d2;
    const int64_t *scans = PTR(const int64_t *, D_SCANS);
    const int64_t *nz_offs = PTR(const int64_t *, D_NZ_OFFS);
    const int32_t *scan = (const int32_t *)(intptr_t)scans[tx * 3 + tx_class];
    const int32_t *nz = (const int32_t *)(intptr_t)nz_offs[tx * 3 + tx_class];
    int64_t cul = svt_ec_txb_emit(
        w->e, q, scan, eob, cw, ch, tx_class, nz, base->v + kb * base->len,
        base->c + kb, beob->v + ke * beob->len, beob->c + ke,
        br->v + kr * br->len, br->c + kr, dcs->v + kd * dcs->len, dcs->c + kd,
        dc_sign_ctx, w->adapt);
    if (q[0] < 0) cul |= 1 << 6;
    else if (q[0] > 0) cul += 2 << 6;
    set_coeff_ctx(w, plane, tx, ux, uy, (int)cul);
}

/* ---- one leaf (TileWriter._write_block) ---------------------------------- */
static void write_block(W *w, const int32_t *o, const int64_t *txbs) {
    const int r = o[O_R], c = o[O_C], bsize = o[O_BSIZE];
    const int bw4 = BW[bsize] >> 2, bh4 = BH[bsize] >> 2;
    const int au = r > w->r0, al = c > w->c0;
    const int skip = o[O_SKIP] ? 1 : 0;
    const int above_skip = au ? AT(w->skips, r - 1, c) : 0;
    const int left_skip = al ? AT(w->skips, r, c - 1) : 0;
    sym(w, F_SKIP, skip, above_skip + left_skip, 0, 0);
    write_segment_id(w, r, c, bsize, au, al, skip);
    write_cdef(w, r, c, skip);
    if (w->err) return;
    write_delta_q(w, r, c, bsize, skip);

    const int use_angle = bsize >= 3;
    const int ss_x = (int)w->d[D_SS_X], ss_y = (int)w->d[D_SS_Y];
    const int has_chroma = !w->d[D_MONO] &&
                           ((r & 1) || !(bh4 & 1) || ss_y == 0) &&
                           ((c & 1) || !(bw4 & 1) || ss_x == 0);
    const int is_inter = o[O_IS_INTER] ? 1 : 0, y_mode = o[O_Y_MODE];
    if (w->d[D_FRAME_IS_INTRA]) {
        const int am = au ? AT(w->y_modes, r - 1, c) : 0;
        const int lm = al ? AT(w->y_modes, r, c - 1) : 0;
        sym(w, F_KF_Y_MODE, y_mode, INTRA_MODE_CTX[am], INTRA_MODE_CTX[lm], 0);
        if (use_angle && directional(y_mode))
            sym(w, F_ANGLE_DELTA, o[O_ANGLE_Y] + 3, y_mode - 1, 0, 0);
        if (has_chroma) write_uv_mode(w, o, bsize, use_angle);
    } else {
        write_inter_mode_info(w, o, r, c, bsize, au, al, use_angle, has_chroma);
        if (w->err) return;
    }
    /* palette_mode_info: the flags of a leaf with no palette */
    if (!is_inter && w->d[D_SCREEN_CONTENT] && bsize >= 3 && BW[bsize] <= 64 &&
        BH[bsize] <= 64) {
        const int bctx = bitlen((uint32_t)(BW[bsize] * BH[bsize])) - 1 - 6;
        if (y_mode == 0) {
            const int ctx = (au && AT(w->pal_size, r - 1, c) > 0) +
                            (al && AT(w->pal_size, r, c - 1) > 0);
            sym(w, F_PALETTE_Y_MODE, 0, bctx, ctx, 0);
        }
        if (has_chroma && o[O_UV_MODE] == 0) sym(w, F_PALETTE_UV_MODE, 0, 0, 0, 0);
    }
    if (w->d[D_FILTER_INTRA] && !is_inter && y_mode == 0 &&
        imax(BW[bsize], BH[bsize]) <= 32) {
        sym(w, F_FILTER_INTRA, o[O_FILTER_INTRA] ? 1 : 0, bsize, 0, 0);
        if (o[O_FILTER_INTRA]) sym(w, F_FILTER_INTRA_MODE, o[O_FI_MODE], 0, 0, 0);
    }
    if (w->d[D_TX_MODE_SELECT]) code_tx_size(w, o, r, c, bsize);

    if (skip) {
        fill_u8(w->ctx_above[0], w->ctx_above_len[0], c, bw4, 0);
        fill_u8(w->ctx_left[0], w->ctx_left_len[0], r, bh4, 0);
        if (has_chroma) {
            const int cx = c >> ss_x, cy = r >> ss_y;
            const int cwn = imax(bw4 >> ss_x, 1), chn = imax(bh4 >> ss_y, 1);
            for (int p = 1; p < 3; p++) {
                fill_u8(w->ctx_above[p], w->ctx_above_len[p], cx, cwn, 0);
                fill_u8(w->ctx_left[p], w->ctx_left_len[p], cy, chn, 0);
            }
        }
    } else {
        for (int i = 0; i < o[O_NTXB]; i++) {
            write_txb(w, o, txbs + (int64_t)(o[O_TXB0] + i) * T_WIDTH);
            if (w->err) return;
        }
    }

    /* neighbour state */
    fill_i8(w, w->y_modes, r, c, bh4, bw4, y_mode);
    fill_i8(w, w->skips, r, c, bh4, bw4, skip);
    fill_i8(w, w->pal_size, r, c, bh4, bw4, 0);
    fill_i8(w, w->inters, r, c, bh4, bw4, is_inter);
    fill_i8(w, w->flt, r, c, bh4, bw4, is_inter ? o[O_INTERP_FILTER] : 3);
    fill_i8(w, w->ref0g, r, c, bh4, bw4, is_inter ? o[O_REF0] : 0);
    fill_i8(w, w->ref1g, r, c, bh4, bw4, is_inter ? o[O_REF1] : -1);
    fill_i8(w, w->cgig, r, c, bh4, bw4, is_inter ? o[O_CGI] : 0);
    fill_i8(w, w->cpig, r, c, bh4, bw4, is_inter ? o[O_CPI] : 1);
    if (w->has_mi) {
        const int mode = o[O_MODE];
        const int newmv = is_inter && (mode == 16 || (mode >= 19 && mode <= 22) ||
                                       mode == 24);
        fill_i8(w, w->mi_ref0, r, c, bh4, bw4, is_inter ? o[O_REF0] : -1);
        fill_i8(w, w->mi_ref1, r, c, bh4, bw4, is_inter ? o[O_REF1] : -1);
        fill_i16(w, w->mi_mvr, r, c, bh4, bw4, is_inter ? o[O_MV_R] : 0);
        fill_i16(w, w->mi_mvc, r, c, bh4, bw4, is_inter ? o[O_MV_C] : 0);
        fill_i16(w, w->mi_mvr1, r, c, bh4, bw4, is_inter ? o[O_MV1_R] : 0);
        fill_i16(w, w->mi_mvc1, r, c, bh4, bw4, is_inter ? o[O_MV1_C] : 0);
        fill_i8(w, w->mi_newmv, r, c, bh4, bw4, newmv);
        fill_i8(w, w->mi_gmv, r, c, bh4, bw4,
                is_inter && (mode == GLOBALMV || mode == GLOBAL_GLOBALMV));
        fill_i8(w, w->mi_flt, r, c, bh4, bw4, is_inter ? o[O_INTERP_FILTER] : 0);
        fill_i8(w, w->mi_bsize, r, c, bh4, bw4, bsize);
    }
    const int bsl_w = bitlen((uint32_t)bw4) - 1, bsl_h = bitlen((uint32_t)bh4) - 1;
    fill_u8(w->above_part, w->mi_cols, c, bw4, (31 << bsl_w) & 31);
    fill_u8(w->left_part, w->mi_rows, r, bh4, (31 << bsl_h) & 31);
}

/* ---- entry --------------------------------------------------------------- */
/* Codes the ops of one superblock whose origin is (sb_r, sb_c). io[0]
 * carries the running qindex of delta q in and out. Returns 0, or a
 * negative E_* code where the Python walk's checks would fail. */
int32_t svt_tw_superblock(EcEnc *e, const int64_t *desc, const int32_t *ops,
                          int n_ops, const int64_t *txbs, int sb_r, int sb_c,
                          int32_t *io) {
    e->n_calls++;
    W ws, *w = &ws;
    memset(w, 0, sizeof(*w));
    w->e = e;
    w->d = desc;
    w->adapt = (int)desc[D_ADAPT];
    w->mi_rows = (int)desc[D_MI_ROWS];
    w->mi_cols = (int)desc[D_MI_COLS];
    w->r0 = (int)desc[D_R0];
    w->c0 = (int)desc[D_C0];
    w->sb_r = sb_r;
    w->sb_c = sb_c;
    w->prev_qindex = io[0];
    w->y_modes = PTR(int8_t *, D_Y_MODES);
    w->skips = PTR(int8_t *, D_SKIPS);
    w->inters = PTR(int8_t *, D_INTERS);
    w->flt = PTR(int8_t *, D_FLT);
    w->ref0g = PTR(int8_t *, D_REF0G);
    w->ref1g = PTR(int8_t *, D_REF1G);
    w->cgig = PTR(int8_t *, D_CGIG);
    w->cpig = PTR(int8_t *, D_CPIG);
    w->pal_size = PTR(int8_t *, D_PAL_SIZE);
    w->seg_map = PTR(int8_t *, D_SEG_MAP);
    w->seg_target = PTR(const int8_t *, D_SEG_TARGET);
    w->cdef_map = PTR(const int32_t *, D_CDEF_MAP);
    w->qmap = PTR(const int32_t *, D_QMAP);
    w->above_part = PTR(uint8_t *, D_ABOVE_PART);
    w->left_part = PTR(uint8_t *, D_LEFT_PART);
    w->txi_above = PTR(uint8_t *, D_TXI_ABOVE);
    w->txi_left = PTR(uint8_t *, D_TXI_LEFT);
    w->txp_above = PTR(uint8_t *, D_TXP_ABOVE);
    w->txp_left = PTR(uint8_t *, D_TXP_LEFT);
    for (int p = 0; p < 3; p++) {
        w->ctx_above[p] = PTR(uint8_t *, D_CTX_ABOVE + p);
        w->ctx_left[p] = PTR(uint8_t *, D_CTX_LEFT + p);
        w->ctx_above_len[p] = (int)desc[D_CTX_ABOVE_LEN + p];
        w->ctx_left_len[p] = (int)desc[D_CTX_LEFT_LEN + p];
    }
    w->has_mi = desc[D_MI] != 0;
    w->mi_ref0 = PTR(int8_t *, D_MI_REF0);
    w->mi_ref1 = PTR(int8_t *, D_MI_REF1);
    w->mi_mvr = PTR(int16_t *, D_MI_MVR);
    w->mi_mvc = PTR(int16_t *, D_MI_MVC);
    w->mi_mvr1 = PTR(int16_t *, D_MI_MVR1);
    w->mi_mvc1 = PTR(int16_t *, D_MI_MVC1);
    w->mi_newmv = PTR(int8_t *, D_MI_NEWMV);
    w->mi_gmv = PTR(int8_t *, D_MI_GMV);
    w->mi_flt = PTR(int8_t *, D_MI_FLT);
    w->mi_bsize = PTR(int8_t *, D_MI_BSIZE);
    for (int f = 0; f < N_FAM; f++) {
        const int64_t *s = desc + D_FAMS + f * FAM_SLOTS;
        w->fam[f].v = (int32_t *)(intptr_t)s[0];
        w->fam[f].c = (int32_t *)(intptr_t)s[1];
        w->fam[f].n = (const int32_t *)(intptr_t)s[2];
        w->fam[f].len = s[3];
        w->fam[f].d1 = s[5];
        w->fam[f].d2 = s[6];
    }
    for (int i = 0; i < n_ops && !w->err; i++) {
        const int32_t *o = ops + (int64_t)i * O_WIDTH;
        if (o[O_KIND] == 0)
            write_partition(w, o[O_PARTITION], o[O_R], o[O_C], o[O_BSIZE]);
        else
            write_block(w, o, txbs);
    }
    io[0] = w->prev_qindex;
    return -w->err;
}
