"""Coefficient (residual) syntax writer — spec coeffs() on the encode side.

Implements txb_skip, tx_type signaling, EOB classes + extra bits, base
levels (coeff_base_eob / coeff_base), high-range levels (coeff_br +
golomb), and signs, with exact context derivations:

* txb_skip ctx:      svt_aom_get_txb_ctx      (entropy_coding.c:313)
* sig-coeff ctx:     get_nz_mag / get_nz_map_ctx_from_stats
                     (coefficients.h:2884,2908 — generative form used)
* br ctx:            get_br_ctx               (common_utils.h:114)
* eob classes:       get_eob_pos_token        (entropy_coding.c:296)
* per-4x4 entropy context bytes: cul_level | dc_sign<<6 (set_dc_sign)

All derivations are vectorizable; this host version is the reference and
feeds the symbol stream; batched device variants compute contexts for RD
estimation in ops/.
"""

from __future__ import annotations

import numpy as np
from functools import lru_cache

from ..codec.constants import BLOCK_H, BLOCK_W, TX_H, TX_W, TxType, tx_size_sqr, tx_size_sqr_up
from .tables import scan_table

COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = (1 << COEFF_CONTEXT_BITS) - 1
NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
TX_PAD_HOR = 4

# spec eob group tables
EOB_GROUP_START = np.array([0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513])
EOB_OFFSET_BITS = np.array([0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9])

EOB_TO_POS_SMALL = np.array([0, 1, 2, 3, 3, 4, 4, 4, 4] + [5] * 8 + [6] * 16)
EOB_TO_POS_LARGE = np.array([6, 7, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 11])

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
TX_TYPE_CLASS = {
    TxType.DCT_DCT: TX_CLASS_2D, TxType.ADST_DCT: TX_CLASS_2D,
    TxType.DCT_ADST: TX_CLASS_2D, TxType.ADST_ADST: TX_CLASS_2D,
    TxType.FLIPADST_DCT: TX_CLASS_2D, TxType.DCT_FLIPADST: TX_CLASS_2D,
    TxType.FLIPADST_FLIPADST: TX_CLASS_2D, TxType.ADST_FLIPADST: TX_CLASS_2D,
    TxType.FLIPADST_ADST: TX_CLASS_2D, TxType.IDTX: TX_CLASS_2D,
    TxType.V_DCT: TX_CLASS_VERT, TxType.H_DCT: TX_CLASS_HORIZ,
    TxType.V_ADST: TX_CLASS_VERT, TxType.H_ADST: TX_CLASS_HORIZ,
    TxType.V_FLIPADST: TX_CLASS_VERT, TxType.H_FLIPADST: TX_CLASS_HORIZ,
}

_NZ_CTX_OFFSET_1D = np.array([0, 5, 10] + [10] * 29) + 26  # SIG_COEF_CONTEXTS_2D=26


FAST_RATE = True  # vectorized RateCounter path (tests flip to cross-check)


def txs_ctx(tx_size: int) -> int:
    return (tx_size_sqr(tx_size) + tx_size_sqr_up(tx_size) + 1) >> 1


def eob_pos_token(eob: int) -> tuple[int, int]:
    if eob < 33:
        t = int(EOB_TO_POS_SMALL[eob])
    else:
        t = int(EOB_TO_POS_LARGE[min((eob - 1) >> 5, 16)])
    return t, eob - int(EOB_GROUP_START[t])


def _nz_ctx_offset_2d(row: np.ndarray, col: np.ndarray, w: int, h: int) -> np.ndarray:
    """Generative form of eb_av1_nz_map_ctx_offset (comment in
    coefficients.h:2917). w/h are the FULL tx dims (rect rule), row/col
    are within the coded (<=32) region. Rect rules take precedence."""
    out = np.full(row.shape, 21, np.int32)
    out = np.where(row + col < 4, 6, out)
    out = np.where(row + col < 2, 1, out)
    if w < h:
        out = np.where(row < 2, 11, out)
    elif w > h:
        out = np.where(col < 2, 16, out)
    return out


class CoeffWriter:
    """Per-tile coefficient writer with entropy-context tracking.

    Entropy context: one byte per 4x4 unit per plane, above[mi cols] and
    left[mi rows] arrays (chroma indexed in chroma mi units).
    """

    def __init__(self, tile_writer, mi_rows: int, mi_cols: int, ss_x: int, ss_y: int):
        self.tw = tile_writer
        self.ss_x = ss_x
        self.ss_y = ss_y
        self._txb_ptr_cache: dict = {}
        self.above = [np.zeros(mi_cols, np.uint8),
                      np.zeros((mi_cols >> ss_x) + 1, np.uint8),
                      np.zeros((mi_cols >> ss_x) + 1, np.uint8)]
        self.left = [np.zeros(mi_rows, np.uint8),
                     np.zeros((mi_rows >> ss_y) + 1, np.uint8),
                     np.zeros((mi_rows >> ss_y) + 1, np.uint8)]

    # ---- contexts ------------------------------------------------------------
    def _txb_ctx(self, plane: int, plane_bsize: int, tx_size: int,
                 ux: int, uy: int) -> tuple[int, int]:
        """(txb_skip_ctx, dc_sign_ctx); ux/uy in 4px units of this plane."""
        tw_units = int(TX_W[tx_size]) >> 2
        th_units = int(TX_H[tx_size]) >> 2
        a = self.above[plane][ux : ux + tw_units]
        l = self.left[plane][uy : uy + th_units]

        signs = np.array([0, -1, 1])
        dc_sign = int(signs[a >> COEFF_CONTEXT_BITS].sum() + signs[l >> COEFF_CONTEXT_BITS].sum())
        dc_sign_ctx = 2 if dc_sign > 0 else (1 if dc_sign < 0 else 0)

        if plane == 0:
            bw, bh = int(BLOCK_W[plane_bsize]), int(BLOCK_H[plane_bsize])
            if bw == int(TX_W[tx_size]) and bh == int(TX_H[tx_size]):
                return 0, dc_sign_ctx
            skip_contexts = np.array([[1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
                                      [1, 4, 4, 4, 5], [1, 4, 4, 4, 6]])
            top = int(np.bitwise_or.reduce(a) & COEFF_CONTEXT_MASK) if len(a) else 0
            lft = int(np.bitwise_or.reduce(l) & COEFF_CONTEXT_MASK) if len(l) else 0
            mx = min(top | lft, 4)
            mn = min(min(top, lft), 4)
            return int(skip_contexts[mn][mx]), dc_sign_ctx
        ctx_base = int((a != 0).any()) + int((l != 0).any())
        bw, bh = int(BLOCK_W[plane_bsize]), int(BLOCK_H[plane_bsize])
        ctx_offset = 10 if bw * bh > int(TX_W[tx_size]) * int(TX_H[tx_size]) else 7
        return ctx_base + ctx_offset, dc_sign_ctx

    def reset_skip_ctx(self, r: int, c: int, bw4: int, bh4: int,
                       has_chroma: bool) -> None:
        """spec reset_block_context: skip blocks zero the entropy context."""
        self.above[0][c : c + bw4] = 0
        self.left[0][r : r + bh4] = 0
        if has_chroma:
            cx, cy = c >> self.ss_x, r >> self.ss_y
            cw = max(bw4 >> self.ss_x, 1)
            chh = max(bh4 >> self.ss_y, 1)
            for p in (1, 2):
                self.above[p][cx : cx + cw] = 0
                self.left[p][cy : cy + chh] = 0

    def _update_ctx(self, plane: int, tx_size: int, ux: int, uy: int,
                    cul_level: int) -> None:
        tw_units = int(TX_W[tx_size]) >> 2
        th_units = int(TX_H[tx_size]) >> 2
        self.above[plane][ux : ux + tw_units] = cul_level
        self.left[plane][uy : uy + th_units] = cul_level

    # ---- txb write -----------------------------------------------------------
    def _txb_ctx_native(self, plane: int, plane_bsize: int, tx_size: int,
                        ux: int, uy: int):
        """C-backed _txb_ctx (native/ecenc.c svt_txb_skip_ctx)."""
        lib = self.tw.enc._lib
        tw_units = int(TX_W[tx_size]) >> 2
        th_units = int(TX_H[tx_size]) >> 2
        a = self.above[plane]
        l = self.left[plane]
        if plane == 0:
            bw, bh = int(BLOCK_W[plane_bsize]), int(BLOCK_H[plane_bsize])
            same = bw == int(TX_W[tx_size]) and bh == int(TX_H[tx_size])
            packed = lib.svt_txb_skip_ctx(
                a.ctypes.data + ux, l.ctypes.data + uy,
                min(tw_units, len(a) - ux), min(th_units, len(l) - uy),
                1, 1 if same else 0, 0)
        else:
            bw, bh = int(BLOCK_W[plane_bsize]), int(BLOCK_H[plane_bsize])
            off = 10 if bw * bh > int(TX_W[tx_size]) * int(TX_H[tx_size]) else 7
            packed = lib.svt_txb_skip_ctx(
                a.ctypes.data + ux, l.ctypes.data + uy,
                min(tw_units, len(a) - ux), min(th_units, len(l) - uy),
                0, 0, off)
        return packed & 0xFF, packed >> 8

    def write_txb(self, plane: int, plane_bsize: int, tx_size: int, tx_type: int,
                  qcoeff: np.ndarray, eob: int, ux: int, uy: int,
                  write_tx_type_fn=None) -> None:
        """qcoeff: raster (ch, cw) int32 of the coded region; eob in scan order."""
        tw = self.tw
        cw = min(int(TX_W[tx_size]), 32)
        ch = min(int(TX_H[tx_size]), 32)
        ts_ctx = txs_ctx(tx_size)
        if hasattr(tw.enc, "_lib"):
            skip_ctx, dc_sign_ctx = self._txb_ctx_native(
                plane, plane_bsize, tx_size, ux, uy)
        else:
            skip_ctx, dc_sign_ctx = self._txb_ctx(plane, plane_bsize,
                                                  tx_size, ux, uy)
        ptype = 0 if plane == 0 else 1

        tw._sym_at(1 if eob == 0 else 0, tw.cdfs.txb_skip, ts_ctx, skip_ctx)
        if eob == 0:
            self._update_ctx(plane, tx_size, ux, uy, 0)
            return

        if plane == 0 and write_tx_type_fn is not None:
            write_tx_type_fn(tx_size, tx_type)

        flat = qcoeff.reshape(-1)
        scan = scan_table(tx_size, _scan_kind(tx_type))
        tx_class = TX_TYPE_CLASS[TxType(tx_type)]
        full_w, full_h = int(TX_W[tx_size]), int(TX_H[tx_size])

        # eob coding
        eob_pt, eob_extra = eob_pos_token(eob)
        eob_multi_size = int(np.log2(cw)) + int(np.log2(ch)) - 4
        eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
        tw._sym_at(eob_pt - 1, tw.cdfs.eob_flag[16 << eob_multi_size], ptype, eob_multi_ctx)
        offset_bits = int(EOB_OFFSET_BITS[eob_pt])
        if offset_bits > 0:
            bit = (eob_extra >> (offset_bits - 1)) & 1
            tw._sym_at(bit, tw.cdfs.eob_extra, ts_ctx, ptype, eob_pt)
            for i in range(1, offset_bits):
                tw.enc.encode_literal((eob_extra >> (offset_bits - 1 - i)) & 1, 1)

        native = hasattr(tw.enc, "txb")
        if not (native and not hasattr(tw, "bits")):
            # levels buffer (padded right by 4, bottom by 4); the native
            # path builds these inside svt_ec_txb instead
            levels = np.zeros((ch + 4, cw + TX_PAD_HOR), np.int32)
            levels[:ch, :cw] = np.minimum(np.abs(flat).reshape(ch, cw), 127)
            coeff_ctx = self._nz_map_contexts(levels, scan, eob, cw, ch,
                                              full_w, full_h, tx_class)

        bwl = int(np.log2(cw))
        if FAST_RATE and hasattr(tw, "bits"):
            # rate-counting sink (md.RateCounter): vectorized cost sum,
            # arithmetic-identical to the per-symbol path below
            tw.bits += self._txb_rate_fast(tw, flat, scan, eob, coeff_ctx,
                                           levels, bwl, tx_class, ts_ctx,
                                           ptype, dc_sign_ctx)
            av_all = np.abs(flat[scan[:eob]].astype(np.int64))
            cul_level = min(COEFF_CONTEXT_MASK, int(av_all.sum()))
        elif native:
            # native backend: one C call builds levels/contexts and emits
            # base/br symbols, signs, golomb escapes (svt_ec_txb); CDF
            # group/row addresses cached per (ts_ctx, ptype) for the
            # writer's lifetime (rows are adapted in place)
            key = (ts_ctx, ptype, tx_size, tx_class)
            e = self._txb_ptr_cache.get(key)
            if e is None:
                base = tw.cdfs.coeff_base
                beob = tw.cdfs.coeff_base_eob
                br = tw.cdfs.coeff_br
                dcs = tw.cdfs.dc_sign
                rows = (base[0][ts_ctx, ptype], base[1][ts_ctx, ptype],
                        beob[0][ts_ctx, ptype], beob[1][ts_ctx, ptype],
                        br[0][min(ts_ctx, 3), ptype],
                        br[1][min(ts_ctx, 3), ptype],
                        dcs[0][ptype], dcs[1][ptype])
                scan32 = _scan_i32(tx_size, _scan_kind(tx_type))
                nz_off = _nz_offsets(tx_size, tx_class)
                e = ([r.ctypes.data for r in rows],
                     scan32.ctypes.data, nz_off.ctypes.data, rows,
                     scan32, nz_off)
                self._txb_ptr_cache[key] = e
            ptrs, scan_p, nz_p = e[0], e[1], e[2]
            flat32 = flat if (flat.dtype == np.int32 and
                              flat.flags.c_contiguous) \
                else np.ascontiguousarray(flat, np.int32)
            cul_level = int(tw.enc._lib.svt_ec_txb(
                tw.enc._h, flat32.ctypes.data, scan_p, eob, cw, ch,
                tx_class, nz_p, *ptrs, dc_sign_ctx,
                1 if tw.adapt else 0))
        else:
            for c in range(eob - 1, -1, -1):
                pos = int(scan[c])
                level = int(abs(flat[pos]))
                ctx = int(coeff_ctx[c])
                if c == eob - 1:
                    tw._sym_at(min(level, 3) - 1, tw.cdfs.coeff_base_eob, ts_ctx, ptype, ctx)
                else:
                    tw._sym_at(min(level, 3), tw.cdfs.coeff_base, ts_ctx, ptype, ctx)
                if level > NUM_BASE_LEVELS:
                    base_range = level - 1 - NUM_BASE_LEVELS
                    br_ctx = _get_br_ctx(levels, pos, bwl, tx_class)
                    idx = 0
                    while idx < COEFF_BASE_RANGE:
                        k = min(base_range - idx, BR_CDF_SIZE - 1)
                        tw._sym_at(k, tw.cdfs.coeff_br, min(ts_ctx, 3), ptype, br_ctx)
                        if k < BR_CDF_SIZE - 1:
                            break
                        idx += BR_CDF_SIZE - 1

            # signs + golomb
            cul_level = 0
            for c in range(eob):
                pos = int(scan[c])
                v = int(flat[pos])
                level = abs(v)
                cul_level += level
                if level:
                    if c == 0:
                        tw._sym_at(1 if v < 0 else 0, tw.cdfs.dc_sign, ptype, dc_sign_ctx)
                    else:
                        tw.enc.encode_literal(1 if v < 0 else 0, 1)
                    if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                        _write_golomb(tw.enc, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS)

            cul_level = min(COEFF_CONTEXT_MASK, cul_level)
        dc = int(flat[0])
        if dc < 0:
            cul_level |= 1 << COEFF_CONTEXT_BITS
        elif dc > 0:
            cul_level += 2 << COEFF_CONTEXT_BITS
        self._update_ctx(plane, tx_size, ux, uy, cul_level)

    @staticmethod
    def _txb_rate_fast(tw, flat, scan, eob, coeff_ctx, levels, bwl, tx_class,
                       ts_ctx, ptype, dc_sign_ctx) -> int:
        """Vectorized rate of the base/br/sign/golomb symbols (the
        RateCounter path of the per-coefficient loop below)."""
        pos = scan[:eob]
        av = np.abs(flat[pos].astype(np.int64))
        syms = np.minimum(av, 3)
        cost = 0
        tb = tw.family_costs(tw.cdfs.coeff_base[0])
        teob = tw.family_costs(tw.cdfs.coeff_base_eob[0])
        if eob > 1:
            cost += int(tb[ts_ctx, ptype, coeff_ctx[: eob - 1],
                           syms[: eob - 1]].sum())
        cost += int(teob[ts_ctx, ptype, int(coeff_ctx[eob - 1]),
                         int(syms[eob - 1]) - 1])

        hi = av > NUM_BASE_LEVELS
        if np.any(hi):
            ph = pos[hi]
            lvh = av[hi]
            row = ph >> bwl
            col = ph - (row << bwl)
            mag = levels[row, col + 1].astype(np.int64) + levels[row + 1, col]
            if tx_class == TX_CLASS_2D:
                mag = np.minimum((mag + levels[row + 1, col + 1] + 1) >> 1, 6)
                near = (row < 2) & (col < 2)
            elif tx_class == TX_CLASS_HORIZ:
                mag = np.minimum((mag + levels[row, col + 2] + 1) >> 1, 6)
                near = col == 0
            else:
                mag = np.minimum((mag + levels[row + 2, col] + 1) >> 1, 6)
                near = row == 0
            brctx = np.where(ph == 0, mag, np.where(near, mag + 7, mag + 14))
            tbr = tw.family_costs(tw.cdfs.coeff_br[0])[min(ts_ctx, 3), ptype]
            br = np.minimum(lvh - 1 - NUM_BASE_LEVELS, COEFF_BASE_RANGE)
            nfull = np.where(br >= COEFF_BASE_RANGE, 4, br // (BR_CDF_SIZE - 1))
            cost += int((nfull * tbr[brctx, BR_CDF_SIZE - 1]).sum())
            part = br < COEFF_BASE_RANGE
            if np.any(part):
                cost += int(tbr[brctx[part], br[part] % (BR_CDF_SIZE - 1)].sum())
            # golomb escapes
            go = lvh > COEFF_BASE_RANGE + NUM_BASE_LEVELS
            if np.any(go):
                x = lvh[go] - COEFF_BASE_RANGE - NUM_BASE_LEVELS  # level+1 term
                length = np.floor(np.log2(x)).astype(np.int64) + 1
                cost += int(((2 * length - 1) << 9).sum())

        # signs: DC via cdf, the rest 1 literal bit each
        nz = av > 0
        n_ac_signs = int(np.count_nonzero(nz[1:])) if eob > 1 else 0
        cost += n_ac_signs << 9
        if nz[0]:
            tdcs = tw.family_costs(tw.cdfs.dc_sign[0])
            cost += int(tdcs[ptype, dc_sign_ctx,
                             1 if flat[pos[0]] < 0 else 0])
        return cost

    @staticmethod
    def _nz_map_contexts(levels: np.ndarray, scan: np.ndarray, eob: int,
                         cw: int, ch: int, full_w: int, full_h: int,
                         tx_class: int) -> np.ndarray:
        """Vectorized sig-coeff contexts for positions scan[0..eob-1]."""
        pos = scan[:eob]
        row = pos >> int(np.log2(cw))
        col = pos & (cw - 1)
        lv = levels
        clip3 = np.minimum(lv, 3)
        if tx_class == TX_CLASS_2D:
            mag = (clip3[row, col + 1] + clip3[row + 1, col] + clip3[row + 1, col + 1]
                   + clip3[row, col + 2] + clip3[row + 2, col])
            off = _nz_ctx_offset_2d(row, col, full_w, full_h)
            ctx = np.minimum((mag + 1) >> 1, 4) + off
            ctx = np.where((row == 0) & (col == 0), 0, ctx)
        elif tx_class == TX_CLASS_VERT:
            mag = (clip3[row, col + 1] + clip3[row + 1, col]
                   + clip3[row + 2, col] + clip3[row + 3, col] + clip3[row + 4, col])
            ctx = np.minimum((mag + 1) >> 1, 4) + _NZ_CTX_OFFSET_1D[np.minimum(row, 31)]
        else:
            mag = (clip3[row, col + 1] + clip3[row + 1, col]
                   + clip3[row, col + 2] + clip3[row, col + 3] + clip3[row, col + 4])
            ctx = np.minimum((mag + 1) >> 1, 4) + _NZ_CTX_OFFSET_1D[np.minimum(col, 31)]
        # eob position context (is_eob path of get_nz_map_ctx)
        n = cw * ch
        si = np.arange(eob)
        eob_ctx = np.where(si == 0, 0, np.where(si <= n // 8, 1, np.where(si <= n // 4, 2, 3)))
        ctx[eob - 1] = eob_ctx[eob - 1]
        return ctx


@lru_cache(maxsize=None)
def _scan_i32(tx_size: int, kind: str) -> np.ndarray:
    return np.ascontiguousarray(scan_table(tx_size, kind).astype(np.int32))


@lru_cache(maxsize=None)
def _nz_offsets(tx_size: int, tx_class: int) -> np.ndarray:
    """Per-raster-position nz-map ctx offsets for svt_ec_txb."""
    cw = min(int(TX_W[tx_size]), 32)
    ch = min(int(TX_H[tx_size]), 32)
    full_w, full_h = int(TX_W[tx_size]), int(TX_H[tx_size])
    row, col = np.divmod(np.arange(ch * cw), cw)
    if tx_class == TX_CLASS_2D:
        off = _nz_ctx_offset_2d(row, col, full_w, full_h)
    elif tx_class == TX_CLASS_VERT:
        off = _NZ_CTX_OFFSET_1D[np.minimum(row, 31)]
    else:
        off = _NZ_CTX_OFFSET_1D[np.minimum(col, 31)]
    return np.ascontiguousarray(off.astype(np.int32))


def _scan_kind(tx_type: int) -> str:
    cls = TX_TYPE_CLASS[TxType(tx_type)]
    if cls == TX_CLASS_VERT:
        return "mcol"
    if cls == TX_CLASS_HORIZ:
        return "mrow"
    return "default"


def _get_br_ctx(levels: np.ndarray, pos: int, bwl: int, tx_class: int) -> int:
    row = pos >> bwl
    col = pos - (row << bwl)
    mag = int(levels[row, col + 1]) + int(levels[row + 1, col])
    if tx_class == TX_CLASS_2D:
        mag += int(levels[row + 1, col + 1])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == TX_CLASS_HORIZ:
        mag += int(levels[row, col + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if col == 0:
            return mag + 7
    else:
        mag += int(levels[row + 2, col])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row == 0:
            return mag + 7
    return mag + 14


def _write_golomb(enc, level: int) -> None:
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        enc.encode_literal(0, 1)
    for i in range(length - 1, -1, -1):
        enc.encode_literal((x >> i) & 1, 1)
