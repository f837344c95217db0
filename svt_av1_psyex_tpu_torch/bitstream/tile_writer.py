"""Tile-group syntax writer: partitions, intra mode info, coefficients.

Mirrors the decode_tile/decode_partition/decode_block syntax of the AV1
spec (5.11.x) on the encode side. Counterpart in the reference:
Source/Lib/Codec/entropy_coding.c (write_modes / encode_partition_av1 /
encode_intra_luma_mode_kf_av1 / av1_encode_tx_coef_y).

The writer consumes a PartitionNode tree per superblock produced by mode
decision; all neighbor/context state (partition contexts, skip, modes,
per-plane entropy contexts) lives here, exactly as the decoder will
reconstruct it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..codec.constants import (
    COMPOUND_MODE_CTX_MAP as _COMPOUND_MODE_CTX_MAP,
    mode_has_newmv,
    BLOCK_H,
    BLOCK_W,
    DIRECTIONAL,
    INTRA_MODE_CONTEXT,
    MAX_ANGLE_DELTA,
    IntraMode,
    Partition,
    partition_ctx_lookup,
    subsize,
)
from .ec import EntropyEncoder, update_cdf
from .tables import FrameCdfs, trim

from ..codec.constants import InterMode as _IM
_GLOBAL_MODES = (int(_IM.GLOBALMV), int(_IM.GLOBAL_GLOBALMV))


@dataclass
class LeafBlock:
    bsize: int
    y_mode: int = IntraMode.DC
    uv_mode: int = IntraMode.DC
    angle_delta_y: int = 0
    angle_delta_uv: int = 0
    skip: bool = True
    # per-plane coefficient payloads: list over tx blocks in coding order;
    # filled by the transform/quant stage. None => all-skip.
    coeffs: object = None
    # inter fields (inter frames only)
    is_inter: bool = False
    ref_frame: int = 1  # LAST_FRAME
    ref_frame1: int = -1  # second ref (compound) or -1
    inter_mode: int = 16  # NEWMV
    mv: tuple = (0, 0)  # (row, col) 1/8 pel
    mv1: tuple = (0, 0)  # second-ref MV (compound)
    drl_index: int = 0
    tx_depth: int = 0  # luma tx split depth from max-rect (TX_MODE_SELECT)
    use_filter_intra: bool = False  # recursive filter intra (y DC only)
    filter_intra_mode: int = 0
    cfl_alpha_u: int = 0  # signed alpha_q3 per component (uv_mode 13)
    cfl_alpha_v: int = 0
    interp_filter: int = 0  # REGULAR/SMOOTH/SHARP (SWITCHABLE frames)
    # Y palette (screen-content tools): sorted base colors + the index
    # map at luma resolution ((bh, bw) uint8); empty/None = no palette
    palette_colors: tuple = ()
    palette_map: object = None
    # intra block copy (SC intra frames): DV carried in .mv (1/8 units)
    use_intrabc: bool = False
    motion_mode: int = 0  # 0 SIMPLE, 1 OBMC_CAUSAL, 2 WARPED_CAUSAL
    # compound type (read_compound_type): group 0 = avg / dist-wtd
    # (compound_idx 1 / 0), group 1 = wedge / diff-wtd masks
    comp_group_idx: int = 0
    compound_idx: int = 1
    comp_type: int = 0  # constants.COMPOUND_* (AVERAGE/DISTWTD/WEDGE/DIFFWTD)
    wedge_index: int = 0
    wedge_sign: int = 0
    mask_type: int = 0
    # inter-intra (single-ref, 8x8..32x32): -1 = off, else II_DC/V/H/SMOOTH;
    # wedge_interintra reuses wedge_index (sign fixed 0)
    interintra_mode: int = -1
    wedge_interintra: int = 0


@dataclass
class PartitionNode:
    partition: int = Partition.NONE
    leaf: LeafBlock | None = None
    children: list = field(default_factory=list)


class TileWriter:
    def __init__(self, seq, fr, cdfs: FrameCdfs, mi_rows: int, mi_cols: int,
                 tile_mi_row_start: int = 0, tile_mi_row_end: int | None = None,
                 tile_mi_col_start: int = 0, tile_mi_col_end: int | None = None):
        self.seq = seq
        self.fr = fr
        self.cdfs = cdfs
        from ..native.ecenc import make_entropy_encoder

        self.enc = make_entropy_encoder()
        self._row_cache: dict = {}
        self._sym_fast = hasattr(self.enc, "symbol_ptr")
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.r0 = tile_mi_row_start
        self.r1 = tile_mi_row_end if tile_mi_row_end is not None else mi_rows
        self.c0 = tile_mi_col_start
        self.c1 = tile_mi_col_end if tile_mi_col_end is not None else mi_cols
        self.adapt = not fr.disable_cdf_update

        # neighbor state over the full mi grid (simple; tiles slice it)
        self.y_modes = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        self.skips = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        self.inters = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        # switchable-interp neighbor state: per-mi filter (3 = none/intra)
        # and ref frames (0 = intra) for get_pred_context_switchable_interp
        self.flt = np.full((mi_rows, mi_cols), 3, dtype=np.int8)
        self.ref0g = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        self.ref1g = np.full((mi_rows, mi_cols), -1, dtype=np.int8)
        # compound-type neighbor state (comp_group_idx / compound_idx
        # contexts read these for two-ref neighbors)
        self.cgig = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        self.cpig = np.ones((mi_rows, mi_cols), dtype=np.int8)
        # palette neighbor state: per-mi Y palette size (mode ctx) and
        # the covering block's sorted colors (cache merge); colors keyed
        # by mi position since sizes vary
        self.pal_size = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        self.pal_colors: dict = {}
        # coefficient contexts are managed by the coeff writer (set later)
        self.coeff_writer = None
        # inter frames: MVP mi-state (set by the encoder), replayed in
        # lockstep with the decoder's derivation
        self.mi_state = None
        self.above_part = np.zeros(mi_cols, dtype=np.uint8)
        self.left_part = np.zeros(mi_rows, dtype=np.uint8)
        # per-SB delta q (variance boost): map set by the encoder
        self.sb_qindex_map = None
        self.prev_qindex = fr.base_q_idx
        self._cur_sb = (0, 0)
        # per-64x64 cdef strength indices (set by the encoder after search)
        self.cdef_fb_map = None
        self._cdef_coded = False
        # TX_MODE_SELECT neighbor arrays, two pairs (dav1d's tx_intra/tx
        # split of the reference's single txfm_context + runtime inter
        # override, entropy_coding.c:4455-4477): `txi_*` feed the intra
        # tx-depth context (inter neighbors report BLOCK dims), `txp_*`
        # feed the vartx txfm_partition context (actual coded tx dims,
        # block dims for skip-inter). above = widths px per mi col, left =
        # heights px per mi row; 255 = unavailable (reference memset ~0,
        # raw reads make missing neighbors compare "very large").
        self.txi_above = np.full(mi_cols, 255, dtype=np.uint8)
        self.txi_left = np.full(mi_rows, 255, dtype=np.uint8)
        self.txp_above = np.full(mi_cols, 255, dtype=np.uint8)
        self.txp_left = np.full(mi_rows, 255, dtype=np.uint8)
        # segmentation: encoder-chosen per-mi target seg ids + the coded
        # map (decoder-visible state for the spatial prediction contexts)
        self.seg_target = None  # (mi_rows, mi_cols) int8 or None
        self.seg_last_active = 0
        self._seg_map = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        # loop restoration: per-plane RestorationInfo (set by the encoder
        # after the LR search) + per-plane running refs for delta coding
        # (svt_av1_reset_loop_restoration, entropy_coding.c:3923)
        self.lr_infos = None
        # absolute mi col of this tile's origin (multi-tile: RU-corner
        # math is frame-global while the writer runs tile-local)
        self.lr_mi_col0 = 0
        from ..ops.restoration import WIENER_TAPS_MID
        # per-plane [ref_vtaps, ref_htaps] (WienerInfo keeps both)
        self._lr_ref_wiener = [[list(WIENER_TAPS_MID), list(WIENER_TAPS_MID)]
                               for _ in range(3)]
        self._lr_ref_sgr = [[-32, 31] for _ in range(3)]  # mid xqd
        # superblocks written, and those the C superblock writer wrote
        # (native/tilewriter.c); its descriptor is built at the first
        # superblock, once the encoder has set the state above
        self.n_sbs = 0
        self.n_sbs_native = 0
        self._native = None

    # ---- symbol helper with adaptation --------------------------------------
    def _sym_at(self, symbol: int, cdf_pair, *idx) -> None:
        if self._sym_fast:
            # cache row addresses per (cdf family, index): the CDF arrays
            # are per-frame objects mutated in place by adaptation, so the
            # pointers stay valid for the writer's lifetime
            key = (id(cdf_pair[0]), idx)
            e = self._row_cache.get(key)
            if e is None:
                values, counters, nsyms = cdf_pair
                if idx:
                    row, cnt, n = values[idx], counters[idx], int(nsyms[idx])
                else:
                    row, cnt, n = values, counters, int(nsyms)
                e = (row.ctypes.data, cnt.ctypes.data, n, row, cnt)
                self._row_cache[key] = e
            self.enc.symbol_ptr(symbol, e[0], e[1], e[2], self.adapt)
            return
        values, counters, nsyms = cdf_pair
        if idx:
            row = values[idx]
            cnt = counters[idx]
            n = int(nsyms[idx])
        else:
            row, cnt, n = values, counters, int(nsyms)
        # adaptation mutates the stored CDF row in place
        self.enc.symbol_adapt(symbol, row, cnt, n, self.adapt)

    # ---- superblock entry -----------------------------------------------------
    def write_superblock(self, node: PartitionNode, mi_row: int, mi_col: int) -> None:
        """Codes one superblock: its loop-restoration units here, then its
        partition tree in one call of the C writer (native/tilewriter.c)
        where the coder is the native one and the tree holds no palette
        or intra block copy leaf, else by the Python walk below. Both
        walks code the same symbols and keep the same state."""
        sb_bsize = 15 if self.seq.use_128x128_superblock else 12  # B128X128 / B64X64
        self._cur_sb = (mi_row, mi_col)
        self._cdef_coded = False  # clear_cdef: one cdef_idx per 64x64 unit
        self._write_lr(mi_row, mi_col)
        self.n_sbs += 1
        if self._native is None:
            self._native = self._native_setup()
        if self._native and self._write_sb_native(node, mi_row, mi_col,
                                                  sb_bsize):
            self.n_sbs_native += 1
            return
        self._write_partition_tree(node, mi_row, mi_col, sb_bsize)

    # ---- the C superblock writer (native/tilewriter.c) -----------------------
    def _native_setup(self):
        """(lib, descriptor, what the descriptor points into) when the C
        writer can code this tile's superblocks, else False: the
        pure-Python coder, intra block copy frames, and a writer without a
        coefficient writer or with an MiState of other dimensions keep the
        Python walk."""
        lib = getattr(self.enc, "_lib", None)
        if (not self._sym_fast or lib is None
                or not hasattr(lib, "svt_tw_superblock")
                or self.fr.allow_intrabc or self.coeff_writer is None):
            return False
        mi = self.mi_state
        if mi is not None:
            from ..codec.mvp import _mvp_lib

            if (not _mvp_lib() or mi.mi_rows != self.mi_rows
                    or mi.mi_cols != self.mi_cols):
                return False
        keep: list = []
        desc = np.array(self._native_desc(keep), np.int64)
        io = np.zeros(1, np.int32)
        return lib, desc, io, keep

    def _native_desc(self, keep: list) -> list:
        """The descriptor of native/tilewriter.c (its D_* slots, in order):
        the frame's flags, the writer's grids, the coefficient contexts,
        the MiState grids, scan tables and CDF families, as addresses of
        the arrays this writer owns; read-only maps are copied into
        `keep`, which lives as long as the descriptor."""
        fr, seq = self.fr, self.seq
        i8, u8, i16, i32 = np.int8, np.uint8, np.int16, np.int32

        def addr(a, dtype):
            if a.dtype != dtype or not a.flags.c_contiguous:
                raise TypeError(f"the C writer reads a contiguous {dtype}"
                                f" array here, not {a.dtype}")
            keep.append(a)
            return a.ctypes.data

        d = [self.mi_rows, self.mi_cols, self.r0, self.r1, self.c0, self.c1,
             int(self.adapt), int(bool(seq.use_128x128_superblock)),
             int(bool(fr.frame_is_intra)), int(bool(fr.delta_q_present)),
             int(fr.delta_q_res), int(getattr(fr, "cdef_bits", 0)),
             int(bool(fr.tx_mode_select)), int(bool(fr.reduced_tx_set)),
             int(fr.base_q_idx), int(bool(fr.allow_screen_content_tools)),
             int(bool(fr.is_motion_mode_switchable)),
             int(bool(fr.allow_warped_motion)), int(fr.interp_filter),
             int(bool(fr.reference_select)), int(fr.order_hint),
             int(seq.order_hint_bits)]
        hints = list(getattr(fr, "ref_order_hints", ()))[:7]
        d += [int(h) for h in hints] + [0] * (7 - len(hints))
        d += [int(bool(seq.mono_chrome)), int(seq.subsampling_x),
              int(seq.subsampling_y), int(bool(seq.enable_filter_intra)),
              int(bool(getattr(seq, "enable_interintra_compound", False))),
              int(bool(getattr(seq, "enable_masked_compound", False))),
              int(bool(getattr(seq, "enable_jnt_comp", False)))]
        gm = getattr(fr, "gm", None)
        for ref in range(1, 8):
            e = gm[ref - 1] if gm else None
            d += ([0] * 7 if e is None
                  else [int(e[0])] + [int(v) for v in e[1][:6]])
        d += [addr(a, i8) for a in (self.y_modes, self.skips, self.inters,
                                    self.flt, self.ref0g, self.ref1g,
                                    self.cgig, self.cpig, self.pal_size)]
        d += [addr(a, u8) for a in (self.above_part, self.left_part,
                                    self.txi_above, self.txi_left,
                                    self.txp_above, self.txp_left)]
        d.append(addr(self._seg_map, i8))
        d += [0 if self.seg_target is None else
              addr(np.ascontiguousarray(self.seg_target, i8), i8),
              int(self.seg_last_active)]
        for m, on in ((self.cdef_fb_map, True),
                      (self.sb_qindex_map, fr.delta_q_present)):
            if m is None or not on:
                d += [0, 0]
            else:
                m = np.ascontiguousarray(m, i32)
                d += [addr(m, i32), m.shape[1]]
        cw = self.coeff_writer
        d += [addr(a, u8) for a in (*cw.above, *cw.left)]
        d += [len(a) for a in (*cw.above, *cw.left)]
        mi = self.mi_state
        if mi is None:
            d += [0] * 16
        else:
            d.append(1)
            d += [addr(a, i8) for a in (mi.ref_frame, mi.ref_frame1)]
            d += [addr(a, i16) for a in (mi.mv_row, mi.mv_col, mi.mv_row1,
                                         mi.mv_col1)]
            d += [addr(a, i8) for a in (mi.is_newmv, mi.is_gmv, mi.flt,
                                        mi.bsize)]
            d.append(addr(np.ascontiguousarray(mi.sign_bias, u8), u8))
            tpl = mi.tpl
            if tpl is None:
                d += [0] * 4
            else:
                if not hasattr(tpl, "_valid_u8"):
                    tpl._valid_u8 = tpl.valid.astype(u8)
                d.append(addr(tpl._valid_u8, u8))
                d += [addr(a, i16) for a in (tpl.mfmv_row, tpl.mfmv_col,
                                             tpl.ref_off)]
        d.append(addr(np.ascontiguousarray(
            mi.tpl_cur_off if mi is not None else np.zeros(8), i32), i32))
        d += [addr(t, np.int64) for t in _native_scan_tables()]
        cdfs = self.cdfs
        for name in _NATIVE_FAMS:
            values, counters, nsyms = (
                cdfs.eob_flag[int(name[8:])] if name.startswith("eob_flag")
                else getattr(cdfs, name))
            lead = list(values.shape[:-1]) + [1] * (4 - values.ndim)
            # a family of one row holds its alphabet size as a scalar
            d += [addr(values, i32), addr(counters, i32),
                  addr(np.atleast_1d(np.asarray(nsyms, i32)), i32),
                  values.shape[-1]] + lead
        return d

    def _write_sb_native(self, node: PartitionNode, mi_row: int, mi_col: int,
                         sb_bsize: int) -> bool:
        """Packs the superblock's coding order into ops and codes it in one
        C call; False, having coded nothing, where a leaf needs the Python
        walk (a palette or intra block copy)."""
        ops: list = []
        txbs: list = []
        keep: list = []
        for leaf, p, r, c, bsize in self._coding_order(node, mi_row, mi_col,
                                                       sb_bsize):
            if leaf is None:
                ops.append((0, r, c, bsize, int(p)) + _OP_PAD)
            elif not self._pack_block(leaf, r, c, bsize, ops, txbs, keep):
                return False
        lib, desc, io, _ = self._native
        ops_a = np.array(ops, np.int32)
        txbs_a = np.array(txbs, np.int64).reshape(-1, 8)
        io[0] = self.prev_qindex
        rc = lib.svt_tw_superblock(self.enc._h, desc.ctypes.data,
                                   ops_a.ctypes.data, len(ops),
                                   txbs_a.ctypes.data, mi_row, mi_col,
                                   io.ctypes.data)
        self.prev_qindex = int(io[0])
        assert rc == 0, f"superblock ({mi_row}, {mi_col}): check {-rc} failed"
        return True

    @staticmethod
    def _pack_block(leaf: LeafBlock, r: int, c: int, bsize: int, ops: list,
                    txbs: list, keep: list) -> bool:
        """A block op (native/tilewriter.c O_* columns) and its transform
        blocks' T_* rows; False for a leaf the C writer does not code."""
        if leaf.palette_colors or leaf.use_intrabc:
            return False
        txb0 = len(txbs)
        if not leaf.skip:
            assert leaf.coeffs is not None
            for t in leaf.coeffs:
                q = t["qcoeff"]
                if q.dtype != np.int32 or not q.flags.c_contiguous:
                    q = np.ascontiguousarray(q, np.int32)
                    keep.append(q)
                txbs.append((t["plane"], t["plane_bsize"], t["tx_size"],
                             t["tx_type"], t["eob"], t["ux"], t["uy"],
                             q.ctypes.data))
        mv, mv1 = leaf.mv, leaf.mv1
        ops.append((1, r, c, bsize, 0, leaf.bsize, int(bool(leaf.skip)),
                    leaf.y_mode, leaf.uv_mode, leaf.angle_delta_y,
                    leaf.angle_delta_uv, int(bool(leaf.is_inter)),
                    leaf.ref_frame, leaf.ref_frame1, leaf.inter_mode,
                    mv[0], mv[1], mv1[0], mv1[1], leaf.drl_index,
                    leaf.tx_depth, int(bool(leaf.use_filter_intra)),
                    leaf.filter_intra_mode, leaf.cfl_alpha_u,
                    leaf.cfl_alpha_v, leaf.interp_filter, leaf.motion_mode,
                    leaf.comp_group_idx, leaf.compound_idx, leaf.comp_type,
                    leaf.wedge_index, leaf.wedge_sign, leaf.mask_type,
                    leaf.interintra_mode, leaf.wedge_interintra, txb0,
                    len(txbs) - txb0))
        return True

    # ---- segmentation (spec 5.11.15 read_segment_id mirror) -------------------
    def _write_segment_id(self, r: int, c: int, bsize: int,
                          avail_u: bool, avail_l: bool,
                          skip: int = 0) -> None:
        """Spatially-predicted segment id (ALT_Q-only segmentation:
        SegIdPreSkip = 0, coded after the skip flag; temporal_update = 0
        so inter blocks use the same spatial coder). Skip blocks code
        NOTHING and take the spatial prediction (spec read_segment_id
        early-out; write_segment_id entropy_coding.c:4714)."""
        if self.seg_target is None:
            return
        target = int(self.seg_target[r, c])
        prev_ul = int(self._seg_map[r - 1, c - 1]) if (avail_u and avail_l) else -1
        prev_u = int(self._seg_map[r - 1, c]) if avail_u else -1
        prev_l = int(self._seg_map[r, c - 1]) if avail_l else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        # any out-of-bounds neighbor forces context 0
        # (av1_get_spatial_seg_pred)
        if prev_ul < 0 or prev_u < 0 or prev_l < 0:
            ctx = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            ctx = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            ctx = 1
        else:
            ctx = 0
        bh4 = int(BLOCK_H[bsize]) >> 2
        bw4 = int(BLOCK_W[bsize]) >> 2
        r1 = min(r + bh4, self.mi_rows)
        c1 = min(c + bw4, self.mi_cols)
        if skip:
            self._seg_map[r:r1, c:c1] = pred
            return
        coded = _neg_interleave(target, pred, self.seg_last_active + 1)
        self._sym_at(coded, self.cdfs.spatial_seg, ctx)
        self._seg_map[r:r1, c:c1] = target

    # ---- loop restoration units (spec 5.11.57 read_lr mirror) ----------------
    def _write_lr(self, mi_row: int, mi_col: int) -> None:
        """Emit restoration unit info for every RU whose top-left corner
        falls inside this superblock (entropy_coding.c:5329 +
        svt_av1_loop_restoration_corners_in_sb restoration.c:1427)."""
        if self.lr_infos is None or self.fr.allow_intrabc:
            return
        from ..ops.restoration import RESTORE_NONE, count_units

        sb_mi = 32 if self.seq.use_128x128_superblock else 16
        for plane, info in enumerate(self.lr_infos):
            if info is None or info.frame_type == RESTORE_NONE:
                continue
            ss_x = 0 if plane == 0 else self.seq.subsampling_x
            ss_y = 0 if plane == 0 else self.seq.subsampling_y
            pw = (self.seq.width + ss_x) >> ss_x
            ph = (self.seq.height + ss_y) >> ss_y
            size = info.unit_size
            hu = count_units(size, pw)
            vu = count_units(size, ph)
            mi_szx = 4 >> ss_x
            mi_szy = 4 >> ss_y
            mc = mi_col + self.lr_mi_col0  # frame-absolute column
            rcol0 = (mc * mi_szx + size - 1) // size
            rrow0 = (mi_row * mi_szy + size - 1) // size
            rcol1 = min(((mc + sb_mi) * mi_szx + size - 1) // size, hu)
            rrow1 = min(((mi_row + sb_mi) * mi_szy + size - 1) // size, vu)
            for rr in range(rrow0, rrow1):
                for rc in range(rcol0, rcol1):
                    self._write_lr_unit(plane, info, rr * hu + rc)

    def _write_lr_unit(self, plane: int, info, idx: int) -> None:
        from ..ops.restoration import (
            RESTORE_NONE,
            RESTORE_SGRPROJ,
            RESTORE_SWITCHABLE,
            RESTORE_WIENER,
        )

        rtype, params, _rate = info.units[idx]
        if info.frame_type == RESTORE_SWITCHABLE:
            self._sym_at(rtype, self.cdfs.switchable_restore)
            if rtype == RESTORE_WIENER:
                self._write_wiener(plane, params)
            elif rtype == RESTORE_SGRPROJ:
                self._write_sgrproj(plane, params)
        elif info.frame_type == RESTORE_WIENER:
            self._sym_at(int(rtype != RESTORE_NONE), self.cdfs.wiener_restore)
            if rtype != RESTORE_NONE:
                self._write_wiener(plane, params)
        else:
            self._sym_at(int(rtype != RESTORE_NONE), self.cdfs.sgrproj_restore)
            if rtype != RESTORE_NONE:
                self._write_sgrproj(plane, params)

    def _write_wiener(self, plane: int, params) -> None:
        """write_wiener_filter (entropy_coding.c:3930): vfilter taps then
        hfilter taps, signed-subexp vs the per-plane running ref."""
        from ..codec.restoration import _recenter_finite
        from ..ops.restoration import (
            WIENER_TAPS_K,
            WIENER_TAPS_MAX,
            WIENER_TAPS_MIN,
        )

        htaps, vtaps = params
        refs = self._lr_ref_wiener[plane]
        first = 1 if plane > 0 else 0  # chroma: 5-tap, tap0 not coded
        for pi, taps in enumerate((vtaps, htaps)):
            ref = refs[pi]
            for j in range(first, 3):
                n = WIENER_TAPS_MAX[j] - WIENER_TAPS_MIN[j] + 1
                self._w_subexpfin(
                    n, WIENER_TAPS_K[j],
                    _recenter_finite(n, ref[j] - WIENER_TAPS_MIN[j],
                                     taps[j] - WIENER_TAPS_MIN[j]))
        refs[0][:] = list(vtaps)
        refs[1][:] = list(htaps)

    def _write_sgrproj(self, plane: int, params) -> None:
        """write_sgrproj_filter (entropy_coding.c:3971)."""
        from ..codec.restoration import _recenter_finite
        from ..ops.restoration import (
            SGR_PARAMS,
            SGRPROJ_PRJ_MAX0,
            SGRPROJ_PRJ_MAX1,
            SGRPROJ_PRJ_MIN0,
            SGRPROJ_PRJ_MIN1,
            SGRPROJ_PRJ_SUBEXP_K,
        )

        ep, xqd = params
        self.enc.encode_literal(ep, 4)
        r0, r1, _, _ = SGR_PARAMS[ep]
        ref = self._lr_ref_sgr[plane]
        if r0:
            n = SGRPROJ_PRJ_MAX0 - SGRPROJ_PRJ_MIN0 + 1
            self._w_subexpfin(
                n, SGRPROJ_PRJ_SUBEXP_K,
                _recenter_finite(n, ref[0] - SGRPROJ_PRJ_MIN0,
                                 xqd[0] - SGRPROJ_PRJ_MIN0))
        if r1:
            n = SGRPROJ_PRJ_MAX1 - SGRPROJ_PRJ_MIN1 + 1
            self._w_subexpfin(
                n, SGRPROJ_PRJ_SUBEXP_K,
                _recenter_finite(n, ref[1] - SGRPROJ_PRJ_MIN1,
                                 xqd[1] - SGRPROJ_PRJ_MIN1))
        ref[0], ref[1] = int(xqd[0]), int(xqd[1])

    def _wq_quniform(self, n: int, v: int) -> None:
        """aom_write_primitive_quniform (range-coder literal bits)."""
        if n <= 1:
            return
        l = n.bit_length()  # noqa: E741  (get_msb(n) + 1)
        m = (1 << l) - n
        if v < m:
            self.enc.encode_literal(v, l - 1)
        else:
            self.enc.encode_literal(m + ((v - m) >> 1), l - 1)
            self.enc.encode_literal((v - m) & 1, 1)

    def _w_subexpfin(self, n: int, k: int, v: int) -> None:
        """svt_aom_write_primitive_subexpfin (entropy_coding.c:2875)."""
        i = 0
        mk = 0
        while True:
            b = k + i - 1 if i else k
            a = 1 << b
            if n <= mk + 3 * a:
                self._wq_quniform(n - mk, v - mk)
                break
            t = 1 if v >= mk + a else 0
            self.enc.encode_literal(t, 1)
            if t:
                i += 1
                mk += a
            else:
                self.enc.encode_literal(v - mk, b)
                break

    def _write_cdef(self, r: int, c: int, skip: int) -> None:
        """read_cdef mirror (entropy_coding.c:3884 write_cdef): emit the
        64x64 unit's strength index as a literal at its first non-skip
        block. 64x64 superblocks only (unit == SB)."""
        if self.cdef_fb_map is None or skip or self._cdef_coded:
            return
        if self.fr.allow_intrabc:
            return
        gi = int(self.cdef_fb_map[r >> 4, c >> 4])
        assert gi >= 0, "non-skip block in an fb the cdef search skipped"
        if self.fr.cdef_bits:
            self.enc.encode_literal(gi, self.fr.cdef_bits)
        self._cdef_coded = True

    def _write_delta_q(self, leaf: LeafBlock, r: int, c: int, bsize: int,
                       skip: int) -> None:
        """read_delta_qindex mirror: coded once per SB at the upper-left
        block unless the SB is a single all-skip block."""
        if not self.fr.delta_q_present or self.sb_qindex_map is None:
            return
        sb_mi = 32 if self.seq.use_128x128_superblock else 16
        if (r, c) != self._cur_sb:
            return  # not superblock upper-left
        sb_bsize = 15 if self.seq.use_128x128_superblock else 12
        if bsize == sb_bsize and skip:
            return
        qindex = int(self.sb_qindex_map[r // sb_mi, c // sb_mi])
        reduced = (qindex - self.prev_qindex) // self.fr.delta_q_res
        self.prev_qindex = qindex
        sign = 1 if reduced < 0 else 0
        av = -reduced if sign else reduced
        self._sym_at(min(av, 3), self.cdfs.delta_q)
        if av >= 3:
            rem_bits = (av - 1).bit_length() - 1  # OD_ILOG_NZ(abs-1)-1
            thr = (1 << rem_bits) + 1
            self.enc.encode_literal(rem_bits - 1, 3)
            self.enc.encode_literal(av - thr, rem_bits)
        if av > 0:
            self.enc.encode_literal(sign, 1)

    def _write_partition_tree(self, node: PartitionNode, r: int, c: int, bsize: int) -> None:
        for leaf, p, rr, cc, bs in self._coding_order(node, r, c, bsize):
            if leaf is not None:
                self._write_block(leaf, rr, cc, bs)
                continue
            bw4 = int(BLOCK_W[bs]) >> 2
            if bw4 > 1:  # is_partition_point (>= 8x8)
                self._write_partition_symbol(p, rr, cc, bs, bw4,
                                             int(BLOCK_H[bs]) >> 2)
            else:
                assert p == Partition.NONE

    def _coding_order(self, node: PartitionNode, r: int, c: int, bsize: int):
        """The tree in coding order (spec decode_partition): (None,
        partition, r, c, bsize) for a node whose partition is coded, then
        (leaf, None, r, c, bsize) for each of its blocks, children first."""
        if r >= self.r1 or c >= self.c1 or r >= self.mi_rows or c >= self.mi_cols:
            return
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        p = node.partition
        yield None, p, r, c, bsize
        if p == Partition.NONE:
            yield node.leaf, None, r, c, bsize
            return
        sub = subsize(p, bsize)
        hw4, hh4 = bw4 // 2, bh4 // 2
        if p == Partition.SPLIT:
            coords = [(r, c), (r, c + hw4), (r + hh4, c), (r + hh4, c + hw4)]
            for child, (rr, cc) in zip(node.children, coords):
                yield from self._coding_order(child, rr, cc, sub)
            return
        if p == Partition.HORZ:
            blocks = [(r, c, sub)]
            if r + hh4 < self.mi_rows:
                blocks.append((r + hh4, c, sub))
        elif p == Partition.VERT:
            blocks = [(r, c, sub)]
            if c + hw4 < self.mi_cols:
                blocks.append((r, c + hw4, sub))
        elif p in (Partition.HORZ_A, Partition.HORZ_B, Partition.VERT_A,
                   Partition.VERT_B):
            # AB layouts (spec decode_partition): two split-squares plus
            # one half rect, in coding order
            sq = subsize(Partition.SPLIT, bsize)
            if p == Partition.HORZ_A:
                blocks = [(r, c, sq), (r, c + hw4, sq), (r + hh4, c, sub)]
            elif p == Partition.HORZ_B:
                blocks = [(r, c, sub), (r + hh4, c, sq),
                          (r + hh4, c + hw4, sq)]
            elif p == Partition.VERT_A:
                blocks = [(r, c, sq), (r + hh4, c, sq), (r, c + hw4, sub)]
            else:  # VERT_B
                blocks = [(r, c, sub), (r, c + hw4, sq),
                          (r + hh4, c + hw4, sq)]
        elif p == Partition.HORZ_4:
            blocks = [(r + i * (bh4 // 4), c, sub)
                      for i in range(len(node.children))]
        elif p == Partition.VERT_4:
            blocks = [(r, c + i * (bw4 // 4), sub)
                      for i in range(len(node.children))]
        else:
            raise NotImplementedError(f"partition {p}")
        for child, (rr, cc, bs) in zip(node.children, blocks):
            yield child.leaf, None, rr, cc, bs

    def _write_partition_symbol(self, p: int, r: int, c: int, bsize: int,
                                bw4: int, bh4: int) -> None:
        has_rows = (r + bh4 // 2) < self.mi_rows
        has_cols = (c + bw4 // 2) < self.mi_cols
        avail_u = r > self.r0
        avail_l = c > self.c0
        bsl_ctx = bw4.bit_length() - 2  # 8x8 -> 0 ... 128x128 -> 4
        above_bit = (int(self.above_part[c]) >> bsl_ctx) & 1 if avail_u else 0
        left_bit = (int(self.left_part[r]) >> bsl_ctx) & 1 if avail_l else 0
        ctx = (left_bit * 2 + above_bit) + bsl_ctx * 4

        values = self.cdfs.partition[0]
        cdf = trim(values[ctx])
        if not has_rows and not has_cols:
            assert p == Partition.SPLIT
            return
        if has_rows and has_cols:
            self._sym_at(p, self.cdfs.partition, ctx)
        elif has_cols:  # bottom edge: split_or_horz, gathered "vert alike"
            assert p in (Partition.SPLIT, Partition.HORZ)
            bcdf = _gather_split_bool(cdf, bsize, vert=True)
            self.enc.encode_symbol(1 if p == Partition.SPLIT else 0, bcdf)
        else:  # right edge: split_or_vert, gathered "horz alike"
            assert p in (Partition.SPLIT, Partition.VERT)
            bcdf = _gather_split_bool(cdf, bsize, vert=False)
            self.enc.encode_symbol(1 if p == Partition.SPLIT else 0, bcdf)

    # ---- leaf block ------------------------------------------------------------
    def _write_block(self, leaf: LeafBlock, r: int, c: int, bsize: int) -> None:
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        avail_u = r > self.r0
        avail_l = c > self.c0

        # skip flag (first in both intra/inter frame mode info)
        above_skip = int(self.skips[r - 1, c]) if avail_u else 0
        left_skip = int(self.skips[r, c - 1]) if avail_l else 0
        skip = 1 if leaf.skip else 0
        self._sym_at(skip, self.cdfs.skip, above_skip + left_skip)
        self._write_segment_id(r, c, bsize, avail_u, avail_l, skip)
        self._write_cdef(r, c, skip)
        self._write_delta_q(leaf, r, c, bsize, skip)

        use_angle = bsize >= 3  # BLOCK_8X8
        has_chroma = self._has_chroma(r, c, bw4, bh4)

        if self.fr.frame_is_intra:
            if self.fr.allow_intrabc:
                # intrabc flag + DV (write_intrabc_info,
                # entropy_coding.c:4298); intrabc blocks code no modes
                self._sym_at(1 if leaf.use_intrabc else 0,
                             self.cdfs.intrabc)
                if leaf.use_intrabc:
                    from ..codec.mvp import find_dv_ref

                    ref_dv = find_dv_ref(self.mi_state, r, c, bsize,
                                         self.mi_rows, self.mi_cols)
                    self._write_dv(leaf.mv, ref_dv)
            if not leaf.use_intrabc:
                # intra_frame_y_mode with kf neighbor context
                above_mode = int(self.y_modes[r - 1, c]) if avail_u \
                    else IntraMode.DC
                left_mode = int(self.y_modes[r, c - 1]) if avail_l \
                    else IntraMode.DC
                actx = int(INTRA_MODE_CONTEXT[above_mode])
                lctx = int(INTRA_MODE_CONTEXT[left_mode])
                self._sym_at(leaf.y_mode, self.cdfs.kf_y_mode, actx, lctx)
                if use_angle and leaf.y_mode in DIRECTIONAL:
                    self._sym_at(leaf.angle_delta_y + MAX_ANGLE_DELTA,
                                 self.cdfs.angle_delta,
                                 leaf.y_mode - IntraMode.V)
                if has_chroma:
                    self._write_uv_mode(leaf, bsize, use_angle)
        else:
            self._write_inter_mode_info(leaf, r, c, bsize, avail_u, avail_l,
                                        use_angle, has_chroma)

        # palette_mode_info (spec 5.11.15; write_palette_mode_info,
        # entropy_coding.c:4249) — DC-mode blocks 8x8..64x64 on SC frames
        if (not leaf.is_inter and not leaf.use_intrabc
                and self.fr.allow_screen_content_tools
                and bsize >= 3
                and int(BLOCK_W[bsize]) <= 64 and int(BLOCK_H[bsize]) <= 64):
            self._write_palette_mode_info(leaf, r, c, bsize, avail_u,
                                          avail_l, has_chroma)
        # filter_intra_mode_info (spec 5.11.20): flag for every eligible
        # DC luma block when the sequence gate is on (palette blocks
        # never code it: filter_intra_allowed requires palette_size 0)
        if (self.seq.enable_filter_intra and not leaf.is_inter
                and not leaf.use_intrabc
                and leaf.y_mode == IntraMode.DC
                and not leaf.palette_colors
                and max(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) <= 32):
            self._sym_at(int(leaf.use_filter_intra), self.cdfs.filter_intra,
                         bsize)
            if leaf.use_filter_intra:
                self._sym_at(leaf.filter_intra_mode,
                             self.cdfs.filter_intra_mode)
        # palette color index map tokens (spec 5.11.49 palette_tokens)
        if not leaf.is_inter and leaf.palette_colors:
            self._write_palette_tokens(leaf, r, c)

        # block tx size (TX_MODE_SELECT) — av1_code_tx_size mirror
        if self.fr.tx_mode_select:
            self._code_tx_size(leaf, r, c, bsize)

        # residual
        if leaf.skip:
            if self.coeff_writer is not None:
                self.coeff_writer.reset_skip_ctx(r, c, bw4, bh4, has_chroma)
        else:
            assert self.coeff_writer is not None and leaf.coeffs is not None
            for txb in leaf.coeffs:
                self.coeff_writer.write_txb(
                    txb["plane"], txb["plane_bsize"], txb["tx_size"], txb["tx_type"],
                    txb["qcoeff"], txb["eob"], txb["ux"], txb["uy"],
                    write_tx_type_fn=self._make_tx_type_writer(leaf),
                )

        # ---- neighbor state updates ----
        r_end = min(r + bh4, self.mi_rows)
        c_end = min(c + bw4, self.mi_cols)
        self.y_modes[r:r_end, c:c_end] = leaf.y_mode
        self.skips[r:r_end, c:c_end] = skip
        npal = 0 if leaf.is_inter else len(leaf.palette_colors)
        self.pal_size[r:r_end, c:c_end] = npal
        if npal:
            cols_t = tuple(leaf.palette_colors)
            for rr in range(r, r_end):
                for cc in range(c, c_end):
                    self.pal_colors[(rr, cc)] = cols_t
        self.inters[r:r_end, c:c_end] = 1 if leaf.is_inter else 0
        self.flt[r:r_end, c:c_end] = (leaf.interp_filter if leaf.is_inter
                                      else 3)
        self.ref0g[r:r_end, c:c_end] = (leaf.ref_frame if leaf.is_inter
                                        else 0)
        self.ref1g[r:r_end, c:c_end] = (leaf.ref_frame1 if leaf.is_inter
                                        else -1)
        self.cgig[r:r_end, c:c_end] = leaf.comp_group_idx if leaf.is_inter else 0
        self.cpig[r:r_end, c:c_end] = leaf.compound_idx if leaf.is_inter else 1
        if self.mi_state is not None:
            mi_ref = (0 if leaf.use_intrabc
                      else (leaf.ref_frame if leaf.is_inter else -1))
            self.mi_state.set_block(
                r, c, bsize, mi_ref,
                leaf.mv if (leaf.is_inter or leaf.use_intrabc) else (0, 0),
                leaf.is_inter and mode_has_newmv(leaf.inter_mode),
                leaf.ref_frame1 if leaf.is_inter else -1,
                leaf.mv1 if leaf.is_inter else (0, 0),
                is_gmv=leaf.is_inter and leaf.inter_mode in _GLOBAL_MODES,
                interp_filter=leaf.interp_filter if leaf.is_inter else 0)
        pa, pl = partition_ctx_lookup(bsize)
        self.above_part[c:c_end] = pa
        self.left_part[r:r_end] = pl

    # ---- block tx size (TX_MODE_SELECT) -------------------------------------
    def _code_tx_size(self, leaf: LeafBlock, r: int, c: int, bsize: int) -> None:
        """av1_code_tx_size mirror (entropy_coding.c:4507-4536): intra
        blocks code a tx depth symbol; non-skip inter blocks code the
        vartx txfm_partition tree; skip-inter sets contexts to block
        dims."""
        from ..codec.constants import (
            MAX_TX_SIZE_RECT,
            SPLIT_TX_SIZE,
            TX_H,
            TX_W,
            bsize_to_tx_size_cat,
        )

        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        max_tx = int(MAX_TX_SIZE_RECT[bsize])
        tx = max_tx
        for _ in range(leaf.tx_depth):
            tx = int(SPLIT_TX_SIZE[tx])
        txw, txh = int(TX_W[tx]), int(TX_H[tx])
        bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
        signals = bsize > 0  # block_signals_txsize: bsize > BLOCK_4X4

        # spec is_inter_block includes use_intrabc: intrabc blocks take
        # the inter (vartx) tx-size coding
        is_int = leaf.is_inter or leaf.use_intrabc
        if signals and not (is_int and leaf.skip):
            if is_int:
                # one max-tx unit covers the whole block (<=64px blocks)
                self._write_vartx(r, c, max_tx, tx, 0, bw_px, bh_px)
                self._set_txi(r, c, bw4, bh4, bw_px, bh_px)
                return
            # write_selected_tx_size (entropy_coding.c:4480-4506); unlike
            # the reference's raw memset(~0) read, a MISSING neighbor
            # contributes 0 (verified against dav1d at frame corners)
            maxw, maxh = int(TX_W[max_tx]), int(TX_H[max_tx])
            above = int(int(self.txi_above[c]) >= maxw) if r > self.r0 else 0
            left = int(int(self.txi_left[r]) >= maxh) if c > self.c0 else 0
            cat = bsize_to_tx_size_cat(bsize)
            self._sym_at(leaf.tx_depth, self.cdfs.tx_size, cat, above + left)
            self._set_txi(r, c, bw4, bh4, txw, txh)
            self._set_txp(r, c, bw4, bh4, txw, txh)
            return
        # set_txfm_ctxs (entropy_coding.c:4426-4441)
        if is_int:
            self._set_txi(r, c, bw4, bh4, bw_px, bh_px)
            if leaf.skip:
                self._set_txp(r, c, bw4, bh4, bw_px, bh_px)
            else:
                self._set_txp(r, c, bw4, bh4, txw, txh)
        else:
            self._set_txi(r, c, bw4, bh4, txw, txh)
            self._set_txp(r, c, bw4, bh4, txw, txh)

    def _write_vartx(self, r: int, c: int, tx: int, target: int, depth: int,
                     bw_px: int, bh_px: int) -> None:
        """write_tx_size_vartx (entropy_coding.c:4381-4424): recursive
        no-split/split flags down to the uniform `target` size."""
        from ..codec.constants import SPLIT_TX_SIZE, TX_H, TX_W, TxSize

        if r >= self.mi_rows or c >= self.mi_cols:
            return
        txw, txh = int(TX_W[tx]), int(TX_H[tx])
        if depth == 2:  # MAX_VARTX_DEPTH
            self._set_txp_unit(r, c, txw >> 2, txh >> 2, txw, txh)
            return
        ctx = self._txfm_partition_ctx(r, c, tx, bw_px, bh_px)
        if tx == target:
            self._sym_at(0, self.cdfs.txfm_partition, ctx)
            self._set_txp_unit(r, c, txw >> 2, txh >> 2, txw, txh)
            return
        self._sym_at(1, self.cdfs.txfm_partition, ctx)
        sub = int(SPLIT_TX_SIZE[tx])
        if sub == TxSize.TX_4X4:
            # terminal: update over the PARENT extent with sub dims
            self._set_txp_unit(r, c, txw >> 2, txh >> 2, 4, 4)
            return
        sw4, sh4 = int(TX_W[sub]) >> 2, int(TX_H[sub]) >> 2
        for dr in range(0, txh >> 2, sh4):
            for dc in range(0, txw >> 2, sw4):
                self._write_vartx(r + dr, c + dc, sub, target, depth + 1,
                                  bw_px, bh_px)

    def _txfm_partition_ctx(self, r: int, c: int, tx: int, bw_px: int,
                            bh_px: int) -> int:
        return txfm_partition_ctx_calc(int(self.txp_above[c]),
                                       int(self.txp_left[r]), tx, bw_px, bh_px)

    def _set_txi(self, r, c, bw4, bh4, w_px, h_px) -> None:
        self.txi_above[c : min(c + bw4, self.mi_cols)] = w_px
        self.txi_left[r : min(r + bh4, self.mi_rows)] = h_px

    def _set_txp(self, r, c, bw4, bh4, w_px, h_px) -> None:
        self.txp_above[c : min(c + bw4, self.mi_cols)] = w_px
        self.txp_left[r : min(r + bh4, self.mi_rows)] = h_px

    def _set_txp_unit(self, r, c, w4, h4, w_px, h_px) -> None:
        self.txp_above[c : min(c + w4, self.mi_cols)] = w_px
        self.txp_left[r : min(r + h4, self.mi_rows)] = h_px

    def _write_uv_mode(self, leaf: LeafBlock, bsize: int, use_angle: bool) -> None:
        cfl_allowed = 1 if (int(BLOCK_W[bsize]) <= 32 and int(BLOCK_H[bsize]) <= 32) else 0
        self._sym_at(leaf.uv_mode, self.cdfs.uv_mode, cfl_allowed, leaf.y_mode)
        if leaf.uv_mode == 13:  # UV_CFL_PRED (write_cfl_alphas mirror)
            from ..ops.intra import cfl_context_u, cfl_context_v, cfl_joint_sign

            au, av = leaf.cfl_alpha_u, leaf.cfl_alpha_v
            js = cfl_joint_sign(au, av)
            self._sym_at(js, self.cdfs.cfl_sign)
            if au != 0:
                self._sym_at(abs(au) - 1, self.cdfs.cfl_alpha,
                             cfl_context_u(js))
            if av != 0:
                self._sym_at(abs(av) - 1, self.cdfs.cfl_alpha,
                             cfl_context_v(js))
        if use_angle and leaf.uv_mode in DIRECTIONAL:
            self._sym_at(leaf.angle_delta_uv + MAX_ANGLE_DELTA,
                         self.cdfs.angle_delta, leaf.uv_mode - IntraMode.V)

    def _write_inter_mode_info(self, leaf: LeafBlock, r: int, c: int, bsize: int,
                               avail_u: bool, avail_l: bool, use_angle: bool,
                               has_chroma: bool) -> None:
        """mode_info() for inter frames (spec inter_frame_mode_info after
        skip): is_inter, then intra modes or ref/mode/drl/mv."""
        from ..codec.constants import SIZE_GROUP, InterMode
        from ..codec.mvp import find_mv_stack

        # intra/inter context (av1_get_intra_inter_context semantics)
        a_int = int(self.inters[r - 1, c]) if avail_u else -1
        l_int = int(self.inters[r, c - 1]) if avail_l else -1
        if avail_u and avail_l:
            ctx = 3 if (a_int == 0 and l_int == 0) else int(a_int == 0) + int(l_int == 0)
        elif avail_u or avail_l:
            ctx = 2 * int((a_int if avail_u else l_int) == 0)
        else:
            ctx = 0
        self._sym_at(1 if leaf.is_inter else 0, self.cdfs.intra_inter, ctx)

        if not leaf.is_inter:
            self._sym_at(leaf.y_mode, self.cdfs.y_mode, int(SIZE_GROUP[bsize]))
            if use_angle and leaf.y_mode in DIRECTIONAL:
                self._sym_at(leaf.angle_delta_y + MAX_ANGLE_DELTA,
                             self.cdfs.angle_delta, leaf.y_mode - IntraMode.V)
            if has_chroma:
                self._write_uv_mode(leaf, bsize, use_angle)
            return

        # ---- ref frames ----
        self._write_ref_frames(leaf, r, c, avail_u, avail_l)
        is_comp = leaf.ref_frame1 >= 1

        ref_key = (leaf.ref_frame, leaf.ref_frame1) if is_comp else leaf.ref_frame
        stack = find_mv_stack(self.mi_state, r, c, bsize, ref_key,
                              gm_mv=(self._gm_mv(leaf.ref_frame, r, c, bsize),
                                     self._gm_mv(leaf.ref_frame1, r, c,
                                                 bsize)),
                              gm_warp=self._gm_type(leaf.ref_frame) >= 2)
        mode_ctx = stack.mode_context
        mode = InterMode(leaf.inter_mode)

        if is_comp:
            from ..codec.constants import compound_sub_modes

            # av1_mode_context_analyzer compound compression
            newmv_ctx = mode_ctx & 7
            refmv_ctx = (mode_ctx >> 4) & 15
            comp_ctx = _COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1][min(newmv_ctx, 4)]
            self._sym_at(int(mode) - int(InterMode.NEAREST_NEARESTMV),
                         self.cdfs.inter_compound_mode, comp_ctx)
            sub0, sub1 = compound_sub_modes(mode)
            # read_drl_mode: only NEW_NEWMV takes the idx 0..1 branch;
            # modes with any NEAR component (NEAR_NEAR/NEAR_NEW/NEW_NEAR)
            # take the has_nearmv idx 1..2 branch (spec 5.11.25)
            self._write_drl(mode, leaf.drl_index, stack,
                            has_new=(mode == InterMode.NEW_NEWMV),
                            near_like=(InterMode.NEARMV in (sub0, sub1)))
            # assign_mv: a NEW component codes its residual; NEAR uses
            # drl_index + 1 offset handled by the chosen drl entry
            if sub0 == InterMode.NEWMV:
                self._write_mv(leaf.mv, stack.mvs[leaf.drl_index])
            if sub1 == InterMode.NEWMV:
                self._write_mv(leaf.mv1, stack.comp_mvs[leaf.drl_index])
            # compound blocks are always SIMPLE (read_motion_mode)
            self._write_compound_type(leaf, r, c, bsize, avail_u, avail_l)
            self._write_interp_filter(leaf, r, c, avail_u, avail_l)
            return

        # write_inter_mode (single reference)
        newmv_ctx = mode_ctx & 7
        self._sym_at(0 if mode == InterMode.NEWMV else 1, self.cdfs.newmv, newmv_ctx)
        if mode != InterMode.NEWMV:
            zeromv_ctx = (mode_ctx >> 3) & 1
            self._sym_at(0 if mode == InterMode.GLOBALMV else 1,
                         self.cdfs.zeromv, zeromv_ctx)
            if mode != InterMode.GLOBALMV:
                refmv_ctx = (mode_ctx >> 4) & 15
                self._sym_at(0 if mode == InterMode.NEARESTMV else 1,
                             self.cdfs.refmv, refmv_ctx)

        self._write_drl(mode, leaf.drl_index, stack,
                        has_new=(mode == InterMode.NEWMV),
                        near_like=(mode == InterMode.NEARMV))

        # MV residual
        if mode == InterMode.NEWMV:
            ref_mv = stack.mvs[leaf.drl_index]
            self._write_mv(leaf.mv, ref_mv)
        ii_coded = self._write_interintra(leaf, bsize)
        if not ii_coded or leaf.interintra_mode < 0:
            # inter-intra blocks read no motion_mode (rf[1] == INTRA,
            # entropy_coding.c:5134)
            self._write_motion_mode(leaf, r, c, bsize)
        self._write_interp_filter(leaf, r, c, avail_u, avail_l)

    def _write_interintra(self, leaf: LeafBlock, bsize: int) -> bool:
        """read_interintra_mode mirror: flag + mode (+ wedge) for
        single-ref NEAREST/NEAR/GLOBAL/NEWMV at 8x8..32x32 when the seq
        gate is on. Returns whether the flag was coded."""
        from ..codec.constants import SIZE_GROUP, WEDGE_BITS

        if not getattr(self.seq, "enable_interintra_compound", False):
            return False
        if not (8 <= int(BLOCK_W[bsize]) <= 32
                and 8 <= int(BLOCK_H[bsize]) <= 32):
            return False
        if not (13 <= leaf.inter_mode <= 16):  # NEARESTMV..NEWMV
            return False
        grp = int(SIZE_GROUP[bsize])
        ii = leaf.interintra_mode >= 0
        self._sym_at(1 if ii else 0, self.cdfs.interintra, grp)
        if not ii:
            return True
        self._sym_at(leaf.interintra_mode, self.cdfs.interintra_mode, grp)
        if int(WEDGE_BITS[bsize]) > 0:
            self._sym_at(leaf.wedge_interintra, self.cdfs.wedge_interintra,
                         bsize)
            if leaf.wedge_interintra:
                self._sym_at(leaf.wedge_index, self.cdfs.wedge_idx, bsize)
        return True

    # ---- compound type (spec 5.11.27 read_compound_type mirror) ---------
    def _cgi_nb(self, rr: int, cc: int) -> int:
        """Neighbor contribution to the comp_group_idx context
        (svt_aom_get_comp_group_idx_context_enc, entropy_coding.c:74)."""
        if self.ref1g[rr, cc] >= 1:
            return int(self.cgig[rr, cc])
        if self.ref0g[rr, cc] == 7:  # single-ref ALTREF
            return 3
        return 0

    def _cpi_nb(self, rr: int, cc: int) -> int:
        """Neighbor contribution to the compound_idx context
        (svt_aom_get_comp_index_context_enc, entropy_coding.c:48)."""
        if self.ref1g[rr, cc] >= 1:
            return int(self.cpig[rr, cc])
        if self.ref0g[rr, cc] == 7:
            return 1
        return 0

    def comp_index_ctx(self, ref0: int, ref1: int, r: int, c: int,
                       avail_u: bool, avail_l: bool) -> int:
        bits = self.seq.order_hint_bits
        cur = self.fr.order_hint
        from ..ops.mc import rel_dist
        fwd = abs(rel_dist(bits, self.fr.ref_order_hints[ref1 - 1], cur))
        bck = abs(rel_dist(bits, cur, self.fr.ref_order_hints[ref0 - 1]))
        above = self._cpi_nb(r - 1, c) if avail_u else 0
        left = self._cpi_nb(r, c - 1) if avail_l else 0
        return above + left + (3 if fwd == bck else 0)

    def comp_group_ctx(self, r: int, c: int, avail_u: bool,
                       avail_l: bool) -> int:
        above = self._cgi_nb(r - 1, c) if avail_u else 0
        left = self._cgi_nb(r, c - 1) if avail_l else 0
        return min(5, above + left)

    def _write_compound_type(self, leaf: LeafBlock, r: int, c: int,
                             bsize: int, avail_u: bool, avail_l: bool) -> None:
        """Compound group / index / masked-type syntax after the MVs
        (entropy_coding.c:5141-5200; our streams never use skip_mode)."""
        from ..codec.constants import COMPOUND_WEDGE, WEDGE_BITS

        masked_used = (getattr(self.seq, "enable_masked_compound", False)
                       and min(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) >= 8)
        if masked_used:
            self._sym_at(leaf.comp_group_idx, self.cdfs.comp_group_idx,
                         self.comp_group_ctx(r, c, avail_u, avail_l))
        if leaf.comp_group_idx == 0:
            if getattr(self.seq, "enable_jnt_comp", False):
                ctx = self.comp_index_ctx(leaf.ref_frame, leaf.ref_frame1,
                                          r, c, avail_u, avail_l)
                self._sym_at(leaf.compound_idx, self.cdfs.compound_idx, ctx)
            return
        if int(WEDGE_BITS[bsize]) > 0:
            self._sym_at(leaf.comp_type - COMPOUND_WEDGE,
                         self.cdfs.compound_type, bsize)
        if leaf.comp_type == COMPOUND_WEDGE:
            self._sym_at(leaf.wedge_index, self.cdfs.wedge_idx, bsize)
            self.enc.encode_literal(leaf.wedge_sign, 1)
        else:
            self.enc.encode_literal(leaf.mask_type, 1)

    def _interp_ctx(self, r: int, c: int, avail_u: bool, avail_l: bool,
                    rf0: int, rf1: int, dir_: int) -> int:
        """get_pred_context_switchable_interp (entropy_coding.c:1564):
        combine left/above per-dir filters of neighbors that share rf0."""
        def ref_filter(rr, cc):
            if (self.ref0g[rr, cc] == rf0 or self.ref1g[rr, cc] == rf0):
                return int(self.flt[rr, cc])
            return 3  # SWITCHABLE_FILTERS

        ctx = (4 if rf1 >= 1 else 0) + (dir_ & 1) * 8
        left = ref_filter(r, c - 1) if avail_l else 3
        above = ref_filter(r - 1, c) if avail_u else 3
        if left == above:
            return ctx + left
        if left == 3:
            return ctx + above
        if above == 3:
            return ctx + left
        return ctx + 3

    def motion_mode_kind(self, leaf, r: int, c: int, bsize: int) -> str:
        """Which motion_mode syntax the decoder reads for this block
        (spec 5.11.27 read_motion_mode): "none" (inferred SIMPLE),
        "obmc" (binary obmc symbol), or "full" (3-ary motion_mode)."""
        from ..codec.constants import BLOCK_H, BLOCK_W, InterMode
        from ..codec.warp_samples import count_overlappable, find_warp_samples

        if not self.fr.is_motion_mode_switchable:
            return "none"
        if min(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) < 8:
            return "none"
        if (leaf.inter_mode in (int(InterMode.GLOBALMV),
                                int(InterMode.GLOBAL_GLOBALMV))
                and self._gm_type(leaf.ref_frame) >= 2):
            return "none"
        if leaf.ref_frame1 >= 1:
            return "none"
        if count_overlappable(self.mi_state, r, c, bsize) == 0:
            return "none"
        pts, _ = find_warp_samples(self.mi_state, r, c, bsize,
                                   leaf.ref_frame)
        if len(pts) == 0 or not self.fr.allow_warped_motion:
            return "obmc"
        return "full"

    def _write_motion_mode(self, leaf, r: int, c: int, bsize: int) -> None:
        kind = self.motion_mode_kind(leaf, r, c, bsize)
        if kind == "none":
            assert leaf.motion_mode == 0
            return
        if kind == "obmc":
            self._sym_at(1 if leaf.motion_mode == 1 else 0,
                         self.cdfs.obmc, bsize)
            return
        self._sym_at(leaf.motion_mode, self.cdfs.motion_mode, bsize)

    def _gm_type(self, ref_id: int) -> int:
        gm = getattr(self.fr, "gm", None)
        if not gm or not (1 <= ref_id <= 7) or gm[ref_id - 1] is None:
            return 0  # IDENTITY
        return gm[ref_id - 1][0]

    def _gm_mv(self, ref_id: int, r: int, c: int, bsize: int):
        """GLOBALMV of this block per ref (spec 7.10.2.10), 1/8 pel."""
        gm = getattr(self.fr, "gm", None)
        if not gm or not (1 <= ref_id <= 7) or gm[ref_id - 1] is None:
            return (0, 0)
        from ..codec.constants import BLOCK_H, BLOCK_W
        from ..ops.warp import project_mv

        gt, mat = gm[ref_id - 1]
        return project_mv(mat, gt, r, c, int(BLOCK_W[bsize]),
                          int(BLOCK_H[bsize]), False, False)

    # ---- palette (screen-content tools) --------------------------------
    def _write_palette_mode_info(self, leaf: LeafBlock, r: int, c: int,
                                 bsize: int, avail_u: bool, avail_l: bool,
                                 has_chroma: bool) -> None:
        """write_palette_mode_info (entropy_coding.c:4249): Y palette
        flag/size/colors for DC blocks + the (always-zero) UV flag."""
        from ..codec.constants import BLOCK_H, BLOCK_W

        bw, bh = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
        bsize_ctx = (bw * bh).bit_length() - 1 - 6  # num_pels_log2 - 6
        n = len(leaf.palette_colors)
        if leaf.y_mode == IntraMode.DC:
            ctx = 0
            if avail_u and int(self.pal_size[r - 1, c]) > 0:
                ctx += 1
            if avail_l and int(self.pal_size[r, c - 1]) > 0:
                ctx += 1
            self._sym_at(1 if n else 0, self.cdfs.palette_y_mode,
                         bsize_ctx, ctx)
            if n:
                self._sym_at(n - 2, self.cdfs.palette_y_size, bsize_ctx)
                self._write_palette_colors_y(leaf, r, c, avail_u, avail_l)
        if has_chroma and leaf.uv_mode == IntraMode.DC:
            # UV palette unimplemented (as in the reference encoder:
            # entropy_coding.c:4283 asserts palette_size[1] == 0)
            self._sym_at(0, self.cdfs.palette_uv_mode, 1 if n else 0)

    def _palette_cache(self, r: int, c: int, avail_u: bool,
                       avail_l: bool) -> list:
        """svt_get_palette_cache_y: merge the above (same SB row only)
        and left MIs' sorted palettes, deduplicated."""
        above = (self.pal_colors.get((r - 1, c), ())
                 if avail_u and (r % 16) else ())
        left = self.pal_colors.get((r, c - 1), ()) if avail_l else ()
        cache: list = []

        def add(v):
            if not cache or cache[-1] != v:
                cache.append(v)

        ai = li = 0
        while ai < len(above) and li < len(left):
            va, vl = above[ai], left[li]
            if vl < va:
                add(vl)
                li += 1
            else:
                add(va)
                ai += 1
                if vl == va:
                    li += 1
        while ai < len(above):
            add(above[ai])
            ai += 1
        while li < len(left):
            add(left[li])
            li += 1
        return cache

    def _write_palette_colors_y(self, leaf: LeafBlock, r: int, c: int,
                                avail_u: bool, avail_l: bool) -> None:
        """write_palette_colors_y: cache-hit bits + delta-coded rest."""
        colors = list(leaf.palette_colors)
        n = len(colors)
        cache = self._palette_cache(r, c, avail_u, avail_l)
        in_flags = [False] * n
        found = [0] * len(cache)
        n_in = 0
        for i, cv in enumerate(cache):
            if n_in >= n:
                break
            for j in range(n):
                if colors[j] == cv and not in_flags[j]:
                    in_flags[j] = True
                    found[i] = 1
                    n_in += 1
                    break
        n_written = 0
        for i in range(len(cache)):
            if n_written >= n:
                break
            self.enc.encode_literal(found[i], 1)
            n_written += found[i]
        out = [colors[j] for j in range(n) if not in_flags[j]]
        self._delta_encode_palette_colors(out, self.seq.bit_depth, 1)

    def _delta_encode_palette_colors(self, colors: list, bit_depth: int,
                                     min_val: int) -> None:
        """delta_encode_palette_colors (entropy_coding.c:4162)."""
        num = len(colors)
        if num <= 0:
            return
        self.enc.encode_literal(colors[0], bit_depth)
        if num == 1:
            return
        deltas = [colors[i] - colors[i - 1] for i in range(1, num)]
        max_delta = max(deltas)

        def clog2(x: int) -> int:
            return 0 if x < 2 else (x - 1).bit_length()

        min_bits = bit_depth - 3
        bits = max(clog2(max_delta + 1 - min_val), min_bits)
        rng = (1 << bit_depth) - colors[0] - min_val
        self.enc.encode_literal(bits - min_bits, 2)
        for d in deltas:
            self.enc.encode_literal(d - min_val, bits)
            rng -= d
            bits = min(bits, clog2(rng))

    @staticmethod
    def _palette_color_ctx(cmap: np.ndarray, i: int, j: int):
        """svt_aom_get_palette_color_index_context_optimized
        (cabac_context_model.c:2458): neighbor-weighted color order;
        returns (context, reordered symbol)."""
        cn = [int(cmap[i, j - 1]) if j > 0 else -1,
              int(cmap[i - 1, j]) if i > 0 else -1,
              int(cmap[i - 1, j - 1]) if (i > 0 and j > 0) else -1]
        sc = [2, 2, 1]
        if cn[0] == cn[1]:
            sc[0] += sc[1]
            cn[1] = -1
            if cn[0] == cn[2]:
                sc[0] += sc[2]
                cn[2] = -1
        elif cn[0] == cn[2]:
            sc[0] += sc[2]
            cn[2] = -1
        elif cn[1] == cn[2]:
            sc[1] += sc[2]
            cn[2] = -1
        rank = [-1, -1, -1]
        score = [0, 0, 0]
        nv = 0
        for idx in range(3):
            if cn[idx] != -1:
                score[nv] = sc[idx]
                rank[nv] = cn[idx]
                nv += 1
        if score[0] < score[1] or (score[0] == score[1]
                                   and rank[0] > rank[1]):
            score[0], score[1] = score[1], score[0]
            rank[0], rank[1] = rank[1], rank[0]
        if score[0] < score[2]:
            score[0], score[2] = score[2], score[0]
            rank[0], rank[2] = rank[2], rank[0]
        if score[1] < score[2]:
            score[1], score[2] = score[2], score[1]
            rank[1], rank[2] = rank[2], rank[1]
        cur = int(cmap[i, j])
        sym = cur
        same = -1
        for idx in range(3):
            if rank[idx] > cur:
                sym += 1
            elif rank[idx] == cur:
                same = idx
        if same != -1:
            sym = same
        hashv = score[0] + 2 * score[1] + 2 * score[2]
        ctx = (-1, -1, 0, -1, -1, 4, 3, 2, 1)[hashv]
        return ctx, sym

    def _write_palette_tokens(self, leaf: LeafBlock, r: int, c: int) -> None:
        """palette_tokens (spec 5.11.49): first index uniform, the rest
        in diagonal wavefront order with neighbor-ordered symbols."""
        n = len(leaf.palette_colors)
        cmap = np.asarray(leaf.palette_map)
        rows = min(cmap.shape[0], (self.mi_rows - r) * 4)
        cols = min(cmap.shape[1], (self.mi_cols - c) * 4)
        self._wq_quniform(n, int(cmap[0, 0]))
        for k in range(1, rows + cols - 1):
            for j in range(min(k, cols - 1), max(0, k - rows + 1) - 1, -1):
                i = k - j
                ctx, sym = self._palette_color_ctx(cmap, i, j)
                self._sym_at(sym, self.cdfs.palette_y_color_index,
                             n - 2, ctx)

    def _write_interp_filter(self, leaf: LeafBlock, r: int, c: int,
                             avail_u: bool, avail_l: bool) -> None:
        """read_interp_filter mirror (spec 5.11.26 needs_interp_filter;
        write_mb_interp_filter entropy_coding.c:1636).  No skip_mode /
        warp here; large GLOBALMV blocks code the symbol only when a used
        ref's GmType is TRANSLATION; enable_dual_filter is off => one
        symbol for both axes."""
        if self.fr.interp_filter != 4:  # SWITCHABLE
            return
        if leaf.motion_mode == 2:  # LOCALWARP: filter not coded
            return
        from ..codec.constants import BLOCK_H, BLOCK_W, InterMode

        large = min(int(BLOCK_W[leaf.bsize]), int(BLOCK_H[leaf.bsize])) >= 8
        if large and leaf.inter_mode == int(InterMode.GLOBALMV):
            if self._gm_type(leaf.ref_frame) != 1:
                return  # decoder infers EIGHTTAP
        elif large and leaf.inter_mode == int(InterMode.GLOBAL_GLOBALMV):
            if (self._gm_type(leaf.ref_frame) != 1
                    and self._gm_type(leaf.ref_frame1) != 1):
                return
        ctx = self._interp_ctx(r, c, avail_u, avail_l, leaf.ref_frame,
                               leaf.ref_frame1, 0)
        self._sym_at(leaf.interp_filter, self.cdfs.switchable_interp, ctx)

    def _write_drl(self, mode, drl_index, stack, has_new: bool,
                   near_like: bool) -> None:
        """write_drl_idx: NEW-containing modes pick among stack[0..2];
        NEAR(_NEAR) modes among stack[1..3]."""
        if has_new:
            for idx in range(2):
                if stack.count > idx + 1:
                    self._sym_at(1 if drl_index != idx else 0,
                                 self.cdfs.drl, stack.drl_ctx(idx))
                    if drl_index == idx:
                        break
        elif near_like:
            for idx in range(1, 3):
                if stack.count > idx + 1:
                    self._sym_at(1 if drl_index != (idx - 1) else 0,
                                 self.cdfs.drl, stack.drl_ctx(idx))
                    if drl_index == idx - 1:
                        break

    def _neighbor_ref_counts(self, r: int, c: int, avail_u: bool,
                             avail_l: bool) -> np.ndarray:
        """neighbors_ref_counts: both components of each edge neighbor."""
        counts = np.zeros(8, np.int32)
        for rr, cc, av in ((r - 1, c, avail_u), (r, c - 1, avail_l)):
            if av and self.inters[rr, cc]:
                counts[int(self.mi_state.ref_frame[rr, cc])] += 1
                r1 = int(self.mi_state.ref_frame1[rr, cc])
                if r1 >= 1:
                    counts[r1] += 1
        return counts

    def _comp_mode_ctx(self, r: int, c: int, avail_u: bool, avail_l: bool) -> int:
        """svt_aom_get_reference_mode_context_new (entropy_coding.c:1855)."""

        def is_bwd(rr, cc):
            return int(self.mi_state.ref_frame[rr, cc]) >= 5

        def is_comp(rr, cc):
            return int(self.mi_state.ref_frame1[rr, cc]) >= 1

        def is_int(rr, cc):
            return not self.inters[rr, cc]

        if avail_u and avail_l:
            a, l = (r - 1, c), (r, c - 1)
            if not is_comp(*a) and not is_comp(*l):
                return int((is_bwd(*a) and not is_int(*a))
                           ^ (is_bwd(*l) and not is_int(*l)))
            if not is_comp(*a):
                return 2 + int(is_bwd(*a) or is_int(*a))
            if not is_comp(*l):
                return 2 + int(is_bwd(*l) or is_int(*l))
            return 4
        if avail_u or avail_l:
            e = (r - 1, c) if avail_u else (r, c - 1)
            if not is_comp(*e):
                return int(is_bwd(*e) and not is_int(*e))
            return 3
        return 1

    def _write_ref_frames(self, leaf: LeafBlock, r: int, c: int,
                          avail_u: bool, avail_l: bool) -> None:
        """write_ref_frames: comp mode flag (when reference_select), then
        the single-ref or bidir-compound tree, neighbor-count contexts."""
        counts = self._neighbor_ref_counts(r, c, avail_u, avail_l)

        def cmp_ctx(a, b):
            return 1 if a == b else (0 if a < b else 2)

        is_comp = leaf.ref_frame1 >= 1
        if self.fr.reference_select:
            # comp_mode only allowed for blocks >= 8x8 in both dims
            self._sym_at(1 if is_comp else 0, self.cdfs.comp_inter,
                         self._comp_mode_ctx(r, c, avail_u, avail_l))
        if is_comp:
            # comp_reference_type: BIDIR (unidir compound unused)
            self._sym_at(1, self.cdfs.comp_ref_type,
                         self._comp_ref_type_ctx(r, c, avail_u, avail_l))
            fwd, bwd = leaf.ref_frame, leaf.ref_frame1
            # forward ref: comp_ref tree
            bit = 1 if fwd in (3, 4) else 0
            self._sym_at(bit, self.cdfs.comp_ref,
                         cmp_ctx(int(counts[1] + counts[2]),
                                 int(counts[3] + counts[4])), 0)
            if not bit:
                self._sym_at(1 if fwd == 2 else 0, self.cdfs.comp_ref,
                             cmp_ctx(int(counts[1]), int(counts[2])), 1)
            else:
                self._sym_at(1 if fwd == 4 else 0, self.cdfs.comp_ref,
                             cmp_ctx(int(counts[3]), int(counts[4])), 2)
            # backward ref: comp_bwdref tree
            bit_b = 1 if bwd == 7 else 0
            self._sym_at(bit_b, self.cdfs.comp_bwdref,
                         cmp_ctx(int(counts[5] + counts[6]), int(counts[7])), 0)
            if not bit_b:
                self._sym_at(1 if bwd == 6 else 0, self.cdfs.comp_bwdref,
                             cmp_ctx(int(counts[5]), int(counts[6])), 1)
            return

        fwd = int(counts[1:5].sum())
        bwd = int(counts[5:8].sum())
        ref = leaf.ref_frame
        bit0 = 1 if ref >= 5 else 0  # BWDREF group
        self._sym_at(bit0, self.cdfs.single_ref, cmp_ctx(fwd, bwd), 0)
        if bit0:
            bit1 = 1 if ref == 7 else 0
            ctx = cmp_ctx(int(counts[5] + counts[6]), int(counts[7]))
            self._sym_at(bit1, self.cdfs.single_ref, ctx, 1)
            if not bit1:
                self._sym_at(1 if ref == 6 else 0, self.cdfs.single_ref,
                             cmp_ctx(int(counts[5]), int(counts[6])), 5)
        else:
            bit2 = 1 if ref in (3, 4) else 0
            ctx = cmp_ctx(int(counts[1] + counts[2]), int(counts[3] + counts[4]))
            self._sym_at(bit2, self.cdfs.single_ref, ctx, 2)
            if not bit2:
                self._sym_at(1 if ref != 1 else 0, self.cdfs.single_ref,
                             cmp_ctx(int(counts[1]), int(counts[2])), 3)
            else:
                self._sym_at(1 if ref != 3 else 0, self.cdfs.single_ref,
                             cmp_ctx(int(counts[3]), int(counts[4])), 4)

    def _comp_ref_type_ctx(self, r: int, c: int, avail_u: bool,
                           avail_l: bool) -> int:
        """svt_aom_get_comp_reference_type_context_new (uni-comp unused by
        this encoder, so has_uni_comp_refs(neighbor) is always False)."""

        def is_comp(rr, cc):
            return int(self.mi_state.ref_frame1[rr, cc]) >= 1

        def is_bwd(rr, cc):
            return int(self.mi_state.ref_frame[rr, cc]) >= 5

        def intra(rr, cc):
            return not self.inters[rr, cc]

        if avail_u and avail_l:
            a, l = (r - 1, c), (r, c - 1)
            ai, li = intra(*a), intra(*l)
            if ai and li:
                return 2
            if ai or li:
                e = l if ai else a
                return 2 if not is_comp(*e) else 1
            a_sg, l_sg = not is_comp(*a), not is_comp(*l)
            if a_sg and l_sg:
                return 1 + 2 * int(not (is_bwd(*a) ^ is_bwd(*l)))
            if a_sg or l_sg:
                return 1  # single/comp, neighbor comp is bidir
            return 0  # comp/comp, both bidir
        if avail_u or avail_l:
            e = (r - 1, c) if avail_u else (r, c - 1)
            if intra(*e) or not is_comp(*e):
                return 2
            return 0  # comp neighbor, bidir
        return 2

    def _write_dv(self, dv: tuple, ref_dv: tuple) -> None:
        """svt_av1_encode_dv (entropy_coding.c:4290): like _write_mv but
        over the separate ndvc context and MV_SUBPEL_NONE — the low
        three magnitude bits are all-ones by construction (full-pel DVs)
        so the fr/hp symbols are never coded (decoder infers 3/1)."""
        diff = (dv[0] - ref_dv[0], dv[1] - ref_dv[1])
        if diff[0] == 0:
            joint = 0 if diff[1] == 0 else 1
        else:
            joint = 2 if diff[1] == 0 else 3
        self._sym_at(joint, self.cdfs.ndv_joints)
        for ci, comp in ((0, diff[0]), (1, diff[1])):
            if comp == 0:
                continue
            sign = 1 if comp < 0 else 0
            mag = -comp if comp < 0 else comp
            z = mag - 1
            if z < 16:
                mv_class = 0
                offset = z
            else:
                mv_class = min(10, (z >> 3).bit_length() - 1)
                offset = z - (2 << (mv_class + 2))
            d = offset >> 3
            self._sym_at(sign, self.cdfs.ndv_sign, ci)
            self._sym_at(mv_class, self.cdfs.ndv_classes, ci)
            if mv_class == 0:
                self._sym_at(d, self.cdfs.ndv_class0, ci)
            else:
                for i in range(mv_class):
                    self._sym_at((d >> i) & 1, self.cdfs.ndv_bits, ci, i)

    def _write_mv(self, mv: tuple, ref_mv: tuple) -> None:
        """svt_av1_encode_mv: joint + per-component, low precision (no hp)."""
        diff = (mv[0] - ref_mv[0], mv[1] - ref_mv[1])
        joint = (2 if diff[1] else 0) | (1 if diff[0] else 0)
        # MV_JOINT: 0 zero, 1 HNZVZ (col!=0? no...) spec: 1 = hor zero,
        # vert nonzero? av1_get_mv_joint_diff: diff[0]==0 ? (diff[1]==0 ?
        # ZERO : HNZVZ) : (diff[1]==0 ? HZVNZ : HNZVNZ) with diff[0]=row
        if diff[0] == 0:
            joint = 0 if diff[1] == 0 else 1
        else:
            joint = 2 if diff[1] == 0 else 3
        self._sym_at(joint, self.cdfs.nmv_joints)
        if diff[0] != 0:  # vertical component (comp index 0)
            self._write_mv_component(diff[0], 0)
        if diff[1] != 0:
            self._write_mv_component(diff[1], 1)

    def _write_mv_component(self, comp: int, ci: int) -> None:
        sign = 1 if comp < 0 else 0
        mag = -comp if comp < 0 else comp
        z = mag - 1
        if z < 16:  # CLASS0_SIZE(2) << 3
            mv_class = 0
            offset = z
        else:
            mv_class = min(10, (z >> 3).bit_length() - 1)
            offset = z - (2 << (mv_class + 2))
        d = offset >> 3
        fr_bits = (offset >> 1) & 3
        self._sym_at(sign, self.cdfs.nmv_sign, ci)
        self._sym_at(mv_class, self.cdfs.nmv_classes, ci)
        if mv_class == 0:
            self._sym_at(d, self.cdfs.nmv_class0, ci)
        else:
            n = mv_class  # mv_class + CLASS0_BITS(1) - 1 integer bits
            for i in range(n):
                self._sym_at((d >> i) & 1, self.cdfs.nmv_bits, ci, i)
        # fractional (precision MV_SUBPEL_LOW_PRECISION: fr coded, hp not)
        if mv_class == 0:
            self._sym_at(fr_bits, self.cdfs.nmv_class0_fp, ci, d)
        else:
            self._sym_at(fr_bits, self.cdfs.nmv_fp, ci)

    def _make_tx_type_writer(self, leaf: LeafBlock):
        """Returns a callback writing the luma tx_type symbol when the tx
        set for (tx_size, intra) has more than one type (spec
        transform_type(); reference av1_write_tx_type entropy_coding.c:437).
        """

        def write(tx_size: int, tx_type: int) -> None:
            from ..codec.constants import tx_size_sqr, tx_size_sqr_up

            if self.fr.base_q_idx == 0:
                return
            sqr_up = tx_size_sqr_up(tx_size)
            if sqr_up > 3:  # 64-class: DCT only, no signal
                return
            sqr = tx_size_sqr(tx_size)
            if leaf.is_inter or leaf.use_intrabc:
                # ext_tx_set_index[inter]: DCT_IDTX->3, DTT9_IDTX_1DDCT->2,
                # ALL16->1 (definitions.h:1808)
                if self.fr.reduced_tx_set or sqr_up == 3:  # DCT_IDTX (2)
                    eset = 3
                    ind = {0: 1, 9: 0}[tx_type]
                elif sqr == 2:  # 16x16: DTT9_IDTX_1DDCT (12)
                    eset = 2
                    ind = {9: 0, 10: 1, 11: 2, 0: 3, 1: 4, 2: 5, 4: 6, 5: 7,
                           3: 8, 6: 9, 7: 10, 8: 11}[tx_type]
                else:  # ALL16
                    eset = 1
                    ind = {9: 0, 10: 1, 11: 2, 12: 3, 13: 4, 14: 5, 15: 6,
                           0: 7, 1: 8, 2: 9, 4: 10, 5: 11, 3: 12, 6: 13,
                           7: 14, 8: 15}[tx_type]
                self._sym_at(ind, self.cdfs.inter_ext_tx, eset, sqr)
                return
            if sqr_up == 3:
                return  # intra 32x32: EXT_TX_SET_DCTONLY
            if self.fr.reduced_tx_set or sqr == 2:  # 16x16: DTT4_IDTX (5)
                eset = 2
                ind = {9: 0, 0: 1, 3: 2, 1: 3, 2: 4}[tx_type]
            else:  # 4x4/8x8: DTT4_IDTX_1DDCT (7)
                eset = 1
                ind = {9: 0, 0: 1, 10: 2, 11: 3, 3: 4, 1: 5, 2: 6}[tx_type]
            # CDF context is the intra DIRECTION: filter-intra blocks map
            # their filter mode (spec Filter_Intra_Mode_To_Intra_Dir)
            if leaf.use_filter_intra:
                from ..ops.intra import FI_MODE_TO_INTRA_DIR

                intra_dir = int(FI_MODE_TO_INTRA_DIR[leaf.filter_intra_mode])
            else:
                intra_dir = leaf.y_mode
            self._sym_at(ind, self.cdfs.intra_ext_tx, eset, sqr, intra_dir)

        return write

    def _has_chroma(self, r: int, c: int, bw4: int, bh4: int) -> bool:
        if self.seq.mono_chrome:
            return False
        ok_y = (r % 2 == 1) or (bh4 % 2 == 0) or (self.seq.subsampling_y == 0)
        ok_x = (c % 2 == 1) or (bw4 % 2 == 0) or (self.seq.subsampling_x == 0)
        return ok_y and ok_x

    def finish(self) -> bytes:
        return self.enc.done()


# native/tilewriter.c: a partition op's unused columns (O_WIDTH = 37),
# and the CDF families in the order of its F_* enum
_OP_PAD = (0,) * 32
_NATIVE_FAMS = (
    "partition", "skip", "spatial_seg", "delta_q", "kf_y_mode", "angle_delta",
    "uv_mode", "cfl_sign", "cfl_alpha", "y_mode", "intra_inter", "comp_inter",
    "comp_ref_type", "comp_ref", "comp_bwdref", "single_ref",
    "inter_compound_mode", "newmv", "zeromv", "refmv", "drl", "nmv_joints",
    "nmv_sign", "nmv_classes", "nmv_class0", "nmv_bits", "nmv_class0_fp",
    "nmv_fp", "interintra", "interintra_mode", "wedge_interintra",
    "wedge_idx", "obmc", "motion_mode", "comp_group_idx", "compound_idx",
    "compound_type", "switchable_interp", "palette_y_mode",
    "palette_uv_mode", "filter_intra", "filter_intra_mode", "tx_size",
    "txfm_partition", "inter_ext_tx", "intra_ext_tx", "txb_skip",
    "eob_extra", "dc_sign", "coeff_br", "coeff_base", "coeff_base_eob",
    "eob_flag16", "eob_flag32", "eob_flag64", "eob_flag128", "eob_flag256",
    "eob_flag512", "eob_flag1024",
)


@lru_cache(maxsize=None)
def _native_scan_tables():
    """Addresses of the scan order and nz-context offsets of each tx size
    and class (int64[19 * 3] each, index tx_size * 3 + class), for
    native/tilewriter.c; the tables live in coeff_writer's caches."""
    from .coeff_writer import _nz_offsets, _scan_i32

    kinds = ("default", "mrow", "mcol")  # 2-D, horizontal, vertical
    return (np.array([_scan_i32(t, kinds[k]).ctypes.data
                      for t in range(19) for k in range(3)], np.int64),
            np.array([_nz_offsets(t, k).ctypes.data
                      for t in range(19) for k in range(3)], np.int64))


def txfm_partition_ctx_calc(above_val: int, left_val: int, tx: int,
                            bw_px: int, bh_px: int) -> int:
    """txfm_partition_context (entropy_coding.c:4359-4380): ctx for the
    vartx split flag given the raw neighbor array values at the unit."""
    from ..codec.constants import TX_H, TX_W, TxSize, tx_size_sqr_up

    if tx == TxSize.TX_4X4:
        return 0
    txw, txh = int(TX_W[tx]), int(TX_H[tx])
    above = int(above_val < txw)
    left = int(left_val < txh)
    max_sq = {64: TxSize.TX_64X64, 32: TxSize.TX_32X32,
              16: TxSize.TX_16X16, 8: TxSize.TX_8X8}.get(
                  max(bw_px, bh_px), TxSize.TX_4X4)
    category = 0
    if max_sq >= TxSize.TX_8X8:
        category = (int(tx_size_sqr_up(tx) != max_sq and
                        max_sq > TxSize.TX_8X8)
                    + (5 - 1 - int(max_sq)) * 2)  # TX_SIZES = 5
    return category * 3 + above + left


def _gather_split_bool(cdf: np.ndarray, bsize: int, vert: bool) -> np.ndarray:
    """Binary CDF for split_or_{horz,vert} at frame edges (spec 9.3
    partition_gather_*_alike). Symbol 1 = SPLIT, symbol 0 = HORZ/VERT.

    P(split-alike) sums the probabilities of every partition type that
    divides the forced edge; 8x8 alphabets lack the extended types and
    128x128 lacks the _4 types.
    """

    def prob(sym: int) -> int:
        if sym >= len(cdf):
            return 0
        lo = int(cdf[sym - 1]) if sym > 0 else 0
        return int(cdf[sym]) - lo

    if vert:
        gather = [Partition.VERT, Partition.SPLIT, Partition.HORZ_A,
                  Partition.VERT_A, Partition.VERT_B]
        if bsize != 15:  # BLOCK_128X128
            gather.append(Partition.VERT_4)
    else:
        gather = [Partition.HORZ, Partition.SPLIT, Partition.HORZ_A,
                  Partition.HORZ_B, Partition.VERT_A]
        if bsize != 15:
            gather.append(Partition.HORZ_4)
    s = sum(prob(g) for g in gather)
    return np.array([32768 - s, 32768], dtype=np.uint16)


def _neg_interleave(x: int, ref: int, max_n: int) -> int:
    """Encode-side recentering for the spatially-predicted segment id
    (inverse of the spec's neg_deinterleave, 5.11.15)."""
    diff = x - ref
    if ref == 0:
        return x
    if ref >= max_n - 1:
        return -x + max_n - 1
    if 2 * ref < max_n:
        if abs(diff) <= ref:
            return (diff << 1) - 1 if diff > 0 else (-diff) << 1
        return x
    else:
        if abs(diff) < (max_n - ref):
            return (diff << 1) - 1 if diff > 0 else (-diff) << 1
        return (max_n - x) - 1
