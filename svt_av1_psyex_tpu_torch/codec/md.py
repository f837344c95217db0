"""Mode decision: recursive partition RDO with exact-distortion,
estimated-rate costs.

Counterpart: the reference's MD stages (product_coding_loop.c
md_encode_block / depth partitioning) collapsed to: candidate pruning by
prediction SSE (its md_stage_0), full transform RD on survivors, and a
NONE-vs-SPLIT recursive partition search with state save/restore.

Rates come from frame-initial CDF snapshots (the reference's
md_rate_estimation snapshot approach); distortion is exact recon SSE.
All neighbor/context state is MD-local; the bitstream pass replays the
chosen tree with its own clean state.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.coeff_writer import CoeffWriter
from ..bitstream.tables import FrameCdfs, scan_table, trim
from ..bitstream.tile_writer import LeafBlock, PartitionNode, _gather_split_bool
from ..ops import intra as intra_ops
from ..ops.quant import build_plane_quant, quantize_b
from ..ops.txfm import forward_txfm2d, inverse_txfm2d
from .constants import (
    mode_has_newmv,
    BLOCK_H,
    BLOCK_W,
    INTRA_MODE_CONTEXT,
    MAX_TX_SIZE_RECT,
    TX_H,
    TX_W,
    IntraMode,
    Partition,
    TxType,
    block_size_of,
    partition_ctx_lookup,
    subsize,
)
from .rd import CostTables, cdf_costs, rdcost

from .constants import InterMode as _IM
_GLOBAL_MODES = (int(_IM.GLOBALMV), int(_IM.GLOBAL_GLOBALMV))


class RateCounter:
    """Duck-typed TileWriter for rate estimation: same _sym_at/enc/cdfs
    interface, accumulates cost instead of coding. CDFs are static."""

    class _Enc:
        def __init__(self, outer):
            self.outer = outer

        def encode_literal(self, v, n):
            self.outer.bits += n << 9

    def __init__(self, cdfs: FrameCdfs):
        self.cdfs = cdfs
        self.adapt = False
        self.bits = 0
        self.enc = RateCounter._Enc(self)
        self._cost_cache: dict = {}
        self._family_cache: dict = {}

    def family_costs(self, values) -> np.ndarray:
        """Whole-family symbol cost table (vectorized cdf_costs over the
        last axis); rows indexed only up to their true alphabet."""
        key = id(values)
        t = self._family_cache.get(key)
        if t is None:
            v = np.asarray(values, np.int64)
            prev = np.concatenate(
                [np.zeros(v.shape[:-1] + (1,), np.int64), v[..., :-1]], axis=-1)
            p = np.maximum(v - prev, 1) / 32768.0
            t = np.round(-np.log2(p) * 512).astype(np.int64)
            self._family_cache[key] = t
        return t

    def _sym_at(self, symbol: int, cdf_pair, *idx) -> None:
        values = cdf_pair[0]
        key = (id(values), idx)
        costs = self._cost_cache.get(key)
        if costs is None:
            row = values[idx] if idx else values
            costs = cdf_costs(row)
            self._cost_cache[key] = costs
        self.bits += int(costs[symbol])


class ModeDecision:
    MODES_FULL = [IntraMode.DC, IntraMode.V, IntraMode.H, IntraMode.SMOOTH,
                  IntraMode.SMOOTH_V, IntraMode.SMOOTH_H, IntraMode.PAETH,
                  IntraMode.D45, IntraMode.D135, IntraMode.D113,
                  IntraMode.D157, IntraMode.D203, IntraMode.D67]

    def __init__(self, seq, fr, pctx: list, mi_rows: int, mi_cols: int,
                 rdmult: int, min_bsize: int, n_full_rd: int = 2,
                 angle_deltas: bool = False, ref_planes: list | None = None,
                 try_rect: bool = False, try_ext: bool = False,
                 cdfs: FrameCdfs | None = None,
                 me_field=None, psy_factor: float = 0.0,
                 filter_intra: bool = False, cfl: bool = False,
                 tile_x_off: int = 0, noise_norm: int = 0,
                 max_32_tx: bool = False, try_4way: bool = False,
                 rdoq=None, spy_rd: int = 0, temporal_layer: int = 0,
                 complex_hvs: int = 0, hbd_mds: int = 0):
        # layer-modulated psy-rd strength (0 = off); adds the SA8D energy
        # delta to every txb's distortion (full_loop.c:2285-2536 hook)
        self.psy_factor = psy_factor
        # recursive filter-intra candidates (seq gate must be on)
        self.filter_intra = filter_intra
        # tile-local MD: luma-px offset of this tile's column 0 in the
        # frame; reference-plane reads (MC crosses tiles) use absolute x
        self.tile_x_off = tile_x_off
        # PSYEX noise normalization strength (full_loop.c:1467)
        self.noise_norm = noise_norm
        # RDOQ trellis (codec/rdoq.py RdoqFrame or None)
        self.rdoq = rdoq
        # PSYEX spy-rd: mode-class distortion biases for candidate
        # ranking (pic_operators.c:241 facade); 0 off, 1 full, 2 partial
        self.spy_rd = int(spy_rd)
        self.complex_hvs = int(complex_hvs)
        self.hbd_mds = int(hbd_mds)
        self.temporal_layer = int(temporal_layer)
        # switchable interp filter search: on when the frame header
        # signals SWITCHABLE (encoder preset gate sets fr.interp_filter)
        self.interp_search = getattr(fr, "interp_filter", 0) == 4
        self._ifs_cost_cache: dict = {}
        # 4-way ext partitions: keyframe-exact but inter still desyncs
        # (round-3 item); AB shapes are governed by try_ext alone
        self.try_4way = try_4way
        # --max-32-tx-size: forbid 64-class transforms (intra tx depth
        # forced to split; needs TX_MODE_SELECT)
        self.max_32_tx = max_32_tx
        self.angle_deltas = angle_deltas
        self.try_rect = try_rect
        self.try_ext = try_ext  # AB + 4-way partitions
        # inter: padded reference planes (LAST) + MVP mi-state
        self.ref_planes = ref_planes
        # device full-pel motion field (device.me.FrameMotionField);
        # None falls back to the host raster search
        self.me_field = me_field
        from .mvp import MiState

        self.mi_state = MiState(mi_rows, mi_cols) \
            if (not fr.frame_is_intra
                or getattr(fr, "allow_intrabc", False)) else None
        self.seq = seq
        self.fr = fr
        self.pctx = pctx
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.rdmult = rdmult
        self.min_bsize = min_bsize  # smallest square bsize searched
        self.n_full_rd = n_full_rd
        self.bd = seq.bit_depth

        self.cur_qindex = fr.base_q_idx  # per-SB qindex (variance boost)
        # static snapshot of the frame-start CDFs (forwarded or default)
        # for rate estimation
        self.cdfs = cdfs if cdfs is not None else FrameCdfs(fr.base_q_idx)
        self.rc = RateCounter(self.cdfs)
        self.cw = CoeffWriter(self.rc, mi_rows, mi_cols,
                              seq.subsampling_x, seq.subsampling_y)
        # MD-local neighbor state
        self.y_modes = np.zeros((mi_rows, mi_cols), np.int8)
        self.skips = np.zeros((mi_rows, mi_cols), np.int8)
        self.above_part = np.zeros(mi_cols, np.uint8)
        self.left_part = np.zeros(mi_rows, np.uint8)
        # TX_MODE_SELECT state: tx-depth search + neighbor ctx arrays
        # mirroring the TileWriter's txi_*/txp_* (see tile_writer.py)
        self.tx_select = bool(getattr(fr, "tx_mode_select", False))
        self.txi_above = np.full(mi_cols, 255, np.uint8)
        self.txi_left = np.full(mi_rows, 255, np.uint8)
        self.txp_above = np.full(mi_cols, 255, np.uint8)
        self.txp_left = np.full(mi_rows, 255, np.uint8)
        # per-ctx partition cost tables
        pvals = self.cdfs.partition[0]
        self._part_costs = [cdf_costs(pvals[i]) for i in range(pvals.shape[0])]
        kvals = self.cdfs.kf_y_mode[0]
        self._kf_costs = [[cdf_costs(kvals[a, l]) for l in range(5)] for a in range(5)]
        svals = self.cdfs.skip[0]
        self._skip_costs = [cdf_costs(svals[i]) for i in range(3)]
        avals = self.cdfs.angle_delta[0]
        self._angle_costs = [cdf_costs(avals[i]) for i in range(avals.shape[0])]
        if filter_intra:
            fvals = self.cdfs.filter_intra[0]
            self._fi_flag_costs = [cdf_costs(fvals[b])
                                   for b in range(fvals.shape[0])]
            self._fi_mode_costs = cdf_costs(self.cdfs.filter_intra_mode[0])
        # chroma-from-luma candidates (uv_mode CFL + alpha search)
        self.cfl = cfl and not seq.mono_chrome
        if self.cfl:
            uvv = self.cdfs.uv_mode[0]
            self._uv_costs_cfl = [cdf_costs(uvv[1][m]) for m in range(13)]
            self._cfl_sign_costs = cdf_costs(self.cdfs.cfl_sign[0])
            self._cfl_alpha_costs = [cdf_costs(self.cdfs.cfl_alpha[0][i])
                                     for i in range(6)]
        if not fr.frame_is_intra:
            yv = self.cdfs.y_mode[0]
            self._ify_costs = [cdf_costs(yv[i]) for i in range(4)]
            iiv = self.cdfs.intra_inter[0]
            self._ii_costs = [cdf_costs(iiv[i]) for i in range(4)]
            self._newmv_costs = [cdf_costs(self.cdfs.newmv[0][i]) for i in range(6)]
            self._zeromv_costs = [cdf_costs(self.cdfs.zeromv[0][i]) for i in range(2)]
            self._refmv_costs = [cdf_costs(self.cdfs.refmv[0][i]) for i in range(6)]
            self._drl_costs = [cdf_costs(self.cdfs.drl[0][i]) for i in range(3)]
            self._mv_joint_costs = cdf_costs(self.cdfs.nmv_joints[0])
            self._mv_comp_costs = []
            for ci in range(2):
                self._mv_comp_costs.append({
                    "sign": cdf_costs(self.cdfs.nmv_sign[0][ci]),
                    "classes": cdf_costs(self.cdfs.nmv_classes[0][ci]),
                    "class0": cdf_costs(self.cdfs.nmv_class0[0][ci]),
                    "class0_fp": [cdf_costs(self.cdfs.nmv_class0_fp[0][ci][d]) for d in range(2)],
                    "fp": cdf_costs(self.cdfs.nmv_fp[0][ci]),
                    "bits": [cdf_costs(self.cdfs.nmv_bits[0][ci][i]) for i in range(10)],
                })

    # ---- state save/restore --------------------------------------------------------
    def _save(self, r: int, c: int, bsize: int) -> dict:
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        r1 = min(r + bh4, self.mi_rows)
        c1 = min(c + bw4, self.mi_cols)
        st = {
            "y_modes": self.y_modes[r:r1, c:c1].copy(),
            "skips": self.skips[r:r1, c:c1].copy(),
            "apart": self.above_part[c:c1].copy(),
            "lpart": self.left_part[r:r1].copy(),
            "coeff_a": [a[...].copy() for a in self.cw.above],
            "coeff_l": [a[...].copy() for a in self.cw.left],
            "txi_a": self.txi_above[c:c1].copy(),
            "txi_l": self.txi_left[r:r1].copy(),
            "txp_a": self.txp_above[c:c1].copy(),
            "txp_l": self.txp_left[r:r1].copy(),
            "recon": [],
        }
        for p, pc in enumerate(self.pctx):
            ssx = pc.ss_x
            ssy = pc.ss_y
            x0, y0 = (c * 4) >> ssx, (r * 4) >> ssy
            x1 = min(((c + bw4) * 4) >> ssx, pc.recon.shape[1])
            y1 = min(((r + bh4) * 4) >> ssy, pc.recon.shape[0])
            st["recon"].append(pc.recon[y0:y1, x0:x1].copy())
        if self.mi_state is not None:
            st["mi"] = self.mi_state.save(r, c, bsize)
        st["rc"] = (r, c, bsize)
        return st

    def _restore(self, st: dict) -> None:
        r, c, bsize = st["rc"]
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        r1 = min(r + bh4, self.mi_rows)
        c1 = min(c + bw4, self.mi_cols)
        self.y_modes[r:r1, c:c1] = st["y_modes"]
        self.skips[r:r1, c:c1] = st["skips"]
        self.above_part[c:c1] = st["apart"]
        self.left_part[r:r1] = st["lpart"]
        for p in range(3):
            self.cw.above[p][...] = st["coeff_a"][p]
            self.cw.left[p][...] = st["coeff_l"][p]
        self.txi_above[c:c1] = st["txi_a"]
        self.txi_left[r:r1] = st["txi_l"]
        self.txp_above[c:c1] = st["txp_a"]
        self.txp_left[r:r1] = st["txp_l"]
        for p, pc in enumerate(self.pctx):
            blk = st["recon"][p]
            ssx, ssy = pc.ss_x, pc.ss_y
            x0, y0 = (c * 4) >> ssx, (r * 4) >> ssy
            pc.recon[y0 : y0 + blk.shape[0], x0 : x0 + blk.shape[1]] = blk
        if self.mi_state is not None:
            self.mi_state.restore(r, c, bsize, st["mi"])

    # ---- partition search -------------------------------------------------------------
    def pick_partition(self, r: int, c: int, bsize: int) -> tuple[int, PartitionNode]:
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        has_rows = (r + bh4 // 2) < self.mi_rows
        has_cols = (c + bw4 // 2) < self.mi_cols
        inside = (r + bh4 <= self.mi_rows) and (c + bw4 <= self.mi_cols)
        can_split = bsize > self.min_bsize

        part_rates = self._partition_rates(r, c, bsize, bw4, has_rows, has_cols)

        # 4:4:4: 64-px blocks would need 64-class chroma transforms, which
        # the spec clamps to tiled 32x32 units; until chroma tx tiling
        # lands, split 64-blocks so every chroma tx fits one unit
        no_leaf = (len(self.pctx) > 1 and self.pctx[1].ss_x == 0
                   and bsize >= 12)  # B64X64+
        best = None
        if inside and not no_leaf:
            st = self._save(r, c, bsize)
            j_none, leaf = self._encode_block_rd(r, c, bsize)
            j_none += (part_rates.get(Partition.NONE, 0) * self.rdmult) >> 9
            best = (j_none, PartitionNode(Partition.NONE, leaf=leaf),
                    self._save(r, c, bsize))
            self._restore(st)

        # HORZ / VERT (rectangular) — blocks >= 16x16; at the bottom/right
        # edge these code only the inside child (legal partition choice)
        if bsize >= 6 and self.try_rect and not no_leaf:  # B16X16
            h4, w4 = bh4 // 2, bw4 // 2
            if c + bw4 <= self.mi_cols and r + h4 <= self.mi_rows:
                best = self._try_rect(Partition.HORZ, r, c, bsize, part_rates,
                                      ((r, c), (r + h4, c)), best)
            if r + bh4 <= self.mi_rows and c + w4 <= self.mi_cols:
                best = self._try_rect(Partition.VERT, r, c, bsize, part_rates,
                                      ((r, c), (r, c + w4)), best)
        # extended partitions (AB + 4-way, spec decode_partition) at the
        # slowest presets; square bsize >= 16x16, fully inside only
        if self.try_ext and bsize >= 6 and inside and not no_leaf:
            h4, w4 = bh4 // 2, bw4 // 2
            sq = subsize(Partition.SPLIT, bsize)
            rh = subsize(Partition.HORZ, bsize)
            rv = subsize(Partition.VERT, bsize)
            best = self._try_multi(Partition.HORZ_A, r, c, bsize, part_rates,
                                   [(r, c, sq), (r, c + w4, sq),
                                    (r + h4, c, rh)], best)
            best = self._try_multi(Partition.HORZ_B, r, c, bsize, part_rates,
                                   [(r, c, rh), (r + h4, c, sq),
                                    (r + h4, c + w4, sq)], best)
            best = self._try_multi(Partition.VERT_A, r, c, bsize, part_rates,
                                   [(r, c, sq), (r + h4, c, sq),
                                    (r, c + w4, rv)], best)
            best = self._try_multi(Partition.VERT_B, r, c, bsize, part_rates,
                                   [(r, c, rv), (r, c + w4, sq),
                                    (r + h4, c + w4, sq)], best)
            # 4-way children of 16x16 are 4px on one axis; with chroma
            # subsampling on that axis they'd need the spec's sub-8x8
            # chroma-pair coding (not implemented yet) — gate to formats
            # where every chroma tx stays >= 4px.
            # (4-way inter desync resolved late round 2: SIZE_GROUP ext
            # tail + MVP has_top_right; try_4way is preset-gated.)
            mono = self.seq.mono_chrome
            s4h = subsize(Partition.HORZ_4, bsize)
            if (self.try_4way and s4h >= 0 and bh4 >= 4
                    and (bh4 > 4 or mono or self.seq.subsampling_y == 0)):
                q4 = bh4 // 4
                best = self._try_multi(
                    Partition.HORZ_4, r, c, bsize, part_rates,
                    [(r + i * q4, c, s4h) for i in range(4)], best)
            s4v = subsize(Partition.VERT_4, bsize)
            if (self.try_4way and s4v >= 0 and bw4 >= 4
                    and (bw4 > 4 or mono or self.seq.subsampling_x == 0)):
                q4 = bw4 // 4
                best = self._try_multi(
                    Partition.VERT_4, r, c, bsize, part_rates,
                    [(r, c + i * q4, s4v) for i in range(4)], best)

        if (not inside) or can_split:
            st = self._save(r, c, bsize)
            sub = subsize(Partition.SPLIT, bsize)
            half = bw4 // 2
            j_split = (part_rates.get(Partition.SPLIT, 0) * self.rdmult) >> 9
            children = []
            for rr, cc in ((r, c), (r, c + half), (r + half, c), (r + half, c + half)):
                if rr >= self.mi_rows or cc >= self.mi_cols:
                    children.append(PartitionNode(Partition.NONE, leaf=LeafBlock(sub)))
                    continue
                j, node = self.pick_partition(rr, cc, sub)
                j_split += j
                children.append(node)
            if best is None or j_split < best[0]:
                best = (j_split, PartitionNode(Partition.SPLIT, children=children),
                        self._save(r, c, bsize))
            self._restore(st)

        assert best is not None, "no legal partition (block outside?)"
        # leave the chosen alternative's state applied
        jbest, node, state = best
        self._restore(state)
        return jbest, node

    def _try_rect(self, part, r, c, bsize, part_rates, coords, best):
        if part not in part_rates:
            return best
        sub = subsize(part, bsize)
        sw4 = int(BLOCK_W[sub]) >> 2
        sh4 = int(BLOCK_H[sub]) >> 2
        for rr, cc in coords:
            # a child starting in-frame must fit entirely inside the
            # aligned grid (overhanging-edge rect evaluation unsupported)
            if (rr < self.mi_rows and cc < self.mi_cols
                    and (rr + sh4 > self.mi_rows or cc + sw4 > self.mi_cols)):
                return best
        st = self._save(r, c, bsize)
        j = (part_rates[part] * self.rdmult) >> 9
        children = []
        for rr, cc in coords:
            if rr >= self.mi_rows or cc >= self.mi_cols:
                children.append(PartitionNode(Partition.NONE, leaf=LeafBlock(sub)))
                continue
            jj, leaf = self._encode_block_rd(rr, cc, sub)
            j += jj
            children.append(PartitionNode(Partition.NONE, leaf=leaf))
        if best is None or j < best[0]:
            best = (j, PartitionNode(part, children=children),
                    self._save(r, c, bsize))
        self._restore(st)
        return best

    def _try_multi(self, part, r, c, bsize, part_rates, blocks, best):
        """RD one extended partition: blocks = [(rr, cc, sub_bsize)]
        children in coding order (spec decode_partition AB/4-way
        layouts)."""
        if part not in part_rates:
            return best
        for rr, cc, sb in blocks:
            sw4 = int(BLOCK_W[sb]) >> 2
            sh4 = int(BLOCK_H[sb]) >> 2
            if rr + sh4 > self.mi_rows or cc + sw4 > self.mi_cols:
                return best  # ext partitions only fully inside
        st = self._save(r, c, bsize)
        j = (part_rates[part] * self.rdmult) >> 9
        children = []
        self.cur_partition = part  # children derive availability from it
        try:
            for rr, cc, sb in blocks:
                jj, leaf = self._encode_block_rd(rr, cc, sb)
                j += jj
                children.append(PartitionNode(Partition.NONE, leaf=leaf))
        finally:
            self.cur_partition = Partition.NONE
        if best is None or j < best[0]:
            best = (j, PartitionNode(part, children=children),
                    self._save(r, c, bsize))
        self._restore(st)
        return best

    def _partition_rates(self, r, c, bsize, bw4, has_rows, has_cols) -> dict:
        if bw4 <= 1:
            return {}
        avail_u = r > 0
        avail_l = c > 0
        bsl_ctx = bw4.bit_length() - 2
        above_bit = (int(self.above_part[c]) >> bsl_ctx) & 1 if avail_u else 0
        left_bit = (int(self.left_part[r]) >> bsl_ctx) & 1 if avail_l else 0
        ctx = (left_bit * 2 + above_bit) + bsl_ctx * 4
        if has_rows and has_cols:
            costs = self._part_costs[ctx]
            out = {Partition.NONE: int(costs[0]), Partition.HORZ: int(costs[1]),
                   Partition.VERT: int(costs[2]), Partition.SPLIT: int(costs[3])}
            if len(costs) >= 10:  # EXT_PARTITION_TYPES alphabet (>= 16x16)
                for pp in (Partition.HORZ_A, Partition.HORZ_B,
                           Partition.VERT_A, Partition.VERT_B,
                           Partition.HORZ_4, Partition.VERT_4):
                    out[pp] = int(costs[int(pp)])
            return out
        if not has_rows and not has_cols:
            return {Partition.SPLIT: 0}
        pvals = self.cdfs.partition[0]
        cdf = trim(pvals[ctx])
        bcdf = _gather_split_bool(cdf, bsize, vert=not has_rows)
        bc = cdf_costs(bcdf)
        if not has_rows:  # bottom edge: HORZ(bit 0) or SPLIT(bit 1)
            return {Partition.SPLIT: int(bc[1]), Partition.HORZ: int(bc[0])}
        return {Partition.SPLIT: int(bc[1]), Partition.VERT: int(bc[0])}

    # ---- block RD ------------------------------------------------------------------------
    def _encode_block_rd(self, r: int, c: int, bsize: int) -> tuple[int, LeafBlock]:
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        x, y = c * 4, r * 4
        pc = self.pctx[0]
        tx_size = int(MAX_TX_SIZE_RECT[bsize])
        tx_w, tx_h = int(TX_W[tx_size]), int(TX_H[tx_size])
        have_above = r > 0
        have_left = c > 0
        is_inter_frame = not self.fr.frame_is_intra

        # stage 0: prediction-domain metric over all intra candidates.
        # --complex-hvs 1 ranks by SA8D (the reference's mds0_level=1
        # full HVS cost, enc_mode_config.c:8517) instead of SSE
        dr_avail_y = self._dr_avail(r, c, bsize, tx_size, 0)
        use_hvs = getattr(self, "complex_hvs", 0) and tx_w >= 8 and tx_h >= 8
        cands = []
        for mode in self.MODES_FULL:
            pred = self._predict(pc, x, y, tx_w, tx_h, have_above, have_left,
                                 mode, 0, dr_avail_y)
            src = pc.src[y : y + tx_h, x : x + tx_w]
            resid = (src - pred).astype(np.int64)
            if use_hvs:
                from ..ops.psy_dist import sa8d_8x8

                t = (resid.reshape(tx_h // 8, 8, tx_w // 8, 8)
                     .transpose(0, 2, 1, 3).reshape(-1, 8, 8))
                sse = int(sa8d_8x8(t).sum())
            else:
                sse = int((resid ** 2).sum())
            cands.append((sse, mode, pred))
        cands.sort(key=lambda t: t[0])
        survivors = cands[: self.n_full_rd]

        # mode-rate contexts
        above_skip = int(self.skips[r - 1, c]) if have_above else 0
        left_skip = int(self.skips[r, c - 1]) if have_left else 0
        skip_costs = self._skip_costs[above_skip + left_skip]
        if is_inter_frame:
            ii_ctx = self._intra_inter_ctx(r, c, have_above, have_left)
            from .constants import SIZE_GROUP

            intra_mode_costs = self._ify_costs[int(SIZE_GROUP[bsize])].copy()
            intra_base = int(self._ii_costs[ii_ctx][0])
            inter_base = int(self._ii_costs[ii_ctx][1])
        else:
            above_mode = int(self.y_modes[r - 1, c]) if have_above else IntraMode.DC
            left_mode = int(self.y_modes[r, c - 1]) if have_left else IntraMode.DC
            intra_mode_costs = self._kf_costs[int(INTRA_MODE_CONTEXT[above_mode])][
                int(INTRA_MODE_CONTEXT[left_mode])]
            intra_base = 0

        has_chroma = self._has_chroma(r, c, bw4, bh4)
        fi_ok = (self.filter_intra
                 and max(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) <= 32)

        # --max-32-tx-size: 64-class max-rect transforms are skipped by
        # starting at tx depth 1 (requires TX_MODE_SELECT)
        d0 = 1 if (self.max_32_tx and self.tx_select
                   and max(tx_w, tx_h) == 64) else 0
        best = None
        for _, mode, pred in survivors:
            j, leaf, artifacts = self._try_mode(mode, 0, pred, r, c, bsize, x, y,
                                                tx_size, intra_mode_costs, intra_base,
                                                skip_costs, has_chroma,
                                                fi_eligible=fi_ok, tx_depth=d0)
            if best is None or j < best[0]:
                best = (j, leaf, artifacts)
        # angle-delta refinement on the winning directional mode
        if self.angle_deltas and best[1].y_mode in intra_ops.MODE_TO_ANGLE:
            mode = IntraMode(best[1].y_mode)
            for delta in (-3, -2, -1, 1, 2, 3):
                pred = self._predict(pc, x, y, tx_w, tx_h, have_above, have_left,
                                     mode, delta, dr_avail_y)
                j, leaf, artifacts = self._try_mode(mode, delta, pred, r, c, bsize,
                                                    x, y, tx_size, intra_mode_costs,
                                                    intra_base, skip_costs, has_chroma,
                                                    fi_eligible=fi_ok, tx_depth=d0)
                if j < best[0]:
                    best = (j, leaf, artifacts)
        # recursive filter-intra candidates (5 modes on a DC base;
        # intra_prediction.c filter-intra search at md_filter_intra_level)
        if fi_ok:
            for fim in range(intra_ops.FILTER_INTRA_MODES):
                pred = self._predict(pc, x, y, tx_w, tx_h, have_above,
                                     have_left, IntraMode.DC, fi_mode=fim)
                j, leaf, artifacts = self._try_mode(
                    IntraMode.DC, 0, pred, r, c, bsize, x, y, tx_size,
                    intra_mode_costs, intra_base, skip_costs, has_chroma,
                    fi_eligible=True, fi_mode=fim, tx_depth=d0)
                if j < best[0]:
                    best = (j, leaf, artifacts)

        # palette candidate (screen-content frames, 8x8..64x64 DC blocks;
        # av1_rd_pick_palette_intra_sby, palette.c:561): the palette
        # reconstruction is the prediction, residual coded normally
        if (self.fr.allow_screen_content_tools and bsize >= 3 and d0 == 0
                and int(BLOCK_W[bsize]) <= 64 and int(BLOCK_H[bsize]) <= 64):
            from ..ops.palette import palette_search

            bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
            pal = palette_search(pc.src[y : y + bh_px, x : x + bw_px],
                                 self.bd)
            if pal is not None:
                colors, cmap = pal
                pp = np.asarray(colors, np.int32)[cmap]
                j, leaf, artifacts = self._try_mode(
                    IntraMode.DC, 0, pp, r, c, bsize, x, y, tx_size,
                    intra_mode_costs, intra_base, skip_costs, has_chroma,
                    fi_eligible=False, tx_depth=0, palette=(colors, cmap))
                if j < best[0]:
                    best = (j, leaf, artifacts)

        # intra block copy candidate (SC intra frames): a handful of DV
        # candidates (DV prediction, neighbor DVs, one-SB fallbacks)
        # against the causal pre-filter recon (mode_decision.c:3390
        # intrabc candidate generation, simplified search)
        if getattr(self.fr, "allow_intrabc", False) and d0 == 0:
            got = self._try_intrabc(r, c, bsize, x, y, tx_size,
                                    skip_costs, has_chroma)
            if got is not None and got[0] < best[0]:
                best = got

        # tx depth 1 on the winning intra mode (TX_MODE_SELECT); pruned
        # when the whole-block tx already coded (near-)nothing — splitting
        # only pays when there is real residual structure to localize
        # (the reference's tx-depth early-exit, tx_search in
        # product_coding_loop.c)
        if (self.tx_select and bsize > 0 and not best[1].is_inter
                and not best[1].skip and d0 == 0
                and best[1].coeffs is not None
                and best[1].coeffs[0]["eob"] >= 4):
            mode = IntraMode(best[1].y_mode)
            delta = best[1].angle_delta_y
            j, leaf, artifacts = self._try_mode(
                mode, delta, None, r, c, bsize, x, y, tx_size,
                intra_mode_costs, intra_base, skip_costs, has_chroma,
                tx_depth=1, fi_eligible=fi_ok,
                fi_mode=(best[1].filter_intra_mode
                         if best[1].use_filter_intra else None))
            if j < best[0]:
                best = (j, leaf, artifacts)

        if is_inter_frame:
            for j, leaf, artifacts in self._inter_candidates(
                    r, c, bsize, x, y, tx_size, inter_base, skip_costs, has_chroma):
                if j < best[0]:
                    best = (j, leaf, artifacts)

        j, leaf, artifacts = best
        self._commit_block(leaf, artifacts, r, c, bsize, x, y, has_chroma)
        return j, leaf

    def _intra_inter_ctx(self, r, c, have_above, have_left) -> int:
        a_inter = int(self.mi_state.ref_frame[r - 1, c] >= 0) if have_above else -1
        l_inter = int(self.mi_state.ref_frame[r, c - 1] >= 0) if have_left else -1
        if have_above and have_left:
            if a_inter == 0 and l_inter == 0:
                return 3
            return int(a_inter == 0) + int(l_inter == 0)
        if have_above or have_left:
            return 2 * int((a_inter if have_above else l_inter) == 0)
        return 0

    # ---- inter search ----------------------------------------------------------------------
    def _mv_cost(self, diff: tuple[int, int]) -> int:
        dr, dc = diff
        joint = (0 if dc == 0 else 1) if dr == 0 else (2 if dc == 0 else 3)
        cost = int(self._mv_joint_costs[joint])
        for ci, d in ((0, dr), (1, dc)):
            if d == 0:
                continue
            t = self._mv_comp_costs[ci]
            mag = abs(d)
            z = mag - 1
            cost += int(t["sign"][1 if d < 0 else 0])
            if z < 16:
                mv_class, offset = 0, z
            else:
                mv_class = min(10, (z >> 3).bit_length() - 1)
                offset = z - (2 << (mv_class + 2))
            cost += int(t["classes"][mv_class])
            di = offset >> 3
            fr_bits = (offset >> 1) & 3
            if mv_class == 0:
                cost += int(t["class0"][di]) + int(t["class0_fp"][di][fr_bits])
            else:
                for i in range(mv_class):
                    cost += int(t["bits"][i][(di >> i) & 1])
                cost += int(t["fp"][fr_bits])
        return cost

    def _motion_search(self, x: int, y: int, w: int, h: int,
                       start_mv: tuple[int, int],
                       ref_id: int = 1) -> tuple[int, int]:
        """Full-pel stage (device motion field when available, host
        raster fallback), then quarter-pel refinement; returns an MV in
        1/8-pel units with even components."""
        from ..ops.mc import _patch, mc_block

        src = self.pctx[0].src[y : y + h, x : x + w].astype(np.int32)
        ref = self.ref_planes[ref_id][0]
        ax = x + self.tile_x_off  # ref reads are frame-absolute
        # full-pel center from the predictor
        cy = int(np.clip(round(start_mv[0] / 8), -48, 48))
        cx = int(np.clip(round(start_mv[1] / 8), -48, 48))

        def sad_at(fy, fx):
            cand = _patch(ref, ax + fx, y + fy, w, h)
            return int(np.abs(src - cand).sum())

        def raster(cy0, cx0, rng, step):
            best = None
            for dy in range(-rng, rng + 1, step):
                strip = _patch(ref, ax + cx0 - rng, y + cy0 + dy, w + 2 * rng, h)
                for dx in range(-rng, rng + 1, step):
                    cand = strip[:, dx + rng : dx + rng + w]
                    sad = int(np.abs(src - cand).sum())
                    if best is None or sad < best[0]:
                        best = (sad, cy0 + dy, cx0 + dx)
            return best

        dev_mv = None
        if self.me_field is not None:
            dev_mv = self.me_field.lookup(ref_id, x, y, w, h)
        if dev_mv is not None:
            # device full-pel winner vs the MVP-predicted position, then
            # a tight +-1 full-pel polish around the better one
            dy, dx = dev_mv[0] // 8, dev_mv[1] // 8
            best = (sad_at(dy, dx), dy, dx)
            if (cy, cx) != (dy, dx):
                s = sad_at(cy, cx)
                if s < best[0]:
                    best = (s, cy, cx)
            best = raster(best[1], best[2], 1, 1)
        else:
            # coarse wide sweep (distant refs need reach), then fine raster
            _, gy, gx = raster(cy, cx, 24, 4)
            best = raster(gy, gx, 4, 1)
            # also keep the predictor-centered fine result (cheap insurance)
            if abs(gy - cy) > 4 or abs(gx - cx) > 4:
                b2 = raster(cy, cx, 4, 1)
                if b2[0] < best[0]:
                    best = b2
        _, fy, fx = best
        return self._subpel_refine(x, y, w, h, (fy * 8, fx * 8), ref_id)

    def _subpel_refine(self, x: int, y: int, w: int, h: int, mv,
                       ref_id: int = 1) -> tuple[int, int]:
        """Quarter-pel refinement (two rounds of +-1 quarter step) around
        a 1/8-pel MV; keeps components even."""
        from ..ops.mc import mc_block

        src = self.pctx[0].src[y : y + h, x : x + w].astype(np.int32)
        ref = self.ref_planes[ref_id][0]
        ax = x + self.tile_x_off
        best_sse = None
        best_mv = tuple(mv)
        for _ in range(2):
            improved = False
            for dmv in ((0, 0), (-2, 0), (2, 0), (0, -2), (0, 2)):
                cand_mv = (best_mv[0] + dmv[0], best_mv[1] + dmv[1])
                pred = mc_block(ref, ax, y, w, h, cand_mv[0], cand_mv[1], 0, 0,
                                bit_depth=self.bd)
                sse = int(((src - pred).astype(np.int64) ** 2).sum())
                if best_sse is None or sse < best_sse:
                    best_sse = sse
                    new_mv = cand_mv
                    improved = dmv != (0, 0)
            if not improved:
                break
            best_mv = new_mv
        return best_mv

    def _inter_candidates(self, r, c, bsize, x, y, tx_size, inter_base,
                          skip_costs, has_chroma):
        from .constants import InterMode
        from .mvp import find_mv_stack

        tx_w, tx_h = int(TX_W[tx_size]), int(TX_H[tx_size])
        out = []
        comp_allowed = (self.fr.reference_select
                        and int(BLOCK_W[bsize]) >= 8 and int(BLOCK_H[bsize]) >= 8)
        single_extra = 0
        if comp_allowed:
            cm_ctx = self._comp_mode_ctx_md(r, c)
            cm_costs = cdf_costs(self.cdfs.comp_inter[0][cm_ctx])
            single_extra = int(cm_costs[0])
        self._newmv_by_ref = {}
        for ref_id in self.ref_planes:
            out.extend(self._inter_candidates_ref(
                r, c, bsize, x, y, tx_size, inter_base + single_extra,
                skip_costs, has_chroma, ref_id, tx_w, tx_h))
        if comp_allowed:
            bias = self.mi_state.sign_bias
            fwds = [n for n in self.ref_planes if not bias[n]]
            bwds = [n for n in self.ref_planes if bias[n]]
            if fwds and bwds:
                out.extend(self._inter_candidates_comp(
                    r, c, bsize, x, y, tx_size,
                    inter_base + int(cm_costs[1]), skip_costs, has_chroma,
                    (fwds[0], bwds[-1]), tx_w, tx_h))
        return out

    def _gm_entry(self, ref_id: int):
        """(gm_type, mat) for a named ref, or None (identity)."""
        gm = getattr(self.fr, "gm", None)
        if not gm or not (1 <= ref_id <= 7):
            return None
        return gm[ref_id - 1]

    def _gm_mv(self, ref_id: int, r: int, c: int, bsize: int):
        """This block's GLOBALMV (spec 7.10.2.10), 1/8 pel."""
        ent = self._gm_entry(ref_id)
        if ent is None:
            return (0, 0)
        from ..ops.warp import project_mv

        return project_mv(ent[1], ent[0], r, c, int(BLOCK_W[bsize]),
                          int(BLOCK_H[bsize]), False, False)

    def _motion_mode_kind_md(self, r, c, bsize, ref_id):
        """Mirror of TileWriter.motion_mode_kind minus the per-mode
        GLOBAL check (applied per candidate): "none"/"obmc"/"full"
        plus the warp-sample set for reuse."""
        from .warp_samples import count_overlappable, find_warp_samples

        fr = self.fr
        if not getattr(fr, "is_motion_mode_switchable", False):
            return "none", None
        if min(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) < 8:
            return "none", None
        if count_overlappable(self.mi_state, r, c, bsize) == 0:
            return "none", None
        pts, ptsr = find_warp_samples(self.mi_state, r, c, bsize, ref_id)
        if len(pts) == 0 or not getattr(fr, "allow_warped_motion", False):
            return "obmc", None
        return "full", (pts, ptsr)

    def _mm_cost(self, kind: str, mm: int, bsize: int) -> int:
        if kind == "none":
            return 0
        if kind == "obmc":
            return int(cdf_costs(self.cdfs.obmc[0][bsize])[1 if mm == 1 else 0])
        return int(cdf_costs(self.cdfs.motion_mode[0][bsize])[mm])

    def _comp_mode_ctx_md(self, r, c):
        """reference_mode context from the MD-local mi state."""
        mi = self.mi_state

        def is_bwd(rr, cc):
            return int(mi.ref_frame[rr, cc]) >= 5

        def is_cmp(rr, cc):
            return int(mi.ref_frame1[rr, cc]) >= 1

        au, al = r > 0, c > 0
        if au and al:
            a, l = (r - 1, c), (r, c - 1)
            if not is_cmp(*a) and not is_cmp(*l):
                return int(is_bwd(*a) ^ is_bwd(*l))
            if not is_cmp(*a):
                return 2 + int(is_bwd(*a) or mi.ref_frame[a] < 0)
            if not is_cmp(*l):
                return 2 + int(is_bwd(*l) or mi.ref_frame[l] < 0)
            return 4
        if au or al:
            e = (r - 1, c) if au else (r, c - 1)
            if not is_cmp(*e):
                return int(is_bwd(*e))
            return 3
        return 1

    def _inter_candidates_comp(self, r, c, bsize, x, y, tx_size, base,
                               skip_costs, has_chroma, rf, tx_w, tx_h):
        from .constants import COMPOUND_MODE_CTX_MAP, InterMode
        from .mvp import find_mv_stack

        gmv0 = self._gm_mv(rf[0], r, c, bsize)
        gmv1 = self._gm_mv(rf[1], r, c, bsize)
        ge0 = self._gm_entry(rf[0])
        stack = find_mv_stack(self.mi_state, r, c, bsize, rf,
                              gm_mv=(gmv0, gmv1),
                              gm_warp=ge0 is not None and ge0[0] >= 2)
        mode_ctx = stack.mode_context
        comp_ctx = COMPOUND_MODE_CTX_MAP[((mode_ctx >> 4) & 15) >> 1][
            min(mode_ctx & 7, 4)]
        mode_costs = cdf_costs(self.cdfs.inter_compound_mode[0][comp_ctx])
        ref_rate = self._comp_ref_rate(r, c, rf)

        def drl_rate(has_new, drl_index):
            rate = 0
            if has_new:
                for idx in range(2):
                    if stack.count > idx + 1:
                        rate += int(self._drl_costs[stack.drl_ctx(idx)][
                            1 if drl_index != idx else 0])
                        if drl_index == idx:
                            break
            return rate

        cands = [
            (InterMode.NEAREST_NEARESTMV, stack.mvs[0], stack.comp_mvs[0], 0, 0),
        ]
        # compound global: skipped when the decoder would WARP either ref
        # (>= 8x8 block, GmType > TRANSLATION) — compound warp prediction
        # is not implemented yet, so the encoder never emits it
        ge1 = self._gm_entry(rf[1])
        warp_engages = (min(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) >= 8
                        and ((ge0 is not None and ge0[0] >= 2)
                             or (ge1 is not None and ge1[0] >= 2)))
        if not warp_engages:
            cands.append((InterMode.GLOBAL_GLOBALMV, gmv0, gmv1, 0, 0))
        if stack.count >= 2:
            cands.append((InterMode.NEAR_NEARMV, stack.mvs[1],
                          stack.comp_mvs[1], 0, 0))
        mv0 = self._newmv_by_ref.get(rf[0])
        mv1 = self._newmv_by_ref.get(rf[1])
        if mv0 is not None and mv1 is not None:
            mvr = (int(self._mv_cost((mv0[0] - stack.mvs[0][0],
                                      mv0[1] - stack.mvs[0][1])))
                   + int(self._mv_cost((mv1[0] - stack.comp_mvs[0][0],
                                        mv1[1] - stack.comp_mvs[0][1])))
                   + drl_rate(True, 0))
            cands.append((InterMode.NEW_NEWMV, mv0, mv1, 0, mvr))

        out = []
        for mode, m0, m1, drl_index, extra in cands:
            mode_rate = int(mode_costs[int(mode) - int(InterMode.NEAREST_NEARESTMV)]) + extra
            j, leaf, arts = self._try_inter(
                mode, m0, drl_index, base + ref_rate + mode_rate,
                r, c, bsize, x, y, tx_size, skip_costs, has_chroma,
                rf[0], ref_id1=rf[1], mv1=m1)
            out.append((j, leaf, arts))
        return out

    def _comp_ref_rate(self, r, c, rf) -> int:
        """Rate of comp_ref_type(BIDIR) + comp_ref/comp_bwdref trees."""
        counts = np.zeros(8, np.int32)
        for rr, cc, av in ((r - 1, c, r > 0), (r, c - 1, c > 0)):
            if av and self.mi_state.ref_frame[rr, cc] >= 1:
                counts[int(self.mi_state.ref_frame[rr, cc])] += 1
                r1 = int(self.mi_state.ref_frame1[rr, cc])
                if r1 >= 1:
                    counts[r1] += 1

        def cmp_ctx(a, b):
            return 1 if a == b else (0 if a < b else 2)

        fwd, bwd = rf
        # comp_ref_type ~ 1 bit estimate (ctx varies; BIDIR symbol)
        rate = 512
        bit = 1 if fwd in (3, 4) else 0
        rate += int(cdf_costs(self.cdfs.comp_ref[0][
            cmp_ctx(int(counts[1] + counts[2]), int(counts[3] + counts[4]))][0])[bit])
        if not bit:
            rate += int(cdf_costs(self.cdfs.comp_ref[0][
                cmp_ctx(int(counts[1]), int(counts[2]))][1])[1 if fwd == 2 else 0])
        else:
            rate += int(cdf_costs(self.cdfs.comp_ref[0][
                cmp_ctx(int(counts[3]), int(counts[4]))][2])[1 if fwd == 4 else 0])
        bit_b = 1 if bwd == 7 else 0
        rate += int(cdf_costs(self.cdfs.comp_bwdref[0][
            cmp_ctx(int(counts[5] + counts[6]), int(counts[7]))][0])[bit_b])
        if not bit_b:
            rate += int(cdf_costs(self.cdfs.comp_bwdref[0][
                cmp_ctx(int(counts[5]), int(counts[6]))][1])[1 if bwd == 6 else 0])
        return rate

    def _inter_candidates_ref(self, r, c, bsize, x, y, tx_size, inter_base,
                              skip_costs, has_chroma, ref_id, tx_w, tx_h):
        from .constants import InterMode
        from .mvp import find_mv_stack

        gmv = self._gm_mv(ref_id, r, c, bsize)
        ge = self._gm_entry(ref_id)
        stack = find_mv_stack(self.mi_state, r, c, bsize, ref_id,
                              gm_mv=(gmv, (0, 0)),
                              gm_warp=ge is not None and ge[0] >= 2)
        mode_ctx = stack.mode_context
        newmv_c = self._newmv_costs[mode_ctx & 7]
        zeromv_c = self._zeromv_costs[(mode_ctx >> 3) & 1]
        refmv_c = self._refmv_costs[(mode_ctx >> 4) & 15]
        ref_rate = self._single_ref_rate(r, c, bsize, ref_id)

        def drl_rate(mode, drl_index):
            rate = 0
            if mode == InterMode.NEWMV:
                for idx in range(2):
                    if stack.count > idx + 1:
                        rate += int(self._drl_costs[stack.drl_ctx(idx)][
                            1 if drl_index != idx else 0])
                        if drl_index == idx:
                            break
            elif mode == InterMode.NEARMV:
                for idx in range(1, 3):
                    if stack.count > idx + 1:
                        rate += int(self._drl_costs[stack.drl_ctx(idx)][
                            1 if drl_index != (idx - 1) else 0])
                        if drl_index == idx - 1:
                            break
            return rate

        cands = []
        # NEARESTMV / NEARMV / GLOBALMV
        cands.append((InterMode.NEARESTMV, stack.mvs[0], 0,
                      int(newmv_c[1]) + int(zeromv_c[1]) + int(refmv_c[0])))
        if stack.count >= 2:
            cands.append((InterMode.NEARMV, stack.mvs[1], 0,
                          int(newmv_c[1]) + int(zeromv_c[1]) + int(refmv_c[1])
                          + drl_rate(InterMode.NEARMV, 0)))
        cands.append((InterMode.GLOBALMV, gmv, 0,
                      int(newmv_c[1]) + int(zeromv_c[0])))
        # NEWMV via motion search (predictor = DRL 0)
        mv = self._motion_search(x, y, tx_w, tx_h, stack.mvs[0], ref_id)
        self._newmv_by_ref[ref_id] = mv
        nm_rate = (int(newmv_c[0]) + drl_rate(InterMode.NEWMV, 0)
                   + self._mv_cost((mv[0] - stack.mvs[0][0], mv[1] - stack.mvs[0][1])))
        cands.append((InterMode.NEWMV, mv, 0, nm_rate))

        kind, samples = self._motion_mode_kind_md(r, c, bsize, ref_id)
        out = []
        seen = set()
        for mode, mv, drl_index, mode_rate in cands:
            key = (mode != InterMode.NEWMV, mv)
            if mode != InterMode.NEWMV and key in seen:
                continue
            # per-candidate motion-mode symbol: GLOBALMV with a warp-class
            # gm reads none (SIMPLE inferred); everything else pays it
            cand_kind = kind
            if (mode == InterMode.GLOBALMV and ge is not None
                    and ge[0] >= 2):
                cand_kind = "none"
            mode_rate = mode_rate + self._mm_cost(cand_kind, 0, bsize)
            seen.add(key)
            j, leaf, arts = self._try_inter(mode, mv, drl_index,
                                            inter_base + ref_rate + mode_rate,
                                            r, c, bsize, x, y, tx_size,
                                            skip_costs, has_chroma, ref_id)
            out.append((j, leaf, arts))
            if cand_kind == "full":
                # WARPED_CAUSAL variant: params re-derived by the decoder
                # from (samples, mv) — spec 7.11.3.8
                from ..ops.warp import find_projection, select_samples

                bw, bh = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
                pts, ptsr = samples
                if len(pts) > 1:
                    pts, ptsr = select_samples(mv, pts, ptsr, bw, bh)
                wp = find_projection(pts, ptsr, bw, bh, mv, r, c)
                if wp is not None:
                    mr = (mode_rate - self._mm_cost(cand_kind, 0, bsize)
                          + self._mm_cost(cand_kind, 2, bsize))
                    j2, leaf2, arts2 = self._try_inter(
                        mode, mv, drl_index, inter_base + ref_rate + mr,
                        r, c, bsize, x, y, tx_size, skip_costs, has_chroma,
                        ref_id, lwarp=wp)
                    out.append((j2, leaf2, arts2))
            if cand_kind in ("obmc", "full") and mode == InterMode.NEWMV:
                # OBMC_CAUSAL variant on the NEWMV candidate (the
                # reference's obmc injection gates to top candidates too)
                mr = (mode_rate - self._mm_cost(cand_kind, 0, bsize)
                      + self._mm_cost(cand_kind, 1, bsize))
                j3, leaf3, arts3 = self._try_inter(
                    mode, mv, drl_index, inter_base + ref_rate + mr,
                    r, c, bsize, x, y, tx_size, skip_costs, has_chroma,
                    ref_id, obmc=True)
                out.append((j3, leaf3, arts3))
        return out

    def _single_ref_rate(self, r, c, bsize, ref: int = 1) -> int:
        """Rate of coding single ref_frame = `ref` (write_ref_frames tree)."""
        counts = np.zeros(8, np.int32)
        for rr, cc, av in ((r - 1, c, r > 0), (r, c - 1, c > 0)):
            if av and self.mi_state.ref_frame[rr, cc] >= 0:
                counts[int(self.mi_state.ref_frame[rr, cc])] += 1
        fwd = int(counts[1:5].sum())
        bwd = int(counts[5:8].sum())

        def cmp_ctx(a, b):
            return 1 if a == b else (0 if a < b else 2)

        srv = self.cdfs.single_ref[0]

        def bit_rate(sym, ctx, p):
            return int(cdf_costs(srv[ctx][p])[sym])

        bit0 = 1 if ref >= 5 else 0
        rate = bit_rate(bit0, cmp_ctx(fwd, bwd), 0)
        if bit0:
            bit1 = 1 if ref == 7 else 0
            rate += bit_rate(bit1, cmp_ctx(int(counts[5] + counts[6]),
                                           int(counts[7])), 1)
            if not bit1:
                rate += bit_rate(1 if ref == 6 else 0,
                                 cmp_ctx(int(counts[5]), int(counts[6])), 5)
        else:
            bit2 = 1 if ref in (3, 4) else 0
            rate += bit_rate(bit2, cmp_ctx(int(counts[1] + counts[2]),
                                           int(counts[3] + counts[4])), 2)
            if not bit2:
                rate += bit_rate(1 if ref != 1 else 0,
                                 cmp_ctx(int(counts[1]), int(counts[2])), 3)
            else:
                rate += bit_rate(1 if ref != 3 else 0,
                                 cmp_ctx(int(counts[3]), int(counts[4])), 4)
        return rate

    def _try_inter(self, mode, mv, drl_index, mode_rate, r, c, bsize, x, y,
                   tx_size, skip_costs, has_chroma, ref_id: int = 1,
                   ref_id1: int = -1, mv1=None, lwarp=None,
                   obmc: bool = False):
        """lwarp: (mat6, shear4) for a WARPED_CAUSAL variant — the
        prediction runs through the warp filter and the interp-filter
        symbol is not coded (spec 5.11.27 / 7.11.3.1). obmc: blend the
        prediction with causal neighbor predictions (OBMC_CAUSAL)."""
        from ..ops.mc import mc_block, mc_block_compound
        from .constants import InterMode

        rate = mode_rate
        tx_w, tx_h = int(TX_W[tx_size]), int(TX_H[tx_size])
        ref_pl = self.ref_planes[ref_id]
        is_comp = ref_id1 >= 1
        ax = x + self.tile_x_off
        # global warp (spec 7.11.3.1 useWarp): GLOBALMV with a
        # non-translation model and both dims >= 8 predicts through the
        # warp filter instead of translational MC
        warp_ent = None
        if (mode == InterMode.GLOBALMV and not is_comp
                and min(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) >= 8):
            _e = self._gm_entry(ref_id)
            if _e is not None and _e[0] >= 2:
                warp_ent = _e
        if is_comp:
            ref_pl1 = self.ref_planes[ref_id1]

            def mk_pred(f):
                return mc_block_compound(ref_pl[0], ref_pl1[0], ax, y, tx_w,
                                         tx_h, mv, mv1, 0, 0,
                                         bit_depth=self.bd, interp=f)
        else:
            def mk_pred(f):
                return mc_block(ref_pl[0], ax, y, tx_w, tx_h, mv[0], mv[1],
                                0, 0, f, f, bit_depth=self.bd)

        # switchable interpolation filter search (SWITCHABLE frames):
        # prediction-domain SSE + symbol rate over REG/SMOOTH/SHARP, the
        # reference's interpolation_filter_search restricted to dual-off
        # (enc_inter_prediction.c:2276-2352; spy-rd filter biases :2551)
        flt = 0
        subpel = ((mv[0] | mv[1]) & 7) or (is_comp and (mv1[0] | mv1[1]) & 7)
        import os as _os

        _force = _os.environ.get("SVT_TPU_FORCE_INTERP")
        if lwarp is not None:
            from ..ops.warp import warp_plane

            warp_ent = (3, lwarp[0])  # local warp: AFFINE model
            pred = warp_plane(ref_pl[0], lwarp[0], lwarp[1], ax, y,
                              tx_w, tx_h, 0, 0, bd=self.bd).astype(np.int32)
        elif warp_ent is not None:
            from ..ops.warp import get_shear_params, warp_plane

            _shear = get_shear_params(warp_ent[1])[1:]
            pred = warp_plane(ref_pl[0], warp_ent[1], _shear, ax, y,
                              tx_w, tx_h, 0, 0, bd=self.bd).astype(np.int32)
        elif self.interp_search and _force is not None:
            flt = int(_force)
            pred = mk_pred(flt)
        elif self.interp_search and subpel:
            fcosts = self._interp_fcosts(is_comp)
            src = self.pctx[0].src[y : y + tx_h, x : x + tx_w]
            best = None
            for f in (0, 1, 2):
                p_f = mk_pred(f)
                sse = int(((src - p_f).astype(np.int64) ** 2).sum())
                j = rdcost(self.rdmult, int(fcosts[f]), sse)
                if self.spy_rd:
                    if f == 2:
                        j = j * 75 // 100
                    elif f == 0:
                        j = j * 80 // 100
                if best is None or j < best[0]:
                    best = (j, f, p_f)
            flt = best[1]
            pred = best[2]
        else:
            pred = mk_pred(flt)
        # needs_interp_filter (spec 5.11.26): large GLOBALMV blocks code
        # the symbol only when a used ref's GmType is TRANSLATION
        large = min(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) >= 8
        codes_filter = lwarp is None
        if lwarp is not None:
            pass
        elif large and mode == InterMode.GLOBALMV:
            e = self._gm_entry(ref_id)
            codes_filter = e is not None and e[0] == 1
        elif large and mode == InterMode.GLOBAL_GLOBALMV:
            e0, e1 = self._gm_entry(ref_id), self._gm_entry(ref_id1)
            codes_filter = ((e0 is not None and e0[0] == 1)
                            or (e1 is not None and e1[0] == 1))
        if self.fr.interp_filter == 4 and codes_filter:
            rate += int(self._interp_fcosts(is_comp)[flt])
        elif not codes_filter:
            flt = 0
        # compound-type trial (read_compound_type tools): pred-domain SSE
        # + syntax rate picks among average / dist-wtd / diff-wtd /
        # wedge, mirroring the reference's MD_COMP_* stages
        # (set_inter_comp_controls; preset gate = the seq flags, enabled
        # at enc_mode <= 2 like get_inter_compound_level)
        comp_idx = 1
        comp_group = 0
        dw_weights = None
        masked_pick = None  # (comp_type, wedge_idx, wedge_sign, mask_type, mask)
        jnt_on = getattr(self.seq, "enable_jnt_comp", False)
        masked_on = (getattr(self.seq, "enable_masked_compound", False)
                     and min(int(BLOCK_W[bsize]), int(BLOCK_H[bsize])) >= 8)
        if is_comp and (jnt_on or masked_on):
            from ..ops.mc import (
                compound_dist_wtd,
                dist_wtd_weights,
                mc_block_convbuf,
                rel_dist,
            )
            from ..ops.wedge import blend_a64_d16, diffwtd_mask_d16, wedge_mask
            from .constants import (
                COMPOUND_DIFFWTD,
                COMPOUND_WEDGE,
                WEDGE_BITS,
            )

            b0 = mc_block_convbuf(ref_pl[0], ax, y, tx_w, tx_h, mv[0], mv[1],
                                  0, 0, flt, flt, bit_depth=self.bd)
            b1 = mc_block_convbuf(ref_pl1[0], ax, y, tx_w, tx_h, mv1[0],
                                  mv1[1], 0, 0, flt, flt, bit_depth=self.bd)
            src = self.pctx[0].src[y : y + tx_h, x : x + tx_w]

            def sse_of(p):
                return int(((src - p).astype(np.int64) ** 2).sum())

            cg = self._comp_group_costs() if masked_on else (0, 0)
            # group 0: average (what `pred` already holds) vs dist-wtd
            if jnt_on:
                ohb = self.seq.order_hint_bits
                cur_h = self.fr.order_hint
                bck_h = self.fr.ref_order_hints[ref_id - 1]
                fwd_h = self.fr.ref_order_hints[ref_id1 - 1]
                wts = dist_wtd_weights(ohb, cur_h, bck_h, fwd_h)
                offset = int(abs(rel_dist(ohb, fwd_h, cur_h))
                             == abs(rel_dist(ohb, cur_h, bck_h)))
                ccosts = self._comp_idx_costs(3 * offset)
                cost_avg = int(ccosts[1]) + int(cg[0])
                cost_dw = int(ccosts[0]) + int(cg[0])
            else:
                wts = None
                cost_avg = int(cg[0])
                cost_dw = None
            best = (rdcost(self.rdmult, cost_avg, sse_of(pred)),
                    cost_avg, pred, 1, None, None)
            if cost_dw is not None:
                p_dw = compound_dist_wtd(b0, b1, wts[0], wts[1], self.bd)
                j_dw = rdcost(self.rdmult, cost_dw, sse_of(p_dw))
                if j_dw < best[0]:
                    best = (j_dw, cost_dw, p_dw, 0, wts, None)
            if masked_on:
                wb = int(WEDGE_BITS[bsize])
                ct_costs = self._comp_type_costs(bsize) if wb else None
                # diff-wtd: both mask polarities
                for mt in (0, 1):
                    msk = diffwtd_mask_d16(b0, b1, mt, self.bd)
                    p_m = blend_a64_d16(b0, b1, msk, 0, 0, self.bd)
                    cost = (int(cg[1]) + 512
                            + (int(ct_costs[1]) if wb else 0))
                    j_m = rdcost(self.rdmult, cost, sse_of(p_m))
                    if j_m < best[0]:
                        best = (j_m, cost, p_m, 1, None,
                                (COMPOUND_DIFFWTD, 0, 0, mt, msk))
                if wb:
                    wi_costs = self._wedge_idx_costs(bsize)
                    for wi in range(16):
                        for ws in (0, 1):
                            msk = wedge_mask(bsize, wi, ws)
                            p_m = blend_a64_d16(b0, b1, msk, 0, 0, self.bd)
                            cost = (int(cg[1]) + int(ct_costs[0])
                                    + int(wi_costs[wi]) + 512)
                            j_m = rdcost(self.rdmult, cost, sse_of(p_m))
                            if j_m < best[0]:
                                best = (j_m, cost, p_m, 1, None,
                                        (COMPOUND_WEDGE, wi, ws, 0, msk))
            _, pick_cost, pred, comp_idx, dw_weights, masked_pick = best
            comp_group = 1 if masked_pick is not None else 0
            rate += pick_cost
        # inter-intra trial (single-ref 8x8..32x32, NEAREST/NEAR/NEWMV;
        # GLOBALMV skipped to stay clear of the global-warp pred path):
        # blend the inter pred with a DC/V/H/SMOOTH intra pred through
        # the smooth ii mask, then optionally a wedge mask (sign 0)
        ii_pick = None  # (ii_mode, wedge_flag, wedge_idx, mask)
        if (not is_comp and lwarp is None and not obmc
                and warp_ent is None
                and getattr(self.seq, "enable_interintra_compound", False)
                and int(mode) in (13, 14, 16)
                and 8 <= int(BLOCK_W[bsize]) <= 32
                and 8 <= int(BLOCK_H[bsize]) <= 32):
            from ..ops.wedge import (
                blend_a64_pixel,
                smooth_ii_mask,
                wedge_mask,
            )
            from .constants import SIZE_GROUP, WEDGE_BITS

            grp = int(SIZE_GROUP[bsize])
            iif = self._ii_flag_costs(grp)
            iim = self._ii_mode_costs(grp)
            src = self.pctx[0].src[y : y + tx_h, x : x + tx_w]

            def sse_of(p):
                return int(((src - p).astype(np.int64) ** 2).sum())

            _II2INTRA = (IntraMode.DC, IntraMode.V, IntraMode.H,
                         IntraMode.SMOOTH)
            dr_avail = self._dr_avail(r, c, bsize, tx_size, 0)
            best_ii = (rdcost(self.rdmult, int(iif[0]), sse_of(pred)),
                       int(iif[0]), pred, None)
            wb = int(WEDGE_BITS[bsize])
            iiw = (self._ii_wedge_costs(bsize) if wb else None)
            intra_preds = {}
            for iimode in range(4):
                ip = self._predict(self.pctx[0], x, y, tx_w, tx_h, r > 0,
                                   c > 0, _II2INTRA[iimode], 0, dr_avail)
                intra_preds[iimode] = ip
                msk = smooth_ii_mask(bsize, iimode)
                p_ii = blend_a64_pixel(ip, pred, msk, 0, 0)
                cost = int(iif[1]) + int(iim[iimode]) \
                    + (int(iiw[0]) if wb else 0)
                j_ii = rdcost(self.rdmult, cost, sse_of(p_ii))
                if j_ii < best_ii[0]:
                    best_ii = (j_ii, cost, p_ii, (iimode, 0, 0, msk))
            if wb and best_ii[3] is not None:
                iimode = best_ii[3][0]
                ip = intra_preds[iimode]
                wic = self._wedge_idx_costs(bsize)
                for wi in range(16):
                    msk = wedge_mask(bsize, wi, 0)
                    p_w = blend_a64_pixel(ip, pred, msk, 0, 0)
                    cost = (int(iif[1]) + int(iim[iimode]) + int(iiw[1])
                            + int(wic[wi]))
                    j_w = rdcost(self.rdmult, cost, sse_of(p_w))
                    if j_w < best_ii[0]:
                        best_ii = (j_w, cost, p_w, (iimode, 1, wi, msk))
            _, ii_cost, pred, ii_pick = best_ii
            rate += ii_cost
        if obmc:
            from .obmc import obmc_blend_plane

            _oss = ((self.pctx[1].ss_x, self.pctx[1].ss_y)
                    if len(self.pctx) > 1 else (1, 1))
            pred = obmc_blend_plane(pred, 0, self.mi_state, r, c, bsize,
                                    self.ref_planes, self.bd, _oss,
                                    self.tile_x_off)
        txbs = []
        dist = 0
        qc, eob, rec, d = self._txb_rd_pred(self.pctx[0], pred, x, y, tx_size,
                                            TxType.DCT_DCT, 0)
        txbs.append({"plane": 0, "plane_bsize": bsize, "tx_size": tx_size,
                     "tx_type": int(TxType.DCT_DCT), "qcoeff": qc, "eob": eob,
                     "ux": x >> 2, "uy": y >> 2, "_rec": rec})
        dist += d
        if has_chroma:
            ssx, ssy = self.pctx[1].ss_x, self.pctx[1].ss_y
            cw_px = max(int(BLOCK_W[bsize]) >> ssx, 4)
            ch_px = max(int(BLOCK_H[bsize]) >> ssy, 4)
            uv_bsize = block_size_of(cw_px, ch_px)
            uv_tx = int(MAX_TX_SIZE_RECT[uv_bsize])
            cx, cy = x >> ssx, y >> ssy
            acx = (x + self.tile_x_off) >> ssx
            for p in (1, 2):
                if (warp_ent is not None and int(TX_W[uv_tx]) >= 8
                        and int(TX_H[uv_tx]) >= 8):
                    from ..ops.warp import get_shear_params, warp_plane

                    _shear = (lwarp[1] if lwarp is not None
                              else get_shear_params(warp_ent[1])[1:])
                    predc = warp_plane(ref_pl[p], warp_ent[1], _shear,
                                       acx, cy, int(TX_W[uv_tx]),
                                       int(TX_H[uv_tx]), ssx, ssy,
                                       bd=self.bd).astype(np.int32)
                elif is_comp and masked_pick is not None:
                    from ..ops.mc import mc_block_convbuf
                    from ..ops.wedge import blend_a64_d16

                    b0c = mc_block_convbuf(ref_pl[p], acx, cy,
                                           int(TX_W[uv_tx]), int(TX_H[uv_tx]),
                                           mv[0], mv[1], ssx, ssy, flt, flt,
                                           bit_depth=self.bd)
                    b1c = mc_block_convbuf(ref_pl1[p], acx, cy,
                                           int(TX_W[uv_tx]), int(TX_H[uv_tx]),
                                           mv1[0], mv1[1], ssx, ssy, flt, flt,
                                           bit_depth=self.bd)
                    predc = blend_a64_d16(b0c, b1c, masked_pick[4], ssx, ssy,
                                          self.bd)
                elif is_comp:
                    predc = mc_block_compound(ref_pl[p], ref_pl1[p], acx, cy,
                                              int(TX_W[uv_tx]), int(TX_H[uv_tx]),
                                              mv, mv1, ssx, ssy,
                                              bit_depth=self.bd, interp=flt,
                                              weights=dw_weights)
                else:
                    predc = mc_block(ref_pl[p], acx, cy,
                                     int(TX_W[uv_tx]), int(TX_H[uv_tx]),
                                     mv[0], mv[1], ssx, ssy, flt, flt,
                                     bit_depth=self.bd)
                    if ii_pick is not None:
                        from ..ops.wedge import (
                            blend_a64_pixel,
                            smooth_ii_mask,
                            wedge_mask,
                        )

                        iimode, wflag, wi, _ = ii_pick
                        _II2I = (IntraMode.DC, IntraMode.V, IntraMode.H,
                                 IntraMode.SMOOTH)
                        ipc = self._predict(
                            self.pctx[p], cx, cy, int(TX_W[uv_tx]),
                            int(TX_H[uv_tx]), r > 0, c > 0, _II2I[iimode],
                            0, self._dr_avail(r, c, bsize, uv_tx, p))
                        if wflag:
                            predc = blend_a64_pixel(ipc, predc,
                                                    wedge_mask(bsize, wi, 0),
                                                    ssx, ssy)
                        else:
                            predc = blend_a64_pixel(
                                ipc, predc, smooth_ii_mask(uv_bsize, iimode),
                                0, 0)
                if obmc:
                    from .obmc import obmc_blend_plane

                    predc = obmc_blend_plane(predc, p, self.mi_state, r, c,
                                             bsize, self.ref_planes, self.bd,
                                             (ssx, ssy), self.tile_x_off)
                qc, eob, rec, d = self._txb_rd_pred(self.pctx[p], predc, cx, cy,
                                                    uv_tx, TxType.DCT_DCT, p)
                txbs.append({"plane": p, "plane_bsize": uv_bsize, "tx_size": uv_tx,
                             "tx_type": int(TxType.DCT_DCT), "qcoeff": qc,
                             "eob": eob, "ux": cx >> 2, "uy": cy >> 2, "_rec": rec})
                dist += d

        skip = all(t["eob"] == 0 for t in txbs)
        rate += int(skip_costs[1 if skip else 0])
        if self.tx_select and bsize > 0 and not skip:
            rate += self._txfm_flag0_cost(r, c, bsize)
        if not skip:
            ca = [a.copy() for a in self.cw.above]
            cl = [a.copy() for a in self.cw.left]
            self.rc.bits = 0
            for t in txbs:
                self.cw.write_txb(t["plane"], t["plane_bsize"], t["tx_size"],
                                  t["tx_type"], t["qcoeff"], t["eob"],
                                  t["ux"], t["uy"])
            rate += self.rc.bits
            for p in range(3):
                self.cw.above[p][...] = ca[p]
                self.cw.left[p][...] = cl[p]

        from .constants import COMPOUND_AVERAGE, COMPOUND_DISTWTD

        if masked_pick is not None:
            c_type, wedge_i, wedge_s, mask_t, _ = masked_pick
        else:
            c_type = COMPOUND_DISTWTD if comp_idx == 0 else COMPOUND_AVERAGE
            wedge_i = wedge_s = mask_t = 0
        if ii_pick is not None:
            ii_mode_v, ii_wedge_f, wedge_i, _ = ii_pick
        else:
            ii_mode_v, ii_wedge_f = -1, 0
        leaf = LeafBlock(bsize, skip=skip, is_inter=True, ref_frame=ref_id,
                         ref_frame1=ref_id1 if is_comp else -1,
                         mv1=tuple(mv1) if is_comp else (0, 0),
                         inter_mode=int(mode), mv=tuple(mv), drl_index=drl_index,
                         interp_filter=flt,
                         motion_mode=(2 if lwarp is not None
                                      else 1 if obmc else 0),
                         comp_group_idx=comp_group,
                         compound_idx=comp_idx,
                         comp_type=c_type, wedge_index=wedge_i,
                         wedge_sign=wedge_s, mask_type=mask_t,
                         interintra_mode=ii_mode_v,
                         wedge_interintra=ii_wedge_f,
                         coeffs=None if skip else
                         [{k: v for k, v in t.items() if k != "_rec"} for t in txbs])
        jdist = self._spy_dist(dist, is_intra=False, comp_avg=is_comp)
        return rdcost(self.rdmult, rate, jdist), leaf, txbs

    def _txb_rd_pred(self, pc, pred, x, y, tx_size, tx_type, plane):
        return self._txb_rd(pc, pred, x, y, tx_size, tx_type, plane,
                            is_inter=True)

    def _interp_fcosts(self, is_comp: bool) -> np.ndarray:
        """Filter symbol costs at the modal context (both neighbors
        REGULAR => ctx 0 / 4); the exact per-block context only shifts
        candidate ties, the writer codes with the true context."""
        key = bool(is_comp)
        t = self._ifs_cost_cache.get(key)
        if t is None:
            t = cdf_costs(self.cdfs.switchable_interp[0][4 if is_comp else 0])
            self._ifs_cost_cache[key] = t
        return t

    def _comp_idx_costs(self, ctx: int) -> np.ndarray:
        """compound_idx symbol costs at the distance-offset context
        (neighbor terms 0 — the writer codes the exact context)."""
        cache = getattr(self, "_cmpidx_cost_cache", None)
        if cache is None:
            cache = self._cmpidx_cost_cache = {}
        t = cache.get(ctx)
        if t is None:
            t = cdf_costs(self.cdfs.compound_idx[0][ctx])
            cache[ctx] = t
        return t

    def _comp_group_costs(self) -> np.ndarray:
        t = getattr(self, "_cmpgrp_costs", None)
        if t is None:
            t = self._cmpgrp_costs = cdf_costs(self.cdfs.comp_group_idx[0][0])
        return t

    def _comp_type_costs(self, bsize: int) -> np.ndarray:
        cache = getattr(self, "_ctype_cost_cache", None)
        if cache is None:
            cache = self._ctype_cost_cache = {}
        t = cache.get(bsize)
        if t is None:
            t = cache[bsize] = cdf_costs(self.cdfs.compound_type[0][bsize])
        return t

    def _wedge_idx_costs(self, bsize: int) -> np.ndarray:
        cache = getattr(self, "_widx_cost_cache", None)
        if cache is None:
            cache = self._widx_cost_cache = {}
        t = cache.get(bsize)
        if t is None:
            t = cache[bsize] = cdf_costs(self.cdfs.wedge_idx[0][bsize])
        return t

    def _ii_flag_costs(self, grp: int) -> np.ndarray:
        cache = getattr(self, "_iif_cost_cache", None)
        if cache is None:
            cache = self._iif_cost_cache = {}
        t = cache.get(grp)
        if t is None:
            t = cache[grp] = cdf_costs(self.cdfs.interintra[0][grp])
        return t

    def _ii_mode_costs(self, grp: int) -> np.ndarray:
        cache = getattr(self, "_iim_cost_cache", None)
        if cache is None:
            cache = self._iim_cost_cache = {}
        t = cache.get(grp)
        if t is None:
            t = cache[grp] = cdf_costs(self.cdfs.interintra_mode[0][grp])
        return t

    def _ii_wedge_costs(self, bsize: int) -> np.ndarray:
        cache = getattr(self, "_iiw_cost_cache", None)
        if cache is None:
            cache = self._iiw_cost_cache = {}
        t = cache.get(bsize)
        if t is None:
            t = cache[bsize] = cdf_costs(self.cdfs.wedge_interintra[0][bsize])
        return t

    def _spy_dist(self, dist: int, *, is_intra: bool, mode: int = -1,
                  bsize: int = -1, comp_avg: bool = False) -> int:
        """spy-rd candidate-ranking distortion bias (the reference's
        full-distortion facade, pic_operators.c:241-292): penalize
        visually blurry mode classes.  Full tweaks at spy_rd == 1 only;
        spy_rd == 2 keeps just the non-facade biases (interp filters)."""
        if self.spy_rd != 1:
            return dist
        if is_intra:
            if (mode in (IntraMode.DC, IntraMode.SMOOTH, IntraMode.SMOOTH_V,
                         IntraMode.SMOOTH_H) and self.psy_factor == 0.0):
                dist = dist * 5 // 4
            elif mode in (IntraMode.H, IntraMode.V, IntraMode.PAETH):
                dist = dist * 9 // 8
            if self.temporal_layer >= 2:
                w = (8, 8, 9, 10, 11, 12)[min(self.temporal_layer, 5)]
                dist = dist * w // 8
            bw, bh = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
            if bw == 64 and bh == 64:
                dist = dist * 3 // 2
            elif bw * bh <= 32 * 32:
                dist = dist * 17 // 16
        elif comp_avg:
            # our compound inter is COMPOUND_AVERAGE
            dist = dist * 5 // 4
        return dist

    def _tx_depth_cost(self, r: int, c: int, bsize: int, depth: int) -> int:
        """Rate of the intra tx depth symbol (write_selected_tx_size)."""
        from .constants import bsize_to_tx_size_cat

        max_tx = int(MAX_TX_SIZE_RECT[bsize])
        maxw, maxh = int(TX_W[max_tx]), int(TX_H[max_tx])
        ctx = (int(int(self.txi_above[c]) >= maxw) if r > 0 else 0) + \
            (int(int(self.txi_left[r]) >= maxh) if c > 0 else 0)
        cat = bsize_to_tx_size_cat(bsize)
        key = (cat, ctx)
        costs = self._txd_cost_cache.get(key) if hasattr(self, "_txd_cost_cache") \
            else None
        if costs is None:
            if not hasattr(self, "_txd_cost_cache"):
                self._txd_cost_cache = {}
            costs = cdf_costs(self.cdfs.tx_size[0][cat][ctx])
            self._txd_cost_cache[key] = costs
        return int(costs[depth])

    def _txfm_flag0_cost(self, r: int, c: int, bsize: int) -> int:
        """Rate of the single no-split txfm_partition flag (inter, depth 0)."""
        from ..bitstream.tile_writer import txfm_partition_ctx_calc

        max_tx = int(MAX_TX_SIZE_RECT[bsize])
        ctx = txfm_partition_ctx_calc(
            int(self.txp_above[c]), int(self.txp_left[r]), max_tx,
            int(BLOCK_W[bsize]), int(BLOCK_H[bsize]))
        if not hasattr(self, "_txp_cost_cache"):
            self._txp_cost_cache = {}
        costs = self._txp_cost_cache.get(ctx)
        if costs is None:
            costs = cdf_costs(self.cdfs.txfm_partition[0][ctx])
            self._txp_cost_cache[ctx] = costs
        return int(costs[0])

    def _try_intrabc(self, r, c, bsize, x, y, tx_size, skip_costs,
                     has_chroma):
        """Intra-BC candidate: best valid DV among the DV prediction,
        neighbor DVs and one-SB fallbacks; prediction is a copy of the
        causal recon (chroma via the BILINEAR subpel path when the
        halved DV lands on a half sample, spec 7.11.3)."""
        from ..ops.mc import mc_block
        from .mvp import dv_valid, find_dv_ref

        mi = self.mi_state
        fr = self.fr
        bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
        tx_w, tx_h = int(TX_W[tx_size]), int(TX_H[tx_size])
        ref_dv = find_dv_ref(mi, r, c, bsize, self.mi_rows, self.mi_cols)
        cands = [tuple(ref_dv)]
        if r > 0 and int(mi.ref_frame[r - 1, c]) == 0:
            cands.append((int(mi.mv_row[r - 1, c]), int(mi.mv_col[r - 1, c])))
        if c > 0 and int(mi.ref_frame[r, c - 1]) == 0:
            cands.append((int(mi.mv_row[r, c - 1]), int(mi.mv_col[r, c - 1])))
        # fixed fallbacks: 1/2 SBs up and left (the 256px intrabc delay
        # makes one-SB-up DVs invalid on narrow frames), plus the
        # find_ref_dv first-row fallback
        cands += [(0, -512), (-512, 0), (-1024, 0), (0, -1024),
                  (0, -2560), (-512, -512), (-1024, -512),
                  (-1032, 0)]  # odd-pel probe (half-pel chroma phase)
        best = None
        seen = set()
        pc = self.pctx[0]
        src = pc.src[y : y + tx_h, x : x + tx_w]
        for dv in cands:
            if dv in seen or dv == (0, 0):
                continue
            seen.add(dv)
            if not dv_valid(dv, r, c, bsize, self.mi_rows, self.mi_cols,
                            has_chroma):
                continue
            pred = mc_block(pc.recon, x, y, tx_w, tx_h, dv[0], dv[1],
                            0, 0, bit_depth=self.bd)
            sse = int(((src - pred).astype(np.int64) ** 2).sum())
            # flag + joint + component magnitudes (rate proxy, 1/512b)
            diff = (abs(dv[0] - ref_dv[0]) >> 3, abs(dv[1] - ref_dv[1]) >> 3)
            rate = 512 * (3 + (1 + diff[0]).bit_length()
                          + (1 + diff[1]).bit_length())
            j = rdcost(self.rdmult, rate, sse)
            if best is None or j < best[0]:
                best = (j, dv, pred, rate)
        if best is None:
            return None
        _, dv, pred, dv_rate = best

        txbs = []
        dist = 0
        qc, eob, rec, d = self._txb_rd(pc, pred, x, y, tx_size,
                                       TxType.DCT_DCT, 0)
        txbs.append({"plane": 0, "plane_bsize": bsize, "tx_size": tx_size,
                     "tx_type": int(TxType.DCT_DCT), "qcoeff": qc,
                     "eob": eob, "ux": x >> 2, "uy": y >> 2, "_rec": rec})
        dist += d
        rate = dv_rate
        if has_chroma:
            ssx, ssy = self.pctx[1].ss_x, self.pctx[1].ss_y
            cw_px = max(bw_px >> ssx, 4)
            ch_px = max(bh_px >> ssy, 4)
            uv_bsize = block_size_of(cw_px, ch_px)
            uv_tx = int(MAX_TX_SIZE_RECT[uv_bsize])
            cx, cy = x >> ssx, y >> ssy
            for p in (1, 2):
                pcc = self.pctx[p]
                predc = mc_block(pcc.recon, cx, cy, int(TX_W[uv_tx]),
                                 int(TX_H[uv_tx]), dv[0], dv[1], ssx, ssy,
                                 3, 3, bit_depth=self.bd)  # BILINEAR
                qcc, eobc, recc, dc = self._txb_rd(pcc, predc, cx, cy,
                                                   uv_tx, TxType.DCT_DCT, p)
                txbs.append({"plane": p, "plane_bsize": uv_bsize,
                             "tx_size": uv_tx,
                             "tx_type": int(TxType.DCT_DCT), "qcoeff": qcc,
                             "eob": eobc, "ux": cx >> 2, "uy": cy >> 2,
                             "_rec": recc})
                dist += dc
        skip = all(t["eob"] == 0 for t in txbs)
        rate += int(skip_costs[1 if skip else 0])
        if not skip:
            rate += self._txbs_rate(txbs)
        leaf = LeafBlock(bsize, y_mode=int(IntraMode.DC),
                         uv_mode=int(IntraMode.DC), skip=skip,
                         use_intrabc=True, mv=tuple(dv),
                         coeffs=None if skip else
                         [{k: v for k, v in t.items() if k != "_rec"}
                          for t in txbs])
        return rdcost(self.rdmult, rate, dist), leaf, txbs

    def _try_mode(self, mode, angle_delta, pred, r, c, bsize, x, y, tx_size,
                  mode_costs, base_rate, skip_costs, has_chroma, tx_depth=0,
                  fi_eligible=False, fi_mode=None, palette=None):
        """RD one intra luma mode (+ DC chroma); returns (J, leaf, artifacts)
        without mutating shared state beyond what _commit_block redoes.
        tx_depth > 0 splits the luma tx (TX_MODE_SELECT), predicting each
        sub-TU from the progressively reconstructed block. fi_mode selects
        a recursive filter-intra candidate (mode must be DC);
        fi_eligible adds the use_filter_intra flag rate for DC blocks."""
        from .constants import SPLIT_TX_SIZE

        fr = self.fr
        bd = self.bd
        rate = base_rate + int(mode_costs[mode])
        if mode in intra_ops.MODE_TO_ANGLE:
            rate += int(self._angle_costs[int(mode) - int(IntraMode.V)][angle_delta + 3])
        if fi_eligible and mode == IntraMode.DC:
            rate += int(self._fi_flag_costs[bsize][1 if fi_mode is not None
                                                   else 0])
            if fi_mode is not None:
                rate += int(self._fi_mode_costs[fi_mode])
        if palette is not None:
            from ..ops.palette import palette_colors_rate, palette_tokens_rate

            pal_colors, pal_map = palette
            n_pal = len(pal_colors)
            rate += (palette_colors_rate(n_pal, self.bd)
                     + palette_tokens_rate(np.asarray(pal_map), n_pal)
                     + 512 * 2)  # flag + size symbols (proxy)
        if self.tx_select and bsize > 0:
            rate += self._tx_depth_cost(r, c, bsize, tx_depth)

        txbs = []
        dist = 0
        # luma
        if tx_depth == 0:
            qc, eob, rec, d = self._txb_rd(self.pctx[0], pred, x, y, tx_size,
                                           TxType.DCT_DCT, 0)
            txbs.append({"plane": 0, "plane_bsize": bsize, "tx_size": tx_size,
                         "tx_type": int(TxType.DCT_DCT), "qcoeff": qc, "eob": eob,
                         "ux": x >> 2, "uy": y >> 2, "_rec": rec})
            dist += d
        else:
            tx = tx_size
            for _ in range(tx_depth):
                tx = int(SPLIT_TX_SIZE[tx])
            tw, th = int(TX_W[tx]), int(TX_H[tx])
            bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
            pc = self.pctx[0]
            snap = pc.recon[y : y + bh_px, x : x + bw_px].copy()
            blk_au, blk_al = r > 0, c > 0
            directional = mode in intra_ops.MODE_TO_ANGLE
            for ty in range(0, bh_px, th):
                for txx in range(0, bw_px, tw):
                    ha = blk_au or ty > 0
                    hl = blk_al or txx > 0
                    uy, ux = (y + ty) >> 2, (x + txx) >> 2
                    dr = self._dr_avail(r, c, bsize, tx, 0, row_off=ty >> 2,
                                        col_off=txx >> 2) \
                        if directional else None
                    p = self._predict(pc, x + txx, y + ty, tw, th, ha, hl,
                                      mode, angle_delta, dr, fi_mode=fi_mode)
                    qc, eob, rec, d = self._txb_rd(pc, p, x + txx, y + ty, tx,
                                                   TxType.DCT_DCT, 0)
                    pc.recon[y + ty : y + ty + th, x + txx : x + txx + tw] = rec
                    txbs.append({"plane": 0, "plane_bsize": bsize, "tx_size": tx,
                                 "tx_type": int(TxType.DCT_DCT), "qcoeff": qc,
                                 "eob": eob, "ux": ux, "uy": uy, "_rec": rec})
                    dist += d
            pc.recon[y : y + bh_px, x : x + bw_px] = snap
        uv_mode = int(IntraMode.DC)
        cfl_alphas = (0, 0)
        if has_chroma:
            ssx, ssy = self.pctx[1].ss_x, self.pctx[1].ss_y
            bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
            cw_px = max(bw_px >> ssx, 4)
            ch_px = max(bh_px >> ssy, 4)
            uv_bsize = block_size_of(cw_px, ch_px)
            uv_tx = int(MAX_TX_SIZE_RECT[uv_bsize])
            cx, cy = x >> ssx, y >> ssy
            from .encoder import chroma_tx_type

            uv_tt = chroma_tx_type(IntraMode.DC, uv_tx)
            dc_preds = {}
            dc_txbs = []
            dc_dist = 0
            for p in (1, 2):
                pcc = self.pctx[p]
                predc = self._predict(pcc, cx, cy, int(TX_W[uv_tx]), int(TX_H[uv_tx]),
                                      cy > 0, cx > 0, IntraMode.DC)
                dc_preds[p] = predc
                qc, eob, rec, d = self._txb_rd(pcc, predc, cx, cy, uv_tx, uv_tt, p)
                dc_txbs.append({"plane": p, "plane_bsize": uv_bsize, "tx_size": uv_tx,
                                "tx_type": int(uv_tt), "qcoeff": qc, "eob": eob,
                                "ux": cx >> 2, "uy": cy >> 2, "_rec": rec})
                dc_dist += d
            # chroma-from-luma candidate (spec 7.11.5; cfl search per
            # intra_prediction.c cfl_rd_pick_alpha reformulated as a
            # closed-form projection + quantized neighborhood eval)
            cfl_ok = (self.cfl and (bw_px >> ssx) >= 4 and (bh_px >> ssy) >= 4
                      and bw_px <= 32 and bh_px <= 32)
            picked_cfl = None
            if cfl_ok:
                picked_cfl = self._try_cfl(txbs, dc_preds, x, y, cx, cy,
                                           cw_px, ch_px, ssx, ssy, uv_bsize,
                                           uv_tx, uv_tt, int(mode))
            if picked_cfl is not None:
                _, cfl_txbs, cfl_dist, cfl_rate, alphas = picked_cfl
                dc_rate = int(self._uv_costs_cfl[int(mode)][IntraMode.DC]) \
                    if self.cfl else 0
                # decide on FULL chroma rate: CfL's main win is cheaper
                # coefficients, not lower distortion at fixed q
                cfl_j = rdcost(self.rdmult,
                               cfl_rate + self._txbs_rate(cfl_txbs), cfl_dist)
                dc_j = rdcost(self.rdmult,
                              dc_rate + self._txbs_rate(dc_txbs), dc_dist)
                if cfl_j < dc_j:
                    txbs.extend(cfl_txbs)
                    dist += cfl_dist
                    rate += cfl_rate
                    uv_mode = 13
                    cfl_alphas = alphas
                else:
                    txbs.extend(dc_txbs)
                    dist += dc_dist
                    rate += dc_rate
            else:
                if cfl_ok or (self.cfl and bw_px <= 32 and bh_px <= 32):
                    # cfl-allowed block: DC still pays its uv-mode rate
                    rate += int(self._uv_costs_cfl[int(mode)][IntraMode.DC])
                txbs.extend(dc_txbs)
                dist += dc_dist

        skip = all(t["eob"] == 0 for t in txbs)
        rate += int(skip_costs[1 if skip else 0])
        if not skip:
            # coefficient rate via the counting sink (uses current ctx state)
            ca = [a.copy() for a in self.cw.above]
            cl = [a.copy() for a in self.cw.left]
            self.rc.bits = 0
            for t in txbs:
                self.cw.write_txb(t["plane"], t["plane_bsize"], t["tx_size"],
                                  t["tx_type"], t["qcoeff"], t["eob"],
                                  t["ux"], t["uy"])
            rate += self.rc.bits
            for p in range(3):
                self.cw.above[p][...] = ca[p]
                self.cw.left[p][...] = cl[p]

        leaf = LeafBlock(bsize, y_mode=int(mode), uv_mode=uv_mode,
                         angle_delta_y=angle_delta, skip=skip, tx_depth=tx_depth,
                         use_filter_intra=fi_mode is not None,
                         filter_intra_mode=fi_mode if fi_mode is not None else 0,
                         cfl_alpha_u=cfl_alphas[0], cfl_alpha_v=cfl_alphas[1],
                         palette_colors=(tuple(int(v) for v in palette[0])
                                         if palette is not None else ()),
                         palette_map=(np.asarray(palette[1])
                                      if palette is not None else None),
                         coeffs=None if skip else
                         [{k: v for k, v in t.items() if k != "_rec"} for t in txbs])
        jdist = self._spy_dist(dist, is_intra=True, mode=int(mode),
                               bsize=bsize)
        return rdcost(self.rdmult, rate, jdist), leaf, txbs

    def _txbs_rate(self, txbs) -> int:
        """Coefficient rate (x512) of a txb list via the counting sink,
        with entropy contexts restored."""
        ca = [a.copy() for a in self.cw.above]
        cl = [a.copy() for a in self.cw.left]
        self.rc.bits = 0
        for t in txbs:
            self.cw.write_txb(t["plane"], t["plane_bsize"], t["tx_size"],
                              t["tx_type"], t["qcoeff"], t["eob"],
                              t["ux"], t["uy"])
        bits = self.rc.bits
        for p in range(3):
            self.cw.above[p][...] = ca[p]
            self.cw.left[p][...] = cl[p]
        return bits

    def _try_cfl(self, txbs, dc_preds, x, y, cx, cy, cw, ch, ssx, ssy,
                 uv_bsize, uv_tx, uv_tt, y_mode_idx):
        """CfL chroma candidate: closed-form alpha projection per
        component + quantized-neighborhood exact txb RD. Returns
        (J, [u txb, v txb], dist, rate, (alpha_u, alpha_v)) or None."""
        from ..ops.intra import (
            cfl_ac,
            cfl_context_u,
            cfl_context_v,
            cfl_joint_sign,
            cfl_predict,
        )

        lh, lw = ch << ssy, cw << ssx
        luma = np.full((lh, lw), -1, np.int32)
        for t in txbs:
            if t["plane"] != 0:
                continue
            rec = t["_rec"]
            py, px = t["uy"] * 4 - y, t["ux"] * 4 - x
            luma[py : py + rec.shape[0], px : px + rec.shape[1]] = rec
        if (luma < 0).any():
            return None
        ac = cfl_ac(luma, cw, ch, ssx, ssy)
        den = int((ac.astype(np.int64) ** 2).sum())
        if den == 0:
            return None
        comp = {}
        for p in (1, 2):
            pcc = self.pctx[p]
            src = pcc.src[cy : cy + ch, cx : cx + cw]
            resid = (src - dc_preds[p]).astype(np.int64)
            ideal = 64.0 * float((ac.astype(np.int64) * resid).sum()) / den
            cands = sorted({int(np.clip(np.floor(ideal), -16, 16)),
                            int(np.clip(np.ceil(ideal), -16, 16))})
            best = None
            for a in cands:
                pred = dc_preds[p] if a == 0 else \
                    cfl_predict(dc_preds[p], ac, a, self.bd)
                qc, eob, rec, d = self._txb_rd(pcc, pred, cx, cy, uv_tx,
                                               uv_tt, p)
                # 2 candidates/component: distortion-ordered pick; the
                # exact symbol rates are added jointly below
                if best is None or d < best[1]:
                    best = (a, d, {"plane": p, "plane_bsize": uv_bsize,
                                   "tx_size": uv_tx, "tx_type": int(uv_tt),
                                   "qcoeff": qc, "eob": eob, "ux": cx >> 2,
                                   "uy": cy >> 2, "_rec": rec})
            comp[p] = best
        au, av = comp[1][0], comp[2][0]
        if au == 0 and av == 0:
            return None
        js = cfl_joint_sign(au, av)
        rate = int(self._uv_costs_cfl[y_mode_idx][13]) \
            + int(self._cfl_sign_costs[js])
        if au:
            rate += int(self._cfl_alpha_costs[cfl_context_u(js)][abs(au) - 1])
        if av:
            rate += int(self._cfl_alpha_costs[cfl_context_v(js)][abs(av) - 1])
        dist = comp[1][1] + comp[2][1]
        return (rdcost(self.rdmult, rate, dist),
                [comp[1][2], comp[2][2]], dist, rate, (au, av))

    def _txb_rd(self, pc, pred, x, y, tx_size, tx_type, plane,
                is_inter: bool = False):
        from .encoder import tx_log_scale

        fr = self.fr
        bd = self.bd
        tx_w, tx_h = int(TX_W[tx_size]), int(TX_H[tx_size])
        src = pc.src[y : y + tx_h, x : x + tx_w]
        resid = (src - pred).astype(np.int32)
        coeffs = forward_txfm2d(resid[None], tx_w, tx_h, tx_type, bd)[0]
        ls = tx_log_scale(tx_size)
        dc_delta = fr.delta_q_y_dc if plane == 0 else fr.delta_q_u_dc
        ac_delta = 0 if plane == 0 else fr.delta_q_u_ac
        pq = build_plane_quant(self.cur_qindex, dc_delta, ac_delta, bd)
        from ..bitstream.coeff_writer import _scan_kind

        scan = scan_table(tx_size, _scan_kind(tx_type))
        # quantizer matrices: 2D transform types only (spec dequant gate)
        if getattr(fr, "using_qmatrix", False) and int(tx_type) <= 8:
            from ..ops.quant import qm_tables, quantize_b_qm

            level = (fr.qm_y, fr.qm_u, fr.qm_v)[plane]
            qm = qm_tables(level, plane > 0, int(tx_size))
        else:
            qm = None
        rdoq = self.rdoq
        if rdoq is not None:
            # RDOQ path: fp quantize, then the trellis prunes
            # (full_loop.c:1723 fp_q + 1764 optimize_b)
            from ..ops.quant import quantize_fp

            qcoeff, dqcoeff, eob = quantize_fp(
                coeffs.reshape(1, -1), scan, pq, ls,
                qm[0] if qm is not None else None,
                qm[1] if qm is not None else None)
            if int(eob[0]) > 0:
                from ..bitstream.coeff_writer import (TX_TYPE_CLASS,
                                                      _scan_i32)

                tx_class = int(TX_TYPE_CLASS[TxType(tx_type)])
                qc = np.ascontiguousarray(qcoeff.reshape(-1))
                dqc = np.ascontiguousarray(dqcoeff.reshape(-1))
                tco = np.ascontiguousarray(
                    coeffs.reshape(-1).astype(np.int32))
                ne = rdoq.optimize(
                    tco, qc, dqc, int(eob[0]),
                    _scan_i32(int(tx_size), _scan_kind(tx_type)),
                    int(tx_size), tx_class, min(tx_w, 32), min(tx_h, 32),
                    is_inter, plane, ls, pq.dequant[0], pq.dequant[1],
                    iqm=qm[1] if qm is not None else None,
                    qindex=self.cur_qindex)
                qcoeff = qc.reshape(1, -1)
                dqcoeff = dqc.reshape(1, -1)
                eob = np.array([ne], np.int32)
        elif qm is not None:
            qcoeff, dqcoeff, eob = quantize_b_qm(
                coeffs.reshape(1, -1), scan, pq, ls, qm[0], qm[1])
        else:
            qcoeff, dqcoeff, eob = quantize_b(coeffs.reshape(1, -1), scan,
                                              pq, ls)
        if (self.noise_norm > 0 and plane == 0 and int(tx_type) != 9
                and int(eob[0]) > 0):
            from ..ops.quant import AOM_QM_BITS, noise_normalize

            if qm is not None:
                dqv_ac = (pq.dequant[1] * qm[1]
                          + (1 << (AOM_QM_BITS - 1))) >> AOM_QM_BITS
            else:
                dqv_ac = pq.dequant[1]
            qc = qcoeff.reshape(-1)
            dqc = dqcoeff.reshape(-1)
            _, _, ne = noise_normalize(coeffs.reshape(-1), qc, dqc,
                                       int(eob[0]), scan, dqv_ac, ls,
                                       self.noise_norm,
                                       min(tx_w, 32) * min(tx_h, 32))
            eob = np.array([ne], np.int32)
        cw, ch = min(tx_w, 32), min(tx_h, 32)
        eob = int(eob[0])
        if eob:
            rr = inverse_txfm2d(dqcoeff.reshape(1, ch, cw), tx_w, tx_h, tx_type, bd)[0]
            rec = np.clip(pred + rr, 0, (1 << bd) - 1)
        else:
            rec = np.clip(pred, 0, (1 << bd) - 1)
        dist = int(((src - rec).astype(np.int64) ** 2).sum())
        if self.psy_factor > 0.0:
            from ..ops.psy_dist import psy_distortion

            dist += int(psy_distortion(src, rec, bd) * self.psy_factor)
        return qcoeff.reshape(ch, cw), eob, rec, dist

    def _commit_block(self, leaf: LeafBlock, txbs, r, c, bsize, x, y, has_chroma):
        """Apply the winning mode's recon + neighbor/context state."""
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        for t in txbs:
            pc = self.pctx[t["plane"]]
            rec = t["_rec"]
            px, py = t["ux"] * 4, t["uy"] * 4
            pc.recon[py : py + rec.shape[0], px : px + rec.shape[1]] = rec
        r1 = min(r + bh4, self.mi_rows)
        c1 = min(c + bw4, self.mi_cols)
        self.y_modes[r:r1, c:c1] = leaf.y_mode
        self.skips[r:r1, c:c1] = 1 if leaf.skip else 0
        if self.mi_state is not None:
            mi_ref = (0 if getattr(leaf, "use_intrabc", False)
                      else (leaf.ref_frame if leaf.is_inter else -1))
            self.mi_state.set_block(
                r, c, bsize, mi_ref,
                leaf.mv if (leaf.is_inter
                            or getattr(leaf, "use_intrabc", False))
                else (0, 0),
                leaf.is_inter and mode_has_newmv(leaf.inter_mode),
                leaf.ref_frame1 if leaf.is_inter else -1,
                leaf.mv1 if leaf.is_inter else (0, 0),
                is_gmv=leaf.is_inter and leaf.inter_mode in _GLOBAL_MODES,
                interp_filter=leaf.interp_filter if leaf.is_inter else 0)
        pa, pl = partition_ctx_lookup(bsize)
        self.above_part[c:c1] = pa
        self.left_part[r:r1] = pl
        if self.tx_select:
            from .constants import SPLIT_TX_SIZE

            if leaf.is_inter:
                # txi: block dims; txp: block dims too (inter tx = max-rect
                # = block dims at depth 0, and skip-inter stores block dims)
                wpx, hpx = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
                self.txi_above[c:c1] = wpx
                self.txi_left[r:r1] = hpx
                self.txp_above[c:c1] = wpx
                self.txp_left[r:r1] = hpx
            else:
                tx = int(MAX_TX_SIZE_RECT[bsize])
                for _ in range(leaf.tx_depth):
                    tx = int(SPLIT_TX_SIZE[tx])
                self.txi_above[c:c1] = int(TX_W[tx])
                self.txi_left[r:r1] = int(TX_H[tx])
                self.txp_above[c:c1] = int(TX_W[tx])
                self.txp_left[r:r1] = int(TX_H[tx])
        if leaf.skip:
            self.cw.reset_skip_ctx(r, c, bw4, bh4, has_chroma)
        else:
            for t in txbs:
                self.cw.write_txb(t["plane"], t["plane_bsize"], t["tx_size"],
                                  t["tx_type"], t["qcoeff"], t["eob"],
                                  t["ux"], t["uy"])
            self.rc.bits = 0

    def _predict(self, pc, x, y, w, h, have_above, have_left, mode,
                 angle_delta: int = 0, dr_avail=None, fi_mode=None):
        if fi_mode is not None:
            # filter intra: Paeth-style neighbor requirements (above +
            # left + top-left, with the standard fill fallbacks)
            above, left, _ = intra_ops.fill_neighbors(
                pc.recon, x, y, w, h, have_above, have_left,
                IntraMode.PAETH, self.bd)
            return intra_ops.filter_intra_predict(above, left, fi_mode,
                                                  w, h, self.bd)
        if mode in intra_ops.MODE_TO_ANGLE:
            p_angle = intra_ops.MODE_TO_ANGLE[IntraMode(mode)] \
                + angle_delta * intra_ops.ANGLE_STEP
            have_tr, have_bl = dr_avail if dr_avail else (False, False)
            above, left, tl = intra_ops.fill_neighbors_dr(
                pc.recon, x, y, w, h, have_above, have_left,
                have_tr, have_bl, p_angle, self.bd)
            if above is None:
                return np.full((h, w), tl, np.int32)
            return intra_ops.dr_predict(p_angle, above, left, tl, w, h, self.bd)
        above, left, flat = intra_ops.fill_neighbors(
            pc.recon, x, y, w, h, have_above, have_left, mode, self.bd)
        if flat is not None:
            return np.full((h, w), flat, np.int32)
        return intra_ops.predict(int(mode), above[None], left[None], w, h,
                                 have_above, have_left, self.bd)[0]

    def _dr_avail(self, r, c, bsize, tx_size, plane, row_off: int = 0,
                  col_off: int = 0) -> tuple[bool, bool]:
        """(have_top_right, have_bottom_left) for the TU at plane-4px
        offsets (row_off, col_off) within the block (0,0 = whole block);
        mirrors av1_predict_intra_block's availability derivation."""
        ss_x = self.pctx[plane].ss_x
        ss_y = self.pctx[plane].ss_y
        tw4 = int(TX_W[tx_size]) >> 2
        th4 = int(TX_H[tx_size]) >> 2
        have_top = r > 0 or row_off > 0
        have_left = c > 0 or col_off > 0
        # pixels beyond the TU's right/bottom edge exist in the mi grid
        # (libaom's xr/yr > 0 with the TU offset folded in)
        right_avail = (c + ((col_off + tw4) << ss_x)) < self.mi_cols
        bottom_avail = (r + ((row_off + th4) << ss_y)) < self.mi_rows
        # square children of VERT_A/VERT_B use the orders_vert availability
        # tables (intra_prediction.c get_has_tr_table/get_has_bl_table)
        vp = getattr(self, "cur_partition", Partition.NONE) in (
            Partition.VERT_A, Partition.VERT_B)
        tr = intra_ops.intra_has_top_right(bsize, r, c, have_top, right_avail,
                                           tx_size, ss_x, ss_y,
                                           row_off=row_off, col_off=col_off,
                                           vert_part=vp)
        bl = intra_ops.intra_has_bottom_left(bsize, r, c, bottom_avail, have_left,
                                             tx_size, ss_x, ss_y,
                                             row_off=row_off, col_off=col_off,
                                             vert_part=vp)
        return tr, bl

    def _has_chroma(self, r, c, bw4, bh4) -> bool:
        if self.seq.mono_chrome:
            return False
        ok_y = (r % 2 == 1) or (bh4 % 2 == 0) or (self.seq.subsampling_y == 0)
        ok_x = (c % 2 == 1) or (bw4 % 2 == 0) or (self.seq.subsampling_x == 0)
        return ok_y and ok_x
