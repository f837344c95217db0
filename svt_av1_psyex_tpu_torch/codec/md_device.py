"""Device-backed mode decision: host argmin + conformant commit.

The split (SURVEY §7 "Key design decision"):
  * device — `device.intra.intra_analysis_sharded` (key frames) and
    `device.inter.inter_analysis_sharded` (inter frames) evaluate every
    block of the frame at every depth in one batched torch call a shard
    of the caller's mesh (by default one shard, the whole frame, on the
    device the caller names): open-loop prediction, float32 DCTs,
    analysis quantizer, calibrated rate proxy, through the hand kernels
    or, with kernels="plain", their plain versions;
  * host — this module turns those cost lattices into a partition tree
    (quadtree argmin, `pick`) and then runs the *conformant* commit pass
    in coding order: recon-neighbor prediction, exact quantize, exact
    inverse transform, recon update (the reference's Encode Pass,
    coding_loop.c:1697, with the decision already made).

Used for intra frames at the faster presets (TX depth 0, no angle
deltas); the recursive host RDO in codec/md.py remains the slow-preset /
inter path until those tiers move to device too.
"""

from __future__ import annotations

import os

import numpy as np

from ..bitstream.tile_writer import LeafBlock, PartitionNode
from .constants import (
    BLOCK_H,
    BLOCK_W,
    MAX_TX_SIZE_RECT,
    TX_H,
    TX_W,
    BlockSize,
    IntraMode,
    Partition,
    TxType,
    block_size_of,
)
from ..device.inter import (
    CAND_COMP_NEW,
    CAND_COMP_ZERO,
    CAND_INTER0,
    inter_analysis_sharded,
    unpack_inter_analysis,
)
from ..device.intra import (
    DEVICE_MODES,
    intra_analysis_sharded,
    qp_row_for,
    unpack_rd_analysis,
)
from ..parallel.mesh import DeviceMesh
from ..runtime import check_kernels, resolve_device
from .rd import cdf_costs, compute_rdmult

_BLK_TO_BSIZE = {8: BlockSize.B8X8, 16: BlockSize.B16X16,
                 32: BlockSize.B32X32, 64: BlockSize.B64X64}


def _hbd8(dmd) -> bool:
    """--hbd-mds 3: run the analysis tier at 8 bits for 10-bit
    content (enc_mode_config.c:1817 hbd_md=0 semantics) — half the
    upload bytes and narrower device arithmetic; the conformant commit
    stays full-depth."""
    return (getattr(dmd.md, "hbd_mds", 0) == 3
            and dmd.seq.bit_depth > 8)


def _mk_commit_ctx(dmd):
    """Native C commit context when the frame's quantization is in its
    repertoire; False selects the host numpy chain (QM quantization and
    noise normalization live only in md._txb_rd)."""
    from ..native import commit as native_commit

    if (getattr(dmd.fr, "using_qmatrix", False)
            or getattr(dmd.md, "noise_norm", 0) > 0
            or not native_commit.available()):
        return False
    return native_commit.CommitCtx(dmd.seq.bit_depth)


# partition-cdf ctx row at neutral neighbors: ctx = bsl_ctx * 4
_BSL_CTX = {8: 0, 16: 1, 32: 2, 64: 3}


def txd_cost_tables(cdfs, tx_select: bool):
    """Neutral-context depth-symbol costs (bits<<9) for the commit-time
    tx-depth trial: ((22, 2) intra tx_size symbol, (22, 2) inter vartx
    flags).  Depth 1 on an inter block writes one split flag plus four
    no-split flags (write_tx_size_vartx); intra writes one depth symbol.
    Shared by the C committer job (native/frame_enc.py) and the Python
    oracle (_luma_tx_trial) so both sides J-compare identically."""
    intra = np.zeros((22, 2), np.int32)
    inter = np.zeros((22, 2), np.int32)
    if tx_select:
        from .constants import bsize_to_tx_size_cat

        tp = cdf_costs(cdfs.txfm_partition[0][0])
        for bsize in range(1, 22):
            cat = bsize_to_tx_size_cat(bsize)
            tc = cdf_costs(cdfs.tx_size[0][cat][0])
            intra[bsize, 0] = int(tc[0])
            intra[bsize, 1] = int(tc[1]) if len(tc) > 1 else 1 << 20
            inter[bsize, 0] = int(tp[0])
            inter[bsize, 1] = int(tp[1]) + 4 * int(tp[0])
    return intra, inter


def _ilog2p1_arr(v: np.ndarray) -> np.ndarray:
    """floor(log2(1 + v)) for non-negative int arrays (exact: frexp
    exponents are integer-precise below 2^53)."""
    return np.frexp((v + 1).astype(np.float64))[1].astype(np.int64) - 1


def rate_proxy(qc: np.ndarray, eob: int, tx_size: int) -> int:
    """Integer coefficient-rate proxy (bits<<9) over a committed txb —
    the device lattice's RATE_* model (device/intra.py) with exact
    integer logs; mirrors rate_proxy in native/frame_enc.c."""
    if eob == 0:
        return 0
    from ..bitstream.tables import scan_table

    scan = scan_table(tx_size, "default")
    q = np.abs(qc.ravel()[scan[:eob]].astype(np.int64))
    nz = q > 0
    nnz = int(nz.sum())
    rate = 1946 * int((1 + eob).bit_length() - 1)
    rate += 1229 * nnz + 614 * int(_ilog2p1_arr(q)[nz].sum())
    rate += 154 * (eob - nnz)
    return rate


class DeviceIntraMD:
    """Wraps a ModeDecision instance, replacing its candidate search with
    the device cost lattice; reuses its commit machinery (_predict,
    _txb_rd) for the conformant pass."""

    DEPTHS = (64, 32, 16, 8)

    @staticmethod
    def depths_for(min_bsize: int, mi_rows: int = 0, mi_cols: int = 0):
        """Depths the partition argmin can actually reach: computing
        lattice tiers below the preset min split size is pure waste (the
        jitted program shrinks with it).  Frame-boundary SBs are forced
        to split below the preset min until blocks fit inside the frame,
        so we also keep every depth down to the largest power-of-two
        that tiles both frame dimensions (e.g. 720 = 11*64+16 needs
        16-px leaves along the bottom edge)."""
        blk = int(BLOCK_W[min_bsize])
        if mi_rows and mi_cols:
            h, w = mi_rows * 4, mi_cols * 4
            align = next(d for d in (64, 32, 16, 8)
                         if h % d == 0 and w % d == 0)
            blk = min(blk, align)
        else:
            blk = 8  # dims unknown: keep everything (safe)
        return tuple(d for d in (64, 32, 16, 8) if d >= blk)

    # RD constant cache: keyframe CDFs are a pure function of base_q_idx,
    # so the derived cost tables are too (inter/forwarded CDFs must not
    # use this)
    _rd_cache: dict = {}

    def __init__(self, md, seq, fr, sb_qmap=None, *, device="cuda",
                 kernels: str = "hand", mesh=None):
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        # the analysis shards superblock rows over the mesh's sp axis
        # (None: the (1, 1) mesh, one call on self.device)
        self.mesh = mesh or DeviceMesh.single(self.device)
        self.md = md
        self.seq = seq
        self.fr = fr
        self.sb_qmap = sb_qmap
        self.mi_rows, self.mi_cols = md.mi_rows, md.mi_cols
        self.DEPTHS = self.depths_for(getattr(md, "min_bsize", 3),
                                      self.mi_rows, self.mi_cols)
        self.modes = np.array(DEVICE_MODES, np.int32)
        self.psy_fixed = int(round(getattr(md, "psy_factor", 0.0) * 256))
        cacheable = (fr.frame_is_intra
                     and getattr(fr, "primary_ref_frame", 7) == 7)
        key = (fr.base_q_idx, self.psy_fixed)
        ent = self._rd_cache.get(key) if cacheable else None
        if ent is None:
            kv = md.cdfs.kf_y_mode[0]
            mode_rate = cdf_costs(kv[0, 0])[self.modes].astype(np.int64)
            sk = cdf_costs(md.cdfs.skip[0][0])
            pvals = md.cdfs.partition[0]
            part_costs = {blk: cdf_costs(pvals[_BSL_CTX[blk] * 4])
                          for blk in (16, 32, 64)}
            ent = (mode_rate, int(sk[0]), int(sk[1]), part_costs)
            if cacheable:
                self._rd_cache[key] = ent
        self.mode_rate, self.skip0, self.skip1, self.part_costs = ent
        self.stats: dict = {}
        self._commit_ctx = None
        self.tx_select = bool(getattr(fr, "tx_mode_select", False))
        self._txd_tabs = None
        self._pending = None

    # ---- analysis --------------------------------------------------------
    @staticmethod
    def pad_src(src: np.ndarray) -> np.ndarray:
        h, w = src.shape
        hp = (h + 63) & ~63
        wp = (w + 63) & ~63
        if hp != h or wp != w:
            src = np.pad(src, ((0, hp - h), (0, wp - w)), mode="edge")
        return src

    def rd_row(self) -> np.ndarray:
        """[rdmult, skip0, skip1, mode_costs..., psy_factor<<8] for the
        on-device RD reduction (frame-level rdmult; per-SB deltaq from
        variance boost only re-weights the host partition rates)."""
        rdm = self.md.rdmult
        if _hbd8(self):
            rdm = max(1, rdm // 16)  # 8-bit-unit distortions
        return np.concatenate([
            np.array([rdm, self.skip0, self.skip1], np.int32),
            self.mode_rate.astype(np.int32),
            np.array([self.psy_fixed], np.int32)])

    def analyze_dispatch(self) -> None:
        """Queue the device analysis of this frame without waiting for it
        (CUDA runs it asynchronously); analyze() fetches the result. Each
        sp shard's rows are queued on its device."""
        src = self.pad_src(self.md.pctx[0].src)
        self._hp, self._wp = src.shape
        a_bd = 8 if _hbd8(self) else self.seq.bit_depth
        if a_bd != self.seq.bit_depth:
            src = src >> (self.seq.bit_depth - 8)
        qp = qp_row_for(self.fr.base_q_idx, self.fr.delta_q_y_dc, 0, a_bd)
        self._pending = intra_analysis_sharded(
            src[None], qp[None], self.rd_row()[None], self.mesh,
            depths=self.DEPTHS, bit_depth=a_bd, psy=self.psy_fixed > 0,
            kernels=self.kernels)

    def analyze(self, packed_row: np.ndarray | None = None) -> None:
        """Pull the device (J, mode) lattice. `packed_row` = precomputed
        row from intra_analysis_sharded (group path); None = fetch the
        dispatched call (dispatching now if needed)."""
        if packed_row is None:
            if self._pending is None:
                self.analyze_dispatch()
            packed_row = self._pending.numpy()[0]
            self._pending = None
            hp, wp = self._hp, self._wp
        else:
            hp, wp = self.pad_src(self.md.pctx[0].src).shape
            self._hp, self._wp = hp, wp  # plan_frame reads these
        self.stats = unpack_rd_analysis(packed_row, hp, wp, self.DEPTHS)

    # ---- partition argmin ------------------------------------------------
    def _leaf_j(self, blk: int, by: int, bx: int, rdmult: int):
        """Best mode + J for one block (reduced on device)."""
        s = self.stats[blk]
        return int(s["j"][by, bx]), int(self.modes[int(s["mode"][by, bx])])

    def plan_frame(self, rdmult_sb: np.ndarray) -> None:
        """Whole-frame partition argmin as a vectorized bottom-up DP over
        the depth lattices (the per-SB recursive `pick` re-done as four
        numpy passes; profiled 21.5 s of a 105 s 720p encode tail).
        rdmult_sb: (hp//64, wp//64) per-SB lambda in the lattice J domain
        (pick_rdmult semantics). Fills self._split[blk] bool grids;
        extract_plan() then walks them without recomputing any J."""
        INF = np.int64(1) << 60
        hp, wp = self._hp, self._wp
        h, w = self.mi_rows * 4, self.mi_cols * 4
        min_blk = min(self.DEPTHS)
        rdmult_sb = np.asarray(rdmult_sb, np.int64)
        best = None
        self._split = {}
        for blk in sorted(self.DEPTHS):
            nby, nbx = hp // blk, wp // blk
            j = self.stats[blk]["j"].astype(np.int64)
            y0 = np.arange(nby, dtype=np.int64)[:, None] * blk
            x0 = np.arange(nbx, dtype=np.int64)[None, :] * blk
            inside = (y0 + blk <= h) & (x0 + blk <= w)
            outside = (y0 >= h) | (x0 >= w)
            f = 64 // blk
            rdm = np.repeat(np.repeat(rdmult_sb, f, 0), f, 1)[:nby, :nbx]
            if blk > 8:
                leafj = j + ((np.int64(int(self.part_costs[blk][
                    int(Partition.NONE)])) * rdm) >> 9)
            else:
                leafj = j
            leafj = np.where(inside, leafj, INF)
            if blk == min_blk:
                best = np.where(outside, 0, leafj)
                continue
            sum4 = (best[0::2, 0::2] + best[0::2, 1::2]
                    + best[1::2, 0::2] + best[1::2, 1::2])
            splitj = sum4 + np.where(
                inside,
                (np.int64(int(self.part_costs[blk][int(Partition.SPLIT)]))
                 * rdm) >> 9, 0)
            # inside blocks split only above the PRESET's min size;
            # DEPTHS may extend below it purely for frame-edge partials
            # (depths_for), which must split until they fit
            pmin_blk = int(BLOCK_W[getattr(self.md, "min_bsize", 3)])
            use_split = ((inside & (blk > pmin_blk) & (splitj < leafj))
                         | (~inside & ~outside))
            self._split[blk] = use_split
            best = np.where(outside, 0,
                            np.where(use_split, splitj, leafj))

    def extract_plan(self, r: int, c: int, bsize: int):
        """Plan tuple for the block at (r, c) from plan_frame's split
        grids — same shape as pick()'s second return."""
        if r >= self.mi_rows or c >= self.mi_cols:
            return ("oob", bsize)
        blk = int(BLOCK_W[bsize])
        by, bx = (r * 4) // blk, (c * 4) // blk
        sp = self._split.get(blk)
        if sp is not None and sp[by, bx]:
            from .constants import subsize

            sub = subsize(Partition.SPLIT, bsize)
            half = (blk >> 2) >> 1
            children = [self.extract_plan(rr, cc, sub)
                        for rr, cc in ((r, c), (r, c + half),
                                       (r + half, c), (r + half, c + half))]
            return ("split", bsize, children)
        _, payload = self._leaf_j(blk, by, bx, 0)
        return ("leaf", bsize, payload)

    def pick(self, r: int, c: int, bsize: int, min_bsize: int,
             rdmult: int):
        """Quadtree argmin over the device lattice. Returns (J, plan);
        plan = ('leaf', bsize, mode) | ('split', bsize, children4) |
        ('oob', bsize)."""
        if r >= self.mi_rows or c >= self.mi_cols:
            return 0, ("oob", bsize)
        blk = int(BLOCK_W[bsize])
        bw4 = blk >> 2
        inside = (r + bw4 <= self.mi_rows) and (c + bw4 <= self.mi_cols)
        can_split = bsize > min_bsize
        best = None
        if inside:
            by, bx = (r * 4) // blk, (c * 4) // blk
            j, mode = self._leaf_j(blk, by, bx, rdmult)
            if blk > 8:
                j += (int(self.part_costs[blk][Partition.NONE]) * rdmult) >> 9
            best = (j, ("leaf", bsize, mode))
        if blk > 8 and (can_split or not inside):
            from .constants import subsize

            sub = subsize(Partition.SPLIT, bsize)
            half = bw4 >> 1
            j = (int(self.part_costs[blk][Partition.SPLIT]) * rdmult) >> 9 \
                if inside else 0
            children = []
            for rr, cc in ((r, c), (r, c + half), (r + half, c),
                           (r + half, c + half)):
                jj, plan = self.pick(rr, cc, sub, min_bsize, rdmult)
                j += jj
                children.append(plan)
            if best is None or j < best[0]:
                best = (j, ("split", bsize, children))
        assert best is not None
        return best

    # ---- conformant commit -----------------------------------------------
    def pick_rdmult(self) -> int:
        """Lambda in the lattice J domain (8-bit units under hbd8)."""
        return max(1, self.md.rdmult // 16) if _hbd8(self) \
            else self.md.rdmult

    def encode_sb(self, r: int, c: int, sb_bsize: int, min_bsize: int) -> PartitionNode:
        _, plan = self.pick(r, c, sb_bsize, min_bsize, self.pick_rdmult())
        return self._commit_plan(plan, r, c)

    def _commit_plan(self, plan, r: int, c: int) -> PartitionNode:
        kind, bsize = plan[0], plan[1]
        if kind == "oob":
            return PartitionNode(Partition.NONE, leaf=LeafBlock(bsize))
        if kind == "split":
            half = (int(BLOCK_W[bsize]) >> 2) >> 1
            coords = ((r, c), (r, c + half), (r + half, c),
                      (r + half, c + half))
            children = [self._commit_plan(p, rr, cc)
                        for p, (rr, cc) in zip(plan[2], coords)]
            return PartitionNode(Partition.SPLIT, children=children)
        leaf = self._commit_leaf(r, c, bsize, plan[2])
        return PartitionNode(Partition.NONE, leaf=leaf)

    def _commit_txb(self, pc, pred, x, y, tx_size, plane):
        """One conformant txb: C kernel when available (DCT_DCT), else the
        numpy chain. Updates pc.recon in place; returns (qcoeff, eob)."""
        fr = self.fr
        dc_delta = fr.delta_q_y_dc if plane == 0 else fr.delta_q_u_dc
        ac_delta = 0 if plane == 0 else fr.delta_q_u_ac
        ctx = self._commit_ctx
        if ctx is None:
            ctx = self._commit_ctx = _mk_commit_ctx(self)
        if ctx:
            from .rdoq import arm_for

            return ctx.run(pc, pred, x, y, tx_size, self.md.cur_qindex,
                           dc_delta, ac_delta, plane=plane,
                           rdoq=arm_for(self.md.rdoq))
        qc, eob, rec, _ = self.md._txb_rd(pc, pred, x, y, tx_size,
                                          TxType.DCT_DCT, plane)
        pc.recon[y : y + rec.shape[0], x : x + rec.shape[1]] = rec
        return qc, eob

    def _pred_commit(self, pc, mode: int, x: int, y: int, tx_size: int,
                     plane: int, have_above: bool, have_left: bool):
        """Fill neighbors (host, availability rules) + predict + commit
        (C when available)."""
        from ..ops import intra as intra_ops

        md = self.md
        fr = self.fr
        tx_w, tx_h = int(TX_W[tx_size]), int(TX_H[tx_size])
        ctx = self._commit_ctx
        if ctx is None:
            ctx = self._commit_ctx = _mk_commit_ctx(self)
        if ctx:
            above, left, flat = intra_ops.fill_neighbors(
                pc.recon, x, y, tx_w, tx_h, have_above, have_left, mode,
                self.seq.bit_depth)
            dc_delta = fr.delta_q_y_dc if plane == 0 else fr.delta_q_u_dc
            ac_delta = 0 if plane == 0 else fr.delta_q_u_ac
            from .rdoq import arm_for

            use_rdoq = arm_for(md.rdoq)
            if flat is None:
                return ctx.run_pred(pc, mode, above, left, have_above,
                                    have_left, x, y, tx_size,
                                    md.cur_qindex, dc_delta, ac_delta,
                                    plane=plane, rdoq=use_rdoq)
            pred = np.full((tx_h, tx_w), flat, np.int32)
            return ctx.run(pc, pred, x, y, tx_size, md.cur_qindex,
                           dc_delta, ac_delta, plane=plane,
                           rdoq=use_rdoq)
        pred = md._predict(pc, x, y, tx_w, tx_h, have_above, have_left,
                           IntraMode(mode))
        return self._commit_txb(pc, pred, x, y, tx_size, plane)

    def _txd_cost(self, bsize: int, is_inter: bool):
        if self._txd_tabs is None:
            self._txd_tabs = txd_cost_tables(self.md.cdfs, self.tx_select)
        return self._txd_tabs[1 if is_inter else 0][bsize]

    def _luma_tx_trial(self, pc, commit_fn, x: int, y: int, bsize: int,
                       is_inter: bool):
        """TX_MODE_SELECT depth trial at commit: code the winning
        candidate's luma at depth 0 (max-rect) and depth 1 (uniform 4-way
        split), J-compare with the device lattice's rate proxy + the
        neutral-ctx depth symbol cost, keep the cheaper coding.  Integer-
        exact mirror of svt_frame_commit's trial (native/frame_enc.c);
        the reference's tx-size search (product_coding_loop.c) relocated
        per SURVEY §7.  commit_fn(x, y, tx) -> (qc, eob) commits into
        pc.recon in place.  Returns (tx_depth, luma txbs)."""
        from .constants import SPLIT_TX_SIZE, TX_H, TX_W

        tx_size = int(MAX_TX_SIZE_RECT[bsize])
        bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
        base_depth = 0
        if (getattr(self.md, "max_32_tx", False) and self.tx_select
                and max(int(TX_W[tx_size]), int(TX_H[tx_size])) == 64):
            # --max-32-tx-size: forbid 64-class transforms — the base of
            # the depth trial becomes the 32-split (signaled as depth 1)
            tx_size = int(SPLIT_TX_SIZE[tx_size])
            base_depth = 1
        do_trial = self.tx_select and bsize > 0 and base_depth == 0
        snap = (pc.recon[y : y + bh_px, x : x + bw_px].copy()
                if do_trial else None)
        if base_depth:
            sw, sh = int(TX_W[tx_size]), int(TX_H[tx_size])
            subs0 = []
            for ty in range(0, bh_px, sh):
                for txx in range(0, bw_px, sw):
                    qcs, es = commit_fn(x + txx, y + ty, tx_size)
                    subs0.append({"plane": 0, "plane_bsize": bsize,
                                  "tx_size": tx_size,
                                  "tx_type": int(TxType.DCT_DCT),
                                  "qcoeff": qcs, "eob": es,
                                  "ux": (x + txx) >> 2,
                                  "uy": (y + ty) >> 2})
            return base_depth, subs0
        qc, eob = commit_fn(x, y, tx_size)
        base = [{"plane": 0, "plane_bsize": bsize, "tx_size": tx_size,
                 "tx_type": int(TxType.DCT_DCT), "qcoeff": qc, "eob": eob,
                 "ux": x >> 2, "uy": y >> 2}]
        if not do_trial or eob < 4:
            return 0, base
        src = pc.src[y : y + bh_px, x : x + bw_px].astype(np.int64)
        d0_rec = pc.recon[y : y + bh_px, x : x + bw_px].copy()
        dist0 = int(((src - d0_rec) ** 2).sum())
        rate0 = rate_proxy(qc, eob, tx_size)
        pc.recon[y : y + bh_px, x : x + bw_px] = snap
        sub_tx = int(SPLIT_TX_SIZE[tx_size])
        sw, sh = int(TX_W[sub_tx]), int(TX_H[sub_tx])
        subs = []
        rate1 = 0
        for ty in range(0, bh_px, sh):
            for txx in range(0, bw_px, sw):
                qcs, es = commit_fn(x + txx, y + ty, sub_tx)
                rate1 += rate_proxy(qcs, es, sub_tx)
                subs.append({"plane": 0, "plane_bsize": bsize,
                             "tx_size": sub_tx,
                             "tx_type": int(TxType.DCT_DCT), "qcoeff": qcs,
                             "eob": es, "ux": (x + txx) >> 2,
                             "uy": (y + ty) >> 2})
        dist1 = int(((src - pc.recon[y : y + bh_px, x : x + bw_px]) ** 2)
                    .sum())
        tc = self._txd_cost(bsize, is_inter)
        rdm = self.md.rdmult
        j0 = ((rate0 + int(tc[0])) * rdm >> 9) + (dist0 << 7)
        j1 = ((rate1 + int(tc[1])) * rdm >> 9) + (dist1 << 7)
        if j0 <= j1:
            pc.recon[y : y + bh_px, x : x + bw_px] = d0_rec
            return 0, base
        return 1, subs

    def _commit_leaf(self, r: int, c: int, bsize: int, mode: int) -> LeafBlock:
        """Conformant encode of the decided mode: recon-neighbor
        prediction + exact transform/quant chain; no rate estimation."""
        md = self.md
        x, y = c * 4, r * 4
        pc = md.pctx[0]

        def commit_y(xx, yy, tx):
            return self._pred_commit(pc, mode, xx, yy, tx, 0,
                                     yy > 0, xx > 0)

        tx_depth, txbs = self._luma_tx_trial(pc, commit_y, x, y, bsize,
                                             False)
        bw4 = int(BLOCK_W[bsize]) >> 2
        bh4 = int(BLOCK_H[bsize]) >> 2
        if md._has_chroma(r, c, bw4, bh4):
            ssx, ssy = md.pctx[1].ss_x, md.pctx[1].ss_y
            cw_px = max(int(BLOCK_W[bsize]) >> ssx, 4)
            ch_px = max(int(BLOCK_H[bsize]) >> ssy, 4)
            uv_bsize = block_size_of(cw_px, ch_px)
            uv_tx = int(MAX_TX_SIZE_RECT[uv_bsize])
            cx, cy = x >> ssx, y >> ssy
            for p in (1, 2):
                qcc, eobc = self._pred_commit(md.pctx[p], int(IntraMode.DC),
                                              cx, cy, uv_tx, p,
                                              cy > 0, cx > 0)
                txbs.append({"plane": p, "plane_bsize": uv_bsize,
                             "tx_size": uv_tx,
                             "tx_type": int(TxType.DCT_DCT), "qcoeff": qcc,
                             "eob": eobc, "ux": cx >> 2, "uy": cy >> 2})
        skip = all(t["eob"] == 0 for t in txbs)
        return LeafBlock(bsize, y_mode=mode, uv_mode=int(IntraMode.DC),
                         skip=skip, tx_depth=tx_depth,
                         coeffs=None if skip else txbs)


class DeviceInterMD(DeviceIntraMD):
    """Device MD for INTER frames: the fused ME + candidate lattice
    (device/inter.py) decides intra-vs-inter, mode/ref and the full-pel
    MV for every block; the host maps winning MVs onto the real MVP
    stack (NEAREST/NEAR/GLOBAL/NEW), runs quarter-pel refinement on the
    chosen NEWMV leaves only, and commits conformantly in coding order.

    Counterpart: product_coding_loop.c inter MD classes + the Encode
    Pass — reformulated per SURVEY §7 (device candidate costs, host
    argmin + exact syntax)."""

    def __init__(self, md, seq, fr, sb_qmap=None, ref_names=None, *,
                 device="cuda", kernels: str = "hand", mesh=None):
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        self.mesh = mesh or DeviceMesh.single(self.device)  # as above
        self.md = md
        self.seq = seq
        self.fr = fr
        self.sb_qmap = sb_qmap
        self.mi_rows, self.mi_cols = md.mi_rows, md.mi_cols
        self.DEPTHS = self.depths_for(getattr(md, "min_bsize", 3),
                                      self.mi_rows, self.mi_cols)
        # lattice ref index -> named ref (1..7). Compound convention
        # (device/inter.py): the legal (forward, backward) pair — the
        # host MD's pick, md.py _inter_candidates — rides slots 0 and 1;
        # frames without a pair keep prohibitive compound bases in rd_row.
        names = list(ref_names)
        self.comp_pair = None
        if (getattr(fr, "reference_select", False) and md.mi_state is not None
                and os.environ.get("SVT_TPU_NO_COMP") != "1"):
            bias = md.mi_state.sign_bias
            fwds = [n for n in names if not bias[n]]
            bwds = [n for n in names if bias[n]]
            if fwds and bwds:
                pair = (fwds[0], bwds[-1])
                names = [pair[0], pair[1]] + [n for n in names
                                              if n not in pair]
                self.comp_pair = pair
        self.ref_names = names
        self.modes = np.array(DEVICE_MODES, np.int32)
        self.stats = {}
        self._commit_ctx = None
        # partition costs (shared shape with the intra path)
        pvals = md.cdfs.partition[0]
        self.part_costs = {blk: cdf_costs(pvals[_BSL_CTX[blk] * 4])
                           for blk in (16, 32, 64)}
        sk = cdf_costs(md.cdfs.skip[0][0])
        self.skip0, self.skip1 = int(sk[0]), int(sk[1])
        self.psy_fixed = int(round(getattr(md, "psy_factor", 0.0) * 256))
        self.tx_select = bool(getattr(fr, "tx_mode_select", False))
        self._txd_tabs = None
        self._pending = None

    def rd_row(self) -> np.ndarray:
        """[rdmult, skip0, skip1, intra mode costs x M, NEWMV base x 8,
        zero-MV base x 8, compound NEW/zero bases, psy_factor<<8] —
        neutral-context snapshot costs (the exact neighbor-dependent
        rates only re-weight the host tree walk)."""
        md = self.md
        from .constants import InterMode
        from .rd import cdf_costs as cc

        ii = cc(md.cdfs.intra_inter[0][0])
        # intra mode rates on inter frames: y_mode cdf, mid size group
        ym = cc(md.cdfs.y_mode[0][1])[self.modes].astype(np.int64)
        mode_rate = ym + int(ii[0])
        newmv_c = cc(md.cdfs.newmv[0][0])
        zeromv_c = cc(md.cdfs.zeromv[0][0])
        # single-vs-compound symbol (comp_inter, neutral ctx) precedes
        # the ref trees whenever the frame signals reference_select
        cm0 = cm1 = 0
        if self.comp_pair is not None:
            cm = cc(md.cdfs.comp_inter[0][0])
            cm0, cm1 = int(cm[0]), int(cm[1])
        # slots beyond the frame's refs get a prohibitive base cost (the
        # lattice holds only the real refs)
        new_base = np.full(8, 1 << 28, np.int64)
        zero_base = np.full(8, 1 << 28, np.int64)
        for ri, name in enumerate(self.ref_names):
            rr = md._single_ref_rate(0, 0, 0, name) + cm0
            new_base[ri] = int(ii[1]) + rr + int(newmv_c[0])
            zero_base[ri] = (int(ii[1]) + rr + int(newmv_c[1])
                             + int(zeromv_c[0]))
        comp_base = np.full(2, 1 << 28, np.int64)
        if self.comp_pair is not None:
            cmode = cc(md.cdfs.inter_compound_mode[0][0])
            ref_r = int(ii[1]) + cm1 + md._comp_ref_rate(0, 0,
                                                         self.comp_pair)
            base0 = int(InterMode.NEAREST_NEARESTMV)
            comp_base[0] = ref_r + int(
                cmode[int(InterMode.NEW_NEWMV) - base0])
            comp_base[1] = ref_r + int(
                cmode[int(InterMode.GLOBAL_GLOBALMV) - base0])
        return np.concatenate([
            np.array([max(1, md.rdmult // 16) if _hbd8(self)
                      else md.rdmult, self.skip0, self.skip1], np.int64),
            mode_rate, new_base, zero_base, comp_base,
            np.array([self.psy_fixed], np.int64)]).astype(np.int32)

    def analyze_dispatch(self) -> None:
        """Queue the fused inter lattice of this frame without waiting for
        it; analyze() fetches the result. Each sp shard's rows (and its
        reference slabs) are queued on its device."""
        src = self.pad_src(self.md.pctx[0].src)
        hp, wp = src.shape
        self._hp, self._wp = hp, wp

        def pad(p):
            h, w = p.shape
            if h != hp or w != wp:
                p = np.pad(p, ((0, hp - h), (0, wp - w)), mode="edge")
            return p

        a_bd = 8 if _hbd8(self) else self.seq.bit_depth
        refs = np.stack([pad(np.ascontiguousarray(self.md.ref_planes[n][0]))
                         for n in self.ref_names])
        if a_bd != self.seq.bit_depth:
            src = src >> (self.seq.bit_depth - 8)
            refs = refs >> (self.seq.bit_depth - 8)
        qp = qp_row_for(self.fr.base_q_idx, self.fr.delta_q_y_dc, 0, a_bd)
        self._pending = inter_analysis_sharded(
            src, refs, qp, self.rd_row(), self.mesh, depths=self.DEPTHS,
            bit_depth=a_bd, psy=self.psy_fixed > 0, kernels=self.kernels)

    def analyze(self, packed_row: np.ndarray | None = None) -> None:
        """Pull the packed inter lattice (dispatching now if needed)."""
        if packed_row is None:
            if self._pending is None:
                self.analyze_dispatch()
            packed_row = self._pending.numpy()[0]
            self._pending = None
        self.stats = unpack_inter_analysis(packed_row, self._hp, self._wp,
                                           self.DEPTHS)

    def _leaf_j(self, blk: int, by: int, bx: int, rdmult: int):
        s = self.stats[blk]
        j = int(s["j"][by, bx])
        cand = int(s["cand"][by, bx])
        if cand < CAND_INTER0:
            return j, int(self.modes[cand])
        if cand >= CAND_COMP_NEW:
            if cand == CAND_COMP_ZERO:
                mv0 = mv1 = (0, 0)
            else:
                mv0 = (int(s["mv_y"][by, bx]) * 8,
                       int(s["mv_x"][by, bx]) * 8)
                mv1 = (int(s["mv_y1"][by, bx]) * 8,
                       int(s["mv_x1"][by, bx]) * 8)
            return j, ("comp", self.comp_pair, mv0, mv1)
        ri, is_zero = divmod(cand - CAND_INTER0, 2)
        mv = (0, 0) if is_zero else (int(s["mv_y"][by, bx]) * 8,
                                     int(s["mv_x"][by, bx]) * 8)
        return j, ("inter", self.ref_names[ri], mv)

    # ---- conformant commit -----------------------------------------------
    def _commit_leaf(self, r: int, c: int, bsize: int, payload) -> LeafBlock:
        if not isinstance(payload, tuple):
            leaf = super()._commit_leaf(r, c, bsize, payload)
            self.md.mi_state.set_block(r, c, bsize, -1, (0, 0), False)
            return leaf
        if payload[0] == "comp":
            return self._commit_comp_leaf(r, c, bsize, payload[1],
                                          payload[2], payload[3])
        _, ref_id, mv = payload
        return self._commit_inter_leaf(r, c, bsize, ref_id, mv)

    def _commit_comp_leaf(self, r: int, c: int, bsize: int, rf,
                          mv0, mv1) -> LeafBlock:
        """Conformant compound commit: per-ref subpel refine, joint MVP
        match -> cheapest legal compound mode, spec compound-average MC
        (ops.mc.mc_block_compound), exact txb chain."""
        from ..ops.mc import mc_block_compound
        from .constants import InterMode, mode_has_newmv
        from .mvp import find_mv_stack

        md = self.md
        x, y = c * 4, r * 4
        stack = find_mv_stack(md.mi_state, r, c, bsize, rf)
        bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
        if mv0 != (0, 0):
            mv0 = md._subpel_refine(x, y, bw_px, bh_px, mv0, rf[0])
        if mv1 != (0, 0):
            mv1 = md._subpel_refine(x, y, bw_px, bh_px, mv1, rf[1])
        pair = (tuple(mv0), tuple(mv1))
        if pair == (tuple(stack.mvs[0]), tuple(stack.comp_mvs[0])):
            mode = InterMode.NEAREST_NEARESTMV
        elif stack.count >= 2 and pair == (tuple(stack.mvs[1]),
                                           tuple(stack.comp_mvs[1])):
            mode = InterMode.NEAR_NEARMV
        elif pair == ((0, 0), (0, 0)):
            mode = InterMode.GLOBAL_GLOBALMV
        else:
            mode = InterMode.NEW_NEWMV

        ctx = self._commit_ctx
        if ctx is None:
            ctx = self._commit_ctx = _mk_commit_ctx(self)

        ref_pl0 = md.ref_planes[rf[0]]
        ref_pl1 = md.ref_planes[rf[1]]

        def commit_y(xx, yy, tx):
            from .constants import TX_H, TX_W

            pr = mc_block_compound(ref_pl0[0], ref_pl1[0], xx, yy,
                                   int(TX_W[tx]), int(TX_H[tx]), mv0, mv1,
                                   0, 0, bit_depth=self.seq.bit_depth)
            return self._commit_pred(md.pctx[0], pr, xx, yy, tx, 0, ctx)

        tx_depth, txbs = self._luma_tx_trial(md.pctx[0], commit_y, x, y,
                                             bsize, True)
        bw4, bh4 = bw_px >> 2, bh_px >> 2
        if md._has_chroma(r, c, bw4, bh4):
            ssx, ssy = md.pctx[1].ss_x, md.pctx[1].ss_y
            cw_px = max(bw_px >> ssx, 4)
            ch_px = max(bh_px >> ssy, 4)
            uv_bsize = block_size_of(cw_px, ch_px)
            uv_tx = int(MAX_TX_SIZE_RECT[uv_bsize])
            cx, cy = x >> ssx, y >> ssy
            for p in (1, 2):
                predc = mc_block_compound(
                    ref_pl0[p], ref_pl1[p], cx, cy, int(TX_W[uv_tx]),
                    int(TX_H[uv_tx]), mv0, mv1, ssx, ssy,
                    bit_depth=self.seq.bit_depth)
                qcc, eobc = self._commit_pred(md.pctx[p], predc, cx, cy,
                                              uv_tx, p, ctx)
                txbs.append({"plane": p, "plane_bsize": uv_bsize,
                             "tx_size": uv_tx,
                             "tx_type": int(TxType.DCT_DCT), "qcoeff": qcc,
                             "eob": eobc, "ux": cx >> 2, "uy": cy >> 2})
        skip = all(t["eob"] == 0 for t in txbs)
        md.mi_state.set_block(r, c, bsize, rf[0], mv0,
                              mode_has_newmv(int(mode)),
                              ref_frame1=rf[1], mv1=mv1)
        return LeafBlock(bsize, skip=skip, is_inter=True, ref_frame=rf[0],
                         ref_frame1=rf[1], inter_mode=int(mode),
                         mv=tuple(mv0), mv1=tuple(mv1), drl_index=0,
                         tx_depth=tx_depth,
                         coeffs=None if skip else txbs)

    def _commit_inter_leaf(self, r: int, c: int, bsize: int, ref_id: int,
                           mv) -> LeafBlock:
        from ..ops.mc import mc_block
        from .constants import InterMode, mode_has_newmv
        from .mvp import find_mv_stack

        md = self.md
        fr = self.fr
        x, y = c * 4, r * 4
        stack = find_mv_stack(md.mi_state, r, c, bsize, ref_id)
        bw_px, bh_px = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
        if mv != (0, 0):
            mv = md._subpel_refine(x, y, bw_px, bh_px, mv, ref_id)
        # map the MV onto the cheapest legal mode
        if tuple(mv) == tuple(stack.mvs[0]):
            mode = InterMode.NEARESTMV
        elif stack.count >= 2 and tuple(mv) == tuple(stack.mvs[1]):
            mode = InterMode.NEARMV
        elif tuple(mv) == (0, 0):
            mode = InterMode.GLOBALMV
        else:
            mode = InterMode.NEWMV

        ctx = self._commit_ctx
        if ctx is None:
            ctx = self._commit_ctx = _mk_commit_ctx(self)

        ref_pl = md.ref_planes[ref_id]

        # commit-time switchable-filter trial (the device lattice ranks
        # candidates with full-pel SAD; the exact filter choice is a
        # per-winner trial like the tx-depth one): prediction-domain SSE
        # + symbol rate over REG/SMOOTH/SHARP, mirroring the host search
        # (interpolation_filter_search, enc_inter_prediction.c:2276)
        flt = 0
        if (getattr(fr, "interp_filter", 0) == 4
                and ((mv[0] | mv[1]) & 7)):
            # needs_interp_filter (spec 5.11.26): large GLOBALMV blocks
            # only code the symbol when the ref's GmType is TRANSLATION
            codes_filter = True
            if (mode == InterMode.GLOBALMV
                    and min(bw_px, bh_px) >= 8):
                e = md._gm_entry(ref_id)
                codes_filter = e is not None and e[0] == 1
            if codes_filter:
                fcosts = md._interp_fcosts(False)
                src = md.pctx[0].src[y : y + bh_px, x : x + bw_px]
                from .rd import rdcost

                best = None
                for f in (0, 1, 2):
                    p_f = mc_block(ref_pl[0], x, y, bw_px, bh_px,
                                   mv[0], mv[1], 0, 0, f, f,
                                   bit_depth=self.seq.bit_depth)
                    sse = int(((src - p_f).astype(np.int64) ** 2).sum())
                    j = rdcost(md.rdmult, int(fcosts[f]), sse)
                    if md.spy_rd:
                        if f == 2:
                            j = j * 75 // 100
                        elif f == 0:
                            j = j * 80 // 100
                    if best is None or j < best[0]:
                        best = (j, f)
                flt = best[1]

        # commit-time motion-mode trial (OBMC_CAUSAL / WARPED_CAUSAL):
        # the reference keeps OBMC (obmc_level=4) and local warp
        # (wm_level=3/4) on BASE-layer frames up to M9
        # (enc_mode_config.c:8065-8075, 8237-8243) — the device lattice
        # ranks candidates with SIMPLE translation; the exact motion
        # mode is a per-winner prediction-domain trial like the
        # interp-filter one. Warp forfeits the filter symbol
        # (needs_interp_filter, spec 5.11.26).
        motion_mode = 0
        lwarp = None
        pred_y = mc_block(ref_pl[0], x, y, bw_px, bh_px, mv[0], mv[1],
                          0, 0, flt, flt, bit_depth=self.seq.bit_depth)
        kind = "none"
        if getattr(fr, "is_motion_mode_switchable", False):
            kind, samples = md._motion_mode_kind_md(r, c, bsize, ref_id)
        if kind != "none":
            from .rd import rdcost as _rdc

            src_y = md.pctx[0].src[y : y + bh_px, x : x + bw_px]

            def _sse(p):
                return int(((src_y - p).astype(np.int64) ** 2).sum())

            best = (_rdc(md.rdmult, md._mm_cost(kind, 0, bsize),
                         _sse(pred_y)), 0, None, pred_y)
            from .obmc import obmc_blend_plane

            oss = ((md.pctx[1].ss_x, md.pctx[1].ss_y)
                   if len(md.pctx) > 1 else (1, 1))
            p_ob = obmc_blend_plane(pred_y, 0, md.mi_state, r, c, bsize,
                                    md.ref_planes, self.seq.bit_depth,
                                    oss, 0)
            j_ob = _rdc(md.rdmult, md._mm_cost(kind, 1, bsize), _sse(p_ob))
            if j_ob < best[0]:
                best = (j_ob, 1, None, p_ob)
            if kind == "full":
                from ..ops.warp import (
                    find_projection,
                    select_samples,
                    warp_plane,
                )

                pts, ptsr = samples
                if len(pts) > 1:
                    pts, ptsr = select_samples(mv, pts, ptsr, bw_px, bh_px)
                wp = find_projection(pts, ptsr, bw_px, bh_px, mv, r, c)
                if wp is not None:
                    p_w = warp_plane(ref_pl[0], wp[0], wp[1], x, y, bw_px,
                                     bh_px, 0, 0,
                                     bd=self.seq.bit_depth).astype(np.int32)
                    j_w = _rdc(md.rdmult, md._mm_cost(kind, 2, bsize),
                               _sse(p_w))
                    if j_w < best[0]:
                        best = (j_w, 2, wp, p_w)
            motion_mode, lwarp, pred_y = best[1], best[2], best[3]
            if motion_mode == 2:
                flt = 0  # warp codes no interp-filter symbol

        def commit_y(xx, yy, tx):
            from .constants import TX_H, TX_W

            pr = pred_y[yy - y : yy - y + int(TX_H[tx]),
                        xx - x : xx - x + int(TX_W[tx])]
            return self._commit_pred(md.pctx[0],
                                     np.ascontiguousarray(pr, np.int32),
                                     xx, yy, tx, 0, ctx)

        tx_depth, txbs = self._luma_tx_trial(md.pctx[0], commit_y, x, y,
                                             bsize, True)
        bw4, bh4 = bw_px >> 2, bh_px >> 2
        if md._has_chroma(r, c, bw4, bh4):
            ssx, ssy = md.pctx[1].ss_x, md.pctx[1].ss_y
            cw_px = max(bw_px >> ssx, 4)
            ch_px = max(bh_px >> ssy, 4)
            uv_bsize = block_size_of(cw_px, ch_px)
            uv_tx = int(MAX_TX_SIZE_RECT[uv_bsize])
            cx, cy = x >> ssx, y >> ssy
            for p in (1, 2):
                if (motion_mode == 2 and int(TX_W[uv_tx]) >= 8
                        and int(TX_H[uv_tx]) >= 8):
                    from ..ops.warp import warp_plane as _wpl

                    predc = _wpl(ref_pl[p], lwarp[0], lwarp[1], cx, cy,
                                 int(TX_W[uv_tx]), int(TX_H[uv_tx]),
                                 ssx, ssy,
                                 bd=self.seq.bit_depth).astype(np.int32)
                else:
                    predc = mc_block(ref_pl[p], cx, cy, int(TX_W[uv_tx]),
                                     int(TX_H[uv_tx]), mv[0], mv[1],
                                     ssx, ssy, flt, flt,
                                     bit_depth=self.seq.bit_depth)
                    if motion_mode == 1:
                        from .obmc import obmc_blend_plane as _obp

                        predc = _obp(predc, p, md.mi_state, r, c, bsize,
                                     md.ref_planes, self.seq.bit_depth,
                                     (ssx, ssy), 0)
                qcc, eobc = self._commit_pred(md.pctx[p], predc, cx, cy,
                                              uv_tx, p, ctx)
                txbs.append({"plane": p, "plane_bsize": uv_bsize,
                             "tx_size": uv_tx,
                             "tx_type": int(TxType.DCT_DCT), "qcoeff": qcc,
                             "eob": eobc, "ux": cx >> 2, "uy": cy >> 2})
        skip = all(t["eob"] == 0 for t in txbs)
        md.mi_state.set_block(r, c, bsize, ref_id, mv,
                              mode_has_newmv(int(mode)),
                              interp_filter=flt)
        return LeafBlock(bsize, skip=skip, is_inter=True, ref_frame=ref_id,
                         inter_mode=int(mode), mv=tuple(mv), drl_index=0,
                         tx_depth=tx_depth, interp_filter=flt,
                         motion_mode=motion_mode,
                         coeffs=None if skip else txbs)

    def _commit_pred(self, pc, pred, x, y, tx_size, plane, ctx):
        fr = self.fr
        dc_delta = fr.delta_q_y_dc if plane == 0 else fr.delta_q_u_dc
        ac_delta = 0 if plane == 0 else fr.delta_q_u_ac
        if ctx:
            from .rdoq import arm_for

            return ctx.run(pc, np.ascontiguousarray(pred, np.int32), x, y,
                           tx_size, self.md.cur_qindex, dc_delta, ac_delta,
                           plane=plane, is_inter=True,
                           rdoq=arm_for(self.md.rdoq))
        qc, eob, rec, _ = self.md._txb_rd(pc, pred, x, y, tx_size,
                                          TxType.DCT_DCT, plane,
                                          is_inter=True)
        pc.recon[y : y + rec.shape[0], x : x + rec.shape[1]] = rec
        return qc, eob
