"""Whole-frame native commit backend (native/frame_enc.c).

One C call executes the conformant tail for every leaf of a frame in
coding order — quarter-pel refinement, 8-tap MC, intra prediction from
recon neighbors, exact fwd/inv transforms, quantize, recon update —
replacing the per-txb ctypes loop in codec/md_device.py.  Counterpart of
the reference's Encode Pass (coding_loop.c:1697) batched per frame, per
SURVEY §7: the TPU decides, the native tail executes.

Scope matches the device-MD lattice output: NONE/SPLIT partitions, one
max-rect tx block per plane per leaf, non-directional intra modes,
single-ref and compound-average inter.  The Python per-leaf path
(SVT_TPU_PY_COMMIT=1) remains the oracle; tests hold the two
bit-identical.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..bitstream.tile_writer import LeafBlock, PartitionNode
from ..codec.constants import (
    BLOCK_H,
    BLOCK_W,
    MAX_TX_SIZE_RECT,
    BlockSize,
    IntraMode,
    Partition,
    TxType,
    block_size_of,
)
from .commit import _descriptor, _q10
from .ecenc import get_lib

_I64P = ctypes.POINTER(ctypes.c_int64)

# leaf record layout — must match native/frame_enc.c
(LF_R, LF_C, LF_BSIZE, LF_FLAGS, LF_YMODE, LF_UVMODE, LF_REF0,
 LF_MVY, LF_MVX, LF_QIDX,
 LF_SKIP, LF_EOB_Y, LF_EOB_U, LF_EOB_V,
 LF_OFF_Y, LF_OFF_U, LF_OFF_V,
 LF_MVY_OUT, LF_MVX_OUT, LF_MODE_OUT, LF_DRL_OUT,
 LF_TXS_Y, LF_TXS_UV,
 LF_REF1, LF_MVY1, LF_MVX1, LF_MVY1_OUT, LF_MVX1_OUT,
 LF_RSVD,
 LF_TXD, LF_EOB_Y1, LF_EOB_Y2, LF_EOB_Y3,
 LF_OFF_Y1, LF_OFF_Y2, LF_OFF_Y3) = range(36)
LEAF_I32 = 36
FLAG_INTER = 1
FLAG_COMP = 2

_registered = False


def _lib():
    global _registered
    lib = get_lib()
    if lib is not None and not _registered:
        lib.svt_commit_init.argtypes = [_I64P]
        lib.svt_frame_commit.restype = ctypes.c_int64
        _registered = True
    return lib


def available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "svt_frame_commit")


def _flatten(plan, r, c, qindex, leaves, mi_rows, mi_cols):
    """Walk one pick() plan in coding order, appending leaf records.
    Returns a skeleton mirroring the tree with leaf indices."""
    kind, bsize = plan[0], plan[1]
    if kind == "oob":
        return ("oob", bsize)
    if kind == "split":
        half = (int(BLOCK_W[bsize]) >> 2) >> 1
        coords = ((r, c), (r, c + half), (r + half, c), (r + half, c + half))
        kids = [_flatten(p, rr, cc, qindex, leaves, mi_rows, mi_cols)
                for p, (rr, cc) in zip(plan[2], coords)]
        return ("split", bsize, kids)
    payload = plan[2]
    rec = np.zeros(LEAF_I32, np.int32)
    rec[LF_R], rec[LF_C], rec[LF_BSIZE] = r, c, bsize
    rec[LF_QIDX] = qindex
    if isinstance(payload, tuple) and payload[0] == "comp":
        # ("comp", (ref0, ref1), (mvy0, mvx0), (mvy1, mvx1))
        _, rf, mv0, mv1 = payload
        rec[LF_FLAGS] = FLAG_INTER | FLAG_COMP
        rec[LF_REF0], rec[LF_REF1] = rf
        rec[LF_MVY], rec[LF_MVX] = mv0
        rec[LF_MVY1], rec[LF_MVX1] = mv1
    elif isinstance(payload, tuple):  # ("inter", ref_name, (mvy, mvx))
        _, ref_name, mv = payload
        rec[LF_FLAGS] = FLAG_INTER
        rec[LF_REF0] = ref_name
        rec[LF_MVY], rec[LF_MVX] = mv
    else:
        rec[LF_YMODE] = payload
    idx = len(leaves)
    leaves.append(rec)
    return ("leaf", bsize, idx)


class FrameCommitter:
    """Builds the CommitJob for one frame and rebuilds the LeafBlock
    trees from the committed leaf records."""

    def __init__(self, md, seq, fr, ref_planes=None):
        self.md = md
        self.seq = seq
        self.fr = fr
        self.ref_planes = ref_planes or {}
        self.lib = _lib()
        self._keep = []  # keepalive for every array the job points at

    # ---- job marshalling -------------------------------------------------
    def _pack_job(self, leaves_arr: np.ndarray, qcoeff: np.ndarray,
                  qindexes) -> np.ndarray:
        from ..bitstream.tables import get

        md, seq, fr = self.md, self.seq, self.fr
        keep = self._keep
        slots = []

        def p(a):
            keep.append(a)
            return a.ctypes.data

        pctx = md.pctx
        mono = 1 if len(pctx) == 1 else 0
        for i in range(3):
            slots.append(pctx[i].src.ctypes.data if i < len(pctx) else 0)
        for i in range(3):
            slots.append(pctx[i].recon.ctypes.data if i < len(pctx) else 0)
        for i in range(3):
            slots.append(pctx[i].src.shape[1] if i < len(pctx) else 0)
        for i in range(3):  # display dims (MC clamp, spec 7.11.3.3)
            if i < len(pctx):
                ss_x, ss_y = pctx[i].ss_x, pctx[i].ss_y
                slots.append((seq.width + ss_x) >> ss_x)
            else:
                slots.append(0)
        for i in range(3):
            if i < len(pctx):
                ss_y = pctx[i].ss_y
                slots.append((seq.height + ss_y) >> ss_y)
            else:
                slots.append(0)
        ss_x = pctx[1].ss_x if len(pctx) > 1 else 1
        ss_y = pctx[1].ss_y if len(pctx) > 1 else 1
        slots += [ss_x, ss_y, mono, seq.bit_depth, md.mi_rows, md.mi_cols]
        for ref_id in range(8):
            planes = self.ref_planes.get(ref_id)
            for pl in range(3):
                if planes is not None and pl < len(planes):
                    # cropped DPB views (top-left anchored): the view's
                    # data pointer + row stride address the full buffer,
                    # the view dims are the clamp bounds (spec 7.11.3.3)
                    a = planes[pl]
                    assert a.dtype == np.int32 and a.strides[1] == 4
                    keep.append(a)
                    slots += [a.ctypes.data, a.strides[0] // 4,
                              a.shape[1], a.shape[0]]
                else:
                    slots += [0, 0, 0, 0]
        for tx in range(19):
            desc, dkeep = _descriptor(tx, seq.bit_depth)
            keep.append((desc, dkeep))
            slots.append(desc.ctypes.data)
        # (3, 256, 10) base quant rows for the qindexes actually used
        q10 = np.zeros((3, 256, 10), np.int64)
        for qi in qindexes:
            q10[0, qi] = _q10(qi, fr.delta_q_y_dc, 0, seq.bit_depth, 0)
            q10[1, qi] = _q10(qi, fr.delta_q_u_dc, fr.delta_q_u_ac,
                              seq.bit_depth, 0)
            q10[2, qi] = q10[1, qi]
        slots.append(p(q10))
        smw = np.ascontiguousarray(get("sm_weight_arrays").astype(np.int32))
        slots.append(p(smw))
        f8 = np.ascontiguousarray(get("sub_pel_filters_8").astype(np.int16))
        f4 = np.ascontiguousarray(get("sub_pel_filters_4").astype(np.int16))
        slots.append(p(f8))
        slots.append(p(f4))
        slots.append(p(leaves_arr))
        slots.append(len(leaves_arr))
        slots.append(p(qcoeff))
        slots.append(qcoeff.size)
        # TX_MODE_SELECT commit-time depth trial (tx-size search)
        tx_select = bool(getattr(fr, "tx_mode_select", False))
        slots.append(1 if tx_select else 0)
        from ..codec.md_device import txd_cost_tables
        from ..codec.rd import compute_rdmult

        rdmult_tab = np.zeros(256, np.int64)
        for qi in qindexes:
            rdmult_tab[qi] = compute_rdmult(qi, seq.bit_depth)
        txd_intra, txd_inter = txd_cost_tables(md.cdfs, tx_select)
        slots.append(p(rdmult_tab))
        slots.append(p(np.ascontiguousarray(txd_intra)))
        slots.append(p(np.ascontiguousarray(txd_inter)))
        return np.array(slots, np.int64)

    # ---- main entry ------------------------------------------------------
    def commit(self, plans) -> list:
        """plans: [(plan_tree, r, c, qindex)] in SB coding order.
        Runs the C commit pass and returns [(PartitionNode, r, c)]."""
        md = self.md
        leaves: list = []
        skels = [( _flatten(plan, r, c, qidx, leaves, md.mi_rows,
                            md.mi_cols), r, c)
                 for plan, r, c, qidx in plans]
        if not leaves:
            return [(self._rebuild(s, None, None), r, c)
                    for s, r, c in skels]
        leaves_arr = np.ascontiguousarray(np.stack(leaves))
        cap = 0
        for rec in leaves:
            # full luma block area: a depth-1 tx split of a 64x64 block
            # needs 4x 32x32 coefficient sets (> the capped max-rect)
            bs = int(rec[LF_BSIZE])
            cap += int(BLOCK_W[bs]) * int(BLOCK_H[bs]) + 2 * 32 * 32
        qcoeff = np.empty(cap + 64, np.int32)
        qindexes = sorted({int(rec[LF_QIDX]) for rec in leaves})
        from ..codec.rdoq import arm_for

        arm_for(getattr(md, "rdoq", None))
        job = self._pack_job(leaves_arr, qcoeff, qindexes)
        self.lib.svt_commit_init(job.ctypes.data_as(_I64P))
        used = self.lib.svt_frame_commit()
        assert used >= 0, "qcoeff capacity miscomputed"
        self._leaves = leaves_arr
        self._qcoeff = qcoeff
        self._keep.clear()
        return [(self._rebuild(s, leaves_arr, qcoeff), r, c)
                for s, r, c in skels]

    # ---- LeafBlock reconstruction ---------------------------------------
    def _rebuild(self, skel, leaves_arr, qcoeff) -> PartitionNode:
        kind, bsize = skel[0], skel[1]
        if kind == "oob":
            return PartitionNode(Partition.NONE, leaf=LeafBlock(bsize))
        if kind == "split":
            return PartitionNode(Partition.SPLIT,
                                 children=[self._rebuild(k, leaves_arr,
                                                         qcoeff)
                                           for k in skel[2]])
        rec = leaves_arr[skel[2]]
        return PartitionNode(Partition.NONE,
                             leaf=self._build_leaf(rec, qcoeff))

    def _txbs(self, rec, qcoeff):
        bsize = int(rec[LF_BSIZE])
        x, y = int(rec[LF_C]) * 4, int(rec[LF_R]) * 4
        from ..codec.constants import TX_H, TX_W

        out = []
        tx = int(rec[LF_TXS_Y])
        cw, ch = min(int(TX_W[tx]), 32), min(int(TX_H[tx]), 32)
        if int(rec[LF_TXD]):
            # depth-1 split: LF_TXS_Y already holds the sub-tx size; four
            # sub-TUs in raster order (matches the C commit + vartx writer)
            sw, sh = int(TX_W[tx]), int(TX_H[tx])
            fields = ((LF_OFF_Y, LF_EOB_Y, 0, 0),
                      (LF_OFF_Y1, LF_EOB_Y1, 0, sw),
                      (LF_OFF_Y2, LF_EOB_Y2, sh, 0),
                      (LF_OFF_Y3, LF_EOB_Y3, sh, sw))
            for off_f, eob_f, ty, txx in fields:
                off = int(rec[off_f])
                out.append({"plane": 0, "plane_bsize": bsize, "tx_size": tx,
                            "tx_type": int(TxType.DCT_DCT),
                            "qcoeff": qcoeff[off : off + sh * sw]
                            .reshape(sh, sw),
                            "eob": int(rec[eob_f]),
                            "ux": (x + txx) >> 2, "uy": (y + ty) >> 2})
        else:
            off = int(rec[LF_OFF_Y])
            out.append({"plane": 0, "plane_bsize": bsize, "tx_size": tx,
                        "tx_type": int(TxType.DCT_DCT),
                        "qcoeff": qcoeff[off : off + ch * cw].reshape(ch, cw),
                        "eob": int(rec[LF_EOB_Y]), "ux": x >> 2, "uy": y >> 2})
        uv_tx = int(rec[LF_TXS_UV])
        if uv_tx >= 0:
            md = self.md
            ssx, ssy = md.pctx[1].ss_x, md.pctx[1].ss_y
            cw_px = max(int(BLOCK_W[bsize]) >> ssx, 4)
            ch_px = max(int(BLOCK_H[bsize]) >> ssy, 4)
            uv_bsize = block_size_of(cw_px, ch_px)
            cx, cy = x >> ssx, y >> ssy
            ccw = min(int(TX_W[uv_tx]), 32)
            cch = min(int(TX_H[uv_tx]), 32)
            for pl, off_f, eob_f in ((1, LF_OFF_U, LF_EOB_U),
                                     (2, LF_OFF_V, LF_EOB_V)):
                off = int(rec[off_f])
                out.append({"plane": pl, "plane_bsize": uv_bsize,
                            "tx_size": uv_tx,
                            "tx_type": int(TxType.DCT_DCT),
                            "qcoeff": qcoeff[off : off + cch * ccw]
                            .reshape(cch, ccw),
                            "eob": int(rec[eob_f]),
                            "ux": cx >> 2, "uy": cy >> 2})
        return out

    def _build_leaf(self, rec, qcoeff) -> LeafBlock:
        md = self.md
        bsize = int(rec[LF_BSIZE])
        r, c = int(rec[LF_R]), int(rec[LF_C])
        skip = bool(rec[LF_SKIP])
        txd = int(rec[LF_TXD])
        if not (rec[LF_FLAGS] & FLAG_INTER):
            leaf = LeafBlock(bsize, y_mode=int(rec[LF_YMODE]),
                             uv_mode=int(IntraMode.DC), skip=skip,
                             tx_depth=txd,
                             coeffs=None if skip else self._txbs(rec, qcoeff))
            if md.mi_state is not None:
                md.mi_state.set_block(r, c, bsize, -1, (0, 0), False)
            return leaf
        # inter: map the refined MV onto the MVP stack (codec/md_device.py
        # _commit_inter_leaf / _commit_comp_leaf mode mapping), in the
        # same coding order the C pass committed in
        from ..codec.constants import InterMode, mode_has_newmv
        from ..codec.mvp import find_mv_stack

        ref_id = int(rec[LF_REF0])
        mv = (int(rec[LF_MVY_OUT]), int(rec[LF_MVX_OUT]))
        if rec[LF_FLAGS] & FLAG_COMP:
            rf = (ref_id, int(rec[LF_REF1]))
            mv1 = (int(rec[LF_MVY1_OUT]), int(rec[LF_MVX1_OUT]))
            stack = find_mv_stack(md.mi_state, r, c, bsize, rf)
            pair = (mv, mv1)
            if pair == (tuple(stack.mvs[0]), tuple(stack.comp_mvs[0])):
                mode = InterMode.NEAREST_NEARESTMV
            elif stack.count >= 2 and pair == (tuple(stack.mvs[1]),
                                               tuple(stack.comp_mvs[1])):
                mode = InterMode.NEAR_NEARMV
            elif pair == ((0, 0), (0, 0)):
                mode = InterMode.GLOBAL_GLOBALMV
            else:
                mode = InterMode.NEW_NEWMV
            md.mi_state.set_block(r, c, bsize, rf[0], mv,
                                  mode_has_newmv(int(mode)),
                                  ref_frame1=rf[1], mv1=mv1)
            return LeafBlock(bsize, skip=skip, is_inter=True,
                             ref_frame=rf[0], ref_frame1=rf[1],
                             inter_mode=int(mode), mv=mv, mv1=mv1,
                             drl_index=0, tx_depth=txd,
                             coeffs=None if skip else self._txbs(rec, qcoeff))
        stack = find_mv_stack(md.mi_state, r, c, bsize, ref_id)
        if tuple(mv) == tuple(stack.mvs[0]):
            mode = InterMode.NEARESTMV
        elif stack.count >= 2 and tuple(mv) == tuple(stack.mvs[1]):
            mode = InterMode.NEARMV
        elif tuple(mv) == (0, 0):
            mode = InterMode.GLOBALMV
        else:
            mode = InterMode.NEWMV
        md.mi_state.set_block(r, c, bsize, ref_id, mv,
                              mode_has_newmv(int(mode)))
        return LeafBlock(bsize, skip=skip, is_inter=True, ref_frame=ref_id,
                         inter_mode=int(mode), mv=mv, drl_index=0,
                         tx_depth=txd,
                         coeffs=None if skip else self._txbs(rec, qcoeff))
