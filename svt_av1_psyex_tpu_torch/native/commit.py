"""ctypes wrapper for the C txb commit kernel (native/ecenc.c
svt_txb_commit): one call per transform block of the *decided* mode —
residual -> exact fwd DCT -> quantize_b -> inverse DCT -> recon.

Replaces the numpy predict/txfm/quant chain in the conformant commit
pass (counterpart of the reference encode pass, coding_loop.c:1697).
DCT_DCT only; callers fall back to the numpy path for other tx types.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from ..ops import txfm as txfm_ref
from ..ops.quant import build_plane_quant, _round_pow2
from .ecenc import get_lib

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)

_registered = False


def _lib():
    global _registered
    lib = get_lib()
    if lib is not None and not _registered:
        lib.svt_txb_commit.restype = ctypes.c_int32
        lib.svt_txb_commit.argtypes = [
            _I64P, _I32P, ctypes.c_int, _I32P, ctypes.c_int, _I32P,
            ctypes.c_int, ctypes.c_int, _I64P, _I32P,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.svt_txb_commit_pred.restype = ctypes.c_int32
        lib.svt_txb_commit_pred.argtypes = (
            [_I64P, _I32P, ctypes.c_int, _I32P, ctypes.c_int,
             ctypes.c_int, _I32P, _I32P, ctypes.c_int, ctypes.c_int,
             _I32P, _I32P, ctypes.c_int, ctypes.c_int, _I64P, _I32P,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int])
        _registered = True
    return lib


@lru_cache(maxsize=None)
def _sm_weights_i32(n: int) -> np.ndarray:
    from ..bitstream.tables import get

    return np.ascontiguousarray(get("sm_weight_arrays")[n : 2 * n]
                                .astype(np.int32))


def _net_slots(net, cos_bit: int) -> tuple:
    src0, w0, src1, w1, btf, clp, ns = net._compiled_native(cos_bit)
    ptrs = (src0.ctypes.data, w0.ctypes.data, src1.ctypes.data,
            w1.ctypes.data, btf.ctypes.data, clp.ctypes.data, ns)
    return ptrs, (src0, w0, src1, w1, btf, clp)  # keepalive


@lru_cache(maxsize=None)
def _descriptor(tx_size: int, bit_depth: int):
    """Build (and keep alive) the int64 descriptor for one DCT_DCT tx
    size; returns (desc array, keepalive tuple) or None without the lib."""
    from ..bitstream.tables import scan_table
    from ..codec.constants import TX_H, TX_W

    if _lib() is None:
        return None
    w, h = int(TX_W[tx_size]), int(TX_H[tx_size])
    wi, hi = int(np.log2(w)) - 2, int(np.log2(h)) - 2
    cb_col = txfm_ref._FWD_COS_BIT_COL[wi][hi]
    cb_row = txfm_ref._FWD_COS_BIT_ROW[wi][hi]
    nets = txfm_ref._load_nets()
    fcol, ka0 = _net_slots(nets[f"fdct{h}"], cb_col)
    frow, ka1 = _net_slots(nets[f"fdct{w}"], cb_row)
    irow, ka2 = _net_slots(nets[f"idct{w}"], txfm_ref.INV_COS_BIT)
    icol, ka3 = _net_slots(nets[f"idct{h}"], txfm_ref.INV_COS_BIT)
    fsh = txfm_ref._FWD_SHIFT[(w, h)]
    ish = txfm_ref._INV_SHIFT[(w, h)]
    opt_row = {8: 16, 10: 18, 12: 20}[bit_depth]
    opt_col = {8: 16, 10: 16, 12: 18}[bit_depth]
    scan = np.ascontiguousarray(scan_table(tx_size, "default").astype(np.int32))
    log_scale = int(w * h > 256) + int(w * h > 1024)  # av1_get_tx_scale (area)
    d = np.zeros(46, np.int64)
    d[0], d[1] = w, h
    d[2:9] = fcol
    d[9:16] = frow
    d[16:23] = irow
    d[23:30] = icol
    d[30], d[31], d[32] = -fsh[0], -fsh[1], -fsh[2]
    d[33], d[34] = -ish[0], -ish[1]
    d[35], d[36], d[37] = cb_col, cb_row, txfm_ref.INV_COS_BIT
    d[38], d[39] = opt_row, opt_col
    d[40] = 1 if txfm_ref._rect_ratio1(w, h) else 0
    d[41] = log_scale
    d[42] = scan.ctypes.data
    d[43] = bit_depth
    d[44] = bit_depth + 8
    d[45] = max(bit_depth + 6, 16)
    return d, (ka0, ka1, ka2, ka3, scan)


@lru_cache(maxsize=256)
def _q10(qindex: int, dc_delta: int, ac_delta: int, bit_depth: int,
         log_scale: int) -> np.ndarray:
    pq = build_plane_quant(qindex, dc_delta, ac_delta, bit_depth)
    out = np.zeros(10, np.int64)
    for i in range(2):
        out[i * 5 + 0] = _round_pow2(pq.zbin[i], log_scale)
        out[i * 5 + 1] = _round_pow2(pq.round[i], log_scale)
        out[i * 5 + 2] = pq.quant[i]
        out[i * 5 + 3] = pq.quant_shift[i]
        out[i * 5 + 4] = pq.dequant[i]
    return out


def available() -> bool:
    return _lib() is not None


def txb_commit(src: np.ndarray, recon: np.ndarray, pred: np.ndarray,
               x: int, y: int, tx_size: int, qindex: int, dc_delta: int,
               ac_delta: int, bit_depth: int):
    """Run the C commit kernel; returns (qcoeff (ch, cw) int32, eob int).
    recon is updated in place at (y, x). src/recon int32 C-contiguous."""
    desc, _keep = _descriptor(tx_size, bit_depth)
    from ..codec.constants import TX_H, TX_W

    w, h = int(TX_W[tx_size]), int(TX_H[tx_size])
    cw, ch = min(w, 32), min(h, 32)
    log_scale = int(desc[41])
    q10 = _q10(qindex, dc_delta, ac_delta, bit_depth, log_scale)
    pred = np.ascontiguousarray(pred, np.int32)
    qcoeff = np.empty(ch * cw, np.int32)
    lib = _lib()
    eob = lib.svt_txb_commit(
        desc.ctypes.data_as(_I64P),
        src.ctypes.data_as(_I32P), src.shape[1],
        recon.ctypes.data_as(_I32P), recon.shape[1],
        pred.ctypes.data_as(_I32P), x, y,
        q10.ctypes.data_as(_I64P), qcoeff.ctypes.data_as(_I32P),
        -1, 0, 0, qindex)  # standalone entry: no RDOQ
    return qcoeff.reshape(ch, cw), int(eob)


class CommitCtx:
    """Per-frame cache of descriptor/quant/plane pointers so the hot
    commit loop does no dict lookups or repeated ctypes conversions."""

    def __init__(self, bit_depth: int):
        self.lib = _lib()
        self.bit_depth = bit_depth
        self._desc: dict = {}
        self._q: dict = {}
        self._planes: dict = {}

    def _desc_ptr(self, tx_size: int):
        e = self._desc.get(tx_size)
        if e is None:
            desc, keep = _descriptor(tx_size, self.bit_depth)
            e = (desc.ctypes.data_as(_I64P), int(desc[41]),
                 int(desc[0]), int(desc[1]), desc, keep)
            self._desc[tx_size] = e
        return e

    def _q_ptr(self, qindex: int, dc_d: int, ac_d: int, ls: int):
        key = (qindex, dc_d, ac_d, ls)
        e = self._q.get(key)
        if e is None:
            q10 = _q10(qindex, dc_d, ac_d, self.bit_depth, ls)
            e = (q10.ctypes.data_as(_I64P), q10)
            self._q[key] = e
        return e

    def plane(self, pc):
        key = id(pc)
        e = self._planes.get(key)
        if e is None:
            e = (pc.src.ctypes.data_as(_I32P), pc.src.shape[1],
                 pc.recon.ctypes.data_as(_I32P), pc.recon.shape[1])
            self._planes[key] = e
        return e

    def run_pred(self, pc, mode: int, above: np.ndarray, left: np.ndarray,
                 have_above: bool, have_left: bool, x: int, y: int,
                 tx_size: int, qindex: int, dc_d: int, ac_d: int,
                 plane: int = 0, is_inter: bool = False,
                 rdoq: bool = False):
        """Predict (C, non-directional commit modes) + commit in one call.
        above: (w+1,) int32 incl. top-left; left: (h,) int32."""
        dptr, ls, w, h, _d, _k = self._desc_ptr(tx_size)
        qptr, _q = self._q_ptr(qindex, dc_d, ac_d, ls)
        sptr, sstride, rptr, rstride = self.plane(pc)
        cw, ch = min(w, 32), min(h, 32)
        qcoeff = np.empty(ch * cw, np.int32)
        smw = _sm_weights_i32(w)
        smh = _sm_weights_i32(h)
        eob = self.lib.svt_txb_commit_pred(
            dptr, sptr, sstride, rptr, rstride, mode,
            above.ctypes.data_as(_I32P), left.ctypes.data_as(_I32P),
            1 if have_above else 0, 1 if have_left else 0,
            smw.ctypes.data_as(_I32P), smh.ctypes.data_as(_I32P),
            x, y, qptr, qcoeff.ctypes.data_as(_I32P),
            tx_size if rdoq else -1, plane, int(is_inter), qindex)
        return qcoeff.reshape(ch, cw), int(eob)

    def run(self, pc, pred: np.ndarray, x: int, y: int, tx_size: int,
            qindex: int, dc_d: int, ac_d: int, plane: int = 0,
            is_inter: bool = False, rdoq: bool = False):
        dptr, ls, w, h, _d, _k = self._desc_ptr(tx_size)
        qptr, _q = self._q_ptr(qindex, dc_d, ac_d, ls)
        sptr, sstride, rptr, rstride = self.plane(pc)
        if not (pred.flags.c_contiguous and pred.dtype == np.int32):
            pred = np.ascontiguousarray(pred, np.int32)
        cw, ch = min(w, 32), min(h, 32)
        qcoeff = np.empty(ch * cw, np.int32)
        eob = self.lib.svt_txb_commit(
            dptr, sptr, sstride, rptr, rstride,
            pred.ctypes.data_as(_I32P), x, y, qptr,
            qcoeff.ctypes.data_as(_I32P),
            tx_size if rdoq else -1, plane, int(is_inter), qindex)
        return qcoeff.reshape(ch, cw), int(eob)
