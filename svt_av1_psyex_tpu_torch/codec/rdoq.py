"""RDOQ — rate-distortion optimized quantization (trellis) frontend.

Counterpart: svt_av1_optimize_b (reference full_loop.c:1127) and the
rdoq_level signal derivation (enc_mode_config.c:7481 — level 1, i.e. the
full trellis with fp quantization, at every preset outside rtc).  The
trellis itself is C (native/rdoq.c); this module builds the per-frame
cost tables from the frame-initial CDF snapshot — the same snapshot the
RateCounter rate model uses — and exposes

  * ``RdoqFrame(cdfs, base_q, lambda_, ...)``  — table owner
  * ``frame.install()``                        — register with the C side
  * ``frame.optimize_txb(...)``                — per-txb trellis (host MD)

Everything here is an encoder-side decision: any level assignment the
trellis produces is valid syntax, so conformance is unaffected (the
dav1d round-trip tests still gate every shipped stream).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..bitstream.coeff_writer import _nz_offsets, txs_ctx

_I32P = ctypes.POINTER(ctypes.c_int32)

_configured = False
_installed_id = None
_installed_frame = None  # strong ref: the C side holds raw pointers


def _costs(values: np.ndarray) -> np.ndarray:
    """Vectorized per-symbol cost (1/512 bit) over the last axis
    (RateCounter.family_costs shape)."""
    v = np.asarray(values, np.int64)
    prev = np.concatenate(
        [np.zeros(v.shape[:-1] + (1,), np.int64), v[..., :-1]], axis=-1)
    p = np.maximum(v - prev, 1) / 32768.0
    return np.round(-np.log2(p) * 512).astype(np.int32)


def _bind(lib) -> None:
    global _configured
    if _configured:
        return
    lib.svt_rdoq_frame.argtypes = [_I32P] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.svt_rdoq_txb.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # txs,pt,inter,class
        _I32P, _I32P, _I32P, ctypes.c_int32, _I32P,              # t,q,dq,eob,scan
        ctypes.c_int, ctypes.c_int, _I32P, ctypes.c_int,         # cw,ch,nzoff,shift
        ctypes.c_int32, ctypes.c_int32, _I32P,                   # dqv dc/ac, iqm
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]  # skipctx,dcctx,q,ems
    lib.svt_rdoq_txb.restype = ctypes.c_int32
    lib.svt_rdoq_tx_meta.argtypes = [ctypes.c_int, ctypes.c_int, _I32P]
    lib.svt_rdoq_off.argtypes = []
    _configured = True


_tx_meta_done = False
_tx_meta_keep: list = []


def _install_tx_meta(lib) -> None:
    """Register per-tx-size 2D nz-ctx offsets + entropy tx contexts for
    the whole-frame commit pass (once per process)."""
    global _tx_meta_done
    if _tx_meta_done:
        return
    for tx in range(19):
        off = _nz_offsets(tx, 0)
        _tx_meta_keep.append(off)
        lib.svt_rdoq_tx_meta(tx, txs_ctx(tx), _p(off))
    _tx_meta_done = True


def arm_for(md_rdoq) -> bool:
    """Point the C trellis at this frame's tables (or disable it when
    the frame has no RDOQ); returns True when the trellis is active."""
    if md_rdoq is None:
        if _installed_id is not None:
            rdoq_off()
        return False
    return md_rdoq.ensure()


def rdoq_off() -> None:
    """Disable the C-side trellis (e.g. for a frame without RDOQ when a
    previous frame's tables are still registered)."""
    global _installed_id, _installed_frame
    from ..native.ecenc import get_lib

    lib = get_lib()
    if lib is not None and _configured:
        lib.svt_rdoq_off()
    _installed_id = None
    _installed_frame = None


def _p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _lps_table(br_costs: np.ndarray) -> np.ndarray:
    """(..., 21, 4) br symbol costs -> (..., 21, 13) base_range costs:
    cost of coding base_range v via up-to-4 reads of the 4-ary CDF
    (writer loop in coeff_writer.py:279-287)."""
    shape = br_costs.shape[:-1] + (13,)
    out = np.zeros(shape, np.int32)
    c = br_costs
    for v in range(13):
        nfull, rem = divmod(v, 3)
        t = nfull * c[..., 3]
        if v < 12:
            t = t + c[..., rem]
        out[..., v] = t
    return out


class RdoqFrame:
    """Per-frame RDOQ cost tables + parameters.  Keep the instance alive
    for as long as the C side may reference it (it owns the arrays)."""

    def __init__(self, cdfs, base_q: int, lambda_: int, sharpness: int = 0,
                 sharp_tx: bool = False, use_sharpness: bool = False):
        self.base = np.ascontiguousarray(_costs(cdfs.coeff_base[0]))
        self.base_eob = np.ascontiguousarray(_costs(cdfs.coeff_base_eob[0]))
        self.lps = np.ascontiguousarray(_lps_table(_costs(cdfs.coeff_br[0])))
        # eob_pt: (7 sizes, 2 ptype, 2 class-ctx, 11) padded
        ept = np.zeros((7, 2, 2, 11), np.int32)
        for ems in range(7):
            c = _costs(cdfs.eob_flag[16 << ems][0])  # (2, 2, ems+5)
            ept[ems, :, :, : c.shape[-1]] = c
        self.eob_pt = np.ascontiguousarray(ept)
        self.eob_extra = np.ascontiguousarray(_costs(cdfs.eob_extra[0]))
        self.txb_skip = np.ascontiguousarray(_costs(cdfs.txb_skip[0]))
        self.dc_sign = np.ascontiguousarray(_costs(cdfs.dc_sign[0]))
        self.base_q = int(base_q)
        self.lambda_ = int(lambda_)
        self.sharpness = int(np.clip(sharpness, 0, 7))
        self.sharp_tx = bool(sharp_tx)
        self.use_sharpness = bool(use_sharpness)
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ..native.ecenc import get_lib

            self._lib = get_lib()
            if self._lib is not None:
                _bind(self._lib)
        return self._lib

    def install(self, enabled: bool = True) -> bool:
        """Register this frame's tables with the C trellis (global —
        re-install before each frame's MD/commit when pipelining)."""
        global _installed_id, _installed_frame
        lib = self.lib()
        if lib is None:
            return False
        _install_tx_meta(lib)
        lib.svt_rdoq_frame(_p(self.base), _p(self.base_eob), _p(self.lps),
                           _p(self.eob_pt), _p(self.eob_extra),
                           _p(self.txb_skip), _p(self.dc_sign),
                           self.lambda_, self.sharpness,
                           int(self.sharp_tx), int(self.use_sharpness),
                           self.base_q, int(enabled))
        _installed_id = id(self) if enabled else None
        _installed_frame = self if enabled else None
        return True

    def ensure(self) -> bool:
        """install() only if this frame isn't the one currently
        registered; returns whether the C trellis is usable."""
        if id(self) == _installed_id:
            return True
        return self.install()

    def optimize(self, tcoeff, qcoeff, dqcoeff, eob, scan, tx_size,
                 tx_class, cw, ch, is_inter, plane, shift, dqv_dc, dqv_ac,
                 iqm=None, qindex=None, txb_skip_ctx=0, dc_sign_ctx=0):
        """Trellis one txb in place (arrays contiguous int32, raster
        (cw*ch,)); returns the new eob."""
        if eob <= 0:
            return eob
        if id(self) != _installed_id:
            if not self.install():
                return eob
        lib = self._lib
        if iqm is not None:
            iqm = np.ascontiguousarray(iqm.reshape(-1).astype(np.int32))
        nz = _nz_offsets(int(tx_size), int(tx_class))
        ems = int(np.log2(cw)) + int(np.log2(ch)) - 4
        return int(lib.svt_rdoq_txb(
            txs_ctx(int(tx_size)), 0 if plane == 0 else 1, int(is_inter),
            int(tx_class), _p(tcoeff), _p(qcoeff), _p(dqcoeff), int(eob),
            _p(scan), int(cw), int(ch), _p(nz), int(shift), int(dqv_dc),
            int(dqv_ac), _p(iqm) if iqm is not None else None,
            int(txb_skip_ctx), int(dc_sign_ctx),
            self.base_q if qindex is None else int(qindex), ems))
