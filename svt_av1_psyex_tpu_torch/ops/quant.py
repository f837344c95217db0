"""Quantization / dequantization — libaom-compatible quantize_b, batched.

Mirrors the reference's svt_av1_build_quantizer (md_config_process.c:111)
and svt_aom_quantize_b_c_ii (full_loop.c:29), without quant matrices.
Dequant matches the decoder exactly: abs(level)*dqv >> log_scale, sign
restored.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..bitstream.tables import ac_q, dc_q

AOM_QM_BITS = 5


def _round_pow2(x: int, n: int) -> int:
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def _invert_quant(d: int) -> tuple[int, int]:
    t = d
    l = 0
    while t > 1:
        t >>= 1
        l += 1
    m = 1 + (1 << (16 + l)) // d
    return m - (1 << 16), 1 << (16 - l)


def _qzbin_factor(q: int, bit_depth: int) -> int:
    quant = dc_q(q, bit_depth)
    thresh = {8: 148, 10: 592, 12: 2368}[bit_depth]
    return 64 if q == 0 else (84 if quant < thresh else 80)


@dataclass(frozen=True)
class PlaneQuant:
    zbin: tuple  # (dc, ac)
    round: tuple
    quant: tuple
    quant_shift: tuple
    dequant: tuple
    quant_fp: tuple = (0, 0)   # (1<<16)/dequant (RDOQ fp path)
    round_fp: tuple = (0, 0)   # dequant/2 (qrounding_factor_fp=64 >> 7)


@lru_cache(maxsize=64)
def build_plane_quant(qindex: int, dc_delta: int = 0, ac_delta: int = 0,
                      bit_depth: int = 8, sharpness: int = 0,
                      base_q_idx: int | None = None) -> PlaneQuant:
    q = qindex
    qzbin = _qzbin_factor(q, bit_depth)
    qround = 64 if q == 0 else 48
    if sharpness and base_q_idx is not None:
        diff = q - base_q_idx
        if (sharpness > 0 and diff < 0) or (sharpness < 0 and diff > 0):
            off = max(sharpness << 1, abs(diff)) if sharpness > 0 else min(abs(sharpness) << 1, diff)
            qzbin += -off if sharpness > 0 else off
            qround += off if sharpness > 0 else -off
            qzbin = int(np.clip(qzbin, 1, 256))
            qround = int(np.clip(qround, 1, 256))

    out = {k: [0, 0] for k in ("zbin", "round", "quant", "quant_shift",
                               "dequant", "quant_fp", "round_fp")}
    for i in range(2):
        delta = dc_delta if i == 0 else ac_delta
        lookup = dc_q if i == 0 else ac_q
        quant_qtx = lookup(int(np.clip(q + delta, 0, 255)), bit_depth)
        qv, qs = _invert_quant(quant_qtx)
        out["quant"][i] = qv
        out["quant_shift"][i] = qs
        out["zbin"][i] = _round_pow2(qzbin * quant_qtx, 7)
        out["round"][i] = (qround * quant_qtx) >> 7
        out["dequant"][i] = quant_qtx
        out["quant_fp"][i] = (1 << 16) // quant_qtx
        out["round_fp"][i] = (64 * quant_qtx) >> 7
    return PlaneQuant(**{k: tuple(v) for k, v in out.items()})


def quantize_b(coeffs: np.ndarray, scan: np.ndarray, pq: PlaneQuant,
               log_scale: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched quantize_b (exact quantize_b_c_ii arithmetic, wt = 1<<5).

    coeffs: (batch, n) int32, raster order. Returns (qcoeff raster,
    dqcoeff raster, eob per batch in scan order).
    """
    b, n = coeffs.shape
    is_dc = np.arange(n) == 0
    zbin = np.where(is_dc, _round_pow2(pq.zbin[0], log_scale),
                    _round_pow2(pq.zbin[1], log_scale)).astype(np.int64)
    rnd = np.where(is_dc, _round_pow2(pq.round[0], log_scale),
                   _round_pow2(pq.round[1], log_scale)).astype(np.int64)
    quant = np.where(is_dc, pq.quant[0], pq.quant[1]).astype(np.int64)
    qshift = np.where(is_dc, pq.quant_shift[0], pq.quant_shift[1]).astype(np.int64)
    deq = np.where(is_dc, pq.dequant[0], pq.dequant[1]).astype(np.int64)

    c = coeffs.astype(np.int64)
    sign = np.where(c < 0, -1, 1).astype(np.int64)
    abs_c = np.abs(c)
    pass_zbin = abs_c >= zbin
    tmp = np.clip(abs_c + rnd, -32768, 32767) << AOM_QM_BITS  # wt applied
    tmp32 = (((tmp * quant) >> 16) + tmp) * qshift >> (16 - log_scale + AOM_QM_BITS)
    tmp32 = np.where(pass_zbin, tmp32, 0)
    qcoeff = (tmp32 * sign).astype(np.int32)
    dqcoeff = (((tmp32 * deq) >> log_scale) * sign).astype(np.int32)

    q_scan = tmp32[:, scan] != 0
    idx = np.arange(n)[None, :]
    eob = np.where(q_scan, idx + 1, 0).max(axis=1).astype(np.int32)
    return qcoeff, dqcoeff, eob


def quantize_fp(coeffs: np.ndarray, scan: np.ndarray, pq: PlaneQuant,
                log_scale: int, qm: np.ndarray | None = None,
                iqm: np.ndarray | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched fp quantize (quantize_fp_helper_c, full_loop.c:282): no
    zbin/quant_shift — a simple dead-zone with round = dequant/2, used
    ahead of the RDOQ trellis (which then prunes).  qm/iqm: optional
    raster weight matrices (AOM_QM_BITS fixed point)."""
    b, n = coeffs.shape
    is_dc = np.arange(n) == 0
    rnd = np.where(is_dc, _round_pow2(pq.round_fp[0], log_scale),
                   _round_pow2(pq.round_fp[1], log_scale)).astype(np.int64)
    quant = np.where(is_dc, pq.quant_fp[0], pq.quant_fp[1]).astype(np.int64)
    deq = np.where(is_dc, pq.dequant[0], pq.dequant[1]).astype(np.int64)

    c = coeffs.astype(np.int64)
    sign = np.where(c < 0, -1, 1).astype(np.int64)
    abs_c = np.abs(c)
    if qm is None:
        passes = (abs_c << (1 + log_scale)) >= deq
        t = np.clip(abs_c + rnd, -32768, 32767)
        q = np.where(passes, (t * quant) >> (16 - log_scale), 0)
        dqv = deq
    else:
        wt = qm.reshape(-1).astype(np.int64)
        iwt = iqm.reshape(-1).astype(np.int64)
        dqv = (deq * iwt + (1 << (AOM_QM_BITS - 1))) >> AOM_QM_BITS
        passes = abs_c * wt >= (deq << (AOM_QM_BITS - (1 + log_scale)))
        t = np.clip(abs_c + rnd, -32768, 32767)
        q = np.where(passes,
                     (t * wt * quant) >> (16 - log_scale + AOM_QM_BITS), 0)
    qcoeff = (q * sign).astype(np.int32)
    dqcoeff = (((q * dqv) >> log_scale) * sign).astype(np.int32)

    q_scan = q[:, scan] != 0
    idx = np.arange(n)[None, :]
    eob = np.where(q_scan, idx + 1, 0).max(axis=1).astype(np.int32)
    return qcoeff, dqcoeff, eob


# ---- quantizer matrices (spec Quantizer_Matrix; q_matrices.h) ---------------

NUM_QM_LEVELS = 16

# TX_SIZES_ALL dims in enum order (constants._TX_SIZE order)
_TX_DIMS = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
            (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
            (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]

# av1_get_adjusted_tx_size: 64-class sizes use the 32-class matrices
_ADJUST = {4: 3, 11: 3, 12: 3, 17: 9, 18: 10}


@lru_cache(maxsize=1)
def _qm_offsets() -> dict:
    """Start offset of each stored (adjusted) tx size in the concatenated
    QM layout (svt_av1_qm_init md_config_process.c:232)."""
    offs = {}
    cur = 0
    for t, (w, h) in enumerate(_TX_DIMS):
        if t in _ADJUST:
            continue
        offs[t] = cur
        cur += w * h
    assert cur == 3344
    return offs


@lru_cache(maxsize=256)
def qm_tables(level: int, is_chroma: bool, tx_size: int):
    """(wt, iwt) flat raster arrays for one tx size (clipped to the
    32-coeff region for 64-class sizes), or None at the identity level."""
    if level >= NUM_QM_LEVELS - 1:
        return None
    from ..bitstream.tables import load_tables

    t = _ADJUST.get(tx_size, tx_size)
    off = _qm_offsets()[t]
    w, h = _TX_DIMS[t]
    tabs = load_tables()
    c = 1 if is_chroma else 0
    wt = tabs["qm_wt"][level, c, off:off + w * h].astype(np.int64)
    iwt = tabs["qm_iwt"][level, c, off:off + w * h].astype(np.int64)
    # 64-class: the coded coeff region is the adjusted 32-class size
    # already, so the matrix maps 1:1
    return wt, iwt


def get_qmlevel(qindex: int, first: int, last: int) -> int:
    """aom_get_qmlevel: interpolate the configured level range by q."""
    return first + (qindex * (last + 1 - first)) // 256


def quantize_b_qm(coeffs: np.ndarray, scan: np.ndarray, pq: PlaneQuant,
                  log_scale: int, wt: np.ndarray, iwt: np.ndarray):
    """quantize_b with quantizer-matrix weights (quantize_b_helper qm
    variant): per-position wt scales the quantization, iwt scales the
    dequant exactly as the decoder derives dqv."""
    b, n = coeffs.shape
    is_dc = np.arange(n) == 0
    zbin = np.where(is_dc, _round_pow2(pq.zbin[0], log_scale),
                    _round_pow2(pq.zbin[1], log_scale)).astype(np.int64)
    rnd = np.where(is_dc, _round_pow2(pq.round[0], log_scale),
                   _round_pow2(pq.round[1], log_scale)).astype(np.int64)
    quant = np.where(is_dc, pq.quant[0], pq.quant[1]).astype(np.int64)
    qshift = np.where(is_dc, pq.quant_shift[0], pq.quant_shift[1]).astype(np.int64)
    deq = np.where(is_dc, pq.dequant[0], pq.dequant[1]).astype(np.int64)
    dqv = (deq * iwt + (1 << (AOM_QM_BITS - 1))) >> AOM_QM_BITS

    c = coeffs.astype(np.int64)
    sign = np.where(c < 0, -1, 1).astype(np.int64)
    abs_c = np.abs(c)
    pass_zbin = abs_c * wt >= (zbin << AOM_QM_BITS)
    tmp = np.clip(abs_c + rnd, -32768, 32767) * wt
    tmp32 = (((tmp * quant) >> 16) + tmp) * qshift >> (16 - log_scale + AOM_QM_BITS)
    tmp32 = np.where(pass_zbin, tmp32, 0)
    qcoeff = (tmp32 * sign).astype(np.int32)
    dqcoeff = (((tmp32 * dqv) >> log_scale) * sign).astype(np.int32)

    q_scan = tmp32[:, scan] != 0
    idx = np.arange(n)[None, :]
    eob = np.where(q_scan, idx + 1, 0).max(axis=1).astype(np.int32)
    return qcoeff, dqcoeff, eob


def noise_normalize(tcoeff: np.ndarray, qcoeff: np.ndarray,
                    dqcoeff: np.ndarray, eob: int, scan: np.ndarray,
                    dqv_ac, log_scale: int, strength: int,
                    n_coeffs_area: int):
    """PSYEX noise normalization (svt_av1_perform_noise_normalization,
    full_loop.c:1467): boost one AC coefficient whose true value sits
    close to the next quantization level (textured blocks), or revive
    the best zeroed AC coefficient near DC (flat blocks). Flat arrays;
    returns (qcoeff, dqcoeff, eob) possibly updated in place.

    dqv_ac: scalar AC dequant or per-position vector (QM path)."""
    if strength < 1 or eob == 0 or n_coeffs_area <= 16:
        return qcoeff, dqcoeff, eob
    thresh = {1: 9, 2: 8, 3: 6}.get(strength, 4)
    dqv_vec = (np.full(len(scan), int(dqv_ac), np.int64)
               if np.isscalar(dqv_ac) else np.asarray(dqv_ac, np.int64))

    def qc_dqc_low(abs_qc, sign, dqv):
        lo = abs_qc - 1
        qcl = -lo if sign else lo
        dlo = (lo * dqv) >> log_scale
        return qcl, (-dlo if sign else dlo)

    best = None
    if eob > 1:
        for si in range(1, eob):
            ci = int(scan[si])
            tqc = int(tcoeff[ci])
            qc = int(qcoeff[ci])
            dqc = int(dqcoeff[ci])
            if dqc != 0 and abs(tqc) - abs(dqc) > 0:
                sign = 1 if tqc < 0 else 0
                qcl, dql = qc_dqc_low(abs(qc) + 2, sign, int(dqv_vec[ci]))
                gap = abs(dql - tqc)
                step = abs(dql - dqc)
                if step == 0:
                    continue
                if ((step - gap) << 4) // step >= thresh:
                    best = (si, qcl, dql)  # last qualifying wins
    else:
        best_gap = None
        for si in range(1, n_coeffs_area // 16):
            ci = int(scan[si])
            tqc = int(tcoeff[ci])
            dqc = int(dqcoeff[ci])
            if dqc == 0 and tqc != 0:
                sign = 1 if tqc < 0 else 0
                qcl, dql = qc_dqc_low(2, sign, int(dqv_vec[ci]))
                gap = abs(dql - tqc)
                step = abs(dql - dqc)
                if step == 0:
                    continue
                if (((step - gap) << 4) // step >= thresh
                        and (best_gap is None or gap < best_gap)):
                    best_gap = gap
                    best = (si, qcl, dql)
    if best is not None:
        si, qcl, dql = best
        ci = int(scan[si])
        qcoeff[ci] = qcl
        dqcoeff[ci] = dql
        if si >= eob:
            eob = si + 1
    return qcoeff, dqcoeff, eob
