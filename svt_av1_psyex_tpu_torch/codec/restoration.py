"""Loop-restoration search: per-RU Wiener solve + SGR projection fit.

Counterpart: restoration_pick.c (search_wiener :1197, search_sgrproj
:560, rest_finish_search) — redesigned around small closed-form solves:

* Wiener: instead of the reference's 49x49 autocorrelation decomposition,
  alternate two 3-parameter least squares in the symmetric zero-DC-gain
  tap space (taps (t0,t1,t2), center = 128 - 2*Σt): solve vertical taps
  against the horizontally-filtered degraded signal, then horizontal
  against the vertically-filtered one. The candidate is then *exactly*
  evaluated by the bit-exact striped apply, so the solver only has to be
  good, not bit-identical.
* SGR: for each candidate ep, compute the two guided filters and solve
  the 2x2 projection least squares for (xq0, xq1) (svt_get_proj_subspace
  restoration_pick.c:413), quantize via encode_xq (:500), evaluate
  exactly.
* Unit/frame decisions: accumulate per-RU (none, wiener, sgr) RD costs
  and pick the per-plane frame_restoration_type minimizing the total,
  mirroring rest_finish_search's strategy array walk.
"""

from __future__ import annotations

import time

import numpy as np

from ..ops.restoration import (
    RESTORE_NONE,
    RESTORE_SGRPROJ,
    RESTORE_SWITCHABLE,
    RESTORE_WIENER,
    SGR_PARAMS,
    SGRPROJ_PRJ_BITS,
    SGRPROJ_PRJ_MAX0,
    SGRPROJ_PRJ_MAX1,
    SGRPROJ_PRJ_MIN0,
    SGRPROJ_PRJ_MIN1,
    SGRPROJ_PRJ_SUBEXP_K,
    SGRPROJ_RST_BITS,
    WIENER_TAPS_K,
    WIENER_TAPS_MAX,
    WIENER_TAPS_MID,
    WIENER_TAPS_MIN,
    apply_sgr,
    sgr_flt,
    unit_rows_cols,
    wiener_convolve,
    wiener_kernel7,
)
from .rd import cdf_costs

SGRPROJ_PARAMS_BITS = 4

# default ref xqd (set_default_sgrproj, C trunc-toward-zero division)
_SGR_XQD_MID = (int((SGRPROJ_PRJ_MIN0 + SGRPROJ_PRJ_MAX0) / 2),
                int((SGRPROJ_PRJ_MIN1 + SGRPROJ_PRJ_MAX1) / 2))


# ---- subexp rate counting (entropy_coding.c:2900-2945) ----------------------

def _count_quniform(n: int, v: int) -> int:
    if n <= 1:
        return 0
    l = n.bit_length()  # get_msb(n) + 1  # noqa: E741
    m = (1 << l) - n
    return l - 1 if v < m else l


def _recenter_nonneg(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def _recenter_finite(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _recenter_nonneg(r, v)
    return _recenter_nonneg(n - 1 - r, n - 1 - v)


def _count_subexpfin(n: int, k: int, v: int) -> int:
    count = 0
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            count += _count_quniform(n - mk, v - mk)
            break
        count += 1
        if v >= mk + a:
            i += 1
            mk += a
        else:
            count += b
            break
    return count


def count_refsubexpfin(n: int, k: int, ref: int, v: int) -> int:
    return _count_subexpfin(n, k, _recenter_finite(n, ref, v))


def wiener_taps_rate(taps, ref_taps, chroma: bool) -> int:
    """Bits (x512) to code one direction's 3 taps vs the running ref."""
    bits = 0
    for j in range(0 if not chroma else 1, 3):
        n = WIENER_TAPS_MAX[j] - WIENER_TAPS_MIN[j] + 1
        bits += _count_subexpfin(
            n, WIENER_TAPS_K[j],
            _recenter_finite(n, ref_taps[j] - WIENER_TAPS_MIN[j],
                             taps[j] - WIENER_TAPS_MIN[j]))
    return bits << 9


def sgr_rate(ep: int, xqd, ref_xqd) -> int:
    """Bits (x512) for one SGR unit's params vs the running ref."""
    bits = SGRPROJ_PARAMS_BITS
    r0, r1, _, _ = SGR_PARAMS[ep]
    if r0:
        n = SGRPROJ_PRJ_MAX0 - SGRPROJ_PRJ_MIN0 + 1
        bits += _count_subexpfin(
            n, SGRPROJ_PRJ_SUBEXP_K,
            _recenter_finite(n, ref_xqd[0] - SGRPROJ_PRJ_MIN0,
                             xqd[0] - SGRPROJ_PRJ_MIN0))
    if r1:
        n = SGRPROJ_PRJ_MAX1 - SGRPROJ_PRJ_MIN1 + 1
        bits += _count_subexpfin(
            n, SGRPROJ_PRJ_SUBEXP_K,
            _recenter_finite(n, ref_xqd[1] - SGRPROJ_PRJ_MIN1,
                             xqd[1] - SGRPROJ_PRJ_MIN1))
    return bits << 9


# ---- Wiener solve -----------------------------------------------------------

def _solve_sym_taps(x: np.ndarray, target: np.ndarray, axis: int):
    """LS solve for symmetric 7-tap (t0,t1,t2) along `axis`:
    prediction = x + Σ t_k u_k / 128, u_k = shift(k-3) + shift(3-k) - 2x."""
    h, w = x.shape
    if axis == 0:
        if h < 8:
            return None
        core = (slice(3, h - 3), slice(0, w))

        def sh(d):
            return x[3 + d:h - 3 + d, :]
    else:
        if w < 8:
            return None
        core = (slice(0, h), slice(3, w - 3))

        def sh(d):
            return x[:, 3 + d:w - 3 + d]

    c = sh(0).astype(np.float64)
    us = [(sh(k - 3) + sh(3 - k) - 2 * sh(0)).astype(np.float64)
          for k in range(3)]
    r = target[core].astype(np.float64) - c
    A = np.empty((3, 3))
    b = np.empty(3)
    for i in range(3):
        b[i] = (us[i] * r).sum()
        for j in range(i, 3):
            A[i, j] = A[j, i] = (us[i] * us[j]).sum()
    try:
        t = np.linalg.solve(A + np.eye(3) * 1e-6, b) * 128.0
    except np.linalg.LinAlgError:
        return None
    return t


def _quant_taps(t, chroma: bool):
    out = []
    for j in range(3):
        v = int(round(t[j]))
        if chroma and j == 0:
            v = 0
        out.append(int(np.clip(v, WIENER_TAPS_MIN[j], WIENER_TAPS_MAX[j])))
    return tuple(out)


def _filter1d(x: np.ndarray, taps, axis: int) -> np.ndarray:
    """Float separable pass used only between solver rounds."""
    k = wiener_kernel7(taps).astype(np.float64) / 128.0
    pad = np.pad(x.astype(np.float64), [(3, 3), (0, 0)] if axis == 0
                 else [(0, 0), (3, 3)], mode="edge")
    # differential kernel: identity gain added explicitly
    out = x.astype(np.float64).copy()
    for t in range(7):
        if axis == 0:
            out += k[t] * pad[t:t + x.shape[0], :]
        else:
            out += k[t] * pad[:, t:t + x.shape[1]]
    return out


def solve_wiener(dgd: np.ndarray, src: np.ndarray, chroma: bool):
    """Alternating separable solve -> candidate ((h*, v*)) tap-set list.

    The float LS optimum often lands outside the codable tap ranges
    (finalize_sym_filter clamps the same way); damped variants keep the
    filter shape while staying in range, and the caller picks by exact
    SSE of the bit-exact apply."""
    mid = WIENER_TAPS_MID if not chroma else (0,) + WIENER_TAPS_MID[1:]
    vt = _solve_sym_taps(dgd, src, axis=0)
    if vt is None:
        vt = np.array(mid, float)
    cands = []
    for scale in (1.0, 0.5, 0.25):
        vtaps = _quant_taps(vt * scale, chroma)
        zv = _filter1d(dgd, vtaps, axis=0)
        ht = _solve_sym_taps(zv, src, axis=1)
        htaps = _quant_taps(ht * scale if ht is not None else
                            np.array(mid, float), chroma)
        if (htaps, vtaps) not in cands:
            cands.append((htaps, vtaps))
    return cands


def refine_wiener(dgd_pad: np.ndarray, src: np.ndarray, htaps, vtaps,
                  chroma: bool, bit_depth: int, rounds: int = 1):
    """Greedy +-1 coordinate descent on the integer taps, scored by the
    bit-exact convolve on the (plain-padded) RU. Mirrors the role of the
    reference's finer_tile_search_wiener (restoration_pick.c)."""
    def sse_of(ht, vt):
        r = wiener_convolve(dgd_pad, ht, vt, bit_depth)
        return int(((src - r) ** 2).sum())

    best = sse_of(htaps, vtaps)
    taps = [list(htaps), list(vtaps)]
    first = 1 if chroma else 0
    for _ in range(rounds):
        improved = False
        for d in range(2):
            for j in range(first, 3):
                for step in (1, -1):
                    t = [list(taps[0]), list(taps[1])]
                    v = t[d][j] + step
                    if not (WIENER_TAPS_MIN[j] <= v <= WIENER_TAPS_MAX[j]):
                        continue
                    t[d][j] = v
                    c = sse_of(tuple(t[0]), tuple(t[1]))
                    if c < best:
                        best = c
                        taps = t
                        improved = True
                        break
        if not improved:
            break
    return tuple(taps[0]), tuple(taps[1])


# ---- SGR solve --------------------------------------------------------------

def _encode_xq(xq0: float, xq1: float, ep: int):
    """encode_xq (restoration_pick.c:500)."""
    r0, r1, _, _ = SGR_PARAMS[ep]
    if r0 == 0:
        xqd0 = 0
        xqd1 = int(np.clip(round((1 << SGRPROJ_PRJ_BITS) - xq1),
                           SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1))
    elif r1 == 0:
        xqd0 = int(np.clip(round(xq0), SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0))
        xqd1 = int(np.clip((1 << SGRPROJ_PRJ_BITS) - xqd0,
                           SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1))
    else:
        xqd0 = int(np.clip(round(xq0), SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0))
        xqd1 = int(np.clip(round((1 << SGRPROJ_PRJ_BITS) - xqd0 - xq1),
                           SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1))
    return xqd0, xqd1


def solve_sgr(padded: np.ndarray, src: np.ndarray, ep: int, bit_depth: int):
    """Projection LS (svt_get_proj_subspace semantics) -> (xqd0, xqd1)."""
    r0, r1, _, _ = SGR_PARAMS[ep]
    h, w = src.shape
    flt0, flt1 = sgr_flt(padded, ep, bit_depth)
    d = padded[3:3 + h, 3:3 + w].astype(np.float64)
    u = d * (1 << SGRPROJ_RST_BITS)
    s = src.astype(np.float64) * (1 << SGRPROJ_RST_BITS) - u
    f0 = flt0 - u if r0 else None
    f1 = flt1 - u if r1 else None
    if r0 and r1:
        h00 = (f0 * f0).sum()
        h11 = (f1 * f1).sum()
        h01 = (f0 * f1).sum()
        c0 = (f0 * s).sum()
        c1 = (f1 * s).sum()
        det = h00 * h11 - h01 * h01
        if abs(det) < 1e-9:
            return None
        xq0 = (h11 * c0 - h01 * c1) / det * (1 << SGRPROJ_PRJ_BITS)
        xq1 = (h00 * c1 - h01 * c0) / det * (1 << SGRPROJ_PRJ_BITS)
    elif r0:
        h00 = (f0 * f0).sum()
        if h00 < 1e-9:
            return None
        xq0 = (f0 * s).sum() / h00 * (1 << SGRPROJ_PRJ_BITS)
        xq1 = 0.0
    else:
        h11 = (f1 * f1).sum()
        if h11 < 1e-9:
            return None
        xq0 = 0.0
        xq1 = (f1 * s).sum() / h11 * (1 << SGRPROJ_PRJ_BITS)
    return _encode_xq(xq0, xq1, ep)


# ---- per-plane search -------------------------------------------------------

def _sgr_ep_list(preset: int):
    if preset <= 2:
        return list(range(16))
    if preset <= 6:
        return [0, 4, 9, 11, 14]
    return [4, 11]


class RestorationInfo:
    """Per-plane result: frame type, unit size, row-major unit data."""

    def __init__(self, frame_type: int, unit_size: int, units: list):
        self.frame_type = frame_type
        self.unit_size = unit_size
        self.units = units  # [(rtype, params, rate512)] row-major


def search_plane(src: np.ndarray, cdef: np.ndarray, deblock: np.ndarray,
                 plane_w: int, plane_h: int, ss_y: int, unit_size: int,
                 bit_depth: int, rdmult: int, chroma: bool, preset: int,
                 type_costs, device, note=None) -> tuple[RestorationInfo,
                                                         np.ndarray | None]:
    """Search one plane; returns (info, restored_plane or None).

    type_costs: dict with 'switchable' (3,), 'wiener' (2,), 'sgrproj' (2,)
    symbol costs (x512) from the frame CDF snapshot. device: where the
    candidate scoring runs (torch.device), unless SVT_TPU_HOST_LR=1 asks
    for the host search. note: the calling encoder's stage clock
    (Av1Encoder._note) or None; the device search adds its host tier's
    seconds to "lr.build" (the RU stacks and Wiener seeds) and "lr.exact"
    (the exact evaluation of the winners).
    """
    import os

    from ..ops.restoration import filter_unit_into

    rows, cols = unit_rows_cols(unit_size, plane_w, plane_h, ss_y)
    sw_c, wn_c, sg_c = (type_costs["switchable"], type_costs["wiener"],
                        type_costs["sgrproj"])

    def rd(rate512: int, sse: int) -> float:
        return rate512 * rdmult / 512.0 + sse * 128.0

    if os.environ.get("SVT_TPU_HOST_LR") != "1":
        cand = _cand_device(src, cdef, deblock, plane_w, plane_h, ss_y,
                            unit_size, bit_depth, chroma, preset, rows,
                            cols, rd, sw_c, device, note)
    else:
        cand = _cand_host(src, cdef, deblock, plane_w, plane_h, ss_y,
                          bit_depth, chroma, preset, rows, cols, rd,
                          sw_c)
    return _finish_search(cand, cdef, deblock, plane_w, plane_h, ss_y,
                          unit_size, bit_depth, chroma, rd, sw_c, wn_c,
                          sg_c)


def _cand_device(src, cdef, deblock, plane_w, plane_h, ss_y, unit_size,
                 bit_depth, chroma, preset, rows, cols, rd, sw_c, device,
                 note=None):
    """Device-batched candidate scoring: the Wiener init scoring + the
    +-1 steepest descent and the SGR correlations of every RU run on
    `device` (_device_search); the bit-exact striped apply evaluates only
    the single winner per type per RU."""
    from ..ops.restoration import filter_unit_into

    t = time.perf_counter() if note else 0.0
    n_ru = len(rows) * len(cols)
    # actual worst extent of THIS frame's RU grid (last row/col RUs can
    # stretch to 1.5*unit; everything else is unit(+stripe offset)) —
    # padding to the theoretical max wasted ~2x device work at 1080p
    rh_max = max(max(v1 - v0 for v0, v1 in rows),
                 max(h1 - h0 for h0, h1 in cols))
    # int32 stacks, uploaded as they are (torch's uint16 has few ops)
    pads = np.zeros((n_ru, rh_max + 6, rh_max + 6), np.int32)
    srcs = np.zeros((n_ru, rh_max, rh_max), np.int32)
    masks = np.zeros((n_ru, rh_max, rh_max), np.int32)
    lims, sse_none_l, init_cands = [], [], []
    i = 0
    for (v0, v1) in rows:
        for (h0, h1) in cols:
            s = src[v0:v1, h0:h1]
            d = cdef[v0:v1, h0:h1]
            sse_none_l.append(int(((s - d).astype(np.int64) ** 2).sum()))
            vv0, vv1 = max(v0 - 3, 0), min(v1 + 3, plane_h)
            hh0, hh1 = max(h0 - 3, 0), min(h1 + 3, plane_w)
            pad_full = np.pad(cdef[vv0:vv1, hh0:hh1],
                              ((3 - (v0 - vv0), 3 - (vv1 - v1)),
                               (3 - (h0 - hh0), 3 - (hh1 - h1))),
                              mode="edge")
            rh, rw = v1 - v0, h1 - h0
            pads[i, :rh + 6, :rw + 6] = pad_full
            srcs[i, :rh, :rw] = s
            masks[i, :rh, :rw] = 1
            lims.append((v0, v1, h0, h1))
            init_cands.append(solve_wiener(d, s, chroma))
            i += 1

    # initial damped-LS candidates, padded to a stable T0 for one
    # compiled program per plane shape
    t0 = max(len(c) for c in init_cands)
    init_taps = np.zeros((n_ru, t0, 2, 3), np.int32)
    for r_i, c in enumerate(init_cands):
        c = list(c) + [c[0]] * (t0 - len(c))
        for t_i, (ht, vt) in enumerate(c):
            init_taps[r_i, t_i, 0] = ht
            init_taps[r_i, t_i, 1] = vt

    n_rounds = 2 if preset <= 6 else 0
    eps = tuple(_sgr_ep_list(preset))
    if note:
        note("lr.build", time.perf_counter() - t)
    taps_np, best_plain, corr = _device_search(
        pads, srcs, masks, init_taps, bit_depth, n_rounds, chroma, eps,
        device)
    t = time.perf_counter() if note else 0.0
    state = [(tuple(int(v) for v in taps_np[r, 0]),
              tuple(int(v) for v in taps_np[r, 1])) for r in range(n_ru)]
    corr = corr.astype(np.float64)

    # --- exact striped eval of the winners only -------------------------
    cand = []
    stripe_cache: dict = {}
    scratch = np.empty_like(cdef)
    ref_s = [_SGR_XQD_MID[0], _SGR_XQD_MID[1]]
    for r_i, lim in enumerate(lims):
        v0, v1, h0, h1 = lim
        s = src[v0:v1, h0:h1]
        s64 = s.astype(np.int64)
        entry = {"none": (sse_none_l[r_i], 0, None)}
        if best_plain[r_i] < sse_none_l[r_i] * 2:
            htaps, vtaps = state[r_i]
            filter_unit_into(scratch, cdef, deblock, lim, RESTORE_WIENER,
                             (htaps, vtaps), plane_w, plane_h, ss_y,
                             bit_depth, stripe_cache)
            sse = int(((s64 - scratch[v0:v1, h0:h1]) ** 2).sum())
            mid = list(WIENER_TAPS_MID if not chroma
                       else (0,) + WIENER_TAPS_MID[1:])
            rate = (wiener_taps_rate(vtaps, mid, chroma)
                    + wiener_taps_rate(htaps, mid, chroma))
            entry["wiener"] = (sse, rate, (tuple(htaps), tuple(vtaps)))
        # rank eps by closed-form SSE from the correlations, with the
        # QUANTIZED-then-decoded xq (what the apply actually uses)
        best_sgr = None
        for e_i, ep in enumerate(eps):
            h00, h11, h01, c0, c1, ss_ = corr[r_i, e_i]
            r0, r1 = SGR_PARAMS[ep][0], SGR_PARAMS[ep][1]
            if r0 and r1:
                det = h00 * h11 - h01 * h01
                if abs(det) < 1e-9:
                    continue
                xq0 = (h11 * c0 - h01 * c1) / det * (1 << SGRPROJ_PRJ_BITS)
                xq1 = (h00 * c1 - h01 * c0) / det * (1 << SGRPROJ_PRJ_BITS)
            elif r0:
                if h00 < 1e-9:
                    continue
                xq0 = c0 / h00 * (1 << SGRPROJ_PRJ_BITS)
                xq1 = 0.0
            else:
                if h11 < 1e-9:
                    continue
                xq0 = 0.0
                xq1 = c1 / h11 * (1 << SGRPROJ_PRJ_BITS)
            xqd = _encode_xq(xq0, xq1, ep)
            from ..ops.restoration import decode_xq

            x0, x1 = decode_xq(xqd, ep)
            e2 = (ss_ * (1 << 14) - (1 << 8) * (x0 * c0 + x1 * c1)
                  + x0 * x0 * h00 + 2 * x0 * x1 * h01 + x1 * x1 * h11)
            sse_apx = max(e2, 0.0) / (1 << 22)
            j = rd(sgr_rate(ep, xqd, ref_s), int(sse_apx))
            if best_sgr is None or j < best_sgr[0]:
                best_sgr = (j, ep, xqd)
        if best_sgr is not None:
            _, ep, xqd = best_sgr
            filter_unit_into(scratch, cdef, deblock, lim, RESTORE_SGRPROJ,
                             (ep, xqd), plane_w, plane_h, ss_y,
                             bit_depth, stripe_cache)
            sse = int(((s64 - scratch[v0:v1, h0:h1]) ** 2).sum())
            entry["sgrproj"] = (sse, sgr_rate(ep, xqd, ref_s), (ep, xqd))
            if ("wiener" not in entry
                    or rd(entry["sgrproj"][1], sse)
                    < rd(entry["wiener"][1], entry["wiener"][0])):
                ref_s = list(xqd)
        cand.append(entry)
    if note:
        note("lr.exact", time.perf_counter() - t)
    return cand


def _device_search(pads, srcs, masks, init_taps, bit_depth, n_rounds,
                   chroma, eps, device):
    """The device tier of the LR search (device/restoration.py) on
    `device`: the Wiener descent and the SGR correlations over all RUs.
    pads/srcs/masks are the int32 RU stacks, init_taps (n_ru, T0, 2, 3)
    int32. Returns numpy (taps (n_ru, 2, 3) int32, best Wiener SSE
    (n_ru,) int64, correlations (n_ru, len(eps), 6) int64); each fetch
    waits for its device work."""
    import torch

    from ..device.restoration import sgr_corr, wiener_descent

    pads_d, srcs_d, masks_d = (torch.from_numpy(a).to(device)
                               for a in (pads, srcs, masks))
    taps, best = wiener_descent(pads_d, srcs_d, masks_d,
                                torch.from_numpy(init_taps), bit_depth,
                                n_rounds, chroma)
    taps, best = taps.cpu().numpy(), best.cpu().numpy()
    corr = sgr_corr(pads_d, srcs_d, masks_d, eps, bit_depth).cpu().numpy()
    return taps, best, corr


def _cand_host(src, cdef, deblock, plane_w, plane_h, ss_y, bit_depth,
               chroma, preset, rows, cols, rd, sw_c):
    """Original per-RU numpy search (kept as the oracle path,
    SVT_TPU_HOST_LR=1)."""
    from ..ops.restoration import filter_unit_into

    cand = []  # per RU: dict of per-type (sse, rate_payload, params)
    stripe_cache: dict = {}
    scratch = np.empty_like(cdef)
    mid_taps = list(WIENER_TAPS_MID if not chroma else (0,) + WIENER_TAPS_MID[1:])
    ref_wv, ref_wh = list(mid_taps), list(mid_taps)
    ref_s = [_SGR_XQD_MID[0], _SGR_XQD_MID[1]]
    for (v0, v1) in rows:
        for (h0, h1) in cols:
            lim = (v0, v1, h0, h1)
            s = src[v0:v1, h0:h1]
            d = cdef[v0:v1, h0:h1]
            sse_none = int(((s - d).astype(np.int64) ** 2).sum())
            entry = {"none": (sse_none, 0, None)}
            # plain (edge-clamped) RU padding for the solvers; winning
            # candidates are re-evaluated with the exact striped apply
            vv0, vv1 = max(v0 - 3, 0), min(v1 + 3, plane_h)
            hh0, hh1 = max(h0 - 3, 0), min(h1 + 3, plane_w)
            pad_full = np.pad(cdef[vv0:vv1, hh0:hh1],
                              ((3 - (v0 - vv0), 3 - (vv1 - v1)),
                               (3 - (h0 - hh0), 3 - (hh1 - h1))),
                              mode="edge")
            s64 = s.astype(np.int64)
            # wiener candidates: damped LS variants scored on the plain
            # pad, best refined by +-1 descent, then exact striped eval
            best_w = None
            for htaps, vtaps in solve_wiener(d, s, chroma):
                r = wiener_convolve(pad_full, htaps, vtaps, bit_depth)
                c = int(((s64 - r) ** 2).sum())
                if best_w is None or c < best_w[0]:
                    best_w = (c, htaps, vtaps)
            if best_w is not None and best_w[0] < sse_none * 2:
                htaps, vtaps = best_w[1], best_w[2]
                if preset <= 6:
                    htaps, vtaps = refine_wiener(pad_full, s64, htaps, vtaps,
                                                 chroma, bit_depth)
                filter_unit_into(scratch, cdef, deblock, lim, RESTORE_WIENER,
                                 (htaps, vtaps), plane_w, plane_h, ss_y,
                                 bit_depth, stripe_cache)
                r = scratch[v0:v1, h0:h1]
                sse = int(((s - r).astype(np.int64) ** 2).sum())
                rate = (wiener_taps_rate(vtaps, ref_wv, chroma)
                        + wiener_taps_rate(htaps, ref_wh, chroma))
                entry["wiener"] = (sse, rate, (htaps, vtaps))
            # sgr candidates
            best_sgr = None
            for ep in _sgr_ep_list(preset):
                xqd = solve_sgr(pad_full, s, ep, bit_depth)
                if xqd is None:
                    continue
                filter_unit_into(scratch, cdef, deblock, lim, RESTORE_SGRPROJ,
                                 (ep, xqd), plane_w, plane_h, ss_y,
                                 bit_depth, stripe_cache)
                r = scratch[v0:v1, h0:h1]
                sse = int(((s - r).astype(np.int64) ** 2).sum())
                rate = sgr_rate(ep, xqd, ref_s)
                j = rd(rate, sse)
                if best_sgr is None or j < best_sgr[0]:
                    best_sgr = (j, sse, rate, (ep, xqd))
            if best_sgr is not None:
                entry["sgrproj"] = best_sgr[1:]
            cand.append(entry)
            # running refs advance with the *best local* choice under the
            # switchable strategy (approximation; exact refs are rebuilt
            # when the frame strategy is fixed below)
            jn = rd(int(sw_c[0]), sse_none)
            jw = (rd(int(sw_c[1]) + entry["wiener"][1], entry["wiener"][0])
                  if "wiener" in entry else np.inf)
            js = (rd(int(sw_c[2]) + entry["sgrproj"][1], entry["sgrproj"][0])
                  if "sgrproj" in entry else np.inf)
            if jw <= jn and jw <= js:
                ref_wh, ref_wv = (list(entry["wiener"][2][0]),
                                  list(entry["wiener"][2][1]))
            elif js < jn:
                ref_s = list(entry["sgrproj"][2][1])
    return cand


def _finish_search(cand, cdef, deblock, plane_w, plane_h, ss_y, unit_size,
                   bit_depth, chroma, rd, sw_c, wn_c, sg_c):
    # frame-type strategies (rest_finish_search): NONE / all-WIENER /
    # all-SGR / SWITCHABLE, exact running-ref rates per strategy
    def strategy_cost(ftype: int):
        total = 0.0
        units = []
        rwv = list(WIENER_TAPS_MID if not chroma else (0,) + WIENER_TAPS_MID[1:])
        rwh = list(rwv)
        rs = [_SGR_XQD_MID[0], _SGR_XQD_MID[1]]
        for entry in cand:
            opts = []
            if ftype == RESTORE_NONE:
                opts = [("none", 0)]
            elif ftype == RESTORE_WIENER:
                opts = [("none", int(wn_c[0])), ("wiener", int(wn_c[1]))]
            elif ftype == RESTORE_SGRPROJ:
                opts = [("none", int(sg_c[0])), ("sgrproj", int(sg_c[1]))]
            else:
                opts = [("none", int(sw_c[0])), ("wiener", int(sw_c[1])),
                        ("sgrproj", int(sw_c[2]))]
            best = None
            for kind, sym_rate in opts:
                if kind not in entry:
                    continue
                sse, _, params = entry[kind]
                if kind == "wiener":
                    htaps, vtaps = params
                    rate = sym_rate + wiener_taps_rate(vtaps, rwv, chroma) \
                        + wiener_taps_rate(htaps, rwh, chroma)
                elif kind == "sgrproj":
                    rate = sym_rate + sgr_rate(params[0], params[1], rs)
                else:
                    rate = sym_rate
                j = rd(rate, sse)
                if best is None or j < best[0]:
                    best = (j, kind, params, rate)
            j, kind, params, rate = best
            total += j
            rtype = {"none": RESTORE_NONE, "wiener": RESTORE_WIENER,
                     "sgrproj": RESTORE_SGRPROJ}[kind]
            units.append((rtype, params, rate))
            if kind == "wiener":
                rwh, rwv = list(params[0]), list(params[1])
            elif kind == "sgrproj":
                rs = list(params[1])
        return total, units

    best_ft = RESTORE_NONE
    best_cost, best_units = strategy_cost(RESTORE_NONE)
    for ft in (RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE):
        c, u = strategy_cost(ft)
        if c < best_cost:
            best_cost, best_units, best_ft = c, u, ft
    info = RestorationInfo(best_ft, unit_size, best_units)
    if best_ft == RESTORE_NONE:
        return info, None
    from ..ops.restoration import filter_plane

    restored = filter_plane(cdef, deblock, unit_size,
                            [(t, p) for (t, p, _) in best_units],
                            plane_w, plane_h, ss_y, bit_depth)
    return info, restored


def type_cost_tables(cdfs) -> dict:
    return {
        "switchable": cdf_costs(cdfs.switchable_restore[0]),
        "wiener": cdf_costs(cdfs.wiener_restore[0]),
        "sgrproj": cdf_costs(cdfs.sgrproj_restore[0]),
    }
