"""Film-grain noise model: flat-block detection, AR fit, grain params.

Counterpart: the reference's noise estimation pipeline (noise_model.c —
svt_aom_flat_block_finder_run :507, add_block_observations :792,
ar_equation_system_solve :943, svt_aom_noise_strength_solver_* :248-391,
svt_aom_noise_model_get_grain_parameters :1117, driven from
svt_aom_denoise_and_model_run :2280 / pic_analysis_process.c:1398).

Everything is reformulated batched: block extraction and the low-order
plane fits are one matmul over all blocks, the AR normal equations are
X^T X over a gathered (pixels, taps) matrix — MXU-shaped work, kept in
numpy here because it runs once per keyframe interval on one frame.

Deviation from the reference: the reference estimates noise as
(source - FFT-Wiener-denoised); we use (source - per-block plane fit)
inside flat blocks, which is the same quantity the flat-block finder
scores.  A full Wiener denoiser (and --film-grain-denoise apply) can sit
on top later; the fitted AR/scaling parameters drive the same normative
grain synthesis (ops/film_grain.py).
"""

from __future__ import annotations

import numpy as np

LAG = 3
BLOCK = 32
NUM_BINS = 20
# causal square neighborhood, synthesis scan order (noise_model_init):
# rows dy=-lag..-1 full width, then dy=0 with dx<0  -> 2*lag*(lag+1) taps
COORDS = [(dx, dy) for dy in range(-LAG, 1)
          for dx in range(-LAG, (0 if dy == 0 else LAG + 1))]
N_COORDS = len(COORDS)  # 24


def _plane_basis(bs: int) -> tuple[np.ndarray, np.ndarray]:
    """A (n,3) low-poly basis and (A^T A)^-1 A^T (flat_block_finder_init)."""
    ys, xs = np.mgrid[0:bs, 0:bs].astype(np.float64)
    yd = (ys - bs / 2.0) / (bs / 2.0)
    xd = (xs - bs / 2.0) / (bs / 2.0)
    a = np.stack([yd.reshape(-1), xd.reshape(-1),
                  np.ones(bs * bs)], axis=1)
    pinv = np.linalg.solve(a.T @ a, a.T)
    return a, pinv


def _extract_blocks(plane: np.ndarray, bs: int) -> tuple[np.ndarray, int, int]:
    """Edge-clamped (nby*nbx, bs, bs) float blocks normalized to [0,1]."""
    h, w = plane.shape
    nbx = (w + bs - 1) // bs
    nby = (h + bs - 1) // bs
    pad = np.pad(plane.astype(np.float64),
                 ((0, nby * bs - h), (0, nbx * bs - w)), mode="edge")
    blocks = (pad.reshape(nby, bs, nbx, bs).transpose(0, 2, 1, 3)
              .reshape(nby * nbx, bs, bs))
    return blocks, nby, nbx


def flat_blocks_and_planes(plane: np.ndarray, bit_depth: int = 8,
                           bs: int = BLOCK):
    """Vectorized svt_aom_flat_block_finder_run: returns (flat mask
    (nby, nbx) uint8 with 255 = thresholded flat / 1 = percentile union,
    plane-fit 'denoised' image, nby, nbx)."""
    norm = (1 << bit_depth) - 1
    blocks, nby, nbx = _extract_blocks(plane, bs)
    blocks = blocks / norm
    a, pinv = _plane_basis(bs)
    flat = blocks.reshape(-1, bs * bs)
    coeffs = flat @ pinv.T                      # (nb, 3)
    fit = coeffs @ a.T                          # (nb, n)
    resid = (flat - fit).reshape(-1, bs, bs)

    inner = resid[:, 1:-1, 1:-1]
    gx = (resid[:, 1:-1, 2:] - resid[:, 1:-1, :-2]) / 2
    gy = (resid[:, 2:, 1:-1] - resid[:, :-2, 1:-1]) / 2
    m = (bs - 2) * (bs - 2)
    g_xx = (gx * gx).sum((1, 2)) / m
    g_xy = (gx * gy).sum((1, 2)) / m
    g_yy = (gy * gy).sum((1, 2)) / m
    mean = inner.sum((1, 2)) / m
    var = (inner * inner).sum((1, 2)) / m - mean * mean

    trace = g_xx + g_yy
    det = g_xx * g_yy - g_xy * g_xy
    disc = np.sqrt(np.maximum(trace * trace - 4 * det, 0))
    e1 = (trace + disc) / 2
    e2 = (trace - disc) / 2
    ratio = e1 / np.maximum(e2, 1e-6)

    k_trace = 0.15 / (32 * 32)
    k_ratio = 1.25
    k_norm = 0.08 / (32 * 32)
    k_var = 0.005 / (bs * bs)
    is_flat = ((trace < k_trace) & (ratio < k_ratio) & (e1 < k_norm)
               & (var > k_var))
    w = (-6682, -0.2056, 13087, -12434, 2.5694)
    score = 1.0 / (1 + np.exp(-(w[0] * var + w[1] * ratio + w[2] * trace
                                + w[3] * e1 + w[4])))
    score = np.where(var > k_var, score, 0.0)

    mask = np.where(is_flat, 255, 0).astype(np.uint8)
    # union with the top 10th percentile of scores (finder_run tail)
    order = np.argsort(score, kind="stable")
    thresh = score[order[len(order) * 90 // 100]]
    mask |= (score >= thresh).astype(np.uint8)

    # plane-fit reconstruction as the 'denoised' estimate
    h, wd = plane.shape
    den = (fit.reshape(nby, nbx, bs, bs).transpose(0, 2, 1, 3)
           .reshape(nby * bs, nbx * bs))[:h, :wd] * norm
    return mask.reshape(nby, nbx), den, nby, nbx


def _eligible_mask(flat: np.ndarray, bsc: int, h: int, w: int,
                   lag: int) -> np.ndarray:
    """Per-pixel eligibility of AR observations (add_block_observations
    y_start/x_start/x_end rules), vectorized over the plane grid.
    bsc: block size in this plane's units; flat: (nby, nbx) bool."""
    nby, nbx = flat.shape
    ys, xs = np.mgrid[0:h, 0:w]
    by, bx = ys // bsc, xs // bsc
    by = np.minimum(by, nby - 1)
    bx = np.minimum(bx, nbx - 1)
    yin, xin = ys - by * bsc, xs - bx * bsc
    f = flat[by, bx]
    up = np.zeros_like(f)
    up[bsc:, :] = flat[np.maximum(by[bsc:, :] - 1, 0), bx[bsc:, :]]
    left = np.zeros_like(f)
    left[:, bsc:] = flat[by[:, bsc:], np.maximum(bx[:, bsc:] - 1, 0)]
    right = np.zeros_like(f)
    right[:, :-bsc] = flat[by[:, :-bsc], np.minimum(bx[:, :-bsc] + 1,
                                                    nbx - 1)]
    ok = f.astype(bool)
    ok &= (yin >= lag) | up.astype(bool)
    ok &= (xin >= lag) | left.astype(bool)
    ok &= (xin < bsc - lag) | right.astype(bool)
    # stay inside the real plane with the full neighborhood
    ok &= (ys >= lag) & (xs >= lag) & (xs < w - lag)
    return ok


def _gather_ar(resid: np.ndarray, ok: np.ndarray, lag: int,
               alt_resid: np.ndarray | None = None,
               sub: tuple[int, int] = (0, 0)):
    """(X, v): neighborhood matrix over eligible pixels + center values.
    alt_resid (luma residual) adds the luma-correlation column for
    chroma (extract_ar_row buffer[num_coords])."""
    ys, xs = np.nonzero(ok)
    cols = [resid[ys + dy, xs + dx] for dx, dy in COORDS]
    if alt_resid is not None:
        sx, sy = sub
        ah, aw = alt_resid.shape
        acc = np.zeros(len(ys), np.float64)
        for dy in range(1 << sy):
            for dx in range(1 << sx):
                acc += alt_resid[np.minimum((ys << sy) + dy, ah - 1),
                                 np.minimum((xs << sx) + dx, aw - 1)]
        cols.append(acc / (1 << (sx + sy)))
    x = np.stack(cols, axis=1)
    v = resid[ys, xs]
    return x, v


class _Strength:
    """Noise-strength-vs-intensity solver (bins + smoothness prior)."""

    def __init__(self, bit_depth: int):
        n = NUM_BINS
        self.n = n
        self.max_i = (1 << bit_depth) - 1
        self.a = np.zeros((n, n))
        self.b = np.zeros(n)
        self.total = 0.0
        self.num_eq = 0
        self.x = np.zeros(n)

    def _bin(self, value):
        v = np.clip(value, 0, self.max_i)
        return (self.n - 1) * v / self.max_i

    def add(self, block_mean: float, noise_std: float) -> None:
        b = self._bin(block_mean)
        i0 = int(np.floor(b))
        i1 = min(self.n - 1, i0 + 1)
        a = b - i0
        self.a[i0, i0] += (1 - a) * (1 - a)
        self.a[i1, i0] += a * (1 - a)
        self.a[i1, i1] += a * a
        self.a[i0, i1] += a * (1 - a)
        self.b[i0] += (1 - a) * noise_std
        self.b[i1] += a * noise_std
        self.total += noise_std
        self.num_eq += 1

    def solve(self) -> bool:
        if self.num_eq == 0:
            return False
        n = self.n
        a = self.a.copy()
        b = self.b.copy()
        alpha = 2.0 * self.num_eq / n
        for i in range(n):
            a[i, max(0, i - 1)] -= alpha
            a[i, i] += 2 * alpha
            a[i, min(n - 1, i + 1)] -= alpha
        mean = self.total / self.num_eq
        a[np.arange(n), np.arange(n)] += 1.0 / 8192
        b += mean / 8192
        try:
            self.x = np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            return False
        return True

    def value_at(self, intensity: float) -> float:
        b = self._bin(intensity)
        i0 = int(np.floor(b))
        i1 = min(self.n - 1, i0 + 1)
        a = b - i0
        return (1 - a) * self.x[i0] + a * self.x[i1]

    def center(self, i: int) -> float:
        return i / (self.n - 1) * self.max_i

    def fit_piecewise(self, max_points: int) -> list:
        """Greedy point removal (fit_piecewise, noise_model.c:351)."""
        tol = self.max_i * 0.00625 / 255.0
        pts = [[self.center(i), float(self.x[i])] for i in range(self.n)]

        def residual_at(i):
            lower = max(0, int(np.floor(self._bin(pts[i - 1][0]))))
            upper = min(self.n - 1, int(np.ceil(self._bin(pts[i + 1][0]))))
            r = 0.0
            for j in range(lower, upper + 1):
                x = self.center(j)
                if x < pts[i - 1][0] or x >= pts[i + 1][0]:
                    continue
                a = (x - pts[i - 1][0]) / (pts[i + 1][0] - pts[i - 1][0])
                est = pts[i - 1][1] * (1 - a) + pts[i + 1][1] * a
                r += abs(float(self.x[j]) - est)
            return r * 255.0 / self.n

        res = [0.0] * len(pts)
        for i in range(1, len(pts) - 1):
            res[i] = residual_at(i)
        while len(pts) > 2:
            mi = 1 + int(np.argmin(res[1 : len(pts) - 1]))
            dx = pts[mi + 1][0] - pts[mi - 1][0]
            if len(pts) <= max_points and res[mi] / dx > tol:
                break
            del pts[mi]
            del res[mi]
            for i in (mi - 1, mi):
                if 1 <= i < len(pts) - 1:
                    res[i] = residual_at(i)
        return pts


def estimate_grain_params(planes: list[np.ndarray], bit_depth: int = 8,
                          ss: tuple[int, int] = (1, 1),
                          bs: int = BLOCK) -> dict | None:
    """Fit AR grain parameters + scaling points from one source frame.

    Returns a dict shaped for ops/film_grain.py's FilmGrainParams
    consumers, or None when no usable noise estimate exists (too few
    flat blocks / singular fit).  Mirrors denoise_and_model_run with the
    plane-fit residual as the noise estimate.
    """
    norm = (1 << bit_depth) - 1
    y = planes[0].astype(np.float64)
    h, w = y.shape
    flat, den_y, nby, nbx = flat_blocks_and_planes(planes[0], bit_depth, bs)
    fmask = flat > 0
    if fmask.sum() < 2:  # noise_model_update INSUFFICIENT_FLAT_BLOCKS
        return None

    resid_y = (y - den_y) / norm
    ok_y = _eligible_mask(fmask, bs, h, w, LAG)
    if ok_y.sum() < 16 * N_COORDS:
        return None
    xm, v = _gather_ar(resid_y, ok_y, LAG)
    coeffs = [None, None, None]
    gains = [1.0, 1.0, 1.0]
    solvers = [_Strength(bit_depth) for _ in range(3)]

    def fit(xm, v, is_chroma):
        a = xm.T @ xm
        b = xm.T @ v
        try:
            x = np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            return None, 1.0
        nobs = len(v)
        n = a.shape[0]
        var = float(np.trace(a[: n - is_chroma, : n - is_chroma])
                    / (nobs * (n - is_chroma)))
        bi = b[: n - is_chroma].copy()
        if is_chroma:
            bi -= a[: n - is_chroma, n - 1] * x[n - 1]
        sum_covar = float(bi @ x[: n - is_chroma]) / nobs
        noise_var = max(var - sum_covar, 1e-6)
        gain = max(1.0, np.sqrt(max(var / noise_var, 1e-6)))
        return x, gain

    coeffs[0], gains[0] = fit(xm, v, 0)
    if coeffs[0] is None:
        return None

    # per-flat-block strength measurements (add_noise_std_observations)
    def strengths(c, plane, den, subc, alt_mean_plane):
        bsc = bs >> subc[1]
        hh, ww = plane.shape
        resid = plane.astype(np.float64) - den
        for by in range(nby):
            for bx in range(nbx):
                if not fmask[by, bx]:
                    continue
                y0, x0 = by * bsc, bx * bsc
                nsh = min(hh - y0, bsc)
                nsw = min(ww - x0, bsc)
                if nsh * nsw <= bs:
                    continue
                blk = resid[y0 : y0 + nsh, x0 : x0 + nsw]
                noise_var = float(blk.var())
                mean = float(alt_mean_plane[(y0 << subc[1]) :
                                            (y0 << subc[1]) + (nsh << subc[1]),
                                            (x0 << subc[0]) :
                                            (x0 << subc[0]) + (nsw << subc[0])
                                            ].mean())
                if c > 0:
                    luma_strength = gains[0] * solvers[0].value_at(mean)
                    corr = float(coeffs[c][N_COORDS])
                    uncorr = np.sqrt(max(noise_var / 16,
                                         noise_var
                                         - (corr * luma_strength) ** 2))
                    adj = uncorr / gains[c]
                else:
                    adj = np.sqrt(noise_var) / gains[c]
                solvers[c].add(mean, adj)

    strengths(0, y, den_y, (0, 0), y)
    if not solvers[0].solve():
        return None

    mono = len(planes) < 3
    if not mono:
        for c in (1, 2):
            pc = planes[c].astype(np.float64)
            hc, wc = pc.shape
            _, den_c, _, _ = flat_blocks_and_planes(planes[c], bit_depth,
                                                    max(bs >> ss[1], 8))
            # chroma uses the luma flat mask at chroma resolution
            resid_c = (pc - den_c) / norm
            bsc = bs >> ss[1]
            ok_c = _eligible_mask(fmask, bsc, hc, wc, LAG)
            if ok_c.sum() >= 16 * (N_COORDS + 1):
                xc, vc = _gather_ar(resid_c, ok_c, LAG, resid_y, ss)
                coeffs[c], gains[c] = fit(xc, vc, 1)
            if coeffs[c] is None:
                coeffs[c] = np.zeros(N_COORDS + 1)
                gains[c] = 1.0
            strengths(c, pc, den_c, ss, y)
            solvers[c].solve()

    # ---- conversion (svt_aom_noise_model_get_grain_parameters) --------
    pts = [solvers[0].fit_piecewise(14)]
    if not mono:
        pts += [solvers[c].fit_piecewise(10) for c in (1, 2)]
    else:
        pts += [[], []]
    strength_div = 1 << (bit_depth - 8)
    max_scale = 1e-4
    for p in pts:
        for q in p:
            q[0] = min(255.0, q[0] / strength_div)
            q[1] = min(255.0, q[1] / strength_div)
            max_scale = max(max_scale, q[1])
    msl2 = int(np.clip(np.floor(np.log2(max_scale) + 1), 2, 5))
    scaling_shift = 5 + (8 - msl2)
    scale_factor = 1 << (8 - msl2)
    scaling = []
    for p in pts:
        sp = []
        for q in p:
            xq = int(q[0] + 0.5)
            yq = int(np.clip(scale_factor * q[1] + 0.5, 0, 255))
            if sp and xq <= sp[-1][0]:  # strictly increasing x
                continue
            sp.append((xq, yq))
        scaling.append(sp)
    if len(scaling[0]) < 2 or max(v for _, v in scaling[0]) == 0:
        return None

    max_c = 1e-4
    min_c = -1e-4
    y_corr = [0.0, 0.0]
    for c in range(3 if not mono else 1):
        x = coeffs[c]
        if x is None:
            continue
        max_c = max(max_c, float(np.max(x[:N_COORDS])))
        min_c = min(min_c, float(np.min(x[:N_COORDS])))
        if c > 0:
            sol = solvers[c]
            wgt = np.sqrt(np.maximum(sol.a.sum(axis=1), 0))
            tw = wgt.sum()
            avg = float((sol.x * wgt).sum() / tw) if tw > 0 else 1.0
            sol0 = solvers[0]
            w0 = np.sqrt(np.maximum(sol0.a.sum(axis=1), 0))
            avg0 = (float((sol0.x * w0).sum() / w0.sum())
                    if w0.sum() > 0 else 1.0)
            y_corr[c - 1] = avg0 * float(x[N_COORDS]) / max(avg, 1e-6)
            max_c = max(max_c, y_corr[c - 1])
            min_c = min(min_c, y_corr[c - 1])
    ar_shift = int(np.clip(7 - max(1 + np.floor(np.log2(max_c)),
                                   np.ceil(np.log2(-min_c))), 6, 9))
    sc = 1 << ar_shift

    def quant(x, extra=None):
        out = [int(np.clip(round(sc * float(t)), -128, 127))
               for t in x[:N_COORDS]]
        if extra is not None:
            out.append(int(np.clip(round(sc * extra), -128, 127)))
        return out

    return {
        "ar_coeff_lag": LAG,
        "ar_coeff_shift": ar_shift,
        "scaling_shift": scaling_shift,
        "scaling_points_y": scaling[0],
        "scaling_points_cb": scaling[1] if not mono else [],
        "scaling_points_cr": scaling[2] if not mono else [],
        "ar_coeffs_y": quant(coeffs[0]),
        "ar_coeffs_cb": (quant(coeffs[1], y_corr[0])
                         if not mono and coeffs[1] is not None else []),
        "ar_coeffs_cr": (quant(coeffs[2], y_corr[1])
                         if not mono and coeffs[2] is not None else []),
        "chroma_scaling_from_luma": False,
        "grain_scale_shift": 0,
        "overlap_flag": True,
        "cb_mult": 128, "cb_luma_mult": 192, "cb_offset": 256,
        "cr_mult": 128, "cr_luma_mult": 192, "cr_offset": 256,
    }
