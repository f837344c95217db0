"""Global motion estimation from the batched ME motion field.

Counterpart: the reference's corner-detect + correspondence + RANSAC
pipeline (global_motion.c:368, ransac.c, corner_detect.c, fastfeat).
Redesigned for this encoder's data: the device ME tier already computes
a dense full-pel motion field for every 16x16 block of the frame
(device/me.py), so instead of re-detecting sparse corners we fit the
model to that field directly with iteratively-reweighted least squares
(IRLS) — the robust-fitting role RANSAC plays in the reference, but as
a handful of vectorized numpy normal-equation solves.

Model fitting is float; parameters are quantized to the header
precision (bitstream/headers.py quantize_gm_param), shear-validated for
warpability (ops/warp.py), and accepted only when the model's SAD on a
decimated plane beats the best translation by a margin (the reference's
erroradv gate, global_motion.h GM_ERRORADV_*).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.headers import (
    GM_AFFINE,
    GM_DEFAULT_MAT,
    GM_IDENTITY,
    GM_ROTZOOM,
    GM_TRANSLATION,
    quantize_gm_param,
)
from ..ops.warp import get_shear_params, project_mv

ONE = 1 << 16


@dataclass
class GlobalMotion:
    gm_type: int = GM_IDENTITY
    mat: tuple = GM_DEFAULT_MAT
    shear: tuple = (0, 0, 0, 0)  # alpha..delta, valid for gm_type >= ROTZOOM

    @property
    def is_identity(self) -> bool:
        return self.gm_type == GM_IDENTITY

    def block_mv(self, mi_row: int, mi_col: int, bw: int, bh: int,
                 allow_hp: bool = False, force_int: bool = False):
        """(row, col) 1/8-pel GLOBALMV for a block (spec 7.10.2.10)."""
        return project_mv(self.mat, self.gm_type, mi_row, mi_col, bw, bh,
                          allow_hp, force_int)


def _field_from_me(me_map: dict, w: int, h: int):
    """(pts (N, 2) block centers px, mvs (N, 2) full-pel dy/dx) from the
    device ME lattice's 16x16 geometry."""
    g = me_map.get((16, 16))
    if g is None:
        return None, None
    mv = g["mv"].astype(np.float64)            # (gy, gx, 2) full-pel
    gy, gx = mv.shape[:2]
    ys = (np.arange(gy) * 16 + 8.0)
    xs = (np.arange(gx) * 16 + 8.0)
    pts = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1)
    keep = (pts[..., 0] < h) & (pts[..., 1] < w)
    return pts[keep], mv[keep]


def _fit_irls(pts, mvs, kind: str, iters: int = 6):
    """IRLS fit of dst = A @ src + t.  pts (N,2) as (y, x); mvs (N,2)
    full-pel (dy, dx). Returns float mat6 [t_x, t_y, a_xx, a_xy, a_yx,
    a_yy] in PIXEL units (model-unit scaling happens at quantization),
    or None."""
    if pts is None or len(pts) < 8:
        return None
    src = pts[:, ::-1]                          # (x, y)
    dst = src + mvs[:, ::-1]
    # center for conditioning
    c = src.mean(axis=0)
    sx = src - c
    dx = dst - c
    wgt = np.ones(len(src))
    for _ in range(iters):
        sw = np.sqrt(wgt)[:, None]
        if kind == "translation":
            t = ((dx - sx) * sw ** 2).sum(0) / (sw ** 2).sum()
            a = np.eye(2)
        elif kind == "rotzoom":
            # dst_x = a*x - b*y + tx ; dst_y = b*x + a*y + ty
            m = np.zeros((2 * len(sx), 4))
            m[0::2, 0] = sx[:, 0]
            m[0::2, 1] = -sx[:, 1]
            m[0::2, 2] = 1
            m[1::2, 0] = sx[:, 1]
            m[1::2, 1] = sx[:, 0]
            m[1::2, 3] = 1
            rhs = dx.reshape(-1)
            ww = np.repeat(sw[:, 0], 2)
            sol, *_ = np.linalg.lstsq(m * ww[:, None], rhs * ww,
                                      rcond=None)
            a = np.array([[sol[0], -sol[1]], [sol[1], sol[0]]])
            t = sol[2:4]
        else:  # affine
            m = np.concatenate([sx, np.ones((len(sx), 1))], axis=1)
            sol, *_ = np.linalg.lstsq(m * sw, dx * sw, rcond=None)
            a = sol[:2].T
            t = sol[2]
        pred = sx @ a.T + t
        resid = np.abs(pred - dx).sum(axis=1)
        wgt = 1.0 / (1.0 + resid)
        wgt[resid > 32] = 0.0                   # hard outlier cut (px)
    if not np.isfinite(a).all() or not np.isfinite(t).all():
        return None
    # un-center: dst = a @ (src - c) + c + t
    t_full = t + c - a @ c
    return np.array([t_full[0], t_full[1], a[0, 0], a[0, 1],
                     a[1, 0], a[1, 1]])


def _quantize(kind: int, p) -> tuple | None:
    """Float pixel-unit params -> spec model-unit mat6, header-quantized.
    p = [tx, ty, axx, axy, ayx, ayy] (x' = axx x + axy y + tx)."""
    mat = [0, 0, ONE, 0, 0, ONE]
    mat[2] = quantize_gm_param(kind, 2, int(round(p[2] * ONE)))
    mat[3] = quantize_gm_param(kind, 3, int(round(p[3] * ONE)))
    if kind == GM_AFFINE:
        mat[4] = quantize_gm_param(kind, 4, int(round(p[4] * ONE)))
        mat[5] = quantize_gm_param(kind, 5, int(round(p[5] * ONE)))
    elif kind == GM_ROTZOOM:
        mat[4] = -mat[3]
        mat[5] = mat[2]
    if kind == GM_TRANSLATION:
        mat[2], mat[3], mat[4], mat[5] = ONE, 0, 0, ONE
        # TRANSLATION stores (row, col) in mat[0], mat[1] (libaom/dav1d
        # layout; see ops/warp.py project_mv)
        mat[0] = quantize_gm_param(kind, 0, int(round(p[1] * ONE)))
        mat[1] = quantize_gm_param(kind, 1, int(round(p[0] * ONE)))
        return tuple(mat)
    mat[0] = quantize_gm_param(kind, 0, int(round(p[0] * ONE)))
    mat[1] = quantize_gm_param(kind, 1, int(round(p[1] * ONE)))
    return tuple(mat)


def _sad(a, b) -> float:
    return float(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def _warp_sad_probe(src, ref, mat, gm_type, shear, n_probe: int = 16,
                    rng_seed: int = 7) -> float:
    """SAD of the model's prediction over a deterministic sample of
    16x16 probe blocks (full-res; cheap: n_probe blocks only)."""
    from ..ops import warp as W

    h, w = src.shape
    rng = np.random.RandomState(rng_seed)
    ys = rng.randint(0, max(1, (h - 24) // 8), n_probe) * 8 + 8
    xs = rng.randint(0, max(1, (w - 24) // 8), n_probe) * 8 + 8
    total = 0.0
    for y0, x0 in zip(ys, xs):
        if gm_type >= GM_ROTZOOM:
            pred = W.warp_plane(ref, mat, shear, int(x0), int(y0), 16, 16)
        else:
            mv_r, mv_c = project_mv(mat, gm_type, int(y0) // 4, int(x0) // 4,
                                    16, 16, False, False)
            yy = int(np.clip(y0 + mv_r // 8, 0, h - 16))
            xx = int(np.clip(x0 + mv_c // 8, 0, w - 16))
            pred = ref[yy:yy + 16, xx:xx + 16]
        total += _sad(src[y0:y0 + 16, x0:x0 + 16], pred)
    return total


def estimate_global_motion(src: np.ndarray, ref: np.ndarray, me_map: dict,
                           max_type: int = GM_AFFINE) -> GlobalMotion:
    """Fit/validate a global model of `ref` -> `src` motion.

    src/ref: full-res luma planes; me_map: the ref's device ME lattice
    (device/me.py unpack_me output). Returns IDENTITY unless a model
    meaningfully beats both the zero and best-translation SADs
    (erroradv-style gate)."""
    h, w = src.shape[:2]
    pts, mvs = _field_from_me(me_map, w, h)
    if pts is None or len(pts) < 16:
        return GlobalMotion()
    # motion magnitude gate: a static scene never pays for gm bits
    med = np.median(np.abs(mvs), axis=0)
    if med.sum() < 0.9:
        return GlobalMotion()

    zero_sad = _warp_sad_probe(src, ref, GM_DEFAULT_MAT, GM_IDENTITY,
                               (0, 0, 0, 0))
    best = GlobalMotion()
    best_sad = zero_sad * 0.98

    kinds = [(GM_TRANSLATION, "translation")]
    if max_type >= GM_ROTZOOM:
        kinds.append((GM_ROTZOOM, "rotzoom"))
    if max_type >= GM_AFFINE:
        kinds.append((GM_AFFINE, "affine"))
    for kind, name in kinds:
        p = _fit_irls(pts, mvs, name)
        if p is None:
            continue
        mat = _quantize(kind, p)
        if mat is None or mat == GM_DEFAULT_MAT:
            continue
        shear = (0, 0, 0, 0)
        if kind >= GM_ROTZOOM:
            ok, *shear = get_shear_params(mat)
            if not ok:
                continue
            shear = tuple(shear)
        sad = _warp_sad_probe(src, ref, mat, kind, shear)
        # progressively require more gain for more parameters
        margin = {GM_TRANSLATION: 0.9, GM_ROTZOOM: 0.85,
                  GM_AFFINE: 0.82}[kind]
        if sad < best_sad * margin or (best.gm_type == GM_IDENTITY
                                       and sad < best_sad):
            best = GlobalMotion(kind, mat, tuple(shear))
            best_sad = sad
    return best
