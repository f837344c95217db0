"""The plain PyTorch version of the CDEF kernel (ops/cuda/cdef.cu).

The three functions do what the host C does (native/cdef.c at the root of
the repository: `svt_cdef_dirs`, `svt_cdef_search`, `svt_cdef_apply`), on
the frame contract of native/cdefc.py `cdef_search_frame_c`, with one
difference of layout: they take the recon and source planes as the
encoder holds them, with the coded area's size, and read every sample
outside the coded area as CDEF_VERY_LARGE themselves (the C takes planes
padded so by device/cdef.py `_prep_frame`). Everything is integer but the
luma distortion, which is enc_cdef.c's `dist_8xn` in float64, operation
for operation as the C has it; its product `svar * dvar` is an integer
below 2^53 at 8 and 10 bits, so a fused multiply-add rounds it the same.
So the tables and planes equal the C's bit for bit.

The geometry: nv8p x nh8p 8x8 units (the frame padded to whole 64x64
filter blocks, nhfb of them a row), unit index by * nh8p + bx; chroma
(4:2:0) units are 4x4. `unit_mask` and `search_units` give the units the
C filters and searches, from the frame's skip grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device.cdef import (
    _TAP_DX,
    _TAP_DY,
    _adjust_strength,
    _blocked,
    _combine,
    _find_dir,
    _pri_sum,
    _sec_sum,
    _strengths,
)
from .cdef import _SEARCH_SUBSAMPLE, CDEF_VERY_LARGE


def unit_mask(skip_g: np.ndarray, mi_rows: int, mi_cols: int):
    """The filterable units of the grid, (nv8p, nh8p) uint8, or None when
    none is (device/cdef.py `_prep_frame`'s mask: a unit is filtered when
    any of its four mode-info cells is not a skip)."""
    nvfb, nhfb = (mi_rows + 15) // 16, (mi_cols + 15) // 16
    g = ~skip_g.astype(bool)
    nonskip = g[0::2, 0::2] | g[1::2, 0::2] | g[0::2, 1::2] | g[1::2, 1::2]
    if not nonskip.any():
        return None
    mask = np.zeros((nvfb * 8, nhfb * 8), np.uint8)
    mask[:mi_rows // 2, :mi_cols // 2] = nonskip
    return mask


def search_units(mask: np.ndarray, level: int) -> np.ndarray:
    """The units the search reads, int32 indices in raster order: every
    filterable unit, or at the fast levels every ss-th of them and the
    first of each run of one filter block (native/cdefc.py's search mask,
    the reference's subsampling_factor)."""
    nh8p = mask.shape[1]
    act = np.flatnonzero(mask)
    ss = _SEARCH_SUBSAMPLE.get(level, 1)
    if ss > 1:
        keep = np.zeros(mask.size, bool)
        keep[act[::ss]] = True
        fbidx = (act // nh8p // 8) * (nh8p // 8) + (act % nh8p) // 8
        keep[act[np.r_[True, fbidx[1:] != fbidx[:-1]]]] = True
        act = np.flatnonzero(keep)
    return act.astype(np.int32)


def _padded(plane: torch.Tensor, coded, grid) -> torch.Tensor:
    """The plane over the grid with a 2-sample border, CDEF_VERY_LARGE
    outside the coded area (native/cdefc.py's padded planes)."""
    gh, gw = grid
    ph, pw = min(coded[0], gh), min(coded[1], gw)
    out = torch.full((gh + 4, gw + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=plane.device)
    out[2: 2 + ph, 2: 2 + pw] = plane[:ph, :pw]
    return out


def _taps(pad: torch.Tensor, units: torch.Tensor, nh8p: int, bs: int,
          dirs: torch.Tensor):
    """The filter's inputs at `units` of a padded plane: (x (n, bs, bs),
    P, |P - x|, sign(P - x) (12, n, bs, bs)), the 12 taps in
    device/cdef.py's order for each unit's direction."""
    pw = pad.shape[1]
    dev = pad.device
    flat = pad.reshape(-1)
    i = torch.arange(bs, device=dev)
    by, bx = (units // nh8p).long(), (units % nh8p).long()
    base = ((2 + by[:, None, None] * bs + i[None, :, None]) * pw
            + 2 + bx[:, None, None] * bs + i[None, None, :])
    d = dirs.long()
    off = (torch.as_tensor(_TAP_DY, device=dev)[:, d] * pw
           + torch.as_tensor(_TAP_DX, device=dev)[:, d])        # (12, n)
    x = flat[base]
    p = flat[base[None] + off[:, :, None, None]]
    diff = p - x[None]
    return x, p, diff.abs(), diff.sign()


def _filter(pad, units, nh8p, bs, dirs, pri, sec, damping, cs):
    """svt_cdef_filter_block_c on each unit: pri, sec (n,) strengths as
    the C passes them (luma's primary already adjusted), dirs (n,) the
    direction it passes (0 where the primary strength is 0)."""
    taps = _taps(pad, units, nh8p, bs, dirs)
    return _combine(taps, _pri_sum(taps, pri, damping, cs),
                    _sec_sum(taps, sec, damping))


def _dist_8x8(src: torch.Tensor, dst: torch.Tensor, cs: int) -> torch.Tensor:
    """enc_cdef.c dist_8xn as native/cdef.c `dist_8x8` computes it:
    (n, 8, 8) -> (n,) int64, the integer sums exact, then the same float64
    operations in the same order."""
    s = src.reshape(-1, 64).to(torch.int64)
    d = dst.reshape(-1, 64).to(torch.int64)
    sum_s, sum_d = s.sum(1), d.sum(1)
    sum_s2, sum_d2, sum_sd = (s * s).sum(1), (d * d).sum(1), (s * d).sum(1)
    svar = (sum_s2 - torch.div(sum_s * sum_s + 32, 64,
                               rounding_mode="trunc")).double()
    dvar = (sum_d2 - torch.div(sum_d * sum_d + 32, 64,
                               rounding_mode="trunc")).double()
    num = ((sum_d2 + sum_s2 - 2 * sum_sd).double() * 0.5
           * ((svar + dvar) + float(400 << (2 * cs))))
    den = torch.sqrt(float(20000 << (4 * cs)) + svar * dvar)
    return torch.floor(0.5 + num / den).to(torch.int64)


def cdef_dirs_ref(y: torch.Tensor, coded, grid, cs: int):
    """svt_cdef_dirs: each unit's direction and variance, (nv8p * nh8p,)
    int32 each. y: the luma recon, int32; coded: its coded (rows,
    columns); grid: (nv8p, nh8p)."""
    nv8p, nh8p = grid
    pad = _padded(y, coded, (nv8p * 8, nh8p * 8))
    return _find_dir(_blocked(pad[2:-2, 2:-2], nv8p, nh8p, 8), cs)


def cdef_search_ref(planes, srcs, coded, units: torch.Tensor, grid,
                    dirs: torch.Tensor, var: torch.Tensor,
                    cands: torch.Tensor, ydamp: int, cdamp: int, cs: int):
    """svt_cdef_search: per filter block and candidate, the luma
    distortion (dist_8x8) and the chroma SSE >> 2 * cs summed over the
    searched `units` (int32 indices) of the block; (nfb, n_cand) int64
    each, chroma zeros for a monochrome frame. planes, srcs: the recon and
    source planes (luma, then U and V if any), int32; cands: the
    candidates' strength indices gi = pri * 4 + sec (int32)."""
    nv8p, nh8p = grid
    nhfb = nh8p // 8
    nfb = (nv8p // 8) * nhfb
    dev = planes[0].device
    n_cand = cands.numel()
    mse0 = torch.zeros((nfb, n_cand), dtype=torch.int64, device=dev)
    mse1 = torch.zeros_like(mse0)
    if units.numel() == 0:
        return mse0, mse1
    u = units.long()
    fb = (u // nh8p // 8) * nhfb + (u % nh8p) // 8
    d, v = dirs.long()[u], var[u]
    chroma = len(planes) > 1
    pads = [_padded(p, coded if k == 0 else (coded[0] >> 1, coded[1] >> 1),
                    (nv8p * (8 if k == 0 else 4), nh8p * (8 if k == 0 else 4)))
            for k, p in enumerate(planes)]

    def src_units(s, bs):
        r = torch.arange(bs, device=dev)
        return s[(u // nh8p * bs)[:, None, None] + r[None, :, None],
                 (u % nh8p * bs)[:, None, None] + r[None, None, :]]

    src_y = src_units(srcs[0], 8)
    src_c = [src_units(s, 4) for s in srcs[1:3]] if chroma else []
    zero = torch.zeros_like(d)
    ones = torch.ones_like(v)
    for ci, gi in enumerate(cands.tolist()):
        pri, sec = gi >> 2, gi & 3
        pri, sec = pri << cs, (sec + (sec == 3)) << cs
        dd = d if pri else zero
        out = _filter(pads[0], units, nh8p, 8, dd,
                      _adjust_strength(pri * ones, v), sec * ones, ydamp, cs)
        mse0[:, ci].index_add_(0, fb, _dist_8x8(src_y, out, cs))
        if chroma:
            acc = torch.zeros_like(fb)
            for pad, s in zip(pads[1:], src_c):
                outc = _filter(pad, units, nh8p, 4, dd, pri * ones,
                               sec * ones, cdamp, cs)
                e = (outc - s).to(torch.int64)
                acc += (e * e).sum(dim=(1, 2))
            mse1[:, ci].index_add_(0, fb, acc >> (2 * cs))
    return mse0, mse1


def cdef_apply_ref(planes, coded, mask: torch.Tensor, dirs: torch.Tensor,
                   var: torch.Tensor, y_gi: torch.Tensor, uv_gi: torch.Tensor,
                   ydamp: int, cdamp: int, cs: int):
    """svt_cdef_apply: the planes filtered with each unit's strength
    indices y_gi / uv_gi ((nv8p * nh8p,) int32 over the grid), new
    tensors of the planes' shapes; a unit outside the mask (nv8p, nh8p),
    or at strength 0, keeps its samples, as does every sample outside the
    grid's units."""
    nv8p, nh8p = mask.shape
    out = []
    for k, plane in enumerate(planes):
        bs = 8 if k == 0 else 4
        gi = y_gi if k == 0 else uv_gi
        res = plane.clone()
        units = torch.nonzero((mask.reshape(-1) != 0) & (gi != 0))[:, 0]
        if units.numel():
            pri, sec = _strengths(gi[units], cs)
            d = torch.where(pri != 0, dirs[units], 0)
            if k == 0:
                pri = _adjust_strength(pri, var[units])
            c = coded if k == 0 else (coded[0] >> 1, coded[1] >> 1)
            pad = _padded(plane, c, (nv8p * bs, nh8p * bs))
            filt = _filter(pad, units, nh8p, bs, d, pri, sec,
                           ydamp if k == 0 else cdamp, cs)
            # the units' samples that lie inside the plane
            h, w = plane.shape
            r = torch.arange(bs, device=plane.device)
            ys = (units // nh8p * bs)[:, None, None] + r[None, :, None]
            xs = (units % nh8p * bs)[:, None, None] + r[None, None, :]
            ys, xs = torch.broadcast_tensors(ys, xs)
            inside = (ys < h) & (xs < w)
            res[ys[inside], xs[inside]] = filt[inside]
        out.append(res)
    return out
