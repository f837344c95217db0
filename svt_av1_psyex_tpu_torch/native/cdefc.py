"""ctypes frontend for the C CDEF kernels (native/cdef.c).

Same frame contract as ops.cdef.cdef_search_frame: full-grid padded
planes + per-8x8-unit mask, per-candidate MSE search, host greedy
dual-strength selection, filter apply in place. The frame preparation
and the strength selection are host numpy (`_prep_frame`,
`_select_strengths`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.cdef import (
    _SEARCH_SUBSAMPLE,
    CDEF_STRENGTH_BITS,
    CDEF_VERY_LARGE,
    candidate_strengths,
    joint_strength_search_dual,
)
from .ecenc import get_lib

__all__ = ["available", "cdef_search_frame_c"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_registered = False


def _lib():
    global _registered
    lib = get_lib()
    if lib is not None and not _registered and hasattr(lib, "svt_cdef_search"):
        lib.svt_cdef_dirs.argtypes = [_I32P] + [ctypes.c_int] * 4 + [_I32P] * 2
        lib.svt_cdef_search.argtypes = (
            [_I32P, ctypes.c_int, _I32P, _I32P, ctypes.c_int,
             _I32P, ctypes.c_int, _I32P, _I32P, ctypes.c_int,
             _U8P] + [ctypes.c_int] * 3 + [_I32P] * 2 +
            [_I32P, ctypes.c_int] + [ctypes.c_int] * 4 + [_I64P, _I64P])
        lib.svt_cdef_apply.argtypes = (
            [_I32P, ctypes.c_int, _I32P, _I32P, ctypes.c_int,
             _I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _I32P, _I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _U8P] + [ctypes.c_int] * 2 + [_I32P] * 4 + [ctypes.c_int] * 4)
        _registered = True
    return lib


def available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "svt_cdef_search")


def _p32(a):
    return a.ctypes.data_as(_I32P)


def _prep_frame(recon_planes, src_planes, skip_g, mi_rows, mi_cols):
    """Build padded planes / padded sources / block mask for one frame.
    Returns None when nothing is filterable."""
    nvfb = (mi_rows + 15) // 16
    nhfb = (mi_cols + 15) // 16
    nv8, nh8 = mi_rows // 2, mi_cols // 2
    nv8p, nh8p = nvfb * 8, nhfb * 8
    g = ~skip_g.astype(bool)
    nonskip = g[0::2, 0::2] | g[1::2, 0::2] | g[0::2, 1::2] | g[1::2, 1::2]
    if not nonskip.any():
        return None
    maskg = np.zeros((nv8p, nh8p), np.float32)
    maskg[:nv8, :nh8] = nonskip

    def pad_to(p, hh, ww, ch, cw):
        # spec 7.15.2 CdefAvailable: everything beyond the CODED area
        # (mi grid) is the large value — chroma planes carry a +4
        # overhang margin that must NOT leak in as real samples
        ph, pw = min(ch, hh), min(cw, ww)
        out = np.full((hh + 4, ww + 4), CDEF_VERY_LARGE, np.int32)
        out[2: 2 + ph, 2: 2 + pw] = p[:ph, :pw]
        return out

    def src_pad(p, hh, ww, ch, cw):
        ph, pw = min(ch, hh), min(cw, ww)
        out = np.zeros((hh, ww), np.int32)
        out[:ph, :pw] = p[:ph, :pw]
        return out

    coded = [(mi_rows * 4, mi_cols * 4), (mi_rows * 2, mi_cols * 2),
             (mi_rows * 2, mi_cols * 2)]
    pads = tuple(pad_to(p, nv8p * (8 if i == 0 else 4),
                        nh8p * (8 if i == 0 else 4), *coded[i])
                 for i, p in enumerate(recon_planes))
    srcs = tuple(src_pad(p, nv8p * (8 if i == 0 else 4),
                         nh8p * (8 if i == 0 else 4), *coded[i])
                 for i, p in enumerate(src_planes[: len(recon_planes)]))
    return pads, srcs, maskg, (nvfb, nhfb, nv8p, nh8p)


def _select_strengths(mse0_all, mse1_all, maskg, nvfb, nhfb, cands,
                      rdcost_fn):
    """Greedy dual strength selection + nb_strengths RD (host; tiny)."""
    fb_mask = maskg.reshape(nvfb, 8, nhfb, 8).sum(axis=(1, 3)).reshape(-1) > 0
    act = np.nonzero(fb_mask)[0]
    mse0 = mse0_all[act].astype(np.int64)
    mse1 = mse1_all[act].astype(np.int64)
    n_act = act.size
    best_rd = None
    best = None
    for i in range(4):
        nb = 1 << i
        lev0, lev1, tot = joint_strength_search_dual(nb, mse0, mse1, cands)
        rate = n_act * i + nb * CDEF_STRENGTH_BITS * 2
        rd = rdcost_fn(rate * 512, tot * 16)
        if best_rd is None or rd < best_rd:
            best_rd = rd
            best = (i, lev0, lev1)
    bits, lev0, lev1 = best
    pair_mse = np.stack([mse0[:, l0] + mse1[:, l1]
                         for l0, l1 in zip(lev0, lev1)], axis=1)
    fb_best = np.argmin(pair_mse, axis=1)
    fb_gi_map = np.full((nvfb, nhfb), -1, np.int32)
    fb_gi_map[act // nhfb, act % nhfb] = fb_best
    y_str = [cands[l] for l in lev0]
    uv_str = [cands[l] for l in lev1]
    # per-block strengths over the padded grid
    n = (nvfb * 8) * (nhfb * 8)
    nh8p = nhfb * 8
    blk_fb = (np.arange(n) // nh8p // 8) * nhfb + (np.arange(n) % nh8p) // 8
    sel = np.where(fb_gi_map.reshape(-1)[blk_fb] >= 0,
                   fb_gi_map.reshape(-1)[blk_fb], 0)
    y_gi = np.asarray(y_str, np.int32)[sel]
    uv_gi = np.asarray(uv_str, np.int32)[sel]
    return bits, y_str, uv_str, fb_gi_map, y_gi, uv_gi


def cdef_search_frame_c(recon_planes, src_planes, skip_g, mi_rows: int,
                        mi_cols: int, base_q_idx: int, rdcost_fn,
                        level: int = 3, bit_depth: int = 8):
    """Drop-in for ops.cdef.cdef_search_frame backed by native/cdef.c."""
    prep = _prep_frame(recon_planes, src_planes, skip_g, mi_rows, mi_cols)
    if prep is None:
        return None
    pads, srcs, maskg, (nvfb, nhfb, nv8p, nh8p) = prep
    chroma = len(recon_planes) > 1
    cs = bit_depth - 8
    damping = 3 + (base_q_idx >> 6)
    ydamp, cdamp = damping + cs, max(0, damping + cs - 1)
    cands = np.asarray(candidate_strengths(level), np.int32)
    n_cand = len(cands)
    nfb = nvfb * nhfb
    n = nv8p * nh8p

    lib = _lib()
    mask8 = np.ascontiguousarray(maskg.reshape(-1) > 0).astype(np.uint8)
    dirs = np.empty(n, np.int32)
    var = np.empty(n, np.int32)
    lib.svt_cdef_dirs(_p32(pads[0]), pads[0].shape[1], nv8p, nh8p, cs,
                      _p32(dirs), _p32(var))
    mse0 = np.zeros((nfb, n_cand), np.int64)
    mse1 = np.zeros((nfb, n_cand), np.int64)
    if chroma:
        pu, pv = pads[1], pads[2]
        su, sv = srcs[1], srcs[2]
    else:  # dummies (never dereferenced with chroma=0)
        pu = pv = pads[0]
        su = sv = srcs[0]
    # search-block subsampling at the fast levels (the reference's
    # subsampling_factor, enc_cdef.c): MSE estimated on every ss-th
    # filterable unit, keeping at least one per active 64x64 fb
    ss = _SEARCH_SUBSAMPLE.get(level, 1)
    smask = mask8
    if ss > 1:
        act = np.nonzero(mask8)[0]
        keep = np.zeros(n, np.uint8)
        keep[act[::ss]] = 1
        fbidx = (act // nh8p // 8) * nhfb + (act % nh8p) // 8
        first = np.r_[True, fbidx[1:] != fbidx[:-1]]
        keep[act[first]] = 1
        smask = keep
    lib.svt_cdef_search(
        _p32(pads[0]), pads[0].shape[1], _p32(pu), _p32(pv), pu.shape[1],
        _p32(srcs[0]), srcs[0].shape[1], _p32(su), _p32(sv), su.shape[1],
        smask.ctypes.data_as(_U8P), nv8p, nh8p, nhfb,
        _p32(dirs), _p32(var), _p32(cands), n_cand,
        ydamp, cdamp, cs, 1 if chroma else 0,
        mse0.ctypes.data_as(_I64P), mse1.ctypes.data_as(_I64P))

    bits, y_str, uv_str, fb_gi_map, y_gi, uv_gi = _select_strengths(
        mse0.astype(np.float64), mse1.astype(np.float64), maskg, nvfb, nhfb,
        list(map(int, cands)), rdcost_fn)

    h, w = recon_planes[0].shape
    if chroma:
        hc, wc = recon_planes[1].shape
        ru, rv = recon_planes[1], recon_planes[2]
    else:
        hc = wc = 0
        ru = rv = recon_planes[0]
    lib.svt_cdef_apply(
        _p32(pads[0]), pads[0].shape[1], _p32(pu), _p32(pv), pu.shape[1],
        _p32(recon_planes[0]), recon_planes[0].shape[1], h, w,
        _p32(ru), _p32(rv), ru.shape[1], hc, wc,
        mask8.ctypes.data_as(_U8P), nv8p, nh8p,
        _p32(dirs), _p32(var),
        _p32(np.ascontiguousarray(y_gi)), _p32(np.ascontiguousarray(uv_gi)),
        ydamp, cdamp, cs, 1 if chroma else 0)
    return bits, y_str, uv_str, fb_gi_map, damping
