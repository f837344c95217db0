"""CDEF strength search and filtering on the device, in PyTorch.

Counterpart of svt_av1_psyex_tpu/device/cdef.py (an XLA program there, no
Pallas kernel, so plain torch here), itself a device form of ops/cdef.py.
The frame's 8x8 units form one static lattice, skip semantics ride on a
per-unit mask, and two passes run on the device:

  * search (`cdef_search_kernel`): the luma directions and variances,
    then per candidate strength the filtered units and their distortion,
    summed per 64x64 filter block -> (nfb, n_cand) MSE matrices;
  * apply (`cdef_apply_kernel`): the frame filtered with the chosen
    per-filter-block strengths.

The greedy dual strength selection and its RD stay on the host
(`_select_strengths`); `_prep_frame` builds the padded planes and the
unit mask. `cdef_group_device` runs a group of same-geometry frames (the
keyframe group) with one search and one apply per frame.

Arithmetic. The apply writes the recon, which the decoder re-derives, so
it is exact integer arithmetic throughout, as is `_find_dir`: its 34-bit
costs are int64 here (the JAX module splits them into (hi, lo) int32
pairs), with the same first-max-wins argmax, and its line sums are
integer gathers and sums (the JAX module's float32 einsum would meet
TF32 on the card if anyone allowed it, and torch has no int32 matmul on
CUDA). The distortions are search-only and keep the JAX module's float32
operations (`_dist_luma`, the chroma SSE), except that their sums of
integers are taken exactly and rounded to float32 once: equal to the JAX
module's float32 sums wherever those are exact (below 2^24: always at
8 bits), and independent of the summation order where they are not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cdef import (
    _DIR_DX,
    _DIR_DY,
    _DIV_TABLE,
    _PARTIAL_MAPS,
    _PRI_TAPS,
    CDEF_SEC_STRENGTHS,
    CDEF_STRENGTH_BITS,
    CDEF_VERY_LARGE,
    candidate_strengths,
    joint_strength_search_dual,
)


def _dir_tables():
    """Per (direction, line): the pixels of the line, padded with the
    index 64 of a zero sample, (8, 15, 8); and the line's cost weight
    (cdef.c:176-197, 0 for unused lines), (8, 15)."""
    idx = np.full((8, 15, 8), 64, np.int64)
    for d in range(8):
        for b in range(15):
            px = np.nonzero(_PARTIAL_MAPS[d, :, b])[0]
            idx[d, b, :px.size] = px
    div = _DIV_TABLE
    wgt = np.zeros((8, 15), np.int64)
    for d in (2, 6):
        wgt[d, :8] = div[8]
    for d in (0, 4):
        wgt[d, 7] = div[8]
        for i in range(7):
            wgt[d, i] = wgt[d, 14 - i] = div[i + 1]
    for d in (1, 3, 5, 7):
        wgt[d, 3:8] = div[8]
        for j in range(3):
            wgt[d, j] = wgt[d, 10 - j] = div[2 * j + 2]
    return idx, wgt


_LINE_IDX, _LINE_WGT = _dir_tables()


def _find_dir(blocks: torch.Tensor, coeff_shift: int):
    """(N, 8, 8) -> (dir (N,), var (N,)), both int32. Mirrors
    ops.cdef.find_dir_batch exactly: the decoder re-derives both from
    its recon (cdef.c:152)."""
    n = blocks.shape[0]
    dev = blocks.device
    x = (blocks.reshape(n, 64).to(torch.int64) >> coeff_shift) - 128
    x = torch.cat([x, x.new_zeros(n, 1)], dim=1)
    lines = x[:, torch.as_tensor(_LINE_IDX, device=dev)].sum(dim=3)
    cost = (lines * lines * torch.as_tensor(_LINE_WGT, device=dev)).sum(
        dim=2)                                           # (N, 8)
    # first max wins; all-zero costs keep dir 0 (C: best_cost = 0)
    best_dir = cost.argmax(dim=1)
    best = cost.gather(1, best_dir[:, None])[:, 0]
    opp = cost.gather(1, ((best_dir + 4) & 7)[:, None])[:, 0]
    return best_dir.to(torch.int32), ((best - opp) >> 10).to(torch.int32)


def _tap_offset_tables():
    """Per (tap, dir) (dy, dx) offsets in ops.cdef.gather_taps tap
    order: (12, 8) each."""
    dy = np.zeros((12, 8), np.int64)
    dx = np.zeros((12, 8), np.int64)
    for d in range(8):
        i = 0
        for k in range(2):
            for sgn in (1, -1):
                dy[i, d] = sgn * _DIR_DY[d, k]
                dx[i, d] = sgn * _DIR_DX[d, k]
                i += 1
            for dd in ((d + 2) & 7, (d - 2) & 7):
                for sgn in (1, -1):
                    dy[i, d] = sgn * _DIR_DY[dd, k]
                    dx[i, d] = sgn * _DIR_DX[dd, k]
                    i += 1
    return dy, dx


_TAP_DY, _TAP_DX = _tap_offset_tables()


def _blocked(plane: torch.Tensor, nvb: int, nhb: int, bs: int):
    """(nvb*bs, nhb*bs) plane -> (nvb*nhb, bs, bs) row-major blocks."""
    return plane.reshape(nvb, bs, nhb, bs).permute(0, 2, 1, 3).reshape(
        nvb * nhb, bs, bs)


def _unblocked(blocks: torch.Tensor, nvb: int, nhb: int, bs: int):
    return blocks.reshape(nvb, nhb, bs, bs).permute(0, 2, 1, 3).reshape(
        nvb * bs, nhb * bs)


def _gather_taps(padded: torch.Tensor, nvb: int, nhb: int, bs: int, dirs):
    """ops.cdef.gather_taps over the whole lattice: padded (H+4, W+4)
    int32 plane (CDEF_VERY_LARGE outside the coded area), dirs (N,) per
    block or None for direction 0. Returns (x (N, bs, bs), P, AD, SG
    (12, N, bs, bs)): the centre samples, the 12 tap samples, |P - x| and
    sign(P - x)."""
    dev = padded.device
    pw = padded.shape[1]
    flat = padded.reshape(-1)
    n = nvb * nhb
    i = torch.arange(bs, device=dev)
    by = torch.arange(nvb, device=dev).repeat_interleave(nhb)
    bx = torch.arange(nhb, device=dev).repeat(nvb)
    base = ((2 + by[:, None, None] * bs + i[None, :, None]) * pw
            + 2 + bx[:, None, None] * bs + i[None, None, :])
    if dirs is None:
        dirs = torch.zeros(n, dtype=torch.int64, device=dev)
    dirs = dirs.to(torch.int64)
    off = (torch.as_tensor(_TAP_DY, device=dev)[:, dirs] * pw
           + torch.as_tensor(_TAP_DX, device=dev)[:, dirs])   # (12, N)
    x = flat[base]
    P = flat[base[None] + off[:, :, None, None]]
    D = P - x[None]
    return x, P, D.abs(), D.sign()


_PRI_IDX = (0, 1, 6, 7)
_PRI_KS = (0, 0, 1, 1)
_SEC_IDX0 = (2, 3, 4, 5)
_SEC_IDX1 = (8, 9, 10, 11)


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(x, 1))) in integer operations (the filter output
    is decoder-visible, so no float log2)."""
    v = x.clamp(min=1)
    r = torch.zeros_like(v)
    for k in (16, 8, 4, 2, 1):
        hit = v >= (1 << k)
        r += hit.to(r.dtype) * k
        v = torch.where(hit, v >> k, v)
    return r


def _constrain(AD, SG, strength, shift):
    return SG * torch.minimum(AD, (strength - (AD >> shift)).clamp(min=0))


def _pri_sum(taps, pri: torch.Tensor, damping: int, coeff_shift: int):
    """pri: (N,) per-block primary strength."""
    x, _, AD, SG = taps
    prib = pri[:, None, None]
    shift = (damping - _ilog2(prib)).clamp(min=0)
    tap_sel = (pri >> coeff_shift) & 1
    acc = torch.zeros_like(x)
    for i, k in zip(_PRI_IDX, _PRI_KS):
        w = torch.where(tap_sel == 1, int(_PRI_TAPS[1, k]),
                        int(_PRI_TAPS[0, k])).to(x.dtype)[:, None, None]
        acc += w * _constrain(AD[i], SG[i], prib, shift)
    return torch.where(prib == 0, 0, acc)


def _sec_sum(taps, sec: torch.Tensor, damping: int):
    """sec: (N,) per-block secondary strength."""
    x, _, AD, SG = taps
    sb = sec[:, None, None]
    shift = (damping - _ilog2(sb)).clamp(min=0)
    acc = torch.zeros_like(x)
    for i in _SEC_IDX0:
        acc += 2 * _constrain(AD[i], SG[i], sb, shift)
    for i in _SEC_IDX1:
        acc += _constrain(AD[i], SG[i], sb, shift)
    return torch.where(sb == 0, 0, acc)


def _combine(taps, pri_sum, sec_sum):
    x, P, _, _ = taps
    mx = torch.maximum(x, torch.where(P == CDEF_VERY_LARGE, x[None],
                                      P).amax(dim=0))
    mn = torch.minimum(x, P.amin(dim=0))
    s = pri_sum + sec_sum
    y = x + ((8 + s - (s < 0).to(s.dtype)) >> 4)
    return torch.minimum(torch.maximum(y, mn), mx)


def _adjust_strength(strength: torch.Tensor, var: torch.Tensor):
    i = _ilog2(var >> 6).clamp(max=12)
    return torch.where(var != 0, (strength * (4 + i) + 8) >> 4, 0)


def _split_gi(gi: int, cs: int):
    pri = gi // CDEF_SEC_STRENGTHS
    sec = gi % CDEF_SEC_STRENGTHS
    sec += sec == 3
    return pri, sec << cs


def _f32_sum(a: torch.Tensor, dim) -> torch.Tensor:
    """Exact sum of integer-valued samples, rounded once to float32."""
    if a.is_floating_point():
        return a.to(torch.float64).sum(dim=dim).to(torch.float32)
    return a.to(torch.int64).sum(dim=dim).to(torch.float32)


def _dist_luma(src: torch.Tensor, dst: torch.Tensor, coeff_shift: int):
    """enc_cdef.c dist_8xn in float32 (search-only): (N, 8, 8) -> (N,)."""
    s = src.reshape(-1, 64).to(torch.int64)
    d = dst.reshape(-1, 64).to(torch.int64)
    sum_s = _f32_sum(s, 1)
    sum_d = _f32_sum(d, 1)
    sum_s2 = _f32_sum(s * s, 1)
    sum_d2 = _f32_sum(d * d, 1)
    sum_sd = _f32_sum(s * d, 1)
    svar = sum_s2 - torch.floor((sum_s * sum_s + 32) / 64)
    dvar = sum_d2 - torch.floor((sum_d * sum_d + 32) / 64)
    num = (sum_d2 + sum_s2 - 2 * sum_sd) * 0.5 * \
        (svar + dvar + (400 << (2 * coeff_shift)))
    den = torch.sqrt((20000 << (4 * coeff_shift)) + svar * dvar)
    return torch.floor(0.5 + num / den)


def _fb_sum(per_block: torch.Tensor, nv8p: int, nh8p: int):
    """(N,) block values -> (nvfb*nhfb,) sums over 8x8-block fb tiles."""
    g = per_block.reshape(nv8p // 8, 8, nh8p // 8, 8)
    return _f32_sum(g, (1, 3)).reshape(-1)


def cdef_search_kernel(pads, srcs, mask, ydamp: int, cdamp: int, *,
                       level: int, bit_depth: int, nv8p: int, nh8p: int,
                       chroma: bool):
    """One frame's search. pads: per plane the (H+4, W+4) int32 padded
    recon; srcs: per plane the (H, W) int32 source over the padded grid;
    mask (N,) float32 unit mask. Returns (mse0, mse1 (nfb, n_cand)
    float32: luma, chroma distortion per filter block and candidate of
    candidate_strengths(level), zeros without chroma; dirs, var (N,)
    int32)."""
    cs = bit_depth - 8
    n = nv8p * nh8p
    pad_y = pads[0]
    dirs, var = _find_dir(_blocked(pad_y[2:-2, 2:-2], nv8p, nh8p, 8), cs)
    src_y = _blocked(srcs[0], nv8p, nh8p, 8)
    taps_y = {1: _gather_taps(pad_y, nv8p, nh8p, 8, dirs),
              0: _gather_taps(pad_y, nv8p, nh8p, 8, None)}
    if chroma:
        taps_c = {(pi, nz): _gather_taps(pads[pi], nv8p, nh8p, 4,
                                         dirs if nz else None)
                  for pi in (1, 2) for nz in (0, 1)}
        src_c = [_blocked(p, nv8p, nh8p, 4) for p in srcs[1:3]]
    ones = torch.ones(n, dtype=torch.int32, device=pad_y.device)
    mse0_cols, mse1_cols = [], []
    for gi in candidate_strengths(level):
        pri, sec = _split_gi(gi, cs)
        nz = 1 if pri else 0
        t = _adjust_strength((pri << cs) * ones, var)
        out = _combine(taps_y[nz], _pri_sum(taps_y[nz], t, ydamp, cs),
                       _sec_sum(taps_y[nz], sec * ones, ydamp))
        mse0_cols.append(_fb_sum(_dist_luma(src_y, out, cs) * mask, nv8p,
                                 nh8p))
        if chroma:
            acc = 0.0
            for pi in (1, 2):
                tc = taps_c[(pi, nz)]
                outc = _combine(tc, _pri_sum(tc, (pri << cs) * ones, cdamp,
                                             cs),
                                _sec_sum(tc, sec * ones, cdamp))
                e = (outc - src_c[pi - 1]).to(torch.int64)
                acc = acc + _f32_sum(e * e, (1, 2)) / (1 << (2 * cs))
            mse1_cols.append(_fb_sum(acc * mask, nv8p, nh8p))
    mse0 = torch.stack(mse0_cols, dim=1)
    mse1 = (torch.stack(mse1_cols, dim=1) if chroma
            else torch.zeros_like(mse0))
    return mse0, mse1, dirs, var


def cdef_search_kernel_batch(pads, srcs, masks, ydamps, cdamps, *, level,
                             bit_depth, nv8p, nh8p, chroma):
    """cdef_search_kernel over F frames: pads/srcs per plane (F, ...)
    stacks, masks (F, N), ydamps/cdamps (F,) ints. The frames run one
    after another (one 1080p frame fills the card; a stacked axis would
    multiply the tap planes' memory by F). Returns the four outputs
    stacked over F."""
    outs = [cdef_search_kernel([p[f] for p in pads], [s[f] for s in srcs],
                               masks[f], int(ydamps[f]), int(cdamps[f]),
                               level=level, bit_depth=bit_depth, nv8p=nv8p,
                               nh8p=nh8p, chroma=chroma)
            for f in range(masks.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def _strengths(gi: torch.Tensor, cs: int):
    pri = (gi // CDEF_SEC_STRENGTHS) << cs
    sec = gi % CDEF_SEC_STRENGTHS
    return pri, (sec + (sec == 3).to(sec.dtype)) << cs


def cdef_apply_kernel(pads, dirs, var, y_gi, uv_gi, mask, ydamp: int,
                      cdamp: int, *, bit_depth: int, nv8p: int, nh8p: int,
                      chroma: bool, h: int, w: int, hc: int, wc: int):
    """One frame's filter with per-unit strength indices y_gi/uv_gi (N,)
    (gi = pri * 4 + sec). Returns the filtered planes, cropped to (h, w)
    and (hc, wc) where the padded lattice covers them: a unit outside
    the mask, or at strength 0, keeps its samples."""
    cs = bit_depth - 8
    pri_y, sec_y = _strengths(y_gi, cs)
    taps = _gather_taps(pads[0], nv8p, nh8p, 8,
                        torch.where(pri_y != 0, dirs, 0))
    out_y = _combine(taps, _pri_sum(taps, _adjust_strength(pri_y, var),
                                    ydamp, cs),
                     _sec_sum(taps, sec_y, ydamp))
    keep = (mask > 0) & (y_gi != 0)
    out_y = torch.where(keep[:, None, None], out_y, taps[0])
    outs = [_unblocked(out_y, nv8p, nh8p, 8)[:h, :w]]
    if chroma:
        pri_c, sec_c = _strengths(uv_gi, cs)
        d_c = torch.where(pri_c != 0, dirs, 0)
        keep_c = (mask > 0) & (uv_gi != 0)
        for pi in (1, 2):
            tc = _gather_taps(pads[pi], nv8p, nh8p, 4, d_c)
            oc = _combine(tc, _pri_sum(tc, pri_c, cdamp, cs),
                          _sec_sum(tc, sec_c, cdamp))
            oc = torch.where(keep_c[:, None, None], oc, tc[0])
            outs.append(_unblocked(oc, nv8p, nh8p, 4)[:hc, :wc])
    return outs


def cdef_apply_kernel_batch(pads, dirs, var, y_gi, uv_gi, masks, ydamps,
                            cdamps, *, bit_depth, nv8p, nh8p, chroma, h, w,
                            hc, wc):
    """cdef_apply_kernel over F frames (one after another, as
    cdef_search_kernel_batch): per plane an (F, ...) stack."""
    outs = [cdef_apply_kernel([p[f] for p in pads], dirs[f], var[f],
                              y_gi[f], uv_gi[f], masks[f], int(ydamps[f]),
                              int(cdamps[f]), bit_depth=bit_depth,
                              nv8p=nv8p, nh8p=nh8p, chroma=chroma, h=h, w=w,
                              hc=hc, wc=wc)
            for f in range(masks.shape[0])]
    return [torch.stack(o) for o in zip(*outs)]


# ---- host glue ---------------------------------------------------------


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


def cdef_group_device(jobs: list, level: int, bit_depth: int, *, device):
    """CDEF over a group of same-geometry frames on `device`.

    jobs: list of dicts with keys recon_planes, src_planes, skip_g,
    mi_rows, mi_cols, base_q_idx, rdcost_fn. Mutates each recon in place
    and returns a list of per-frame results (None where nothing to do),
    each (cdef_bits, y_strengths, uv_strengths, fb_gi_map, damping)."""
    results = [None] * len(jobs)
    prepped = []
    for i, j in enumerate(jobs):
        p = _prep_frame(j["recon_planes"], j["src_planes"], j["skip_g"],
                        j["mi_rows"], j["mi_cols"])
        if p is not None:
            prepped.append((i, j, p))
    if not prepped:
        return results
    nvfb, nhfb, nv8p, nh8p = prepped[0][2][3]
    chroma = len(prepped[0][1]["recon_planes"]) > 1
    cs = bit_depth - 8
    cands = candidate_strengths(level)

    def stack(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    nplanes = len(prepped[0][2][0])
    pads_b = [stack([pp[2][0][k] for pp in prepped]) for k in range(nplanes)]
    srcs_b = [stack([pp[2][1][k] for pp in prepped]) for k in range(nplanes)]
    masks_b = stack([pp[2][2].reshape(-1) for pp in prepped])
    dampings = [3 + (pp[1]["base_q_idx"] >> 6) for pp in prepped]
    ydamps = [d + cs for d in dampings]
    cdamps = [max(0, d + cs - 1) for d in dampings]

    mse0_b, mse1_b, dirs_b, var_b = cdef_search_kernel_batch(
        pads_b, srcs_b, masks_b, ydamps, cdamps, level=level,
        bit_depth=bit_depth, nv8p=nv8p, nh8p=nh8p, chroma=chroma)
    mse0_b, mse1_b = mse0_b.cpu().numpy(), mse1_b.cpu().numpy()

    y_gis, uv_gis = [], []
    for f, (i, j, p) in enumerate(prepped):
        bits, y_str, uv_str, fb_gi_map, y_gi, uv_gi = _select_strengths(
            mse0_b[f], mse1_b[f], p[2], nvfb, nhfb, cands, j["rdcost_fn"])
        results[i] = (bits, y_str, uv_str, fb_gi_map, dampings[f])
        y_gis.append(y_gi)
        uv_gis.append(uv_gi)

    h, w = prepped[0][1]["recon_planes"][0].shape
    hc, wc = (prepped[0][1]["recon_planes"][1].shape if chroma else (0, 0))
    planes = cdef_apply_kernel_batch(
        pads_b, dirs_b, var_b, stack(y_gis), stack(uv_gis), masks_b, ydamps,
        cdamps, bit_depth=bit_depth, nv8p=nv8p, nh8p=nh8p, chroma=chroma,
        h=h, w=w, hc=hc, wc=wc)
    for k, plane in enumerate(planes):
        plane = plane.cpu().numpy()
        for f, (_, j, _) in enumerate(prepped):
            out = plane[f]
            j["recon_planes"][k][:out.shape[0], :out.shape[1]] = out
    return results


def cdef_search_frame_device(recon_planes, src_planes, skip_g, mi_rows: int,
                             mi_cols: int, base_q_idx: int, rdcost_fn,
                             level: int = 3, bit_depth: int = 8, *, device):
    """Drop-in for ops.cdef.cdef_search_frame (single frame) with the
    search and the apply on `device`. Same return contract; mutates
    recon_planes."""
    res = cdef_group_device([dict(recon_planes=recon_planes,
                                  src_planes=src_planes, skip_g=skip_g,
                                  mi_rows=mi_rows, mi_cols=mi_cols,
                                  base_q_idx=base_q_idx,
                                  rdcost_fn=rdcost_fn)],
                            level, bit_depth, device=device)
    return res[0]
