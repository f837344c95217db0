"""CDEF: constrained directional enhancement filter (spec 7.15).

Counterparts in the reference:
  - cdef.c:85-122 (constrain, Cdef_Directions), 152-214
    (svt_aom_cdef_find_dir_c), 249-310 (svt_cdef_filter_block_c),
    339-430 (svt_cdef_filter_fb: strength decode, luma var adjust),
  - enc_cdef.c:284-610 (svt_av1_cdef_frame: 64x64 driver, border
    semantics — net effect is a pure function of the post-DLF frame with
    CDEF_VERY_LARGE outside the coded area), 76-100 (dist_8xn luma
    distortion), 613-700 (svt_search_one_dual greedy), 797-960
    (finish_cdef_search: nb_strengths rd search, damping = 3 + q>>6),
  - enc_mode_config.c:876+ (candidate strength sets per search level).

TPU-first design: all per-8x8 work (direction search via one-hot matmul
partial sums, 12-tap constrained filtering) is batched over every
candidate block in the frame at once — no per-block scalar loops.
"""

from __future__ import annotations

import math

import numpy as np

CDEF_VERY_LARGE = 30000
CDEF_SEC_STRENGTHS = 4
CDEF_STRENGTH_BITS = 6

# Cdef_Directions as (dy, dx) pairs, k = 0, 1 (cdef.c:99-120)
_DIR_OFFSETS = [
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)],
]
_DIR_DY = np.array([[o[0] for o in d] for d in _DIR_OFFSETS], np.int64)
_DIR_DX = np.array([[o[1] for o in d] for d in _DIR_OFFSETS], np.int64)

_PRI_TAPS = np.array([[4, 2], [3, 3]], np.int64)
_SEC_TAPS = np.array([2, 1], np.int64)

_DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)


def _build_partial_maps() -> np.ndarray:
    """(8 dirs, 64 pixels, 15 bins) one-hot maps for the direction search
    partial sums (cdef.c:166-175)."""
    maps = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            px = i * 8 + j
            maps[0, px, i + j] = 1
            maps[1, px, i + j // 2] = 1
            maps[2, px, i] = 1
            maps[3, px, 3 + i - j // 2] = 1
            maps[4, px, 7 + i - j] = 1
            maps[5, px, 3 - i // 2 + j] = 1
            maps[6, px, j] = 1
            maps[7, px, i // 2 + j] = 1
    return maps


_PARTIAL_MAPS = _build_partial_maps()


def find_dir_batch(blocks: np.ndarray, coeff_shift: int = 0):
    """svt_aom_cdef_find_dir_c over N 8x8 luma blocks at once.

    blocks: (N, 8, 8) int; returns (dir (N,), var (N,))."""
    n = blocks.shape[0]
    x = (blocks.reshape(n, 64) >> coeff_shift).astype(np.int64) - 128
    # partial[d]: (N, 15) line sums per direction
    cost = np.zeros((n, 8), np.int64)
    partials = np.einsum("np,dpb->dnb", x, _PARTIAL_MAPS)
    for d in (2, 6):
        p = partials[d]
        cost[:, d] = (p[:, :8] ** 2).sum(axis=1) * _DIV_TABLE[8]
    for d in (0, 4):
        p = partials[d]
        c = (p[:, 7] ** 2) * _DIV_TABLE[8]
        for i in range(7):
            c = c + (p[:, i] ** 2 + p[:, 14 - i] ** 2) * _DIV_TABLE[i + 1]
        cost[:, d] = c
    for d in (1, 3, 5, 7):
        p = partials[d]
        c = (p[:, 3:8] ** 2).sum(axis=1) * _DIV_TABLE[8]
        for j in range(3):
            c = c + (p[:, j] ** 2 + p[:, 10 - j] ** 2) * _DIV_TABLE[2 * j + 2]
        cost[:, d] = c
    # first max wins on ties, but only for cost > 0 (C init best_cost=0,
    # best_dir=0: all-zero costs keep dir 0)
    best_dir = np.argmax(cost, axis=1)
    best_cost = cost[np.arange(n), best_dir]
    best_dir = np.where(best_cost > 0, best_dir, 0)
    var = (best_cost - cost[np.arange(n), (best_dir + 4) & 7]) >> 10
    return best_dir.astype(np.int64), var


def _constrain(diff, strength, damping):
    """cdef.c:85-91 vectorized; strength may be per-element.
    Note C sign(): sign(0) == +1, but diff==0 gives 0 anyway."""
    s = np.asarray(strength, np.int64)
    nz = s > 0
    msb = np.floor(np.log2(np.maximum(s, 1))).astype(np.int64)
    shift = np.maximum(0, damping - msb)
    ad = np.abs(diff)
    out = np.sign(diff) * np.minimum(ad, np.maximum(0, s - (ad >> shift)))
    return np.where(nz, out, 0)


def adjust_strength(strength: int, var: np.ndarray) -> np.ndarray:
    """cdef.c:131-136 vectorized over blocks."""
    v6 = var >> 6
    i = np.zeros_like(var)
    nz = v6 > 0
    i[nz] = np.minimum(np.floor(np.log2(v6[nz])).astype(np.int64), 12)
    return np.where(var != 0, (strength * (4 + i) + 8) >> 4, 0)


def gather_taps(padded: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                bh: int, bw: int, dirs: np.ndarray):
    """Gather the center + 4 primary + 8 secondary tap samples (with
    precomputed |diff| and sign) for N blocks in ONE fancy-index; strength
    candidates then reuse them (filter_from_taps / *_tap_sum).

    Returns (x, pri_s, sec_s, (P, AD, SG)): the dict views keep the
    original per-tap interface, the stacked (12, N, bh, bw) arrays feed
    the vectorized sums."""
    ri = ys[:, None, None] + np.arange(bh)[None, :, None]
    ci = xs[:, None, None] + np.arange(bw)[None, None, :]
    x = padded[ri, ci].astype(np.int64)
    d = dirs
    dys, dxs = [], []
    for k in range(2):
        for sgn in (1, -1):
            dys.append(sgn * _DIR_DY[d, k])
            dxs.append(sgn * _DIR_DX[d, k])
        for dd in ((d + 2) & 7, (d - 2) & 7):
            for sgn in (1, -1):
                dys.append(sgn * _DIR_DY[dd, k])
                dxs.append(sgn * _DIR_DX[dd, k])
    DY = np.stack(dys)[:, :, None, None]  # (12, N, 1, 1)
    DX = np.stack(dxs)[:, :, None, None]
    P = padded[ri[None] + DY, ci[None] + DX].astype(np.int64)
    D = P - x[None]
    AD = np.abs(D)
    SG = np.sign(D)

    def tap(i):
        return {"p": P[i], "ad": AD[i], "sg": SG[i]}

    pri_s = [[tap(0), tap(1)], [tap(6), tap(7)]]
    sec_s = [[tap(2), tap(3), tap(4), tap(5)],
             [tap(8), tap(9), tap(10), tap(11)]]
    return x, pri_s, sec_s, (P, AD, SG)


_PRI_IDX = np.array([0, 1, 6, 7])       # (k, sgn) -> stacked index
_PRI_KS = np.array([0, 0, 1, 1])
_SEC_IDX0 = np.array([2, 3, 4, 5])      # k = 0 taps (weight 2)
_SEC_IDX1 = np.array([8, 9, 10, 11])    # k = 1 taps (weight 1)


def tap_minmax(taps):
    """Strength-independent clamp window over the 13 samples."""
    x, P = taps[0], taps[3][0]
    mx = np.maximum(x, np.where(P == CDEF_VERY_LARGE, x[None], P).max(axis=0))
    mn = np.minimum(x, P.min(axis=0))
    return mn, mx


def pri_tap_sum(taps, pri_strength, pri_damping: int, coeff_shift: int = 0):
    """Primary-tap constrained sum for one strength (scalar or per-block)."""
    x = taps[0]
    P, AD, SG = taps[3]
    n = x.shape[0]
    pri = np.broadcast_to(np.asarray(pri_strength, np.int64), (n,))
    if not np.any(pri):
        return np.zeros_like(x)
    tap_sel = (pri >> coeff_shift) & 1
    prib = pri[None, :, None, None]
    msb = np.floor(np.log2(np.maximum(prib, 1))).astype(np.int64)
    shift = np.maximum(0, pri_damping - msb)
    ad = AD[_PRI_IDX]
    c = SG[_PRI_IDX] * np.minimum(ad, np.maximum(0, prib - (ad >> shift)))
    ptap = _PRI_TAPS[tap_sel[:, None], _PRI_KS[None, :]].T  # (4, n)
    sum_ = (ptap[:, :, None, None] * c).sum(axis=0)
    return np.where(pri[:, None, None] == 0, 0, sum_)


def sec_tap_sum(taps, sec_strength, sec_damping: int):
    """Secondary-tap constrained sum for one strength (scalar)."""
    x = taps[0]
    P, AD, SG = taps[3]
    s = int(sec_strength)
    if s == 0:
        return np.zeros_like(x)
    shift = max(0, sec_damping - (s.bit_length() - 1))

    def part(idx):
        ad = AD[idx]
        return (SG[idx] * np.minimum(ad, np.maximum(0, s - (ad >> shift)))
                ).sum(axis=0)

    return _SEC_TAPS[0] * part(_SEC_IDX0) + _SEC_TAPS[1] * part(_SEC_IDX1)


def combine_taps(taps, mnmx, pri_sum, sec_sum):
    x = taps[0]
    mn, mx = mnmx
    s = pri_sum + sec_sum
    y = x + ((8 + s - (s < 0)) >> 4)
    return np.clip(y, mn, mx)


def filter_from_taps(taps, pri_strength, sec_strength, pri_damping: int,
                     sec_damping: int, coeff_shift: int = 0) -> np.ndarray:
    """svt_cdef_filter_block_c arithmetic on pre-gathered taps."""
    n = taps[0].shape[0]
    pri = np.broadcast_to(np.asarray(pri_strength, np.int64), (n,))
    sec = np.broadcast_to(np.asarray(sec_strength, np.int64), (n,))
    mnmx = tap_minmax(taps)
    pri_sum = pri_tap_sum(taps, pri, pri_damping, coeff_shift)
    # per-block secondary strength via the scalar path per unique value
    if np.all(sec == sec[0]):
        sec_sum = sec_tap_sum(taps, int(sec[0]), sec_damping)
    else:
        sec_sum = np.zeros_like(taps[0])
        for sv in np.unique(sec):
            m = sec == sv
            sub = sec_tap_sum(taps, int(sv), sec_damping)
            sec_sum[m] = sub[m]
    return combine_taps(taps, mnmx, pri_sum, sec_sum)


def filter_blocks(padded: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                  bh: int, bw: int, pri_strength, sec_strength,
                  dirs: np.ndarray, pri_damping: int, sec_damping: int,
                  coeff_shift: int = 0) -> np.ndarray:
    """svt_cdef_filter_block_c batched over N blocks of size bh x bw.

    padded: plane with 2px border (CDEF_VERY_LARGE outside the frame),
    ys/xs: (N,) top-left positions in padded coords; pri_strength scalar
    or (N,) (luma variance-adjusted); dirs: (N,). Returns (N, bh, bw)."""
    taps = gather_taps(padded, ys, xs, bh, bw, dirs)
    return filter_from_taps(taps, pri_strength, sec_strength, pri_damping,
                            sec_damping, coeff_shift)


# ---- frame-level apply + search ---------------------------------------------------


def _pad_plane(recon: np.ndarray, coded_h: int | None = None,
               coded_w: int | None = None) -> np.ndarray:
    """2px CDEF_VERY_LARGE border; samples beyond (coded_h, coded_w) —
    e.g. the chroma planes' +4 overhang margin — are outside the frame
    for CDEF (spec 7.15.2 CdefAvailable) and become the large value."""
    h, w = recon.shape
    ch = h if coded_h is None else min(coded_h, h)
    cw = w if coded_w is None else min(coded_w, w)
    out = np.full((h + 4, w + 4), CDEF_VERY_LARGE, np.int32)
    out[2 : 2 + ch, 2 : 2 + cw] = recon[:ch, :cw]
    return out


def compute_cdef_blocks(skip_g: np.ndarray, mi_rows: int, mi_cols: int):
    """svt_sb_compute_cdef_list over the frame: (fb_r, fb_c, by, bx) for
    every 8x8 (luma) unit containing a non-skip 4x4, grouped by 64x64 fb.

    Returns (fb_index (N,), by8 (N,), bx8 (N,)) in global 8x8-luma units."""
    assert mi_rows % 2 == 0 and mi_cols % 2 == 0  # aligned mi grid
    g = ~skip_g.astype(bool)
    any_nonskip = g[0::2, 0::2] | g[1::2, 0::2] | g[0::2, 1::2] | g[1::2, 1::2]
    by8, bx8 = np.nonzero(any_nonskip)
    nhfb = (mi_cols + 15) // 16
    fb = (by8 // 8) * nhfb + (bx8 // 8)
    return fb, by8, bx8


def dist_8x8_luma(src: np.ndarray, dst: np.ndarray, coeff_shift: int = 0) -> np.ndarray:
    """enc_cdef.c:76-100 dist_8xn: variance-weighted luma distortion,
    batched. src/dst: (N, 8, 8). Returns (N,) uint64-ish floats->int."""
    s = src.reshape(-1, 64).astype(np.float64)
    d = dst.reshape(-1, 64).astype(np.float64)
    sum_s = s.sum(1)
    sum_d = d.sum(1)
    sum_s2 = (s * s).sum(1)
    sum_d2 = (d * d).sum(1)
    sum_sd = (s * d).sum(1)
    svar = sum_s2 - np.floor((sum_s * sum_s + 32) / 64)
    dvar = sum_d2 - np.floor((sum_d * sum_d + 32) / 64)
    num = (sum_d2 + sum_s2 - 2 * sum_sd) * 0.5 * (svar + dvar + (400 << (2 * coeff_shift)))
    den = np.sqrt((20000 << (4 * coeff_shift)) + svar * dvar)
    return np.floor(0.5 + num / den).astype(np.int64)


# candidate strength sets per search level (enc_mode_config.c pf/sf sets;
# gi = pri*4 + sec)
_PF_SETS = {
    1: (list(range(16)), (1, 2, 3)),
    2: ([0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14], (1, 2, 3)),
    3: ([0, 4, 8, 12, 15], (1, 2, 3)),
    4: ([0, 7, 15], (1, 2, 3)),
    5: ([0, 7, 15], (2,)),
    7: ([0, 15], (2,)),
}

# search-block subsampling per level (reference subsampling_factor)
_SEARCH_SUBSAMPLE = {5: 2, 7: 4}


def candidate_strengths(level: int) -> list[int]:
    pris, secs = _PF_SETS.get(level, _PF_SETS[5])
    gis = [p * 4 for p in pris]
    gis += [p * 4 + s for p in pris for s in secs]
    return sorted(set(gis))


def search_one_dual(lev0, lev1, mse0, mse1, cand):
    """svt_search_one_dual_c: greedily add the (luma, chroma) candidate
    pair minimizing total frame mse given already-selected pairs."""
    n_fb = mse0.shape[0]
    if lev0:
        prev = np.min(
            np.stack([mse0[:, l0] + mse1[:, l1] for l0, l1 in zip(lev0, lev1)], 1),
            axis=1)
    else:
        prev = np.full(n_fb, np.int64(1) << 62)
    # tot[j,k] = sum_fb min(prev, mse0[:,j]+mse1[:,k])
    comb = mse0[:, :, None] + mse1[:, None, :]  # (fb, j, k)
    tot = np.minimum(comb, prev[:, None, None]).sum(axis=0)
    j, k = np.unravel_index(np.argmin(tot), tot.shape)
    return int(j), int(k), int(tot[j, k])


def joint_strength_search_dual(nb: int, mse0, mse1, cand):
    lev0: list[int] = []
    lev1: list[int] = []
    best = 0
    for _ in range(nb):
        j, k, best = search_one_dual(lev0, lev1, mse0, mse1, cand)
        lev0.append(j)
        lev1.append(k)
    return lev0, lev1, best


def cdef_search_frame(recon_planes, src_planes, skip_g, mi_rows: int,
                      mi_cols: int, base_q_idx: int, rdcost_fn, level: int = 3,
                      bit_depth: int = 8):
    """Frame CDEF: candidate-strength search (enc_cdef.c finish_cdef_search)
    + filtering of the recon in place (svt_av1_cdef_frame semantics: pure
    function of the post-DLF recon, CDEF_VERY_LARGE outside the coded area).

    recon_planes: [Y, U, V] aligned int32 (modified in place);
    src_planes: aligned int32 sources; skip_g: per-mi coded-skip grid;
    rdcost_fn(rate_cost_512ths, dist) -> scalar.
    Returns (cdef_bits, y_strengths, uv_strengths, fb_gi_map, damping)
    or None when no 64x64 unit has a filterable block.
    """
    nvfb = (mi_rows + 15) // 16
    nhfb = (mi_cols + 15) // 16
    fb, by8, bx8 = compute_cdef_blocks(skip_g, mi_rows, mi_cols)
    cs = bit_depth - 8  # coeff_shift
    damping = 3 + (base_q_idx >> 6)
    if fb.size == 0:
        return None

    act_fbs, fb_idx_all = np.unique(fb, return_inverse=True)
    n_act = act_fbs.size
    coded = [(mi_rows * 4, mi_cols * 4), (mi_rows * 2, mi_cols * 2),
             (mi_rows * 2, mi_cols * 2)]
    pad = [_pad_plane(p, *coded[i]) for i, p in enumerate(recon_planes)]

    ys_y_all = by8 * 8 + 2
    xs_y_all = bx8 * 8 + 2
    ri = ys_y_all[:, None, None] + np.arange(8)[None, :, None]
    ci = xs_y_all[:, None, None] + np.arange(8)[None, None, :]
    luma_blocks = pad[0][ri, ci]  # recon 8x8 blocks (padded coords)
    dirs_all, var_all = find_dir_batch(luma_blocks, cs)

    # search on a block subsample (reference subsampling_factor), keeping
    # at least the first block of every active 64x64 unit
    ss = _SEARCH_SUBSAMPLE.get(level, 1)
    if ss > 1:
        first = np.r_[True, fb_idx_all[1:] != fb_idx_all[:-1]]
        sel = (np.arange(fb.size) % ss == 0) | first
    else:
        sel = np.ones(fb.size, bool)
    fb_idx = fb_idx_all[sel]
    ys_y = ys_y_all[sel]
    xs_y = xs_y_all[sel]
    dirs = dirs_all[sel]
    var = var_all[sel]
    sby8, sbx8 = by8[sel], bx8[sel]
    src_y = src_planes[0][(sby8 * 8)[:, None, None] + np.arange(8)[None, :, None],
                          (sbx8 * 8)[:, None, None] + np.arange(8)[None, None, :]]

    chroma = len(recon_planes) > 1
    if chroma:
        ys_c = sby8 * 4 + 2
        xs_c = sbx8 * 4 + 2
        src_c = [p[(sby8 * 4)[:, None, None] + np.arange(4)[None, :, None],
                   (sbx8 * 4)[:, None, None] + np.arange(4)[None, None, :]]
                 for p in src_planes[1:3]]

    cands = candidate_strengths(level)
    n_cand = len(cands)
    mse0 = np.zeros((n_act, n_cand), np.int64)
    mse1 = np.zeros((n_act, n_cand), np.int64)

    # pre-gather tap samples once per (plane, dir-choice); candidates are
    # then pure arithmetic (dir falls back to 0 when pri_strength == 0,
    # which changes the clamp window, so both packs are needed)
    d0 = np.zeros_like(dirs)
    taps_y = {1: gather_taps(pad[0], ys_y, xs_y, 8, 8, dirs),
              0: gather_taps(pad[0], ys_y, xs_y, 8, 8, d0)}
    if chroma:
        taps_c = {(pi, nz): gather_taps(pad[pi], ys_c, xs_c, 4, 4,
                                        dirs if nz else d0)
                  for pi in (1, 2) for nz in (0, 1)}

    # decompose each candidate into cached primary/secondary constrained
    # sums per unique strength value (the clamp window is strength-free)
    mnmx_y = {nz: tap_minmax(taps_y[nz]) for nz in (0, 1)}
    pri_sums_y: dict = {}
    sec_sums_y: dict = {}
    if chroma:
        mnmx_c = {key: tap_minmax(taps_c[key]) for key in taps_c}
        pri_sums_c: dict = {}
        sec_sums_c: dict = {}
        cdamp = max(0, damping + cs - 1)

    ydamp = damping + cs

    def _filter_luma(gi):
        pri = gi // CDEF_SEC_STRENGTHS
        sec = gi % CDEF_SEC_STRENGTHS
        sec += sec == 3
        sec <<= cs
        nz = 1 if pri else 0
        if pri not in pri_sums_y:
            pri_sums_y[pri] = pri_tap_sum(
                taps_y[nz], adjust_strength(pri << cs, var), ydamp, cs)
        if (sec, nz) not in sec_sums_y:
            sec_sums_y[(sec, nz)] = sec_tap_sum(taps_y[nz], int(sec), ydamp)
        return combine_taps(taps_y[nz], mnmx_y[nz], pri_sums_y[pri],
                            sec_sums_y[(sec, nz)])

    def _filter_chroma(gi, pi):
        pri = (gi // CDEF_SEC_STRENGTHS) << cs
        sec = gi % CDEF_SEC_STRENGTHS
        sec += sec == 3
        sec <<= cs
        nz = 1 if pri else 0
        if (pri, pi) not in pri_sums_c:
            pri_sums_c[(pri, pi)] = pri_tap_sum(taps_c[(pi, nz)], int(pri),
                                                cdamp, cs)
        if (sec, nz, pi) not in sec_sums_c:
            sec_sums_c[(sec, nz, pi)] = sec_tap_sum(taps_c[(pi, nz)], int(sec), cdamp)
        return combine_taps(taps_c[(pi, nz)], mnmx_c[(pi, nz)],
                            pri_sums_c[(pri, pi)], sec_sums_c[(sec, nz, pi)])

    for ciidx, gi in enumerate(cands):
        d = dist_8x8_luma(src_y, _filter_luma(gi), cs)
        np.add.at(mse0[:, ciidx], fb_idx, d)
        if chroma:
            for pi in (1, 2):
                e = _filter_chroma(gi, pi) - src_c[pi - 1]
                np.add.at(mse1[:, ciidx], fb_idx,
                          (e * e).sum(axis=(1, 2)) >> (2 * cs))

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
    nb = 1 << bits

    # per-active-fb best gi among the selected pairs
    pair_mse = np.stack([mse0[:, l0] + mse1[:, l1]
                         for l0, l1 in zip(lev0, lev1)], axis=1)
    fb_best = np.argmin(pair_mse, axis=1)

    fb_gi_map = np.full((nvfb, nhfb), -1, np.int32)
    fb_gi_map[act_fbs // nhfb, act_fbs % nhfb] = fb_best

    y_str = [cands[l] for l in lev0]
    uv_str = [cands[l] for l in lev1]

    # ---- apply the chosen strengths to the recon (in place) -----------------
    # (full block set: the search subsample only affected the MSE estimate)
    fb_idx = fb_idx_all
    dirs, var = dirs_all, var_all
    ys_y, xs_y = ys_y_all, xs_y_all
    if chroma:
        ys_c = by8 * 4 + 2
        xs_c = bx8 * 4 + 2
    blk_gi = fb_best[fb_idx]
    y_gi = np.array(y_str, np.int64)[blk_gi]
    uv_gi = np.array(uv_str, np.int64)[blk_gi]

    pri_y = (y_gi // CDEF_SEC_STRENGTHS) << cs
    sec_y = y_gi % CDEF_SEC_STRENGTHS
    sec_y = (sec_y + (sec_y == 3)) << cs
    t_y = adjust_strength(pri_y, var)
    d_y = np.where(pri_y != 0, dirs, 0)
    m = y_gi != 0
    if np.any(m):
        o = filter_blocks(pad[0], ys_y[m], xs_y[m], 8, 8, t_y[m],
                          sec_y[m], d_y[m], ydamp, ydamp, cs)
        rr = (by8[m] * 8)[:, None, None] + np.arange(8)[None, :, None]
        cc = (bx8[m] * 8)[:, None, None] + np.arange(8)[None, None, :]
        recon_planes[0][rr, cc] = o.astype(np.int32)
    if chroma:
        pri_c = (uv_gi // CDEF_SEC_STRENGTHS) << cs
        sec_c = uv_gi % CDEF_SEC_STRENGTHS
        sec_c = (sec_c + (sec_c == 3)) << cs
        d_c = np.where(pri_c != 0, dirs, 0)
        mc = uv_gi != 0
        if np.any(mc):
            rr = (by8[mc] * 4)[:, None, None] + np.arange(4)[None, :, None]
            cc = (bx8[mc] * 4)[:, None, None] + np.arange(4)[None, None, :]
            for pi in (1, 2):
                o = filter_blocks(pad[pi], ys_c[mc], xs_c[mc], 4, 4,
                                  pri_c[mc], sec_c[mc], d_c[mc],
                                  cdamp, cdamp, cs)
                recon_planes[pi][rr, cc] = o.astype(np.int32)

    return bits, y_str, uv_str, fb_gi_map, damping
