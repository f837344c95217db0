"""Film grain synthesis (spec 7.18.3) — generation + application.

Output-side noise synthesis: AR-filtered gaussian grain templates
(73x82 luma / 38x44 chroma for 4:2:0), piecewise-linear scaling LUTs,
per-32x32-block random placement with 2-px overlap blending, scaled
blend into the decoded frame. References are stored PRE-grain; grain is
display-only. Counterpart: grainSynthesis.c (svt_av1_add_film_grain_run
:878, generate_luma_grain_block :382, init_scaling_function :506);
fuzzed bit-exact against that C in tests/test_film_grain.py and against
dav1d end-to-end.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_GAUSS = None
GAUSS_BITS = 11


def _gauss():
    global _GAUSS
    if _GAUSS is None:
        from ..bitstream.tables import load_tables

        _GAUSS = load_tables()["gaussian_sequence"].astype(np.int32)
    return _GAUSS


@dataclass
class FilmGrainParams:
    apply_grain: bool = True
    grain_seed: int = 0
    update_grain: bool = True
    num_y_points: int = 0
    scaling_points_y: list = field(default_factory=list)  # [(value, scaling)]
    chroma_scaling_from_luma: bool = False
    num_cb_points: int = 0
    scaling_points_cb: list = field(default_factory=list)
    num_cr_points: int = 0
    scaling_points_cr: list = field(default_factory=list)
    scaling_shift: int = 8  # grain_scaling_minus_8 + 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: list = field(default_factory=list)  # signed, -128..127
    ar_coeffs_cb: list = field(default_factory=list)
    ar_coeffs_cr: list = field(default_factory=list)
    ar_coeff_shift: int = 6  # ar_coeff_shift_minus_6 + 6
    grain_scale_shift: int = 0
    cb_mult: int = 128
    cb_luma_mult: int = 192
    cb_offset: int = 256
    cr_mult: int = 128
    cr_luma_mult: int = 192
    cr_offset: int = 256
    overlap_flag: bool = True
    clip_to_restricted_range: bool = False


class _Rng:
    """16-bit LFSR (spec get_random_number / grainSynthesis.c:360)."""

    def __init__(self, register: int):
        self.r = register & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.r
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = ((r >> 1) | (bit << 15)) & 0xFFFF
        self.r = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _stripe_rng(seed: int, luma_line: int) -> _Rng:
    """init_random_generator (grainSynthesis.c:366)."""
    r = seed & 0xFFFF
    luma_num = luma_line >> 5
    r ^= ((luma_num * 37 + 178) & 255) << 8
    r ^= (luma_num * 173 + 105) & 255
    return _Rng(r)


def _ar_positions(lag: int):
    pos = []
    for row in range(-lag, 0):
        for col in range(-lag, lag + 1):
            pos.append((row, col))
    for col in range(-lag, 0):
        pos.append((0, col))
    return pos


def generate_grain(p: FilmGrainParams, bit_depth: int,
                   ss_x: int, ss_y: int):
    """-> (luma_grain (73, 82), cb_grain, cr_grain) int32 templates."""
    gauss = _gauss()
    gss = 12 - bit_depth + p.grain_scale_shift
    half = (1 << gss) >> 1
    grain_center = 128 << (bit_depth - 8)
    gmin, gmax = -grain_center, (256 << (bit_depth - 8)) - 1 - grain_center
    pos = _ar_positions(p.ar_coeff_lag)
    shift_r = 1 << (p.ar_coeff_shift - 1)

    ly, lx = 73, 82
    luma = np.zeros((ly, lx), np.int32)
    if p.num_y_points > 0:
        rng = _Rng(p.grain_seed)
        for i in range(ly):
            for j in range(lx):
                luma[i, j] = (int(gauss[rng.bits(GAUSS_BITS)]) + half) >> gss
        coeffs = p.ar_coeffs_y
        for i in range(3, ly):
            for j in range(3, lx - 3):
                wsum = 0
                for (dr, dc), c in zip(pos, coeffs):
                    wsum += c * int(luma[i + dr, j + dc])
                luma[i, j] = int(np.clip(
                    int(luma[i, j]) + ((wsum + shift_r) >> p.ar_coeff_shift),
                    gmin, gmax))

    cy = 3 + (2 >> ss_y) * 3 + (32 >> ss_y) * 2
    cx = 3 + (2 >> ss_x) * 3 + (32 >> ss_x) * 2 + (2 >> ss_x) * 3 + 3
    cb = np.zeros((cy, cx), np.int32)
    cr = np.zeros((cy, cx), np.int32)
    do_cb = p.num_cb_points > 0 or p.chroma_scaling_from_luma
    do_cr = p.num_cr_points > 0 or p.chroma_scaling_from_luma
    if do_cb:
        rng = _stripe_rng(p.grain_seed, 7 << 5)
        for i in range(cy):
            for j in range(cx):
                cb[i, j] = (int(gauss[rng.bits(GAUSS_BITS)]) + half) >> gss
    if do_cr:
        rng = _stripe_rng(p.grain_seed, 11 << 5)
        for i in range(cy):
            for j in range(cx):
                cr[i, j] = (int(gauss[rng.bits(GAUSS_BITS)]) + half) >> gss
    if do_cb or do_cr:
        cpos = list(pos)
        use_luma = p.num_y_points > 0
        top = 3
        left = 3
        for i in range(top, cy):
            for j in range(left, cx - 3):
                wcb = wcr = 0
                for (dr, dc), ccb, ccr in zip(cpos, p.ar_coeffs_cb,
                                              p.ar_coeffs_cr):
                    wcb += ccb * int(cb[i + dr, j + dc])
                    wcr += ccr * int(cr[i + dr, j + dc])
                if use_luma:
                    lyc = ((i - top) << ss_y) + top
                    lxc = ((j - left) << ss_x) + left
                    av = int(luma[lyc:lyc + ss_y + 1,
                                  lxc:lxc + ss_x + 1].sum())
                    av = (av + ((1 << (ss_x + ss_y)) >> 1)) >> (ss_x + ss_y)
                    wcb += p.ar_coeffs_cb[len(cpos)] * av
                    wcr += p.ar_coeffs_cr[len(cpos)] * av
                if do_cb:
                    cb[i, j] = int(np.clip(
                        int(cb[i, j]) + ((wcb + shift_r) >> p.ar_coeff_shift),
                        gmin, gmax))
                if do_cr:
                    cr[i, j] = int(np.clip(
                        int(cr[i, j]) + ((wcr + shift_r) >> p.ar_coeff_shift),
                        gmin, gmax))
    return luma, cb, cr


def _scaling_lut(points) -> np.ndarray:
    """init_scaling_function (grainSynthesis.c:506)."""
    lut = np.zeros(256, np.int32)
    if not points:
        return lut
    lut[: points[0][0]] = points[0][1]
    for (x0, y0), (x1, y1) in zip(points, points[1:]):
        dx, dy = x1 - x0, y1 - y0
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for x in range(dx):
            lut[x0 + x] = y0 + ((x * delta + 32768) >> 16)
    lut[points[-1][0]:] = points[-1][1]
    return lut


def _scale_lut(lut: np.ndarray, index: np.ndarray, bit_depth: int):
    """scale_lut (grainSynthesis.c:530) — vectorized."""
    if bit_depth == 8:
        return lut[index]
    sh = bit_depth - 8
    x = index >> sh
    frac = index & ((1 << sh) - 1)
    nxt = lut[np.minimum(x + 1, 255)]
    interp = lut[x] + (((nxt - lut[x]) * frac + (1 << (sh - 1))) >> sh)
    return np.where(x == 255, lut[x], interp)


def _noise_image(grain: np.ndarray, w2: int, h2: int, sub_x: int, sub_y: int,
                 seed: int, overlap: bool, gmin: int, gmax: int,
                 rand_cache: dict) -> np.ndarray:
    """Assemble the plane noise image from the grain template
    (spec 7.18.3.5 noise stripes; plane dims ((h2<<1)>>sub_y, ...))."""
    pw = (w2 << 1) >> sub_x
    ph = (h2 << 1) >> sub_y
    bw = 32 >> sub_x  # block size in plane px
    bh = 32 >> sub_y
    ov_c = 2 >> sub_x  # overlap columns
    ov_r = 2 >> sub_y  # overlap rows
    off_base = 3 + (2 >> sub_y) * 3
    off_basex = 3 + (2 >> sub_x) * 3
    stripes = []
    n_stripes = (h2 + 15) // 16
    for s in range(n_stripes):
        key = s
        if key not in rand_cache:
            rng = _stripe_rng(seed, s * 32)
            offs = []
            for _x in range(0, w2, 16):
                r = rng.bits(8)
                offs.append(((r >> 4) & 15, r & 15))  # (off_x, off_y)
            rand_cache[key] = offs
        offs = rand_cache[key]
        stripe = np.zeros((bh + ov_r, pw), np.int64)
        for bi, (ox, oy) in enumerate(offs):
            gx = off_basex + ox * (2 >> sub_x)
            gy = off_base + oy * (2 >> sub_y)
            x0 = bi * bw
            cols = min(bw + ov_c, pw - x0)
            blk = grain[gy:gy + bh + ov_r, gx:gx + cols].astype(np.int64)
            if overlap and bi > 0:
                old = stripe[:, x0:x0 + ov_c]
                if ov_c == 1:
                    blk[:, 0] = np.clip(
                        (old[:, 0] * 23 + blk[:, 0] * 22 + 16) >> 5,
                        gmin, gmax)
                else:
                    blk[:, 0] = np.clip(
                        (old[:, 0] * 27 + blk[:, 0] * 17 + 16) >> 5,
                        gmin, gmax)
                    if cols > 1:
                        blk[:, 1] = np.clip(
                            (old[:, 1] * 17 + blk[:, 1] * 27 + 16) >> 5,
                            gmin, gmax)
            stripe[:, x0:x0 + cols] = blk
        stripes.append(stripe)
    out = np.zeros((ph, pw), np.int64)
    for s, stripe in enumerate(stripes):
        base = s * bh
        rows = min(bh, ph - base)
        blk = stripe[:rows].copy()
        if overlap and s > 0:
            prev = stripes[s - 1][bh:bh + ov_r]
            if ov_r == 1:
                blk[0] = np.clip((prev[0] * 23 + blk[0] * 22 + 16) >> 5,
                                 gmin, gmax)
            else:
                blk[0] = np.clip((prev[0] * 27 + blk[0] * 17 + 16) >> 5,
                                 gmin, gmax)
                if rows > 1:
                    blk[1] = np.clip((prev[1] * 17 + blk[1] * 27 + 16) >> 5,
                                     gmin, gmax)
        out[base:base + rows] = blk
    return out


def apply_grain(planes: list, p: FilmGrainParams, w: int, h: int,
                bit_depth: int = 8, ss_x: int = 1, ss_y: int = 1,
                mono: bool = False) -> list:
    """Return display planes with grain applied (crop dims w x h)."""
    if not p.apply_grain:
        return [pl[: (h + (i > 0) * ss_y) >> (ss_y if i else 0),
                   : (w + (i > 0) * ss_x) >> (ss_x if i else 0)].copy()
                for i, pl in enumerate(planes)]
    luma_g, cb_g, cr_g = generate_grain(p, bit_depth, ss_x, ss_y)
    grain_center = 128 << (bit_depth - 8)
    gmin, gmax = -grain_center, (256 << (bit_depth - 8)) - 1 - grain_center
    lut_y = _scaling_lut(p.scaling_points_y)
    if p.chroma_scaling_from_luma:
        lut_cb = lut_cr = lut_y
    else:
        lut_cb = _scaling_lut(p.scaling_points_cb)
        lut_cr = _scaling_lut(p.scaling_points_cr)
    maxv = (256 << (bit_depth - 8)) - 1
    if p.clip_to_restricted_range:
        min_l, max_l = 16 << (bit_depth - 8), 235 << (bit_depth - 8)
        min_c, max_c = 16 << (bit_depth - 8), 240 << (bit_depth - 8)
    else:
        min_l = min_c = 0
        max_l = max_c = maxv
    w2, h2 = w // 2, h // 2
    rand_cache: dict = {}
    rshift = 1 << (p.scaling_shift - 1)

    luma = planes[0][:h, :w].astype(np.int64)
    out = [None] * len(planes)
    if p.num_y_points > 0:
        noise = _noise_image(luma_g, w2, h2, 0, 0, p.grain_seed,
                             p.overlap_flag, gmin, gmax, rand_cache)
        sc = _scale_lut(lut_y, luma.astype(np.int32), bit_depth)
        grained = np.clip(
            luma + ((sc.astype(np.int64) * noise + rshift)
                    >> p.scaling_shift), min_l, max_l)
        out[0] = grained.astype(planes[0].dtype)
    else:
        out[0] = planes[0][:h, :w].copy()
    if mono or len(planes) < 3:
        return out[:1]
    cw = (w + ss_x) >> ss_x
    ch = (h + ss_y) >> ss_y
    apply_cb = p.num_cb_points > 0 or p.chroma_scaling_from_luma
    apply_cr = p.num_cr_points > 0 or p.chroma_scaling_from_luma
    # average luma per chroma sample (horizontal pair only, spec quirk)
    if ss_x:
        av = (luma[::(1 + ss_y), 0::2] + luma[::(1 + ss_y), 1::2] + 1) >> 1
        av = av[:ch, :cw]
    else:
        av = luma[::(1 + ss_y)][:ch, :cw]
    for pi, (g, lut, do, mult, lmult, off) in enumerate((
            (cb_g, lut_cb, apply_cb, p.cb_mult, p.cb_luma_mult, p.cb_offset),
            (cr_g, lut_cr, apply_cr, p.cr_mult, p.cr_luma_mult, p.cr_offset)),
            start=1):
        plane = planes[pi][:ch, :cw].astype(np.int64)
        if not do:
            out[pi] = planes[pi][:ch, :cw].copy()
            continue
        noise = _noise_image(g, w2, h2, ss_x, ss_y, p.grain_seed,
                             p.overlap_flag, gmin, gmax, rand_cache)
        if p.chroma_scaling_from_luma:
            m, lm, o = 0, 64, 0
        else:
            m, lm = mult - 128, lmult - 128
            o = ((off << (bit_depth - 8)) - (1 << bit_depth)) \
                if bit_depth > 8 else off - 256
        merged = np.clip(((av * lm + m * plane) >> 6) + o, 0, maxv)
        if bit_depth == 8:
            sc = lut[merged]
        else:
            sc = _scale_lut(lut, merged.astype(np.int32), bit_depth)
        grained = np.clip(
            plane + ((sc.astype(np.int64) * noise[:ch, :cw] + rshift)
                     >> p.scaling_shift), min_c, max_c)
        out[pi] = grained.astype(planes[pi].dtype)
    return out
