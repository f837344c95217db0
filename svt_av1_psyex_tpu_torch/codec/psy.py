"""PSY quality tools: variance-boost adaptive quantization.

Mirrors the fork's flagship feature (rc_process.c:1393-1700,
Docs/Appendix-Variance-Boost.md): per-superblock 8x8 source variances ->
octile-weighted representative variance -> qstep-ratio boost curve ->
per-SB delta qindex, frame qindex renormalization, and delta_q_res
selection/snapping. The variance map is a batched reduction (host numpy
here; the device MD path computes the same 8x8 variances on TPU as part
of frame analysis); the tiny per-SB scalar pass stays host-side.
"""

from __future__ import annotations

import math

import numpy as np

from ..bitstream.tables import ac_q

VAR_BOOST_MAX_DELTAQ_RANGE = 80
VAR_BOOST_MAX_QSTEP_RATIO_BOOST = 8
_STRENGTHS = [0, 0.65, 1.1, 1.6, 2.5]


def qindex_to_q_fp8(qindex: int, bit_depth: int) -> int:
    shift = {8: 6, 10: 4, 12: 3}[bit_depth]
    return ac_q(qindex, bit_depth) << shift


def _q_fp8_table(bit_depth: int) -> np.ndarray:
    tab = getattr(_q_fp8_table, "_cache", {}).get(bit_depth)
    if tab is None:
        tab = np.array([qindex_to_q_fp8(i, bit_depth) for i in range(256)],
                       np.int64)
        _q_fp8_table._cache = getattr(_q_fp8_table, "_cache", {})
        _q_fp8_table._cache[bit_depth] = tab
    return tab


def compute_qdelta_fp(qstart_fp8: int, qtarget_fp8: int, bit_depth: int) -> int:
    # first qindex whose q_fp8 >= target (ac_q is monotone in qindex);
    # falls back to 255 like the reference's linear scan
    tab = _q_fp8_table(bit_depth)
    start_index = min(int(np.searchsorted(tab, qstart_fp8, "left")), 255)
    target_index = min(int(np.searchsorted(tab, qtarget_fp8, "left")), 255)
    return target_index - start_index


def sb_variances_8x8(luma: np.ndarray, sb_x: int, sb_y: int) -> np.ndarray:
    """64 integer variances of the 8x8 sub-blocks of one 64x64 SB
    (edge SBs use the aligned/padded plane).

    Mirrors the default BLOCK_MEAN_PREC_SUB picture-analysis path
    (enc_handle.c:4280, pic_analysis_process.c:240-268): means and
    mean-squares are sampled over the EVEN rows only, in the <<8 / <<16
    fixed-point domains, with the final >>16 floor. Verified bit-exact
    against the reference's DEBUG_VAR_BOOST variance dumps."""
    blk = luma[sb_y : sb_y + 64, sb_x : sb_x + 64].astype(np.int64)
    t = blk.reshape(8, 8, 8, 8).transpose(0, 2, 1, 3).reshape(64, 8, 8)
    sub = t[:, 0::2, :]  # svt_compute_sub_mean_8x8: every other row
    s = sub.sum(axis=(1, 2))
    s2 = (sub * sub).sum(axis=(1, 2))
    mean_fp8 = s << 3        # (sum << 8) / 32
    meansq_fp16 = s2 << 11   # (sumsq << 16) / 32
    return ((meansq_fp16 - mean_fp8 * mean_fp8) >> 16).astype(np.int64)


def variance_boost(base_q_idx: int, variances: np.ndarray, strength: int,
                   bit_depth: int, octile: int, curve: int) -> int:
    """av1_get_deltaq_sb_variance_boost equivalent."""
    ordered = np.sort(variances)
    mid_idx = octile * 8 - 1
    low_idx = max(7, mid_idx - 8)
    upp_idx = min(63, mid_idx + 8)
    variance = (int(ordered[low_idx]) + 2 * int(ordered[mid_idx])
                + int(ordered[upp_idx]) + 2) // 4
    if variance == 0:
        variance = 1
    if curve == 1:
        qstep_ratio = 0.25 * strength * (-math.log2(variance) + 8) + 1
    elif curve == 2:
        qstep_ratio = 0.15 * strength * (-math.log2(variance) + 10) + 1
    else:
        qstep_ratio = math.pow(1.018, _STRENGTHS[strength] * (-10 * math.log2(variance) + 80))
    qstep_ratio = min(max(qstep_ratio, 1.0), VAR_BOOST_MAX_QSTEP_RATIO_BOOST)
    base_q = qindex_to_q_fp8(base_q_idx, bit_depth)
    target_q = int(base_q / qstep_ratio)
    if curve == 2:
        boost = (base_q_idx + 496) * -compute_qdelta_fp(base_q, target_q, bit_depth) // (255 + 1024)
    else:
        boost = (base_q_idx + 40) * -compute_qdelta_fp(base_q, target_q, bit_depth) // (255 + 40)
    return min(VAR_BOOST_MAX_DELTAQ_RANGE, boost)


def variance_adjust_qp(luma_aligned: np.ndarray, base_q_idx: int, strength: int,
                       octile: int, curve: int, bit_depth: int,
                       sb_size: int = 64,
                       qpm_offsets: np.ndarray | None = None
                       ) -> tuple[int, np.ndarray, int]:
    """svt_variance_adjust_qp + normalize_sb_delta_q equivalent.

    qpm_offsets: optional per-SB TPL QPM qindex offsets applied BEFORE
    the variance boost (svt_aom_sb_qp_derivation_tpl_la order: QPM then
    boost then base normalization, rc_process.c:1626/1543).

    Returns (new_base_q_idx, per-SB qindex map (rows, cols), delta_q_res).
    """
    h, w = luma_aligned.shape
    rows = (h + sb_size - 1) // sb_size
    cols = (w + sb_size - 1) // sb_size
    # edge-replicate up to whole SBs so partial edge superblocks (aligned
    # dims are 8-multiples, not 64) still yield 64 8x8 sub-variances
    if h % sb_size or w % sb_size:
        luma_aligned = np.pad(luma_aligned,
                              ((0, rows * sb_size - h), (0, cols * sb_size - w)),
                              mode="edge")
    qmap = np.zeros((rows, cols), np.int32)
    for r in range(rows):
        for c in range(cols):
            sb_q = base_q_idx
            if qpm_offsets is not None:
                off = int(qpm_offsets[r, c])
                off = int(np.clip(off, -143, 143))  # +-(delta_q_res*9*4-1)
                sb_q = int(np.clip(sb_q + off, 1, 255))
            variances = sb_variances_8x8(luma_aligned, c * sb_size, r * sb_size)
            # boost derives from the FRAME base q; it subtracts from the
            # QPM-adjusted SB qindex (svt_variance_adjust_qp)
            boost = variance_boost(base_q_idx, variances, strength,
                                   bit_depth, octile, curve)
            qmap[r, c] = np.clip(sb_q - boost, 1, 255)

    min_q = int(qmap.min())
    max_q = int(qmap.max())
    rng = min(max_q - min_q, VAR_BOOST_MAX_DELTAQ_RANGE)
    new_base = min_q + (rng >> 1)
    offset = np.clip(qmap - new_base, -(VAR_BOOST_MAX_DELTAQ_RANGE >> 1),
                     VAR_BOOST_MAX_DELTAQ_RANGE >> 1)
    qmap = np.clip(new_base + offset, 1, 255)

    # delta_q_res selection + snapping (normalize_sb_delta_q)
    if new_base >= 160:
        res = 8
    elif new_base >= 120:
        res = 4
    elif new_base >= 80:
        res = 2
    else:
        res = 1
    if res > 1:
        rem = new_base & (res - 1)
        snapped = ((qmap - rem) // res) * res + rem
        qmap = np.clip(snapped, 1, 255)
        # clipping may break res alignment at the extremes; realign toward
        # the valid range (the delta chain requires qindex = base (mod res))
        mis = (qmap - rem) % res
        qmap = np.where(mis != 0,
                        np.where(qmap + (res - mis) <= 255,
                                 qmap + (res - mis), qmap - mis),
                        qmap)
        qmap = np.clip(qmap, 1, 255)
    return new_base, qmap.astype(np.int32), res


def low_q_taper(sb_qmap, scs_qindex: int):
    """Dampen variance-boost q drops at very low q (lowq_taper,
    rc_process.c:1721): below qindex 44 the boost is scaled back by a
    quadratic dampener so near-lossless SBs don't over-spend."""
    import numpy as np

    thr = min(44, int(scs_qindex))
    out = np.asarray(sb_qmap).copy()
    it = np.nditer(out, flags=["multi_index"])
    for v in it:
        q = int(v)
        if q < thr and q < scs_qindex:
            boost = scs_qindex - q
            beyond = boost if thr == scs_qindex else thr - q
            before = boost - beyond
            x = 1.0 - q / thr if thr else 0.0
            damp = ((-0.3 * x * x + x) / x) if x > 0 else 1.0
            out[it.multi_index] = scs_qindex - int(before + beyond * damp)
    return out
