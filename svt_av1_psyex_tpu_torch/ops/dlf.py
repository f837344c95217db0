"""Deblocking loop filter (spec 7.14, encoder-side exact recon filtering).

Counterparts in the reference:
  - deblocking_filter.c:163-285 (set_lpf_parameters: per-edge tx/skip/pu
    rules, filter length selection), 144-159 (get_transform_size),
    1051-1140 (svt_av1_pick_filter_level_by_q: level-from-qindex fit),
    548-655 (per-SB driver; here flattened to frame-wide passes).
  - deblocking_common.c:89-140 (svt_aom_update_sharpness limits),
    143-240 (filter_mask*/flat_mask*/hev_mask/filter4),
    274-310/345-370 (filter6/filter8), 762-785 (filter14).

Design notes (TPU-first rewrite, not a translation):
  * Levels are constant per plane/direction in our streams
    (loop_filter_delta_enabled=0, no segmentation), so every edge of a
    pass shares one (lim, mblim, hev) triple.
  * Within one pass (vertical or horizontal), no edge's writes overlap
    another edge's reads: all reads/writes stay inside the two TUs
    adjacent to the edge (filter4 touches ±2 on 4px TUs, filter8 ±3/±4
    on 8px, filter14 ±6/±7 on >=16px TUs, and TUs tile the frame).
    Hence each pass is computed as one vectorized gather/compute/scatter
    from the pre-pass frame — bit-exact vs. the sequential scan.
  * The spec's normative order (7.14.1) is: per plane, ALL vertical
    edges, then ALL horizontal edges. Horizontal edges are filtered by
    transposing and reusing the vertical kernels.

High bit depth shifts thresholds and the filter4 working domain by bd-8
(highbd_* kernel variants in deblocking_common.c).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.tables import ac_q
from ..codec.constants import (
    BLOCK_H,
    BLOCK_W,
    MAX_TX_SIZE_RECT,
    TX_H,
    TX_W,
    Partition,
    block_size_of,
    subsize as subsize_of,
)

MAX_LOOP_FILTER = 63

# reference sequence_control_set.c:113-128 resolution classes
_RES_THRESH = [0x28500, 0x4CE00, 0xA1400, 0x16DA00, 0x535200, 0x140A000]
# reference deblocking_filter.c:26
_INTER_FRAME_MULT = [6017, 6017, 6017, 12034, 12034, 12034, 12034]


def _input_resolution(num_pixels: int) -> int:
    for i, th in enumerate(_RES_THRESH):
        if num_pixels < th:
            return i
    return 6


def pick_filter_level_by_q(qindex: int, is_key: bool, bit_depth: int,
                           num_pixels: int) -> list[int]:
    """svt_av1_pick_filter_level_by_q (deblocking_filter.c:1054-1140)
    without the ME-based skip heuristic. Returns [y_vert, y_horz, u, v]."""
    q = ac_q(qindex, bit_depth)
    mult = _INTER_FRAME_MULT[_input_resolution(num_pixels)]
    if bit_depth == 8:
        if is_key:
            filt = (q * 17563 - 421574 + (1 << 17)) >> 18
        else:
            filt = (q * mult + 650707 + (1 << 17)) >> 18
    elif bit_depth == 10:
        filt = (q * 20723 + 4060632 + (1 << 19)) >> 20
    else:
        filt = (q * 20723 + 16242526 + (1 << 21)) >> 22
    if bit_depth != 8 and is_key:
        filt -= 4
    chroma = int(filt / 2) if filt >= 0 else -int(-filt / 2)  # C trunc div
    clamp = lambda v: max(0, min(MAX_LOOP_FILTER, v))
    return [clamp(filt), clamp(filt), clamp(chroma), clamp(chroma)]


def filter_limits(level: int, sharpness: int) -> tuple[int, int, int]:
    """(lim, mblim, hev_thr) for one level — svt_aom_update_sharpness
    (deblocking_common.c) + hev_thr = level >> 4 (lf init, line 48)."""
    block_inside_limit = level >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        block_inside_limit = min(block_inside_limit, 9 - sharpness)
    block_inside_limit = max(block_inside_limit, 1)
    return block_inside_limit, 2 * (level + 2) + block_inside_limit, level >> 4


# ---- vectorized filter kernels (vertical-edge orientation) ---------------------
# P: (H, W) int32 plane; ys/xs: per-pixel row/col indices of edge positions
# (the edge is between columns xs-1 and xs). Scalar thresholds.


def _c8(v, sh: int = 0):
    return np.clip(v, -128 << sh, (128 << sh) - 1)


def _rpot(v, n):
    return (v + (1 << (n - 1))) >> n


def _filter4_core(cols, lim, mblim, hev_t, mask=None, sh: int = 0):
    """filter4 (deblocking_common.c:212-240; highbd variant shifts the
    working domain by bd-8). cols[k] = pixel column at offset k from the
    edge. `mask` is the caller's filter_mask for the longer filters'
    fallback path; None => compute filter_mask2 here."""
    p1, p0, q0, q1 = cols[-2], cols[-1], cols[0], cols[1]
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    if mask is None:
        mask = ~((np.abs(p1 - p0) > lim) | (np.abs(q1 - q0) > lim)
                 | (np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 > mblim))
    t80 = 128 << sh
    ps1, ps0, qs0, qs1 = p1 - t80, p0 - t80, q0 - t80, q1 - t80
    f = np.where(hev, _c8(ps1 - qs1, sh), 0)
    f = np.where(mask, _c8(f + 3 * (qs0 - ps0), sh), 0)
    f1 = _c8(f + 4, sh) >> 3
    f2 = _c8(f + 3, sh) >> 3
    oq0 = _c8(qs0 - f1, sh) + t80
    op0 = _c8(ps0 + f2, sh) + t80
    f3 = np.where(hev, 0, _rpot(f1, 1))
    oq1 = _c8(qs1 - f3, sh) + t80
    op1 = _c8(ps1 + f3, sh) + t80
    return op1, op0, oq0, oq1


def _edge_filter_cols(P, ys, xs, length, lim, mblim, hev_t, sh: int = 0):
    """Filter vertical edges at per-pixel positions (ys, xs) with one
    filter length; gathers from P, returns (offsets, new_cols) to scatter."""
    reach = {4: 2, 6: 3, 8: 4, 14: 7}[length]
    cols = {k: P[ys, xs + k].astype(np.int64) for k in range(-reach, reach)}
    ft = 1 << sh  # flat threshold

    if length == 4:
        op1, op0, oq0, oq1 = _filter4_core(cols, lim, mblim, hev_t, sh=sh)
        return {-2: op1, -1: op0, 0: oq0, 1: oq1}

    p0, q0 = cols[-1], cols[0]
    if length == 6:
        p2, p1, q1, q2 = cols[-3], cols[-2], cols[1], cols[2]
        mask = ~((np.abs(p2 - p1) > lim) | (np.abs(p1 - p0) > lim)
                 | (np.abs(q1 - q0) > lim) | (np.abs(q2 - q1) > lim)
                 | (np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 > mblim))
        flat = ~((np.abs(p1 - p0) > ft) | (np.abs(q1 - q0) > ft)
                 | (np.abs(p2 - p0) > ft) | (np.abs(q2 - q0) > ft))
        op1, op0, oq0, oq1 = _filter4_core(cols, lim, mblim, hev_t, mask, sh=sh)
        sel = flat & mask
        out = {
            -2: np.where(sel, _rpot(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3), op1),
            -1: np.where(sel, _rpot(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3), op0),
            0: np.where(sel, _rpot(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3), oq0),
            1: np.where(sel, _rpot(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3), oq1),
        }
        return out

    p3, p2, p1 = cols[-4], cols[-3], cols[-2]
    q1, q2, q3 = cols[1], cols[2], cols[3]
    mask = ~((np.abs(p3 - p2) > lim) | (np.abs(p2 - p1) > lim)
             | (np.abs(p1 - p0) > lim) | (np.abs(q1 - q0) > lim)
             | (np.abs(q2 - q1) > lim) | (np.abs(q3 - q2) > lim)
             | (np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 > mblim))
    flat = ~((np.abs(p1 - p0) > ft) | (np.abs(q1 - q0) > ft)
             | (np.abs(p2 - p0) > ft) | (np.abs(q2 - q0) > ft)
             | (np.abs(p3 - p0) > ft) | (np.abs(q3 - q0) > ft))
    op1_4, op0_4, oq0_4, oq1_4 = _filter4_core(cols, lim, mblim, hev_t, mask, sh=sh)
    sel8 = flat & mask
    out = {
        -3: np.where(sel8, _rpot(p3 * 3 + 2 * p2 + p1 + p0 + q0, 3), cols[-3]),
        -2: np.where(sel8, _rpot(p3 * 2 + p2 + 2 * p1 + p0 + q0 + q1, 3), op1_4),
        -1: np.where(sel8, _rpot(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2, 3), op0_4),
        0: np.where(sel8, _rpot(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3, 3), oq0_4),
        1: np.where(sel8, _rpot(p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3, 3), oq1_4),
        2: np.where(sel8, _rpot(p0 + q0 + q1 + 2 * q2 + 3 * q3, 3), cols[2]),
    }
    if length == 8:
        return out

    p6, p5, p4 = cols[-7], cols[-6], cols[-5]
    q4, q5, q6 = cols[4], cols[5], cols[6]
    flat2 = ~((np.abs(p4 - p0) > ft) | (np.abs(q4 - q0) > ft)
              | (np.abs(p5 - p0) > ft) | (np.abs(q5 - q0) > ft)
              | (np.abs(p6 - p0) > ft) | (np.abs(q6 - q0) > ft))
    sel14 = flat2 & sel8
    t = {
        -6: _rpot(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4),
        -5: _rpot(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1, 4),
        -4: _rpot(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2, 4),
        -3: _rpot(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3, 4),
        -2: _rpot(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4, 4),
        -1: _rpot(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5, 4),
        0: _rpot(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6, 4),
        1: _rpot(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2, 4),
        2: _rpot(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3, 4),
        3: _rpot(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4, 4),
        4: _rpot(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5, 4),
        5: _rpot(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4),
    }
    final = {}
    for k in range(-6, 6):
        base = out.get(k, cols[k])
        final[k] = np.where(sel14, t[k], base)
    return final


def _apply_pass(P, ys, xs, lengths, lim, mblim, hev_t, sh: int = 0):
    """Run one direction's pass: per-pixel edge positions with lengths,
    scatter results back into P (in place)."""
    for L in (4, 6, 8, 14):
        m = lengths == L
        if not np.any(m):
            continue
        ey, ex = ys[m], xs[m]
        new = _edge_filter_cols(P, ey, ex, L, lim, mblim, hev_t, sh=sh)
        for k, v in new.items():
            P[ey, ex + k] = v


# ---- per-plane edge enumeration -------------------------------------------------


def _plane_grids(bsize_g, skip_inter_g, ss_x, ss_y, n_r4, n_c4, txd_g=None):
    """Per-plane-4px-cell tx dims / block dims / skip-inter, gathered from
    the luma mi grids (chroma maps to the bottom/right mi of the co-located
    luma 8x8, deblocking_filter.c:188-189). txd_g is the per-mi luma tx
    split depth (TX_MODE_SELECT); chroma TUs derive from block dims only."""
    from ..codec.constants import SPLIT_TX_SIZE

    r4 = np.arange(n_r4)
    c4 = np.arange(n_c4)
    mi_r = (r4 << ss_y) | ss_y
    mi_c = (c4 << ss_x) | ss_x
    mi_r = np.minimum(mi_r, bsize_g.shape[0] - 1)
    mi_c = np.minimum(mi_c, bsize_g.shape[1] - 1)
    b = bsize_g[np.ix_(mi_r, mi_c)]
    si = skip_inter_g[np.ix_(mi_r, mi_c)].astype(bool)
    if txd_g is None or (ss_x or ss_y):
        td = np.zeros_like(b)
    else:
        td = txd_g[np.ix_(mi_r, mi_c)]

    key = b * 4 + td
    nb = int(key.max()) + 1
    txw_lut = np.zeros(nb, np.int32)
    txh_lut = np.zeros(nb, np.int32)
    bw_lut = np.zeros(nb, np.int32)
    bh_lut = np.zeros(nb, np.int32)
    for k in np.unique(key):
        k = int(k)
        bs, depth = k >> 2, k & 3
        if ss_x or ss_y:
            pw = max(BLOCK_W[bs] >> ss_x, 4)
            ph = max(BLOCK_H[bs] >> ss_y, 4)
            tx = MAX_TX_SIZE_RECT[block_size_of(pw, ph)]
            # av1_get_adjusted_tx_size: cap chroma TUs at 32 (utility.h:117)
            txw_lut[k] = min(TX_W[tx], 32)
            txh_lut[k] = min(TX_H[tx], 32)
            bw_lut[k] = pw
            bh_lut[k] = ph
        else:
            tx = int(MAX_TX_SIZE_RECT[bs])
            for _ in range(depth):
                tx = int(SPLIT_TX_SIZE[tx])
            txw_lut[k] = TX_W[tx]
            txh_lut[k] = TX_H[tx]
            bw_lut[k] = BLOCK_W[bs]
            bh_lut[k] = BLOCK_H[bs]
    return txw_lut[key], txh_lut[key], bw_lut[key], bh_lut[key], si


def loop_filter_frame(planes, disp_w: int, disp_h: int, levels, sharpness: int,
                      bsize_g: np.ndarray, skip_inter_g: np.ndarray,
                      ss_x: int, ss_y: int, bit_depth: int = 8,
                      txd_g: np.ndarray | None = None) -> None:
    """Filter recon planes in place (8-bit values in int32 arrays).

    planes: [Y, U, V] aligned int32 recon; levels: [y_vert, y_horz, u, v];
    bsize_g/skip_inter_g: per-luma-mi grids (skip && is_inter).
    Plane display dims follow setup_dst_planes (deblocking_filter.c:100):
    luma unpadded w/h, chroma = luma >> 1.
    """
    for plane, P in enumerate(planes):
        sx = 0 if plane == 0 else ss_x
        sy = 0 if plane == 0 else ss_y
        lvl_v = levels[0] if plane == 0 else levels[1 + plane]
        lvl_h = levels[1] if plane == 0 else levels[1 + plane]
        if plane == 0 and not levels[0] and not levels[1]:
            return  # reference breaks out of the plane loop entirely
        if plane > 0 and not lvl_v:
            continue
        # ceil-rounded plane dims: dav1d filters the edge at the last
        # (partial) chroma column/row of odd-sized frames; verified
        # empirically at 65x49 (the reference floors here, but it also pads
        # its input to even dims so the cases coincide for it)
        pw = (disp_w + sx) >> sx
        ph = (disp_h + sy) >> sy
        n_c4 = (pw + 3) >> 2
        n_r4 = (ph + 3) >> 2
        txw, txh, bw, bh, si = _plane_grids(bsize_g, skip_inter_g, sx, sy,
                                            n_r4, n_c4, txd_g)
        ci = np.arange(n_c4)[None, :] * 4  # plane x coord of each cell
        ri = np.arange(n_r4)[:, None] * 4

        for direction in (0, 1):  # 0 = vertical edges, 1 = horizontal
            lvl = lvl_v if direction == 0 else lvl_h
            if not lvl:
                continue
            sh = bit_depth - 8
            lim, mblim, hev_t = filter_limits(lvl, sharpness)
            lim, mblim, hev_t = lim << sh, mblim << sh, hev_t << sh
            if direction == 0:
                coord, tdim, pdim = ci, txw, bw
            else:
                coord, tdim, pdim = ri, txh, bh
            is_txb = (coord % tdim) == 0
            prev_si = np.roll(si, 1, axis=1 - direction)
            prev_td = np.roll(tdim, 1, axis=1 - direction)
            pu_edge = (coord % pdim) == 0
            apply = is_txb & (coord > 0) & (~(prev_si & si) | pu_edge)
            min_td = np.minimum(tdim, prev_td)
            if plane == 0:
                lengths = np.where(min_td == 4, 4, np.where(min_td == 8, 8, 14))
            else:
                lengths = np.where(min_td == 4, 4, 6)
            lengths = np.where(apply, lengths, 0)

            cell_r, cell_c = np.nonzero(lengths)
            if cell_r.size == 0:
                continue
            L = lengths[cell_r, cell_c]
            # expand each cell edge to its 4 pixel rows (or columns)
            sub = np.arange(4)
            if direction == 0:
                ys = (cell_r[:, None] * 4 + sub).ravel()
                xs = np.repeat(cell_c * 4, 4)
                _apply_pass(P, ys, xs, np.repeat(L, 4), lim, mblim, hev_t, sh)
            else:
                # horizontal edges == vertical edges of the transpose
                PT = P.T
                ys = (cell_c[:, None] * 4 + sub).ravel()
                xs = np.repeat(cell_r * 4, 4)
                _apply_pass(PT, ys, xs, np.repeat(L, 4), lim, mblim, hev_t, sh)


def collect_lf_grids(sb_plans, mi_rows: int, mi_cols: int, sb_mi: int):
    """Walk the per-SB partition trees and fill per-mi bsize / skip&&inter /
    coded-skip grids for the in-loop filters (the reference reads these from
    mi_grid_base; we rebuild them from the MD output)."""
    bsize_g = np.zeros((mi_rows, mi_cols), np.int32)
    skip_inter_g = np.zeros((mi_rows, mi_cols), bool)
    skip_g = np.zeros((mi_rows, mi_cols), bool)
    txd_g = np.zeros((mi_rows, mi_cols), np.int32)

    def walk(node, r, c, bsize):
        if node.partition == Partition.NONE:
            leaf = node.leaf
            h4 = max(BLOCK_H[bsize] >> 2, 1)
            w4 = max(BLOCK_W[bsize] >> 2, 1)
            r1, c1 = min(r + h4, mi_rows), min(c + w4, mi_cols)
            bsize_g[r:r1, c:c1] = bsize
            skip_inter_g[r:r1, c:c1] = bool(leaf.skip) and leaf.is_inter
            skip_g[r:r1, c:c1] = bool(leaf.skip)
            # inter depth-1 is a uniform vartx split, so per-mi tx size is
            # the split size everywhere in the block (same as intra depth).
            # SKIP inter blocks code no tx size — the decoder infers the
            # block-max tx (dav1d sets b->tx = max for skip), so their
            # committed trial depth must NOT leak into the filter masks
            # (fixes a +-1 bottom-edge recon divergence at 720p p8)
            txd_g[r:r1, c:c1] = (0 if (leaf.skip and leaf.is_inter)
                                 else leaf.tx_depth)
            return
        half = max(BLOCK_W[bsize] >> 3, 1)
        sub = subsize_of(node.partition, bsize)
        if node.partition == Partition.SPLIT:
            coords = [(r, c), (r, c + half), (r + half, c), (r + half, c + half)]
            for child, (rr, cc) in zip(node.children, coords):
                if rr < mi_rows and cc < mi_cols:
                    walk(child, rr, cc, sub)
        elif node.partition == Partition.HORZ:
            walk(node.children[0], r, c, sub)
            if len(node.children) > 1 and r + half < mi_rows:
                walk(node.children[1], r + half, c, sub)
        elif node.partition == Partition.VERT:
            walk(node.children[0], r, c, sub)
            if len(node.children) > 1 and c + half < mi_cols:
                walk(node.children[1], r, c + half, sub)
        elif node.partition in (Partition.HORZ_A, Partition.HORZ_B,
                                Partition.VERT_A, Partition.VERT_B):
            sq = subsize_of(Partition.SPLIT, bsize)
            if node.partition == Partition.HORZ_A:
                coords = [(r, c, sq), (r, c + half, sq), (r + half, c, sub)]
            elif node.partition == Partition.HORZ_B:
                coords = [(r, c, sub), (r + half, c, sq),
                          (r + half, c + half, sq)]
            elif node.partition == Partition.VERT_A:
                coords = [(r, c, sq), (r + half, c, sq), (r, c + half, sub)]
            else:
                coords = [(r, c, sub), (r, c + half, sq),
                          (r + half, c + half, sq)]
            for child, (rr, cc, sb) in zip(node.children, coords):
                walk(child, rr, cc, sb)
        elif node.partition == Partition.HORZ_4:
            q4 = max(BLOCK_H[bsize] >> 4, 1)
            for i, child in enumerate(node.children):
                walk(child, r + i * q4, c, sub)
        elif node.partition == Partition.VERT_4:
            q4 = max(BLOCK_W[bsize] >> 4, 1)
            for i, child in enumerate(node.children):
                walk(child, r, c + i * q4, sub)
        else:
            raise NotImplementedError(f"partition {node.partition}")

    for node, r, c in sb_plans:
        walk(node, r, c, 12)  # B64X64 superblocks
    return bsize_g, skip_inter_g, skip_g, txd_g


def search_filter_level(src_luma: np.ndarray, recon_planes, disp_w: int,
                        disp_h: int, qindex: int, is_key: bool,
                        sharpness: int, bsize_g, skip_inter_g, ss_x: int,
                        ss_y: int, bit_depth: int,
                        txd_g=None) -> list[int]:
    """Frame-level luma filter-level search (the reference's
    enable_dlf_flag=2 quality mode, deblocking_filter.c search /
    libaom search_filter_level): halving-step descent around the
    q-derived level, scored by luma SSE vs the source on a filtered
    copy. Chroma levels stay q-derived. Returns [y_v, y_h, u, v]."""
    base = pick_filter_level_by_q(qindex, is_key, bit_depth,
                                  disp_w * disp_h)
    max_level = 63

    src = src_luma[:disp_h, :disp_w].astype(np.int64)

    def sse_at(level: int) -> float:
        if level == 0:
            rec = recon_planes[0]
            return float(((src - rec[:disp_h, :disp_w]) ** 2).sum())
        cp = [recon_planes[0].copy()]
        loop_filter_frame(cp, disp_w, disp_h, [level, level, 0, 0],
                          sharpness, bsize_g, skip_inter_g, ss_x, ss_y,
                          bit_depth, txd_g=txd_g)
        return float(((src - cp[0][:disp_h, :disp_w]) ** 2).sum())

    cur = int(np.clip(base[0], 0, max_level))
    best_sse = sse_at(cur)
    # bias toward the q-derived level (libaom's bias_to_filt_lvl role):
    # a candidate must beat it meaningfully to move
    step = max(cur >> 1, 2)
    cache = {cur: best_sse}
    while step >= 1:
        for cand in (cur - step, cur + step):
            if not (0 <= cand <= max_level) or cand in cache:
                continue
            s = sse_at(cand)
            cache[cand] = s
            if s < best_sse:
                best_sse = s
                cur = cand
        step >>= 1
    return [cur, cur, base[2], base[3]]
