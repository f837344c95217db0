"""Loop restoration (spec 7.17): Wiener + self-guided (SGR) filters.

Spec-exact integer apply over the striped geometry:

* The frame is processed in 64-luma-row stripes offset up by 8
  (RESTORATION_UNIT_OFFSET), so luma stripes span rows [0,56), [56,120)...
* Within 3 rows of a stripe boundary the filter context comes from the
  *deblocked* (pre-CDEF) frame: 2 saved rows expanded to 3 by duplication
  (reference restoration.c:304-345 setup_processing_stripe_boundary,
  :1522 save_deblock_boundary_lines). At the frame top/bottom the CDEF
  frame's own edge replication is used (restoration.c:258 boundary info).
* Restoration units are unitSize squares; the last row/column absorbs a
  remainder < unitSize/2 (restoration.c:1250 foreach_rest_unit_in_tile),
  and unit rows are shifted up by the stripe offset.

Filters (bit-exact vs svt_av1_wiener_convolve_add_src_c convolve.c:100
and svt_apply_selfguided_restoration_c restoration.c:963, fuzzed against
the compiled C oracle in tests/test_restoration.py):

* Wiener: 7-tap separable integer convolve in "add src" differential
  form — horizontal pass to a clamped intermediate (round0=3), vertical
  pass back to pixels (round1=11); 12-bit shifts round0/1 by +2/-2.
* SGR: two guided box filters (radius 2 on a half-row grid + radius 1
  dense), normative x/(x+1) and 1/x tables, projected onto the source
  via signalled xqd weights.

Host numpy implementation: the per-frame search tier batches whole
stripes; the arithmetic is integer-exact as the spec requires.
"""

from __future__ import annotations

import numpy as np

RESTORE_NONE = 0
RESTORE_WIENER = 1
RESTORE_SGRPROJ = 2
RESTORE_SWITCHABLE = 3

RESTORATION_PROC_UNIT_SIZE = 64
RESTORATION_UNIT_OFFSET = 8
RESTORATION_BORDER = 3
RESTORATION_CTX_VERT = 2
RESTORATION_UNITSIZE_MAX = 256

WIENER_HALFWIN = 3
WIENER_WIN = 7
WIENER_WIN_CHROMA = 5
WIENER_FILT_STEP = 128

# wiener tap quantization ranges (restoration.h:131-153)
WIENER_TAPS_MID = (3, -7, 15)
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)

SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR_BITS = 8
SGRPROJ_SGR = 1 << SGRPROJ_SGR_BITS
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_PRJ_MIN0 = -(1 << SGRPROJ_PRJ_BITS) * 3 // 4  # -96
SGRPROJ_PRJ_MAX0 = SGRPROJ_PRJ_MIN0 + (1 << SGRPROJ_PRJ_BITS) - 1  # 31
SGRPROJ_PRJ_MIN1 = -(1 << SGRPROJ_PRJ_BITS) // 4  # -32
SGRPROJ_PRJ_MAX1 = SGRPROJ_PRJ_MIN1 + (1 << SGRPROJ_PRJ_BITS) - 1  # 95
SGRPROJ_PRJ_SUBEXP_K = 4

# (r0, r1, s0, s1) per ep — normative parameter sets (spec 7.17.3 /
# restoration.c:85 svt_aom_eb_sgr_params; s = GenSgrprojVtable()).
SGR_PARAMS = (
    (2, 1, 140, 3236), (2, 1, 112, 2158), (2, 1, 93, 1618), (2, 1, 80, 1438),
    (2, 1, 70, 1295), (2, 1, 58, 1177), (2, 1, 47, 1079), (2, 1, 37, 996),
    (2, 1, 30, 925), (2, 1, 25, 863), (0, 1, -1, 2589), (0, 1, -1, 1618),
    (0, 1, -1, 1177), (0, 1, -1, 925), (2, 0, 56, -1), (2, 0, 22, -1),
)

# normative x/(x+1) blend table (spec Sgr_X_By_X / restoration.c:643):
# round(256 z / (z+1)) with z=0 mapped to 1 (flat-image blend floor) and
# z=255 to 256 (full local-mean); verified against the oracle's exported
# svt_aom_eb_x_by_xplus1 in tests/test_restoration.py
_z = np.arange(256, dtype=np.int64)
_X_BY_XPLUS1 = (256 * _z + (_z + 1) // 2) // (_z + 1)
_X_BY_XPLUS1[0] = 1
_X_BY_XPLUS1[255] = 256

# round(2^12 / n) for n = 1..25 (spec One_By_X / restoration.c:665)
_ONE_BY_X = np.array([4096, 2048, 1365, 1024, 819, 683, 585, 512, 455, 410,
                      372, 341, 315, 293, 273, 256, 241, 228, 216, 205, 195,
                      186, 178, 171, 164], np.int64)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def wiener_kernel7(taps3) -> np.ndarray:
    """(t0, t1, t2) -> symmetric 7-tap DIFFERENTIAL kernel: the stored
    center is -2*Σt (set_default_wiener restoration.h:249); the identity
    gain of 128 is contributed by the convolve's add-src term, making the
    effective center 128 - 2*Σt as the spec derives it."""
    t0, t1, t2 = (int(t) for t in taps3)
    return np.array([t0, t1, t2, -2 * (t0 + t1 + t2), t2, t1, t0], np.int64)


def wiener_convolve(padded: np.ndarray, htaps3, vtaps3,
                    bit_depth: int = 8) -> np.ndarray:
    """Bit-exact svt_av1_wiener_convolve_add_src (convolve.c:100,160).

    padded: (h+6, w+6) int source with the 3-pixel context ring already
    built (stripe-patched rows / edge replication); returns (h, w).
    """
    hf = wiener_kernel7(htaps3)
    vf = wiener_kernel7(vtaps3)
    bd = bit_depth
    round0 = 3 + (2 if bd == 12 else 0)
    round1 = 11 - (2 if bd == 12 else 0)
    clamp_lim = 1 << (bd + 1 + 7 - round0)
    x = padded.astype(np.int64)
    h = padded.shape[0] - 6
    w = padded.shape[1] - 6
    # horizontal pass over all h+6 rows ("add src": center pixel << 7)
    acc = np.zeros((h + 6, w), np.int64)
    for t in range(7):
        acc += hf[t] * x[:, t:t + w]
    acc += (x[:, 3:3 + w] << 7) + (1 << (bd + 7 - 1))
    mid = np.clip(_round2(acc, round0), 0, clamp_lim - 1)
    # vertical pass
    acc = np.zeros((h, w), np.int64)
    for t in range(7):
        acc += vf[t] * mid[t:t + h]
    acc += (mid[3:3 + h] << 7) - (1 << (bd + round1 - 1))
    return np.clip(_round2(acc, round1), 0, (1 << bd) - 1)


def _boxsum(x: np.ndarray, r: int) -> tuple[np.ndarray, np.ndarray]:
    """(2r+1)^2 windowed sum and sum-of-squares of x, valid region only.
    x: (H, W); returns (H-2r, W-2r) pairs."""
    x = x.astype(np.int64)

    def box(a):
        c = np.cumsum(a, axis=0)
        v = np.vstack([c[2 * r], c[2 * r + 1:] - c[:-2 * r - 1]])
        c = np.cumsum(v, axis=1)
        return np.hstack([c[:, 2 * r:2 * r + 1], c[:, 2 * r + 1:] - c[:, :-2 * r - 1]])

    return box(x), box(x * x)


def _sgr_ab(padded: np.ndarray, r: int, s: int, bit_depth: int,
            rows: np.ndarray):
    """A/B grids for radius r at the given row indices (relative to the
    block top; -1..h). padded: (h+6, w+6); returns (len(rows), w+2)
    arrays covering columns -1..w (restoration.c:710-773)."""
    h = padded.shape[0] - 6
    w = padded.shape[1] - 6
    n = (2 * r + 1) * (2 * r + 1)
    # window sums centered at (i, j) for i in rows, j in -1..w:
    # _boxsum valid output index (i, j) = center (i + r, j + r) in padded
    # coords minus r => center c maps to output index c - r. Center of
    # block coord (i, j) is padded (i+3, j+3) -> output (i+3-r, j+3-r).
    bsum, asum = _boxsum(padded, r)
    sel_r = rows + 3 - r
    sel_c = np.arange(-1, w + 1) + 3 - r
    b_raw = bsum[np.ix_(sel_r, sel_c)]
    a = _round2(asum[np.ix_(sel_r, sel_c)], 2 * (bit_depth - 8))
    b = _round2(b_raw, bit_depth - 8)
    p = np.maximum(a * n - b * b, 0)
    z = _round2(p * s, SGRPROJ_MTABLE_BITS)
    A = _X_BY_XPLUS1[np.minimum(z, 255)]
    # B blends the RAW (un-bit-depth-rounded) box sum (restoration.c:769)
    B = _round2((SGRPROJ_SGR - A) * b_raw * _ONE_BY_X[n - 1],
                SGRPROJ_RECIP_BITS)
    return A, B


def sgr_flt(padded: np.ndarray, ep: int, bit_depth: int = 8):
    """Bit-exact svt_av1_selfguided_restoration_c (restoration.c:925):
    (flt0, flt1) int (h, w) grids; a radius-0 pass returns None."""
    r0, r1, s0, s1 = SGR_PARAMS[ep]
    h = padded.shape[0] - 6
    w = padded.shape[1] - 6
    dgd = padded.astype(np.int64)[3:3 + h, 3:3 + w]
    flt0 = flt1 = None
    if r0 > 0:
        # fast filter: A/B on rows -1, 1, 3, ... only
        rows = np.arange(-1, h + 1, 2)
        A, B = _sgr_ab(padded, r0, s0, bit_depth, rows)
        # even output rows: neighbors above/below (indices in `rows`:
        # row i -> rows (i-1, i+1) = positions (i//2, i//2+1)); weights
        # 6 center-column / 5 diagonals, nb=5
        flt0 = np.zeros((h, w), np.int64)
        ev = np.arange(0, h, 2)
        up = (ev + 1) // 2 - 0  # position of row i-1 in `rows`
        dn = up + 1
        c0 = slice(0, w)
        a_mid = A[:, 1:w + 1]
        b_mid = B[:, 1:w + 1]
        a_l, a_r = A[:, 0:w], A[:, 2:w + 2]
        b_l, b_r = B[:, 0:w], B[:, 2:w + 2]
        a_e = (a_mid[up] + a_mid[dn]) * 6 + (a_l[up] + a_l[dn] + a_r[up] + a_r[dn]) * 5
        b_e = (b_mid[up] + b_mid[dn]) * 6 + (b_l[up] + b_l[dn] + b_r[up] + b_r[dn]) * 5
        flt0[ev] = _round2(a_e * dgd[ev, c0] + b_e,
                           SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
        # odd rows: own row, nb=4
        od = np.arange(1, h, 2)
        own = (od + 1) // 2
        a_o = a_mid[own] * 6 + (a_l[own] + a_r[own]) * 5
        b_o = b_mid[own] * 6 + (b_l[own] + b_r[own]) * 5
        flt0[od] = _round2(a_o * dgd[od, c0] + b_o,
                           SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS)
    if r1 > 0:
        rows = np.arange(-1, h + 1)
        A, B = _sgr_ab(padded, r1, s1, bit_depth, rows)

        def cross(M):
            mid = M[1:h + 1, 1:w + 1]
            return ((mid + M[1:h + 1, 0:w] + M[1:h + 1, 2:w + 2]
                     + M[0:h, 1:w + 1] + M[2:h + 2, 1:w + 1]) * 4
                    + (M[0:h, 0:w] + M[0:h, 2:w + 2]
                       + M[2:h + 2, 0:w] + M[2:h + 2, 2:w + 2]) * 3)

        flt1 = _round2(cross(A) * dgd + cross(B),
                       SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
    return flt0, flt1


def decode_xq(xqd, ep: int):
    """svt_decode_xq (restoration.c:634)."""
    r0, r1, _, _ = SGR_PARAMS[ep]
    if r0 == 0:
        return 0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]
    if r1 == 0:
        return xqd[0], 0
    return xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]


def apply_sgr(padded: np.ndarray, ep: int, xqd,
              bit_depth: int = 8) -> np.ndarray:
    """Bit-exact svt_apply_selfguided_restoration_c (restoration.c:963)."""
    r0, r1, _, _ = SGR_PARAMS[ep]
    flt0, flt1 = sgr_flt(padded, ep, bit_depth)
    h = padded.shape[0] - 6
    w = padded.shape[1] - 6
    dat = padded.astype(np.int64)[3:3 + h, 3:3 + w]
    xq0, xq1 = decode_xq(xqd, ep)
    u = dat << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if r0 > 0:
        v = v + xq0 * (flt0 - u)
    if r1 > 0:
        v = v + xq1 * (flt1 - u)
    out = _round2(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(out, 0, (1 << bit_depth) - 1)


# ---- striped frame geometry -------------------------------------------------

def count_units(unit_size: int, dim: int) -> int:
    """count_units_in_tile (restoration.c): last unit absorbs < size/2."""
    return max((dim + (unit_size >> 1)) // unit_size, 1)


def unit_rows_cols(unit_size: int, plane_w: int, plane_h: int, ss_y: int):
    """Per-RU pixel limits [(v0, v1)], [(h0, h1)] with the stripe offset
    applied vertically (restoration.c:1250-1282)."""
    ext = unit_size * 3 // 2
    voff = RESTORATION_UNIT_OFFSET >> ss_y
    rows = []
    y0 = 0
    while y0 < plane_h:
        rem = plane_h - y0
        h = rem if rem < ext else unit_size
        v0 = max(0, y0 - voff)
        v1 = y0 + h
        if v1 < plane_h:
            v1 -= voff
        rows.append((v0, v1))
        y0 += h
    cols = []
    x0 = 0
    while x0 < plane_w:
        rem = plane_w - x0
        w = rem if rem < ext else unit_size
        cols.append((x0, x0 + w))
        x0 += w
    return rows, cols


def stripes_in(v0: int, v1: int, ss_y: int):
    """Split RU rows [v0, v1) into processing stripes: (sv0, h) pairs
    (restoration.c:1094-1113)."""
    full = RESTORATION_PROC_UNIT_SIZE >> ss_y
    voff = RESTORATION_UNIT_OFFSET >> ss_y
    out = []
    i = v0
    while i < v1:
        tile_stripe = (i + voff) // full
        nominal = full - (voff if tile_stripe == 0 else 0)
        h = min(nominal, v1 - i)
        out.append((i, h))
        i += h
    return out


def stripe_padded(cdef: np.ndarray, deblock: np.ndarray, sv0: int, h: int,
                  plane_w: int, plane_h: int) -> np.ndarray:
    """(h+6, plane_w+6) context block for stripe rows [sv0, sv0+h):
    3 rows above/below from saved deblock rows (2 expanded to 3) unless at
    the frame edge (CDEF edge replication), 3-column horizontal edge
    replication (restoration.c:276-360)."""
    buf = np.empty((h + 6, plane_w + 6), cdef.dtype)
    mid = buf[:, 3:3 + plane_w]
    mid[3:3 + h] = cdef[sv0:sv0 + h, :plane_w]
    if sv0 == 0:
        mid[0:3] = cdef[0, :plane_w]
    else:
        r0 = deblock[sv0 - 2, :plane_w]
        r1 = deblock[sv0 - 1, :plane_w]
        mid[0] = r0
        mid[1] = r0
        mid[2] = r1
    end = sv0 + h
    if end >= plane_h:
        mid[h + 3:] = cdef[plane_h - 1, :plane_w]
    else:
        b0 = deblock[end, :plane_w]
        b1 = deblock[min(end + 1, plane_h - 1), :plane_w]
        mid[h + 3] = b0
        mid[h + 4] = b1
        mid[h + 5] = b1
    buf[:, 0:3] = buf[:, 3:4]
    buf[:, 3 + plane_w:] = buf[:, 2 + plane_w:3 + plane_w]
    return buf


def filter_unit_into(out: np.ndarray, cdef: np.ndarray, deblock: np.ndarray,
                     limits, rtype: int, params, plane_w: int, plane_h: int,
                     ss_y: int, bit_depth: int,
                     stripe_cache: dict | None = None) -> None:
    """Restore one RU (limits = (v0, v1, h0, h1)) from `cdef` into `out`
    (svt_av1_loop_restoration_filter_unit, restoration.c:1066)."""
    v0, v1, h0, h1 = limits
    if rtype == RESTORE_NONE:
        out[v0:v1, h0:h1] = cdef[v0:v1, h0:h1]
        return
    for sv0, h in stripes_in(v0, v1, ss_y):
        if stripe_cache is not None and sv0 in stripe_cache:
            pad = stripe_cache[sv0]
        else:
            pad = stripe_padded(cdef, deblock, sv0, h, plane_w, plane_h)
            if stripe_cache is not None:
                stripe_cache[sv0] = pad
        blk = pad[:, h0:h1 + 6]
        if rtype == RESTORE_WIENER:
            htaps, vtaps = params
            out[sv0:sv0 + h, h0:h1] = wiener_convolve(blk, htaps, vtaps,
                                                      bit_depth)
        else:
            ep, xqd = params
            out[sv0:sv0 + h, h0:h1] = apply_sgr(blk, ep, xqd, bit_depth)


def filter_plane(cdef: np.ndarray, deblock: np.ndarray, unit_size: int,
                 unit_data: list, plane_w: int, plane_h: int, ss_y: int,
                 bit_depth: int) -> np.ndarray:
    """Filter a whole plane. unit_data: row-major [(rtype, params)] over
    the RU grid. Returns the restored plane (aligned shape preserved;
    region beyond the crop copied through)."""
    out = cdef.copy()
    rows, cols = unit_rows_cols(unit_size, plane_w, plane_h, ss_y)
    cache: dict = {}
    i = 0
    for (v0, v1) in rows:
        for (h0, h1) in cols:
            rtype, params = unit_data[i]
            i += 1
            filter_unit_into(out, cdef, deblock, (v0, v1, h0, h1), rtype,
                             params, plane_w, plane_h, ss_y, bit_depth,
                             stripe_cache=cache)
    assert i == len(unit_data)
    return out
