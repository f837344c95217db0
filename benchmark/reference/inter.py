"""Plain PyTorch reference of the device inter analysis that mode
decision reads on every inter frame.

A frozen copy of the arithmetic of the port's device/inter.py
`inter_analysis` over the whole frame, with the motion search of its
device/me.py written out plainly:

* HME level 0 at 1/16 scale (frames of 128 rows and columns or more):
  every shift in +-16 of each superblock's 4x4 tile, out-of-frame
  samples costing maxpix, scored sad * 16 + |dy| + |dx|;
* level 1 at 1/4 scale: +-8 around the scaled level-0 winner, likewise;
* level 2 at full scale: the 8x8-box SAD lattices (sad.py) of the
  80x80 windows around the scaled level-1 winner and around the zero
  MV, edge-replicated; every block size takes its own argmin of the
  summed boxes, the zero window winning ties;

then, for every block of every depth, the candidates' J: the intra
analysis' seven modes (intra.py), per reference NEWMV at the searched
MV and the zero MV, and with two references or more the compound pair
of both (the rounded average of the two predictions), each through the
fullloop chain (fullloop.py) with the MV-rate proxy and the psy term,
and the RD reduction to the first candidate of least J. It returns the
packed row: per depth (j, cand, mv_y, mv_x, mv_y1, mv_x1).
"""

from __future__ import annotations

import numpy as np
import torch

from .fullloop import fullloop, tables
from .intra import analyze_depth, extract_blocks, psy_energy, qp6_for
from .sad import sad_lattice

R0, R1, R2 = 16, 8, 8
N_MODES = 7                       # the intra analysis' modes
MV_RATE_BASE, MV_RATE_LOG2 = 2048, 1024
CAND_INTER0, CAND_COMP_NEW, CAND_COMP_ZERO = 10, 40, 41
FIELDS = 6                        # j, cand, mv_y, mv_x, mv_y1, mv_x1


def decimate(plane: torch.Tensor, f: int) -> torch.Tensor:
    h, w = plane.shape
    s = plane.reshape(h // f, f, w // f, f).sum(dim=(1, 3),
                                                dtype=torch.int32)
    return torch.div(s, f * f, rounding_mode="floor")


def _offsets(rng: int, device):
    d = torch.arange(-rng, rng + 1, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return dy.reshape(-1), dx.reshape(-1)          # row-major (dy, dx)


def _masked_search(src, ref, tile: int, cy, cx, rng: int, maxpix: int):
    """Per tile of `src` (tile x tile, in raster order), the winning
    shift in +-rng around (cy, cx) of `ref` at the same scale: samples
    outside the frame cost maxpix; score sad * 16 + |dy| + |dx|, the
    first (row-major) of least score. cy, cx: (nty, ntx) -> (dy, dx)."""
    h, w = src.shape
    nty, ntx = h // tile, w // tile
    dev = src.device
    dy, dx = _offsets(rng, dev)
    ty = torch.arange(nty, device=dev)[:, None] * tile
    tx = torch.arange(ntx, device=dev)[None, :] * tile
    r = torch.arange(tile, device=dev)
    best = None
    for o in range(dy.numel()):
        # sample rows/cols of every tile at this shift: (nty, ntx, tile)
        ry = (ty + cy + dy[o])[..., None] + r
        rx = (tx + cx + dx[o])[..., None] + r
        vy = (ry >= 0) & (ry < h)
        vx = (rx >= 0) & (rx < w)
        samp = ref[ry.clamp(0, h - 1)[..., :, None],
                   rx.clamp(0, w - 1)[..., None, :]]
        tiles = src.reshape(nty, tile, ntx, tile).permute(0, 2, 1, 3)
        diff = torch.where(vy[..., :, None] & vx[..., None, :],
                           (tiles - samp).abs(),
                           torch.full((), maxpix, dtype=torch.int32,
                                      device=dev))
        score = (diff.sum(dim=(2, 3), dtype=torch.int32) * 16
                 + dy[o].abs() + dx[o].abs())
        if best is None:
            best, arg = score, torch.zeros_like(score)
        else:
            better = score < best
            best = torch.where(better, score, best)
            arg = torch.where(better, torch.full_like(arg, o), arg)
    return dy[arg], dx[arg]


def motion_search(src: torch.Tensor, ref: torch.Tensor, maxpix: int,
                  depths) -> dict:
    """{blk: (mv_y, mv_x)} full-pel MV grids (H/blk, W/blk) of src
    against ref, both (H, W) int32, H and W multiples of 64."""
    h, w = src.shape
    nby, nbx = h // 64, w // 64
    dev = src.device
    zero = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    if min(h, w) >= 128:
        dy0, dx0 = _masked_search(decimate(src, 16), decimate(ref, 16), 4,
                                  zero, zero, R0, maxpix)
    else:
        dy0, dx0 = zero, zero
    dy1, dx1 = _masked_search(decimate(src, 4), decimate(ref, 4), 16,
                              dy0 * 4, dx0 * 4, R1, maxpix)
    cy, cx = (dy0 * 4 + dy1) * 4, (dx0 * 4 + dx1) * 4   # full-pel centre

    tiles = extract_blocks(src[None], 64)                 # (nSB, 64, 64)
    span = torch.arange(64 + 2 * R2, device=dev)

    def lattice(cy_, cx_):
        y0 = (torch.arange(nby, device=dev)[:, None] * 64 + cy_
              - R2).reshape(-1)
        x0 = (torch.arange(nbx, device=dev)[None, :] * 64 + cx_
              - R2).reshape(-1)
        rows = (y0[:, None] + span).clamp(0, h - 1)
        cols = (x0[:, None] + span).clamp(0, w - 1)
        wins = ref[rows[:, :, None], cols[:, None, :]]
        return sad_lattice(tiles, wins)                   # (nSB, 289, 8, 8)

    lat_h, lat_z = lattice(cy, cx), lattice(zero, zero)
    n2 = 2 * R2 + 1
    out = {}
    for blk in depths:
        k = blk // 8                                      # boxes a side
        nh = 64 // blk

        def best(lat):
            s = lat.reshape(-1, n2 * n2, nh, k, nh, k).sum(
                dim=(3, 5), dtype=torch.int32)            # (nSB, 289, nh, nh)
            return s.amin(dim=1), s.argmin(dim=1)

        bh, ih = best(lat_h)
        bz, iz = best(lat_z)
        use_z = bz <= bh
        cyf = cy.reshape(-1)[:, None, None]
        cxf = cx.reshape(-1)[:, None, None]
        mv_y = torch.where(use_z, iz // n2 - R2, cyf + ih // n2 - R2)
        mv_x = torch.where(use_z, iz % n2 - R2, cxf + ih % n2 - R2)

        def grid(a):
            return (a.reshape(nby, nbx, nh, nh).transpose(1, 2)
                    .reshape(nby * nh, nbx * nh).to(torch.int32))

        out[blk] = (grid(mv_y), grid(mv_x))
    return out


def mc_tiles(ref: torch.Tensor, mv_y, mv_x, blk: int) -> torch.Tensor:
    """Full-pel prediction of every block (raster order), the reference's
    samples clamped to the frame."""
    h, w = ref.shape
    nby, nbx = mv_y.shape
    dev = ref.device
    r = torch.arange(blk, device=dev)
    y0 = (torch.arange(nby, device=dev)[:, None] * blk + mv_y).reshape(-1)
    x0 = (torch.arange(nbx, device=dev)[None, :] * blk + mv_x).reshape(-1)
    rows = (y0[:, None] + r).clamp(0, h - 1)
    cols = (x0[:, None] + r).clamp(0, w - 1)
    return ref[rows[:, :, None], cols[:, None, :]]


def mv_rate(mv_y, mv_x, sb_mv, blk: int) -> torch.Tensor:
    nh = 64 // blk
    sby = sb_mv[0].repeat_interleave(nh, 0).repeat_interleave(nh, 1)
    sbx = sb_mv[1].repeat_interleave(nh, 0).repeat_interleave(nh, 1)
    d8 = ((mv_y - sby).abs() + (mv_x - sbx).abs()).to(torch.float32) * 8
    return MV_RATE_BASE + MV_RATE_LOG2 * torch.log2(1.0 + d8)


def candidate_j(tiles, pred, crate, blk: int, qp_row, rd: torch.Tensor,
                bit_depth: int, psy: bool, precision: str):
    log_scale = 2 if blk == 64 else (1 if blk == 32 else 0)
    m, inv = fullloop(tiles - pred, qp6_for(qp_row, log_scale), blk,
                      log_scale, want_inv=True, precision=precision)
    dist, rate, sse = m[:, 0], m[:, 1], m[:, 3]
    if psy:
        had = tables(tiles.device)["had8"]
        scale = 0.5 if bit_depth == 8 else 4.0
        factor = rd[-1].to(torch.float32) / 256.0 * scale
        e_src = psy_energy(tiles, blk, had, precision)
        recon = (pred + inv).clamp(0, (1 << bit_depth) - 1)
        dist = dist + (e_src - psy_energy(recon, blk, had, precision)).abs() \
            * factor
        sse = sse + (e_src - psy_energy(pred, blk, had, precision)).abs() \
            * factor
    rdmult = rd[0].to(torch.float32)
    j_coded = (rate + crate + rd[1].to(torch.float32)) * rdmult / 512.0 \
        + dist * 128.0
    j_skip = (crate + rd[2].to(torch.float32)) * rdmult / 512.0 \
        + sse * 128.0
    return torch.minimum(j_coded, j_skip)


def inter_analysis(src: np.ndarray, refs: np.ndarray, qp_row, rd_row,
                   depths, bit_depth: int, psy: bool, device,
                   precision: str = "fp32") -> np.ndarray:
    """src (H, W), refs (R, H, W) host planes -> the packed float32 row."""
    s = torch.from_numpy(np.ascontiguousarray(src).astype(np.int32)) \
        .to(device)
    rf = torch.from_numpy(np.ascontiguousarray(refs).astype(np.int32)) \
        .to(device)
    rd = torch.tensor(np.asarray(rd_row, np.int32), device=s.device)
    qp_row = np.asarray(qp_row)
    maxpix = (1 << bit_depth) - 1
    mvs = [motion_search(s, r, maxpix, depths) for r in rf]
    n_refs = rf.shape[0]
    parts = []
    for blk in depths:
        tiles = extract_blocks(s[None], blk)
        j_in, mode = analyze_depth(s[None], blk, qp_row[None], rd[None],
                                   bit_depth, psy, precision)
        zf = torch.zeros_like(j_in[0])
        cands = [(j_in[0], mode[0], zf, zf, zf, zf)]

        def sb_of(ri):
            return mvs[ri][64] if 64 in mvs[ri] else mvs[ri][blk]

        for ri in range(n_refs):
            my, mx = mvs[ri][blk]
            zero = torch.zeros_like(my)
            new_rate = rd[3 + N_MODES + ri].to(torch.float32) \
                + mv_rate(my, mx, sb_of(ri), blk).reshape(-1)
            zero_rate = rd[3 + N_MODES + 8 + ri].to(torch.float32) \
                .expand(my.numel())
            for code, gy, gx, crate in ((CAND_INTER0 + 2 * ri, my, mx,
                                         new_rate),
                                        (CAND_INTER0 + 2 * ri + 1, zero, zero,
                                         zero_rate)):
                j = candidate_j(tiles, mc_tiles(rf[ri], gy, gx, blk), crate,
                                blk, qp_row, rd, bit_depth, psy, precision)
                cands.append((j, torch.full_like(j, code),
                              gy.reshape(-1).float(), gx.reshape(-1).float(),
                              torch.zeros_like(j), torch.zeros_like(j)))
        if n_refs >= 2:
            (y0, x0), (y1, x1) = mvs[0][blk], mvs[1][blk]
            zero = torch.zeros_like(y0)
            new_rate = rd[3 + N_MODES + 16].to(torch.float32) \
                + (mv_rate(y0, x0, sb_of(0), blk)
                   + mv_rate(y1, x1, sb_of(1), blk)).reshape(-1)
            zero_rate = rd[3 + N_MODES + 17].to(torch.float32) \
                .expand(y0.numel())
            for code, a, b, c, d, crate in (
                    (CAND_COMP_NEW, y0, x0, y1, x1, new_rate),
                    (CAND_COMP_ZERO, zero, zero, zero, zero, zero_rate)):
                pred = (mc_tiles(rf[0], a, b, blk)
                        + mc_tiles(rf[1], c, d, blk) + 1) >> 1
                j = candidate_j(tiles, pred, crate, blk, qp_row, rd,
                                bit_depth, psy, precision)
                cands.append((j, torch.full_like(j, code),
                              *(g.reshape(-1).float() for g in (a, b, c, d))))
        js = torch.stack([c[0] for c in cands])
        sel = js.argmin(dim=0)[None]                      # the first of least J
        parts.append(js.amin(dim=0))
        parts.extend(torch.stack([c[i] for c in cands]).gather(0, sel)[0]
                     for i in range(1, FIELDS))
    return torch.cat(parts).cpu().numpy()
