"""Fused inter-frame mode-decision analysis on the device, in PyTorch.

Counterpart of svt_av1_psyex_tpu/device/inter.py. One call per (frame,
refs) chains, on the device:

  hierarchical ME (device/me.py lattices)
    -> per-depth full-pel MVs for every block
    -> motion-compensated prediction tiles (clipped gathers == spec MC
       sample clamping at full-pel)
    -> analysis transform, quantizer and inverse (the fullloop kernel for
       blk <= 32, the float32 matmul chain for blk 64; the integer
       networks for every blk under SVT_TPU_INTDCT=1, device.intra.
       analysis_loop)
    -> distortion + calibrated rate proxy
    -> RD reduction against the intra candidates (device/intra.py)

and returns, per depth, the winning candidate per block: J, candidate
code, and the MV(s). The host runs the partition DP and the conformant
commit (codec/md_device.py).

Candidate codes in the packed output:
  0..N_MODES-1          intra (index into device.intra.DEVICE_MODES)
  10 + 2*ri             NEWMV at the ME MV against ref #ri
  11 + 2*ri             zero MV (GLOBALMV) against ref #ri
  40                    compound NEW_NEWMV: ref #0 / ref #1 ME MVs avg'd
  41                    compound zero (GLOBAL_GLOBALMV) over refs #0/#1

Compound uses ref slots 0 and 1 (the host places the legal forward /
backward pair there); frames without a legal pair carry a prohibitive
base cost in rd_row, so those candidates never win. Unlike the JAX
package, the refs are not padded to a fixed count: padding only avoids
recompiles, and a padded slot (a copy of ref 0 at a prohibitive cost)
can never win.

inter_analysis_sharded runs the analysis with the frame's superblock
rows over a mesh's sp axis (parallel/mesh.py): each shard gets its rows
of src, the source row above them (the intra candidates' halo) and a
slab of each reference that reaches device.me.SLAB rows above and below
(the motion search's and the predictions' halo); its rows equal
inter_analysis's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import SB, DeviceMesh, ShardedRows, shard_grid
from ..params import reference_constants
from ..runtime import upload_lumas
from .intra import (
    N_MODES,
    _analyze_depth,
    _extract_blocks,
    analysis_loop,
    psy_energy,
    qp6_for,
)
from .me import SLAB, Window, fullpel_lattice, geometry_best

# MV-rate proxy (1/512-bit units): base covers joint/sign/class symbols;
# the log2 term tracks the class/offset growth per component, against
# the containing SB's 64x64 MV as the predictor
MV_RATE_BASE = 2048       # ~4 bits
MV_RATE_LOG2 = 1024       # ~2 bits per log2(1+|d_eighth|) per component

CAND_INTER0 = 10
CAND_COMP_NEW = 40
CAND_COMP_ZERO = 41


def _mc_tiles(ref: torch.Tensor, mv_y: torch.Tensor, mv_x: torch.Tensor,
              blk: int, win: Window | None = None) -> torch.Tensor:
    """Full-pel MC prediction tiles: (nby, nbx) MV grids -> (B, blk, blk)
    gathered with spec sample clamping (at the frame's edges: `win`
    places the blocks and the reference slab in the frame; by default
    ref is the whole frame)."""
    w = ref.shape[1]
    win = win or Window(0, 0, ref.shape[0])
    nby, nbx = mv_y.shape
    dev = ref.device
    y0 = (torch.arange(nby, device=dev)[:, None] * blk + win.row0
          + mv_y).reshape(-1)
    x0 = (torch.arange(nbx, device=dev)[None, :] * blk + mv_x).reshape(-1)
    span = torch.arange(blk, device=dev)
    rows = win.ref_rows(y0[:, None] + span[None, :])
    cols = (x0[:, None] + span[None, :]).clamp(0, w - 1)
    return ref[rows[:, :, None], cols[:, None, :]]


def _txrd(resid: torch.Tensor, blk: int, qp_row: np.ndarray, kernels: str,
          bit_depth: int):
    """Analysis RD of a residual batch: (dist, rate, sse, inv_residual),
    through the chain the intra analysis takes (device.intra.
    analysis_loop)."""
    log_scale = 2 if blk == 64 else (1 if blk == 32 else 0)
    run = analysis_loop(blk, kernels, bit_depth)
    metrics, inv = run(resid, qp6_for(qp_row, log_scale), blk, log_scale,
                       want_inv=True)
    return metrics[:, 0], metrics[:, 1], metrics[:, 3], inv


def _mv_rate_grid(mv_y, mv_x, sb_mv, blk: int) -> torch.Tensor:
    """MV-rate proxy grid vs the containing SB's 64x64 motion."""
    nh = 64 // blk
    sby = sb_mv[0].repeat_interleave(nh, 0).repeat_interleave(nh, 1)
    sbx = sb_mv[1].repeat_interleave(nh, 0).repeat_interleave(nh, 1)
    d8 = ((mv_y - sby).abs() + (mv_x - sbx).abs()).to(torch.float32) * 8
    return MV_RATE_BASE + MV_RATE_LOG2 * torch.log2(1.0 + d8)


def _cand_j(tiles, pred, crate, blk: int, qp_row, rd_row: torch.Tensor,
            bit_depth: int, psy: bool, kernels: str) -> torch.Tensor:
    """J of one candidate batch from its prediction tiles + const rate
    (coded-vs-skip min, shared by the single-ref and compound paths)."""
    rdmult = rd_row[0].to(torch.float32)
    skip0 = rd_row[1].to(torch.float32)
    skip1 = rd_row[2].to(torch.float32)
    dist, rate, sse, inv = _txrd(tiles - pred, blk, qp_row, kernels,
                                 bit_depth)
    if psy:
        had = reference_constants(tiles.device)["had8"]
        maxpix = (1 << bit_depth) - 1
        scale = 0.5 if bit_depth == 8 else 4.0
        factor = rd_row[-1].to(torch.float32) / 256.0 * scale
        e_src = psy_energy(tiles, blk, had)
        recon = (pred + inv).clamp(0, maxpix)
        dist = dist + (e_src - psy_energy(recon, blk, had)).abs() * factor
        sse = sse + (e_src - psy_energy(pred, blk, had)).abs() * factor
    j_coded = (rate + crate + skip0) * rdmult / 512.0 + dist * 128.0
    j_skip = (crate + skip1) * rdmult / 512.0 + sse * 128.0
    return torch.minimum(j_coded, j_skip)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1).to(torch.float32)


def _inter_depth(tiles, ref, mvs, blk: int, qp_row, rd_row, ri: int,
                 bit_depth: int, sb_mv, psy: bool, kernels: str,
                 win: Window) -> list:
    """Candidates of one (depth, ref): NEWMV at the ME MV and the zero
    MV. tiles: (B, blk, blk) source; mvs: (mv_y, mv_x) grids. Returns
    two (j, cand, mv_y, mv_x, mv_y1, mv_x1) tuples of flat f32 rows."""
    mv_y, mv_x = mvs
    base = rd_row[3 + N_MODES + ri].to(torch.float32)       # NEWMV base
    gbase = rd_row[3 + N_MODES + 8 + ri].to(torch.float32)  # zero base
    mv_rate = _mv_rate_grid(mv_y, mv_x, sb_mv, blk)
    zeros = torch.zeros_like(mv_y)
    out = []
    for cand, my, mx, crate in (
            (CAND_INTER0 + 2 * ri, mv_y, mv_x, base + mv_rate.reshape(-1)),
            (CAND_INTER0 + 2 * ri + 1, zeros, zeros,
             gbase.expand(mv_y.numel()))):
        pred = _mc_tiles(ref, my, mx, blk, win)
        j = _cand_j(tiles, pred, crate, blk, qp_row, rd_row, bit_depth, psy,
                    kernels)
        z = torch.zeros_like(j)
        out.append((j, torch.full_like(j, cand), _flat(my), _flat(mx), z, z))
    return out


def _comp_depth(tiles, refs, geo0, geo1, blk: int, qp_row, rd_row,
                bit_depth: int, sb_mv0, sb_mv1, psy: bool,
                kernels: str, win: Window) -> list:
    """Compound (ref0, ref1) candidates at one depth: NEW_NEWMV at the
    two per-ref ME MVs, and the zero pair (GLOBAL_GLOBALMV). Prediction
    is the rounded average, the analysis stand-in for the spec's
    high-precision compound average (the commit pass is conformant)."""
    base = rd_row[3 + N_MODES + 16].to(torch.float32)
    gbase = rd_row[3 + N_MODES + 17].to(torch.float32)
    mv_y0, mv_x0 = geo0
    mv_y1, mv_x1 = geo1
    mv_rate = (_mv_rate_grid(mv_y0, mv_x0, sb_mv0, blk)
               + _mv_rate_grid(mv_y1, mv_x1, sb_mv1, blk))
    zeros = torch.zeros_like(mv_y0)
    out = []
    for cand, my0, mx0, my1, mx1, crate in (
            (CAND_COMP_NEW, mv_y0, mv_x0, mv_y1, mv_x1,
             base + mv_rate.reshape(-1)),
            (CAND_COMP_ZERO, zeros, zeros, zeros, zeros,
             gbase.expand(mv_y0.numel()))):
        pred = (_mc_tiles(refs[0], my0, mx0, blk, win)
                + _mc_tiles(refs[1], my1, mx1, blk, win) + 1) >> 1
        j = _cand_j(tiles, pred, crate, blk, qp_row, rd_row, bit_depth, psy,
                    kernels)
        out.append((j, torch.full_like(j, cand), _flat(my0), _flat(mx0),
                    _flat(my1), _flat(mx1)))
    return out


def inter_analysis(src: torch.Tensor, refs: torch.Tensor,
                   qp_row: np.ndarray, rd_row: np.ndarray,
                   depths: tuple = (64, 32, 16, 8), bit_depth: int = 8,
                   psy: bool = False, kernels: str = "hand",
                   above: torch.Tensor | None = None,
                   win: Window | None = None) -> torch.Tensor:
    """src (H, W) int tensor, refs (R, H, W) int tensor on the analysis
    device, H/W multiples of 64. For a shard (inter_analysis_sharded):
    src holds its superblock rows, `above` (W,) the source row above
    them, refs the reference slabs, and `win` says where src and the
    slabs sit in the frame (device.me.Window); by default src and refs
    are the whole frame.

    qp_row: (10,) luma quantizer row (device.intra.qp_row_for).
    rd_row: (3 + N_MODES + 18 + 1,) int32, 1/512-bit costs:
      [rdmult, skip0, skip1,
       intra mode costs x N_MODES,
       NEWMV base cost per ref x 8 (unused slots prohibitive),
       zero-MV base cost per ref x 8,
       compound NEW_NEWMV base, compound zero base (prohibitive when
       slots 0/1 aren't a legal fwd/bwd pair),
       psy_factor<<8].

    Returns one packed f32 row on the device: per depth,
    (j, cand, mv_y, mv_x, mv_y1, mv_x1) flattened grids; unpack with
    unpack_inter_analysis. MVs are in full-pel units (the host multiplies
    by 8); mv_*1 is the second (backward) ref's MV of the compound
    candidates, zero otherwise."""
    src = src.to(torch.int32)
    refs = refs.to(torch.int32)
    if above is not None:
        above = above.to(torch.int32)[None]
    maxpix = (1 << bit_depth) - 1
    rd = torch.as_tensor(np.ascontiguousarray(rd_row, np.int32),
                         device=src.device)
    h, w = src.shape
    nby, nbx = h // 64, w // 64
    win = win or Window(0, 0, h)

    # per-ref full-pel lattices + per-depth square MVs
    per_ref = []
    for ri in range(refs.shape[0]):
        lat = fullpel_lattice(src, refs[ri], maxpix, kernels, win)
        geo = {}
        for blk in depths:
            mv_y, mv_x, _ = geometry_best(*lat, blk, blk)
            nh = 64 // blk

            def to_grid(a):
                # (nSB, nh, nw) -> frame grid (nby*nh, nbx*nw)
                return (a.reshape(nby, nbx, nh, nh).transpose(1, 2)
                        .reshape(nby * nh, nbx * nh))

            geo[blk] = (to_grid(mv_y), to_grid(mv_x))
        per_ref.append(geo)

    parts = []
    for blk in depths:
        tiles = _extract_blocks(src[None], blk)
        # intra candidates (the intra analysis' RD reduction, one frame)
        j_intra, mode = _analyze_depth(src[None], blk, qp_row[None], rd[None],
                                       bit_depth, psy, kernels, above)
        z = torch.zeros_like(j_intra[0])
        cands = [(j_intra[0], mode[0], z, z, z, z)]
        for ri in range(refs.shape[0]):
            sb_mv = per_ref[ri][64] if 64 in per_ref[ri] \
                else per_ref[ri][blk]
            cands.extend(_inter_depth(tiles, refs[ri], per_ref[ri][blk], blk,
                                      qp_row, rd, ri, bit_depth, sb_mv, psy,
                                      kernels, win))
        if refs.shape[0] >= 2:
            sb0 = per_ref[0][64] if 64 in per_ref[0] else per_ref[0][blk]
            sb1 = per_ref[1][64] if 64 in per_ref[1] else per_ref[1][blk]
            cands.extend(_comp_depth(tiles, refs, per_ref[0][blk],
                                     per_ref[1][blk], blk, qp_row, rd,
                                     bit_depth, sb0, sb1, psy, kernels, win))
        js = torch.stack([c[0] for c in cands])               # (C, B)
        # argmin keeps the first (lowest) candidate on ties, as jnp.argmin
        sel = torch.argmin(js, dim=0)[None]
        parts.append(js.amin(dim=0))
        parts.extend(torch.stack([c[i] for c in cands]).gather(0, sel)[0]
                     for i in range(1, 6))
    return torch.cat(parts)


FIELDS = ("j", "cand", "mv_y", "mv_x", "mv_y1", "mv_x1")


def inter_analysis_sharded(src: np.ndarray, refs: np.ndarray,
                           qp_row: np.ndarray, rd_row: np.ndarray,
                           mesh: DeviceMesh,
                           depths: tuple = (64, 32, 16, 8),
                           bit_depth: int = 8, psy: bool = False,
                           kernels: str = "hand") -> ShardedRows:
    """inter_analysis with the superblock rows of the frame over the sp
    axis of `mesh` (on its first dp row; uneven splits allowed). src
    (H, W) and refs (R, H, W) host planes, H and W multiples of 64. Each
    shard uploads its rows of src, the row above them and its reference
    slabs to its device and is dispatched before any is fetched. Returns
    the pending shards; numpy()[0] is inter_analysis's row."""
    hp, wp = src.shape
    shards = []
    for dev, _, (r0, r1) in shard_grid(1, hp // SB, mesh):
        y0, y1 = r0 * SB, r1 * SB
        a0 = max(y0 - 1, 0)
        s0, s1 = max(y0 - SLAB, 0), min(y1 + SLAB, hp)
        planes = upload_lumas(src[a0:y1], bit_depth, dev)
        out = inter_analysis(
            planes[y0 - a0:], upload_lumas(refs[:, s0:s1], bit_depth, dev),
            qp_row, rd_row, depths=depths, bit_depth=bit_depth, psy=psy,
            kernels=kernels, above=planes[0] if y0 else None,
            win=Window(y0, s0, hp))
        shards.append(((0, 1), (r0, r1), out[None]))
    return ShardedRows(shards, [(SB // blk, wp // blk) for blk in depths
                                for _ in FIELDS], 1, hp // SB)


def unpack_inter_analysis(packed: np.ndarray, hp: int, wp: int,
                          depths: tuple = (64, 32, 16, 8)) -> dict:
    """{blk: {"j","cand","mv_y","mv_x","mv_y1","mv_x1": (nby, nbx)}};
    mv in full-pel."""
    out = {}
    pos = 0
    for blk in depths:
        nby, nbx = hp // blk, wp // blk
        n = nby * nbx
        d = {}
        for f in FIELDS:
            a = packed[pos: pos + n].reshape(nby, nbx)
            d[f] = a if f == "j" else a.astype(np.int32)
            pos += n
        out[blk] = d
    if pos != packed.size:
        raise ValueError(f"packed row holds {packed.size} values, the "
                         f"depths {depths} at {hp}x{wp} need {pos}")
    return out
