"""Batched intra mode-decision analysis on the device, in PyTorch.

Counterpart of svt_av1_psyex_tpu/device/intra.py (its matmul-DCT tier).
One call evaluates every block of every frame at every searched depth
(64/32/16/8) for a fixed non-directional mode set: open-loop prediction
from source neighbours, float32 matmul DCTs, the analysis quantizer, the
inverse transform for the true reconstruction error, and a calibrated
coefficient-rate proxy; then an on-device RD reduction leaves one
(J, mode) pair per block. The host runs the partition DP and the
conformant commit.

Blocks of 32 and smaller go through the fullloop kernel (the registry in
runtime.py picks the hand kernel or its plain version); blk 64 stays on
two float32 matmuls per transform, as in the reference. With
SVT_TPU_INTDCT=1 every block size goes through the exact integer
networks of ops/int_kernels.py instead, and neither of those float
chains runs (analysis_loop), as in the reference.

intra_analysis_sharded runs the same analysis over a (dp, sp) mesh
(parallel/mesh.py): frames over dp, superblock rows over sp, each shard
with the source row above its rows (a 1-row halo) for its top blocks'
neighbours; its rows equal intra_analysis_batch's bit for bit.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import torch

from ..ops import int_kernels
from ..ops.fullloop_ref import fullloop_ref
from ..parallel.mesh import SB, DeviceMesh, ShardedRows, shard_grid
from ..params import reference_constants
from ..runtime import fullloop_impl, upload_lumas

# mode order of the device candidate lattice (IntraMode values)
DEVICE_MODES = (0, 1, 2, 9, 10, 11, 12)  # DC V H SMOOTH SMOOTH_V SMOOTH_H PAETH
N_MODES = len(DEVICE_MODES)

# Analysis transforms as float32 matmuls (the fullloop kernel for blk <=
# 32, device/matdct.py for blk 64) instead of the exact integer networks.
# SVT_TPU_INTDCT=1 restores the integer networks; read once, at import,
# as the JAX package's device/intra.py reads it. device/inter.py and
# device/tpl.py follow this flag through analysis_loop.
_USE_MATDCT = os.environ.get("SVT_TPU_INTDCT") != "1"


def analysis_loop(blk: int, kernels: str, bit_depth: int):
    """The transform -> quantize -> inverse -> rate chain for blocks of
    size blk, called as fullloop(resid, qp6, blk, log_scale, want_inv):
    the integer networks for every blk when _USE_MATDCT is off, else the
    fullloop kernel (or its plain version, per `kernels`) for blk <= 32
    and the float32 matmul chain for blk 64."""
    if not _USE_MATDCT:
        return partial(int_kernels.fullloop_int, bit_depth=bit_depth)
    return fullloop_ref if blk > 32 else fullloop_impl(kernels)


def _predict_modes(tiles, above, left, tl, blk: int,
                   sm: torch.Tensor) -> torch.Tensor:
    """Open-loop predictions for DEVICE_MODES. tiles (B, blk, blk);
    above/left (B, blk); tl (B,) int32; sm the SMOOTH weights (blk,).
    -> (M, B, blk, blk) int32."""
    b = tiles.shape[0]
    shape = (b, blk, blk)
    a3 = above[:, None, :]
    l3 = left[:, :, None]
    dc = torch.div(above.sum(1, dtype=torch.int32)
                   + left.sum(1, dtype=torch.int32) + blk, 2 * blk,
                   rounding_mode="floor")
    below = left[:, blk - 1][:, None, None]
    right = above[:, blk - 1][:, None, None]
    wv = sm[None, :, None]  # weights down the rows
    wh = sm[None, None, :]  # weights across the cols
    # SMOOTH: 9-bit dual interpolation (spec 7.11.2.6)
    p = wv * a3 + (256 - wv) * below + wh * l3 + (256 - wh) * right
    t3 = tl[:, None, None]
    base = a3 + l3 - t3
    pa = (base - a3).abs()
    pl = (base - l3).abs()
    pt = (base - t3).abs()
    paeth = torch.where((pl <= pa) & (pl <= pt), l3.expand(shape),
                        torch.where(pa <= pt, a3.expand(shape),
                                    t3.expand(shape)))
    return torch.stack([
        dc[:, None, None].expand(shape),
        a3.expand(shape),                                     # V
        l3.expand(shape),                                     # H
        (p + 256) >> 9,                                       # SMOOTH
        ((wv * a3 + (256 - wv) * below + 128) >> 8).expand(shape),
        ((wh * l3 + (256 - wh) * right + 128) >> 8).expand(shape),
        paeth,
    ]).to(torch.int32)


def _block_neighbors(lumas: torch.Tensor, blk: int,
                     above: torch.Tensor | None = None):
    """Source (open-loop) neighbours of every blk-aligned block of every
    frame, edge-replicated at frame borders. lumas (F, H, W) ->
    above/left (F*nby*nbx, blk), tl (F*nby*nbx,). `above` (F, W): the
    source row above lumas' first row, for a shard that does not start
    at the frame's top (None: lumas starts there)."""
    f, h, w = lumas.shape
    nby, nbx = h // blk, w // blk
    top = lumas[:, :1] if above is None else above[:, None]
    pad = torch.cat([top, lumas], dim=1)
    pad = torch.cat([pad[:, :, :1], pad], dim=2)           # (F, H+1, W+1)
    above = pad[:, 0:h:blk, 1:].reshape(f, nby, nbx, blk).reshape(-1, blk)
    left = (pad[:, 1:, 0:w:blk].reshape(f, nby, blk, nbx)
            .transpose(2, 3).reshape(-1, blk))
    tl = pad[:, 0:h:blk, 0:w:blk].reshape(-1)
    return above, left, tl


def _extract_blocks(lumas: torch.Tensor, blk: int) -> torch.Tensor:
    """(F, H, W) -> (F*nby*nbx, blk, blk) in frame, raster order,
    contiguous: with one row of blocks the reshape would be a strided
    view, and the float reductions over a block would then run in
    another order than for a taller plane (a one-row shard must give
    the whole frame's sums)."""
    f, h, w = lumas.shape
    t = lumas.reshape(f, h // blk, blk, w // blk, blk).transpose(2, 3)
    return t.reshape(-1, blk, blk).contiguous()


def psy_energy(x: torch.Tensor, blk: int, had: torch.Tensor) -> torch.Tensor:
    """(B, blk, blk) -> (B,) summed per-8x8-tile SA8D energy (SA8D -
    SAD/4 vs zero; psy_rd.c svt_psy_distortion's per-tile term)."""
    b = x.shape[0]
    n8 = blk // 8
    t = (x.reshape(b, n8, 8, n8, 8).transpose(2, 3).reshape(-1, 8, 8)
         .to(torch.float32))
    tr = had @ t @ had.T
    sa8d = torch.floor((tr.abs().sum(dim=(1, 2)) + 2) / 4)
    sad = t.abs().sum(dim=(1, 2))
    e = sa8d - torch.floor(sad / 4)
    return e.reshape(b, n8 * n8).sum(dim=1)


def _rp2(x: int, n: int) -> int:
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def qp6_for(qp_row: np.ndarray, log_scale: int) -> np.ndarray:
    """The fullloop quantizer row for one qp_row: deq_dc, deq_ac,
    rnd_dc, rnd_ac, zbin_dc, zbin_ac (rnd/zbin pre-shifted)."""
    q = [int(v) for v in qp_row]
    return np.array([q[4], q[9], _rp2(q[1], log_scale),
                     _rp2(q[6], log_scale), _rp2(q[0], log_scale),
                     _rp2(q[5], log_scale)], np.float32)


def _analyze_depth(lumas: torch.Tensor, blk: int, qp_rows: np.ndarray,
                   rd_rows: torch.Tensor, bit_depth: int, psy: bool,
                   kernels: str, above: torch.Tensor | None = None):
    """All blocks of one depth of every frame: -> (jbest, mode), both
    (F, nby*nbx) f32. With psy, the SA8D energy delta (scaled by
    rd_row[-1]/256) is added to the coded and skip distortions. `above`:
    as _block_neighbors takes it."""
    f = lumas.shape[0]
    consts = reference_constants(lumas.device)
    tiles = _extract_blocks(lumas, blk)
    above, left, tl = _block_neighbors(lumas, blk, above)
    preds = _predict_modes(tiles, above, left, tl, blk,
                           consts["sm_weights"][blk])        # (M, F*B, ..)
    m, fb = preds.shape[0], preds.shape[1]
    b = fb // f
    resid = (tiles[None] - preds).reshape(m, f, b, blk, blk)
    log_scale = 2 if blk == 64 else (1 if blk == 32 else 0)
    run = analysis_loop(blk, kernels, bit_depth)
    # one launch per distinct qp row (one for encode_keyframes)
    rows, group = np.unique(np.asarray(qp_rows), axis=0, return_inverse=True)
    if len(rows) == 1:
        metrics, inv = run(resid.reshape(-1, blk, blk),
                           qp6_for(rows[0], log_scale), blk, log_scale,
                           want_inv=psy)
        metrics = metrics.reshape(m, f, b, 8)
        if psy:
            inv = inv.reshape(m, f, b, blk, blk)
    else:
        metrics = torch.empty((m, f, b, 8), dtype=torch.float32,
                              device=lumas.device)
        inv = (torch.empty((m, f, b, blk, blk), dtype=torch.float32,
                           device=lumas.device) if psy else None)
        group = group.reshape(-1)
        for g, row in enumerate(rows):
            idx = torch.as_tensor(np.nonzero(group == g)[0],
                                  device=lumas.device)
            met, iv = run(resid[:, idx].reshape(-1, blk, blk),
                          qp6_for(row, log_scale), blk, log_scale,
                          want_inv=psy)
            metrics[:, idx] = met.reshape(m, len(idx), b, 8)
            if psy:
                inv[:, idx] = iv.reshape(m, len(idx), b, blk, blk)
    dist, rate, sse = metrics[..., 0], metrics[..., 1], metrics[..., 3]
    rd = rd_rows[:, :, None]                                 # (F, R, 1)
    if psy:
        maxpix = (1 << bit_depth) - 1
        scale = 0.5 if bit_depth == 8 else 4.0
        factor = rd[:, -1].to(torch.float32) / 256.0 * scale  # (F, 1)
        had = consts["had8"]
        pflat = preds.reshape(m, f, b, blk, blk)
        recon = (pflat + inv).clamp(0, maxpix)
        e_src = psy_energy(tiles, blk, had).reshape(f, b)
        e_rec = psy_energy(recon.reshape(-1, blk, blk), blk,
                           had).reshape(m, f, b)
        e_pred = psy_energy(pflat.reshape(-1, blk, blk), blk,
                            had).reshape(m, f, b)
        dist = dist + (e_src - e_rec).abs() * factor
        sse = sse + (e_src - e_pred).abs() * factor
    # on-device RD reduction: rd_row = [rdmult, skip0, skip1,
    # mode_rate[0..M-1], psy] (1/512-bit costs from the frame CDFs)
    rdmult = rd[:, 0].to(torch.float32)                      # (F, 1)
    mode_rate = rd[:, 3: 3 + m].to(torch.float32).transpose(0, 1)  # (M, F, 1)
    j_coded = ((rate + mode_rate + rd[:, 1]) * rdmult / 512.0
               + dist * 128.0)
    j_skip = ((mode_rate + rd[:, 2]) * rdmult / 512.0 + sse * 128.0)
    j = torch.minimum(j_coded, j_skip)                       # (M, F, B)
    # argmin keeps the first (lowest) mode index on ties, as jnp.argmin
    return j.amin(dim=0), j.argmin(dim=0).to(torch.float32)


def intra_analysis_batch(lumas: torch.Tensor, qp_rows: np.ndarray,
                         rd_rows: np.ndarray,
                         depths: tuple = (64, 32, 16, 8),
                         bit_depth: int = 8, psy: bool = False,
                         kernels: str = "hand",
                         above: torch.Tensor | None = None) -> torch.Tensor:
    """Group-of-frames analysis with on-device RD reduction.

    lumas (F, Hp, Wp) uint8/int16/int32 tensor on the analysis device,
    Hp/Wp multiples of max(depths); qp_rows (F, 10) and rd_rows
    (F, 3+M+1) int32 host rows (see qp_row_for, DeviceIntraMD.rd_row).
    The frames are folded into the block batch. Returns (F, P) f32 packed
    rows on the device; unpack with unpack_rd_analysis. `above` (F, Wp):
    the source row above lumas' rows when they are a shard's (None: they
    start at the frame's top)."""
    lumas = lumas.to(torch.int32)
    if above is not None:
        above = above.to(torch.int32)
    rd = torch.tensor(np.asarray(rd_rows, np.int32), device=lumas.device)
    parts = []
    for blk in depths:
        j, mode = _analyze_depth(lumas, blk, qp_rows, rd, bit_depth, psy,
                                 kernels, above)
        parts += [j, mode]
    return torch.cat(parts, dim=1)


def intra_analysis_sharded(lumas: np.ndarray, qp_rows: np.ndarray,
                           rd_rows: np.ndarray, mesh: DeviceMesh,
                           depths: tuple = (64, 32, 16, 8),
                           bit_depth: int = 8, psy: bool = False,
                           kernels: str = "hand") -> ShardedRows:
    """intra_analysis_batch over `mesh`: frames over dp, superblock rows
    over sp (uneven splits allowed). lumas (F, Hp, Wp) host planes, Hp a
    multiple of 64; each shard uploads its rows and the row above them
    to its device and is dispatched before any is fetched. Returns the
    pending shards; their numpy() is intra_analysis_batch's (F, P)
    rows."""
    f, hp, wp = lumas.shape
    shards = []
    for dev, (f0, f1), (r0, r1) in shard_grid(f, hp // SB, mesh):
        y0, y1 = r0 * SB, r1 * SB
        a0 = max(y0 - 1, 0)
        planes = upload_lumas(lumas[f0:f1, a0:y1], bit_depth, dev)
        shards.append(((f0, f1), (r0, r1), intra_analysis_batch(
            planes[:, y0 - a0:], qp_rows[f0:f1], rd_rows[f0:f1],
            depths=depths, bit_depth=bit_depth, psy=psy, kernels=kernels,
            above=planes[:, 0] if y0 else None)))
    return ShardedRows(shards, [(SB // blk, wp // blk) for blk in depths
                                for _ in ("j", "mode")], f, hp // SB)


def unpack_rd_analysis(packed: np.ndarray, hp: int, wp: int,
                       depths: tuple = (64, 32, 16, 8)) -> dict:
    """{blk: {"j": (nby, nbx) f32, "mode": (nby, nbx) int}}."""
    out = {}
    pos = 0
    for blk in depths:
        nby, nbx = hp // blk, wp // blk
        n = nby * nbx
        j = packed[pos: pos + n].reshape(nby, nbx)
        pos += n
        mode = packed[pos: pos + n].reshape(nby, nbx).astype(np.int32)
        pos += n
        out[blk] = {"j": j, "mode": mode}
    if pos != packed.size:
        raise ValueError(f"packed row holds {packed.size} values, the "
                         f"depths {depths} at {hp}x{wp} need {pos}")
    return out


def qp_row_for(qindex: int, dc_delta: int, ac_delta: int,
               bit_depth: int) -> np.ndarray:
    """(10,) int32 = (zbin, round, quant, quant_shift, dequant) x (dc,
    ac) of the luma plane at `qindex`."""
    from ..ops.quant import build_plane_quant

    pq = build_plane_quant(qindex, dc_delta, ac_delta, bit_depth)
    return np.array([pq.zbin[0], pq.round[0], pq.quant[0],
                     pq.quant_shift[0], pq.dequant[0], pq.zbin[1],
                     pq.round[1], pq.quant[1], pq.quant_shift[1],
                     pq.dequant[1]], np.int32)
