"""TPL (temporal dependency model) dispenser on the device, in PyTorch.

Counterpart of svt_av1_psyex_tpu/device/tpl.py. One call per lookahead
group runs the TPL forward pass over the group's source frames; each
frame's step, batched over the frame's 16x16 blocks,

  * picks the best open-loop intra prediction (device/intra.py
    predictors, by prediction SSE),
  * motion-searches against the previous SOURCE frame (device/me.py
    `fullpel_lattice`, through the sad_lattice kernel),
  * evaluates the residual through the analysis transform, quantizer and
    rate proxy (the fullloop kernel at n = 16, or the integer networks
    under SVT_TPU_INTDCT=1, device.intra.analysis_loop): once predicting
    from the source reference (srcrf_*) and once from the TPL recon of
    the previous frame (recrf_*),
  * reconstructs the frame for the next step.

The reference's lax.scan over frames is a Python loop here: each frame
predicts from the previous frame's TPL recon, so the steps are
sequential by nature. The recon is carried in float32, unrounded, as the
reference carries it; the recrf residual is therefore float32 (int32
under SVT_TPU_INTDCT=1, whose inverse is integer).

Only the per-block stats grids leave the device; the host synthesizer
and the r0/beta math are codec/tpl.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import reference_constants
from .inter import _mc_tiles
from .intra import (
    _block_neighbors,
    _extract_blocks,
    _predict_modes,
    analysis_loop,
    qp6_for,
)
from .me import fullpel_lattice, geometry_best

BLK = 16  # TPL synth block size (tpl_ctrls.synth_blk_size default 16)

# stats row layout per frame (each a (nh, nw) grid)
STAT_FIELDS = ("srcrf_dist", "recrf_dist", "srcrf_rate", "recrf_rate",
               "mv_y", "mv_x", "is_inter")


def _txrd16(resid: torch.Tensor, qp_row: np.ndarray, bit_depth: int,
            kernels: str):
    """(dist, rate, inverse residual) of a (B, 16, 16) residual batch at
    the TPL q: the analysis chain at n = 16, log_scale 0."""
    run = analysis_loop(BLK, kernels, bit_depth)
    metrics, inv = run(resid.contiguous(), qp6_for(qp_row, 0), BLK, 0,
                       want_inv=True)
    return metrics[:, 0], metrics[:, 1], inv


def _best_intra(src: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """Best open-loop intra prediction per 16x16 block of one frame (by
    prediction SSE; the first mode on ties, as jnp.argmin). src (H, W)
    int32, tiles (B, 16, 16). -> (B, 16, 16) int32."""
    above, left, tl = _block_neighbors(src[None], BLK)
    sm = reference_constants(src.device)["sm_weights"][BLK]
    preds = _predict_modes(tiles, above, left, tl, BLK, sm)  # (M, B, 16, 16)
    sse = ((tiles[None] - preds).to(torch.float32) ** 2).sum(dim=(2, 3))
    sel = torch.argmin(sse, dim=0)                             # (B,)
    return preds[sel, torch.arange(tiles.shape[0], device=src.device)]


def _recon_from(pred: torch.Tensor, inv: torch.Tensor, h: int, w: int,
                maxpix: int) -> torch.Tensor:
    """Assemble block recons back into a float32 frame plane."""
    nby, nbx = h // BLK, w // BLK
    rec = (pred + inv).clamp(0, maxpix)
    return (rec.reshape(nby, nbx, BLK, BLK).transpose(1, 2)
            .reshape(h, w))


def _grid(a: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    return a.reshape(nh, nw).to(torch.float32)


def tpl_group_stats(srcs: torch.Tensor, qp_row: np.ndarray,
                    bit_depth: int = 8, kernels: str = "hand"
                    ) -> torch.Tensor:
    """srcs (F, H, W) int tensor on the analysis device (display order,
    H/W multiples of 64); qp_row the (10,) luma quantizer row
    (device.intra.qp_row_for). Returns (F, 7, nh, nw) f32 stats grids
    (STAT_FIELDS order) on the device; frame 0 is intra-only (srcrf ==
    recrf == intra stats, is_inter = 0).

    Distortions are scaled << TPL_DEP_COST_SCALE_LOG2 (4) to match the
    reference synthesizer formulas (definitions.h:49)."""
    srcs = srcs.to(torch.int32)
    f, h, w = srcs.shape
    maxpix = (1 << bit_depth) - 1
    nh, nw = h // BLK, w // BLK
    nby, nbx = h // 64, w // 64
    g = 64 // BLK

    def to_grid(a):
        # (nSB, g, g) superblock-major -> (nh, nw) frame grid
        return a.reshape(nby, nbx, g, g).transpose(1, 2).reshape(nh, nw)

    # frame 0: intra only
    tiles = _extract_blocks(srcs[:1], BLK)
    ipred = _best_intra(srcs[0], tiles)
    idist, irate, iinv = _txrd16(tiles - ipred, qp_row, bit_depth, kernels)
    rec = _recon_from(ipred, iinv, h, w, maxpix)
    zeros = torch.zeros((nh, nw), dtype=torch.float32, device=srcs.device)
    stats = [torch.stack([_grid(idist * 16.0, nh, nw),
                          _grid(idist * 16.0, nh, nw),
                          _grid(irate, nh, nw), _grid(irate, nh, nw),
                          zeros, zeros, zeros])]

    for i in range(1, f):
        cur, prev_src = srcs[i], srcs[i - 1]
        tiles = _extract_blocks(srcs[i: i + 1], BLK)
        ipred = _best_intra(cur, tiles)
        idist, irate, iinv = _txrd16(tiles - ipred, qp_row, bit_depth,
                                     kernels)

        # source-based full-pel ME (64-SB lattice -> 16x16 grid)
        lat = fullpel_lattice(cur, prev_src, maxpix, kernels)
        mv_y, mv_x, _ = geometry_best(*lat, BLK, BLK)
        mv_y, mv_x = to_grid(mv_y), to_grid(mv_x)

        pred_s = _mc_tiles(prev_src, mv_y, mv_x, BLK)
        pred_r = _mc_tiles(rec, mv_y, mv_x, BLK)
        sdist, srate, _ = _txrd16(tiles - pred_s, qp_row, bit_depth,
                                  kernels)
        rdist, rrate, rinv = _txrd16(tiles - pred_r, qp_row, bit_depth,
                                     kernels)
        # the closed-loop result can't beat the source-ref one (the
        # reference enforces recrf >= srcrf)
        rdist = torch.maximum(rdist, sdist)
        rrate = torch.maximum(rrate, srate)

        # inter/intra choice in the open-loop prediction domain (strict:
        # intra keeps the block on equal SSE)
        sse_i = ((tiles - ipred).to(torch.float32) ** 2).sum(dim=(1, 2))
        sse_s = ((tiles - pred_s).to(torch.float32) ** 2).sum(dim=(1, 2))
        use_inter = sse_s < sse_i
        sel = use_inter[:, None, None]
        rec = _recon_from(torch.where(sel, pred_r, ipred),
                          torch.where(sel, rinv, iinv), h, w, maxpix)
        mv_keep = use_inter.reshape(nh, nw)
        stats.append(torch.stack([
            _grid(torch.where(use_inter, sdist, idist) * 16.0, nh, nw),
            _grid(torch.where(use_inter, rdist, idist) * 16.0, nh, nw),
            _grid(torch.where(use_inter, srate, irate), nh, nw),
            _grid(torch.where(use_inter, rrate, irate), nh, nw),
            torch.where(mv_keep, mv_y, 0).to(torch.float32),
            torch.where(mv_keep, mv_x, 0).to(torch.float32),
            mv_keep.to(torch.float32),
        ]))
    return torch.stack(stats)
