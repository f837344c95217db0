"""Alt-ref temporal filtering on the device, in PyTorch.

Counterpart of svt_av1_psyex_tpu/device/tf.py (an XLA program there, no
Pallas kernel, so plain torch here). The block motion search loops over
the (2R+1)^2 full-pel offsets; each step shifts every neighbour frame at
once (a leading N axis, as the reference's jax.vmap), charges
out-of-frame samples maxpix and box-reduces |diff| and diff^2 into 16x16
block grids. The first offset with the smallest tie-broken SAD wins, as
in the reference's strict-less scan; its SSE drives the exp(-err/decay)
block weight, and the accumulation is a whole-frame gather plus a
weighted sum over the neighbours, per plane.

Unlike the JAX package, the neighbour stack is not padded to a bucket
count: the padding only kept one compiled TPU program, and a padded slot
carries weight 0 and adds nothing. Every sum is int32 and every float
step is the reference's float32 operation, so the filtered planes equal
the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

BLK = 16
SEARCH = 8          # +- full-pel window around the co-located block
WEIGHT_SCALE = 1 << 10


def _offsets() -> np.ndarray:
    """((2R+1)^2, 2) row-major (dy, dx) offsets in [-R, R]."""
    n = 2 * SEARCH + 1
    g = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                 axis=-1).reshape(-1, 2)
    return (g - SEARCH).astype(np.int32)


def _box(x: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """(N, H, W) int32 -> (N, H//by, W//bx) int32 box sums."""
    n, h, w = x.shape
    return x.reshape(n, h // by, by, w // bx, bx).sum(dim=(2, 4),
                                                      dtype=torch.int32)


def _block_search(cy: torch.Tensor, ny: torch.Tensor, maxpix: int):
    """Per-16x16-block best offset of each neighbour luma.

    cy (H, W), ny (N, H, W) int32, H/W multiples of BLK. Returns (dy, dx,
    sse), each (N, H//BLK, W//BLK) int32; sse is the winning offset's true
    SSE (out-of-frame samples cost maxpix per pixel, so they never win
    against an in-frame candidate of equal content)."""
    n, h, w = ny.shape
    dev = ny.device
    # edge-padded once, so each offset is a plain slice
    rows = torch.arange(-SEARCH, h + SEARCH, device=dev).clamp(0, h - 1)
    cols = torch.arange(-SEARCH, w + SEARCH, device=dev).clamp(0, w - 1)
    ny_pad = ny[:, rows[:, None], cols[None, :]]
    sads, sses = [], []
    for oy, ox in _offsets().tolist():
        cand = ny_pad[:, oy + SEARCH: oy + SEARCH + h,
                      ox + SEARCH: ox + SEARCH + w]
        ad = (cy - cand).abs()
        sq = ad * ad
        # out-of-frame rows/cols of this offset: a rectangle's complement
        y0, y1 = max(0, -oy), min(h, h - oy)
        x0, x1 = max(0, -ox), min(w, w - ox)
        for sl in ((slice(None), slice(0, y0)), (slice(None), slice(y1, h)),
                   (slice(None), slice(None), slice(0, x0)),
                   (slice(None), slice(None), slice(x1, w))):
            ad[sl] = maxpix
            sq[sl] = maxpix * maxpix
        # small-motion tie-break
        sads.append(_box(ad, BLK, BLK) * 16 + (abs(oy) + abs(ox)))
        sses.append(_box(sq, BLK, BLK))
    # the first offset of the smallest SAD, as the strict-less scan
    best = torch.argmin(torch.stack(sads), dim=0)            # (N, nby, nbx)
    sse = torch.stack(sses).gather(0, best[None])[0]
    off = torch.from_numpy(_offsets()).to(dev)[best]         # (..., 2)
    return off[..., 0], off[..., 1], sse


def _gather_plane(ref: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                  ss_y: int, ss_x: int):
    """Motion-compensate each neighbour's plane by its per-luma-block
    full-pel offsets.

    ref (N, ph, pw); dy/dx (N, nby, nbx) luma-block offsets. Returns
    (pred, valid), both (N, ph, pw): the per-pixel gathered samples
    (clipped indices) and the in-frame mask (out-of-frame pixels get zero
    weight)."""
    n, ph, pw = ref.shape
    dev = ref.device
    pblk_y, pblk_x = BLK >> ss_y, BLK >> ss_x
    dyp = (dy >> ss_y).repeat_interleave(pblk_y, 1).repeat_interleave(
        pblk_x, 2)
    dxp = (dx >> ss_x).repeat_interleave(pblk_y, 1).repeat_interleave(
        pblk_x, 2)
    ry = torch.arange(ph, device=dev)[None, :, None] + dyp
    cx = torch.arange(pw, device=dev)[None, None, :] + dxp
    valid = (ry >= 0) & (ry < ph) & (cx >= 0) & (cx < pw)
    pred = ref[torch.arange(n, device=dev)[:, None, None],
               ry.clamp(0, ph - 1), cx.clamp(0, pw - 1)]
    return pred, valid


def _weight(err: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """round(exp(-min(err/decay, 7)) * 1024), float32, half to even."""
    return torch.round(torch.exp(-torch.clamp_max(err / decay, 7.0))
                       * WEIGHT_SCALE).to(torch.int32)


def tf_filter(center: tuple, nbrs: tuple, decay_px: float,
              bit_depth: int = 8,
              planes_ss: tuple = ((0, 0), (1, 1), (1, 1))) -> tuple:
    """Temporal-filter `center` with the neighbour stacks.

    center: per-plane (ph, pw) int tensors; nbrs: per-plane (N, ph, pw)
    stacks, all on one device, luma H/W multiples of BLK; decay_px: the
    per-pixel error decay (rounded to float32, as the reference passes
    it). Returns the filtered planes as int32 tensors."""
    maxpix = (1 << bit_depth) - 1
    cy = center[0].to(torch.int32)
    ny = nbrs[0].to(torch.int32)
    decay = torch.tensor(np.float32(decay_px), device=cy.device)

    dy, dx, sse = _block_search(cy, ny, maxpix)
    wgt = _weight(sse.to(torch.float32) / (BLK * BLK), decay)  # (N, nby, nbx)

    out = []
    for p, (ss_y, ss_x) in enumerate(planes_ss[:len(center)]):
        src = center[p].to(torch.int32)
        pblk_y, pblk_x = BLK >> ss_y, BLK >> ss_x
        pred, valid = _gather_plane(nbrs[p].to(torch.int32), dy, dx,
                                    ss_y, ss_x)
        wi = wgt
        if p > 0:
            # planewise weights: chroma moves independently of luma in
            # general, so cap the luma-match weight by this plane's own
            # MC error
            d = torch.where(valid, src - pred, maxpix)
            errp = (_box(d * d, pblk_y, pblk_x).to(torch.float32)
                    / (pblk_y * pblk_x))
            wi = torch.minimum(wi, _weight(errp, decay))
        w_px = wi.repeat_interleave(pblk_y, 1).repeat_interleave(pblk_x, 2)
        w_px = torch.where(valid, w_px, 0)
        accum = src * WEIGHT_SCALE + (w_px * pred).sum(dim=0,
                                                       dtype=torch.int32)
        count = WEIGHT_SCALE + w_px.sum(dim=0, dtype=torch.int32)
        filt = torch.div(accum + count // 2, count.clamp_min(1),
                         rounding_mode="floor")
        out.append(filt.clamp(0, maxpix))
    return tuple(out)
