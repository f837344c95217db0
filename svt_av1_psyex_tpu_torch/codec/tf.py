"""Alt-ref temporal filtering: motion-compensated non-local-mean denoising
of anchor (ARF) sources before encoding.

Counterpart: the reference's temporal filtering process
(temporal_filtering.c svt_av1_apply_temporal_filter_planewise_medium /
calculate_decay_factor): per-block full-pel motion search against each
window frame, per-block exp(-err/decay) weights accumulated pixel-wise,
with decay derived from noise level and q. The search and the
accumulation run as one batched torch program on the device the caller
names (device/tf.py); the decay and its noise estimate are host numpy.

Encoder-side only: no bitstream syntax. The filtered frame becomes the
coded ARF source; hierarchical B frames then predict from a denoised
anchor.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device.tf import BLK, tf_filter
from ..runtime import resolve_device

__all__ = ["estimate_noise_mad", "temporal_filter"]

_SEARCH = 8  # full-pel raster radius around the co-located block
_WEIGHT_SCALE = 1 << 10  # center-frame anchor weight


def estimate_noise_mad(luma: np.ndarray) -> float:
    """Median-absolute-deviation of the Laplacian — the reference's
    svt_estimate_noise_fp16 shape (temporal_filtering.c noise estimate),
    simplified to a plain float."""
    x = luma.astype(np.int64)
    lap = (4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1]
           - x[1:-1, :-2] - x[1:-1, 2:])
    mad = np.median(np.abs(lap))
    # median|Laplacian| for N(0,s^2) noise is ~3.0*s (weights 4,-1x4)
    return float(mad) / 3.0


def _block_motion(center: np.ndarray, ref: np.ndarray, by: int, bx: int,
                  bh: int, bw: int) -> tuple[int, int, int]:
    """Full-pel SAD raster search of ref around the co-located block;
    returns (dy, dx, sse_of_best)."""
    h, w = center.shape
    cur = center[by : by + bh, bx : bx + bw].astype(np.int32)
    best = None
    # two-stage: coarse step 2, then refine +-1
    for step, center_mv, rad in ((2, (0, 0), _SEARCH), (1, None, 1)):
        cy, cx = center_mv if center_mv is not None else (best[1], best[2])
        for dy in range(cy - rad, cy + rad + 1, step):
            y0 = by + dy
            if y0 < 0 or y0 + bh > h:
                continue
            for dx in range(cx - rad, cx + rad + 1, step):
                x0 = bx + dx
                if x0 < 0 or x0 + bw > w:
                    continue
                cand = ref[y0 : y0 + bh, x0 : x0 + bw].astype(np.int32)
                sad = int(np.abs(cand - cur).sum())
                if best is None or sad < best[0]:
                    best = (sad, dy, dx)
    _, dy, dx = best
    blk = ref[by + dy : by + dy + bh, bx + dx : bx + dx + bw].astype(np.int64)
    sse = int(((blk - cur) ** 2).sum())
    return dy, dx, sse


def _decay_px(y: np.ndarray, qindex: int, bit_depth: int,
              strength: int) -> float:
    """Per-pixel squared-error decay for the exp weights (shared by the
    host and device paths)."""
    noise = estimate_noise_mad(y)
    q_decay = max(0.5, min(4.0, (qindex / 120.0) ** 2))
    decay = max(12.0 * (1 << (2 * (bit_depth - 8))),
                2.5 * noise * noise) * q_decay
    # --tf-strength 0..4: power-of-two filter strength ladder
    # (temporal_filtering.c:2996 tf_shift_factor; 3 = default)
    return decay * 2.0 ** (min(strength, 4) - 3)


def temporal_filter(center: list, neighbors: list, qindex: int,
                    bit_depth: int = 8, strength: int = 3, *,
                    device) -> list:
    """Filter `center` planes [Y,U,V] using `neighbors` (list of plane
    lists) on `device`. Returns new numpy planes with the same dtypes.
    SVT_TPU_HOST_TF=1 runs the per-block host loop instead, as the JAX
    package does under the same switch (then nothing runs on `device`)."""
    if not neighbors:
        return center
    dev = resolve_device(device)
    if os.environ.get("SVT_TPU_HOST_TF") == "1":
        return _temporal_filter_host(center, neighbors, qindex, bit_depth,
                                     strength)
    y = np.asarray(center[0])
    h, w = y.shape
    hp = -(-h // BLK) * BLK
    wp = -(-w // BLK) * BLK
    ss = []
    for p in range(len(center)):
        ph, pw = np.asarray(center[p]).shape
        ss.append((int(np.log2(h // ph + 0.5)) if ph != h else 0,
                   int(np.log2(w // pw + 0.5)) if pw != w else 0))

    def pad(a, ss_y, ss_x):
        a = np.asarray(a)
        th, tw = hp >> ss_y, wp >> ss_x
        return np.pad(a, ((0, th - a.shape[0]), (0, tw - a.shape[1])),
                      mode="edge")

    # narrow uploads (uint8, or int16 above 8 bits); int32 on the device
    up_dt = np.uint8 if bit_depth == 8 else np.int16

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a, up_dt)).to(dev)

    cen = tuple(upload(pad(center[p], *ss[p])) for p in range(len(center)))
    stacks = tuple(
        upload(np.stack([pad(f[p], *ss[p]) for f in neighbors]))
        for p in range(len(center)))
    decay = np.float32(_decay_px(y, qindex, bit_depth, strength))
    outs = tf_filter(cen, stacks, decay, bit_depth=bit_depth,
                     planes_ss=tuple(ss))
    res = []
    for p in range(len(center)):
        src = np.asarray(center[p])
        res.append(outs[p][:src.shape[0], :src.shape[1]].cpu().numpy()
                   .astype(src.dtype))
    return res


def _temporal_filter_host(center: list, neighbors: list, qindex: int,
                          bit_depth: int = 8, strength: int = 3) -> list:
    """The per-block host filter: for each 16x16 luma block and each
    neighbour, _block_motion's full-pel match, one exp(-err/decay) weight
    per block (capped per chroma plane by that plane's own MC error),
    accumulated pixel-wise against the center's anchor weight."""
    y = np.asarray(center[0])
    h, w = y.shape
    ss = []
    for p in range(len(center)):
        ph, pw = np.asarray(center[p]).shape
        ss.append((int(np.log2(h // ph + 0.5)) if ph != h else 0,
                   int(np.log2(w // pw + 0.5)) if pw != w else 0))
    decay_px = _decay_px(y, qindex, bit_depth, strength)

    accum = [np.zeros_like(np.asarray(p), np.int64) for p in center]
    count = [np.zeros_like(np.asarray(p), np.int64) for p in center]
    for p in range(len(center)):
        accum[p] += np.asarray(center[p]).astype(np.int64) * _WEIGHT_SCALE
        count[p] += _WEIGHT_SCALE

    for nb in neighbors:
        nyp = np.asarray(nb[0])
        for by in range(0, h - h % BLK, BLK):
            for bx in range(0, w - w % BLK, BLK):
                bh = min(BLK, h - by)
                bw = min(BLK, w - bx)
                dy, dx, sse = _block_motion(y, nyp, by, bx, bh, bw)
                err = sse / (bh * bw)
                wgt = int(round(
                    np.exp(-min(err / decay_px, 7.0)) * _WEIGHT_SCALE))
                if wgt == 0:
                    continue
                for p in range(len(center)):
                    sy, sx = ss[p]
                    pby, pbx = by >> sy, bx >> sx
                    pbh, pbw = bh >> sy, bw >> sx
                    py0 = pby + (dy >> sy)
                    px0 = pbx + (dx >> sx)
                    ref_p = np.asarray(nb[p])
                    ph, pw = ref_p.shape
                    if py0 < 0 or px0 < 0 or py0 + pbh > ph or px0 + pbw > pw:
                        continue
                    blk = ref_p[py0 : py0 + pbh,
                                px0 : px0 + pbw].astype(np.int64)
                    wgt_p = wgt
                    if p > 0:
                        # planewise: cap by this plane's own MC error
                        # (chroma can move independently of luma)
                        cur_p = np.asarray(center[p])[
                            pby : pby + pbh, pbx : pbx + pbw].astype(np.int64)
                        err_p = float(((blk - cur_p) ** 2).mean())
                        wp = int(round(
                            np.exp(-min(err_p / decay_px, 7.0))
                            * _WEIGHT_SCALE))
                        wgt_p = min(wgt, wp)
                        if wgt_p == 0:
                            continue
                    accum[p][pby : pby + pbh, pbx : pbx + pbw] += wgt_p * blk
                    count[p][pby : pby + pbh, pbx : pbx + pbw] += wgt_p

    out = []
    for p in range(len(center)):
        src = np.asarray(center[p])
        filt = (accum[p] + count[p] // 2) // np.maximum(count[p], 1)
        out.append(filt.astype(src.dtype))
    return out
