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

import numpy as np
import torch

from ..device.tf import BLK, tf_filter
from ..runtime import resolve_device

__all__ = ["estimate_noise_mad", "temporal_filter"]


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
    lists) on `device`. Returns new numpy planes with the same dtypes."""
    if not neighbors:
        return center
    dev = resolve_device(device)
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
