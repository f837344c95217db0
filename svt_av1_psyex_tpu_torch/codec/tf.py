"""Alt-ref temporal filtering for the port (counterpart of
svt_av1_psyex_tpu/codec/tf.py `temporal_filter` and
`_temporal_filter_device`, one function here).

The decay (with its noise estimate) is the JAX package's, numpy-only at
import; the filter itself runs the port's device/tf.py on the device
the caller names. There is no switch to the per-block host loop: the
JAX package keeps that loop as a second opinion, and the tests may call
it.
"""

from __future__ import annotations

import numpy as np
import torch

from svt_av1_psyex_tpu.codec.tf import _decay_px

from ..device.tf import BLK, tf_filter
from ..runtime import resolve_device

__all__ = ["temporal_filter"]


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
