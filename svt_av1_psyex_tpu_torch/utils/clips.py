"""Deterministic synthetic clips for programs that drive the port.

`synth_frame(fmt, t)` is the repository's "blobs" test clip
(tools/mkclip.py): smooth moving gaussians over a gradient, light noise
from a fixed seed, sinusoidal chroma. It lives here too, so that a
program can make its input from the port alone.
"""

from __future__ import annotations

import numpy as np

from .y4m import VideoFormat


def synth_frame(fmt: VideoFormat, t: int) -> list[np.ndarray]:
    """Frame `t` of the "blobs" clip in `fmt`, as a list of planes."""
    h, w = fmt.height, fmt.width
    maxv = (1 << fmt.bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = (xx / w) * 0.35 * maxv + (yy / h) * 0.15 * maxv
    rng = np.random.RandomState(1234)
    for i in range(4):
        cx = (0.2 + 0.15 * i) * w + 6.0 * t * (1 + i * 0.3)
        cy = (0.3 + 0.12 * i) * h + 3.0 * t * (1 - i * 0.2)
        cx %= w
        cy %= h
        sig = 0.08 * min(w, h) * (1 + 0.5 * i)
        y += (0.45 * maxv) * np.exp(
            -(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig**2)))
    y += rng.normal(0, 0.003 * maxv, (h, w)).astype(np.float32)
    y = np.clip(y, 0, maxv).astype(fmt.dtype)
    if fmt.subsampling == "400":
        return [y]
    ch, cw = fmt.chroma_size
    cyy, cxx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    u = (0.5 + 0.25 * np.sin(2 * np.pi * (cxx / cw + 0.02 * t))) * maxv
    v = (0.5 + 0.25 * np.cos(2 * np.pi * (cyy / ch - 0.015 * t))) * maxv
    return [y, np.clip(u, 0, maxv).astype(fmt.dtype),
            np.clip(v, 0, maxv).astype(fmt.dtype)]
