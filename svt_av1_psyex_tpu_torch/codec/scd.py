"""Scene-change detection on source frames.

Counterpart: the picture-decision scene_transition_detector
(pd_process.c:274-365) — region histogram difference + activity change —
reduced to a two-feature full-frame test on 4x-decimated luma:

* normalized 64-bin histogram absolute difference (global tone change)
* mean absolute difference of 8x8 block means (structural change, robust
  to noise and small motion: moving content shifts block means locally
  while a cut replaces them everywhere)

Both must fire, mirroring the reference's AND of region votes.
"""

from __future__ import annotations

import numpy as np

HIST_THRESH = 0.55  # fraction of pixels changing histogram bin
MAD_THRESH = 28.0  # motion-tolerant mean abs pixel delta (8-bit units)
_SHIFT = 3  # decimated px => +-12 full-res px motion tolerance


def decimate_luma(luma: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """Subsampled luma normalized to 8-bit (detector working space).
    The decimation factor adapts so the working frame keeps >= ~64 px on
    the short side (tiny frames give noisy statistics)."""
    luma = np.asarray(luma)
    f = max(1, min(4, min(luma.shape) // 64))
    d = luma[::f, ::f]
    if bit_depth > 8:
        d = d >> (bit_depth - 8)
    return d.astype(np.uint8)


def _mc_mad(prev: np.ndarray, cur: np.ndarray) -> float:
    """Minimum mean-abs-difference over small global shifts — continuity
    under motion collapses to a low value at the true displacement, a cut
    stays high everywhere (the reference's pre-HME role in its SCD)."""
    h, w = cur.shape
    s = _SHIFT
    if h <= 2 * s + 4 or w <= 2 * s + 4:
        return float(np.abs(prev.astype(np.int32)
                            - cur.astype(np.int32)).mean())
    core = cur[s:h - s, s:w - s].astype(np.int32)
    best = None
    for dy in range(-s, s + 1):
        for dx in range(-s, s + 1):
            cand = prev[s + dy:h - s + dy, s + dx:w - s + dx].astype(np.int32)
            mad = float(np.abs(core - cand).mean())
            if best is None or mad < best:
                best = mad
    return best


def scene_cut(prev_dec: np.ndarray, cur_dec: np.ndarray) -> bool:
    """True when cur starts a new scene relative to prev (both 4x
    decimated 8-bit luma from decimate_luma)."""
    if prev_dec is None or prev_dec.shape != cur_dec.shape:
        return False
    ha = np.bincount(prev_dec.ravel() >> 2, minlength=64)
    hb = np.bincount(cur_dec.ravel() >> 2, minlength=64)
    hist_sad = float(np.abs(ha - hb).sum()) / prev_dec.size
    mad = _mc_mad(prev_dec, cur_dec)
    # both features agree, or either is overwhelming on its own
    return ((hist_sad > HIST_THRESH and mad > MAD_THRESH)
            or mad > 40.0 or hist_sad > 0.85)
