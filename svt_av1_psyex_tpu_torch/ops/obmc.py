"""Overlapped block motion compensation (spec 7.11.3.9-7.11.3.10).

Counterpart: av1_build_obmc_inter_prediction + blend_a64_v/hmask
(Source/Lib/Codec/enc_inter_prediction.c:1430-1545,
blend_a64_mask.c:302) — the base prediction is re-blended with
motion-compensated predictions from overlappable above/left neighbors
using the normative OBMC mask ramps.
"""

from __future__ import annotations

import numpy as np

# normative mask ramps (spec Obmc_Mask_N; inter_prediction.c:2406)
OBMC_MASKS = {
    1: np.array([64], np.int32),
    2: np.array([45, 64], np.int32),
    4: np.array([39, 50, 59, 64], np.int32),
    8: np.array([36, 42, 48, 53, 57, 61, 64, 64], np.int32),
    16: np.array([34, 37, 40, 43, 46, 49, 52, 54,
                  56, 58, 60, 61, 64, 64, 64, 64], np.int32),
    32: np.array([33, 35, 36, 38, 40, 41, 43, 44,
                  45, 47, 48, 50, 51, 52, 53, 55,
                  56, 57, 58, 59, 60, 60, 61, 62,
                  64, 64, 64, 64, 64, 64, 64, 64], np.int32),
}


def blend_vmask(dst: np.ndarray, src1: np.ndarray, mask: np.ndarray) -> None:
    """dst = round((mask*dst + (64-mask)*src1) / 64) per ROW (above
    overlap). dst (h, w) int32 modified in place; mask (h,)."""
    m = mask[:, None].astype(np.int64)
    dst[...] = (m * dst + (64 - m) * src1 + 32) >> 6


def blend_hmask(dst: np.ndarray, src1: np.ndarray, mask: np.ndarray) -> None:
    """Per-COLUMN blend (left overlap). mask (w,)."""
    m = mask[None, :].astype(np.int64)
    dst[...] = (m * dst + (64 - m) * src1 + 32) >> 6
