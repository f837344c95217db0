"""First-pass analysis + two-pass stats (spec-free encoder machinery).

Counterpart: firstpass.c (open-loop DC-intra / simple-MC error
accumulation) + pass2_strategy.c (stats-driven group bit allocation),
reduced to the decision-relevant core:

* pass 1: per frame, intra energy (variance of 8x8 block residuals vs
  their DC) and motion-compensated error vs the previous frame on
  4x-decimated luma — the same two quantities firstpass.c's
  intra_error / coded_error feed into the group allocator.
* stats serialize to a compact little-endian buffer exposed through
  svt_av1_enc_get_stream_info(FIRST_PASS_STATS_OUT).
* pass 2: relative per-frame complexity weights (coded_error ^ 0.6,
  the pass2 boost curve's shape) that scale the single-pass RC's frame
  targets.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"SVTP1\x00"
_REC = struct.Struct("<qddi")  # poc, intra_err, inter_err, is_cut


@dataclass
class FrameStats:
    poc: int
    intra_err: float
    inter_err: float
    is_cut: bool


def analyze_frame(luma: np.ndarray, prev_dec, bit_depth: int = 8):
    """-> (FrameStats sans poc fields, decimated luma for the next call).

    prev_dec: previous frame's decimated luma (or None for the first)."""
    from .scd import _mc_mad, decimate_luma, scene_cut

    dec = decimate_luma(luma, bit_depth)
    h, w = dec.shape
    h8, w8 = (h // 8) * 8, (w // 8) * 8
    blocks = dec[:h8, :w8].astype(np.float64).reshape(h8 // 8, 8, w8 // 8, 8)
    intra_err = float(blocks.var(axis=(1, 3)).mean())
    if prev_dec is not None and prev_dec.shape == dec.shape:
        inter_err = _mc_mad(prev_dec, dec) ** 2
        cut = scene_cut(prev_dec, dec)
    else:
        inter_err = intra_err
        cut = True
    return intra_err, inter_err, cut, dec


def serialize(stats: list[FrameStats]) -> bytes:
    out = [MAGIC, struct.pack("<i", len(stats))]
    for s in stats:
        out.append(_REC.pack(s.poc, s.intra_err, s.inter_err,
                             1 if s.is_cut else 0))
    return b"".join(out)


def parse(buf: bytes) -> list[FrameStats]:
    if not buf.startswith(MAGIC):
        raise ValueError("not a first-pass stats buffer")
    (n,) = struct.unpack_from("<i", buf, len(MAGIC))
    stats = []
    off = len(MAGIC) + 4
    for _ in range(n):
        poc, ie, pe, cut = _REC.unpack_from(buf, off)
        off += _REC.size
        stats.append(FrameStats(poc, ie, pe, bool(cut)))
    return stats


def complexity_weights(stats: list[FrameStats]) -> np.ndarray:
    """Relative per-frame bit weights (mean 1.0) from coded-error style
    stats (pass2_strategy.c group boost shape: err^0.6, clamped)."""
    if not stats:
        return np.ones(0)
    err = np.array([max(s.inter_err, 1e-3) for s in stats])
    wts = err ** 0.6
    wts = np.clip(wts / wts.mean(), 0.25, 4.0)
    return wts / wts.mean()


def pass2_frame_weights(stats: list[FrameStats], keyint: int = -1) -> np.ndarray:
    """Keyframe-group bit allocation (pass2_strategy.c:1630 reduced to
    its shape): split the stats into kf groups at scene cuts / keyint
    boundaries, boost each keyframe by how predictable its group is
    (intra/coded error ratio — cheap keyframes that seed easy groups
    earn more bits), distribute the rest by the err^0.6 curve.  Returns
    per-poc weights with overall mean 1.0 (RateControl `complexity`)."""
    n = len(stats)
    if n == 0:
        return np.ones(0)
    period = 60 if keyint == -2 else keyint

    def is_key(i: int) -> bool:
        if stats[i].is_cut:
            return True
        return period >= 0 and i % (period + 1) == 0

    bounds = [i for i in range(n) if is_key(i)] or [0]
    bounds.append(n)
    w = np.ones(n)
    for g in range(len(bounds) - 1):
        s, e = bounds[g], bounds[g + 1]
        grp = stats[s:e]
        err = np.array([max(f.inter_err, 1e-3) for f in grp])
        base = np.clip(err ** 0.6 / max((err ** 0.6).mean(), 1e-9),
                       0.25, 4.0)
        w[s:e] = base
        if e - s > 1:
            # kf boost: mean intra/coded ratio over the group, scaled by
            # group length (the reference's calculate_boost_factor shape)
            ratio = np.array([
                np.clip(max(f.intra_err, 1e-3) / max(f.inter_err, 1e-3),
                        1.0, 16.0) for f in grp[1:]])
            boost = np.clip(2.0 + float(ratio.mean())
                            * min(e - s, 16) / 8.0, 2.0, 10.0)
            w[s] = boost
    return w / w.mean()
