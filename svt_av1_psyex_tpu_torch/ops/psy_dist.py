"""PSY distortion (SA8D/SATD energy difference) — host reference kernels.

The fork's flagship psychovisual metric (psy_rd.c): a block's "energy"
is its SA8D (8x8 Hadamard SATD) against zero minus a quarter of its SAD
against zero — i.e. the AC structure with the DC bias removed. The psy
distortion of a candidate is |energy(source) - energy(recon)| summed
over 8x8 tiles (4x4 SATD for thin blocks), scaled by the configured
psy-rd strength, and ADDED to the spatial SSE in the full-loop RD
(full_loop.c:2285-2536; svt_sa8d_8x8 psy_rd.c:64, svt_satd_4x4 :96,
svt_psy_distortion :135, get_svt_psy_full_dist :277).

Batched numpy; exact integer arithmetic matching the reference kernels
(fuzzable against the C oracle).
"""

from __future__ import annotations

import numpy as np


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H8 = _hadamard(8)
_H4 = _hadamard(4)


def sa8d_8x8(blocks: np.ndarray) -> np.ndarray:
    """(B, 8, 8) int -> (B,) SA8D vs zero (svt_sa8d_8x8 semantics)."""
    x = blocks.astype(np.int64)
    t = _H8 @ x @ _H8.T
    return (np.abs(t).sum(axis=(1, 2)) + 2) >> 2


def satd_4x4(blocks: np.ndarray) -> np.ndarray:
    """(B, 4, 4) int -> (B,) SATD vs zero (svt_satd_4x4 semantics)."""
    x = blocks.astype(np.int64)
    t = _H4 @ x @ _H4.T
    return np.abs(t).sum(axis=(1, 2)) >> 1


def _tile(a: np.ndarray, t: int) -> np.ndarray:
    h, w = a.shape
    return (a.reshape(h // t, t, w // t, t).transpose(0, 2, 1, 3)
            .reshape(-1, t, t))


# ---- HBD packed-arithmetic emulation ----------------------------------------
# The reference's 10-bit SA8D/SATD route their column stages through the
# 8-bit HADAMARD4 macro whose temporaries are 32-bit (psy_rd.c:190,219),
# truncating the 64-bit packed lanes. That truncation is part of the
# shipped behavior, so we emulate the packed arithmetic verbatim
# (uint64 wraparound + uint32 macro temporaries) instead of computing
# the mathematically-clean transform.

_M32 = np.uint64(0xFFFFFFFF)
_SH32 = np.uint64(32)
_SH31 = np.uint64(31)


def _abs2_hbd(a: np.ndarray) -> np.ndarray:
    mask = (a >> _SH31) & np.uint64((1 << 32) + 1)
    s = (mask << _SH32) - mask
    return (a + s) ^ s


def _had4_u32(s0, s1, s2, s3):
    t0 = (s0 + s1) & _M32
    t1 = (s0 - s1) & _M32
    t2 = (s2 + s3) & _M32
    t3 = (s2 - s3) & _M32
    return ((t0 + t2) & _M32, (t1 + t3) & _M32,
            (t0 - t2) & _M32, (t1 - t3) & _M32)


def sa8d_8x8_hbd(s: np.ndarray, r: np.ndarray) -> np.ndarray:
    """(B, 8, 8) pairs -> (B,) svt_sa8d_8x8_hbd, quirk-exact."""
    with np.errstate(over="ignore"):
        a = (s.astype(np.int64) - r.astype(np.int64)).astype(np.uint64)
        b = [(a[:, :, 2 * k] + a[:, :, 2 * k + 1]
              + ((a[:, :, 2 * k] - a[:, :, 2 * k + 1]) << _SH32))
             for k in range(4)]                     # each (B, 8)
        tmp = _had4_u32(*b)                          # 4 x (B, 8)
        total = np.zeros(s.shape[0], np.uint64)
        for i in range(4):
            a03 = _had4_u32(tmp[i][:, 0], tmp[i][:, 1],
                            tmp[i][:, 2], tmp[i][:, 3])
            a47 = _had4_u32(tmp[i][:, 4], tmp[i][:, 5],
                            tmp[i][:, 6], tmp[i][:, 7])
            b0 = np.zeros(s.shape[0], np.uint64)
            for k in range(4):
                b0 += _abs2_hbd(a03[k] + a47[k]) + _abs2_hbd(a03[k] - a47[k])
            total += (b0 & _M32) + (b0 >> _SH32)
        return ((total + np.uint64(2)) >> np.uint64(2)).astype(np.int64)


def satd_4x4_hbd(s: np.ndarray, r: np.ndarray) -> np.ndarray:
    """(B, 4, 4) pairs -> (B,) svt_satd_4x4_hbd, quirk-exact."""
    with np.errstate(over="ignore"):
        a = (s.astype(np.int64) - r.astype(np.int64)).astype(np.uint64)
        b0 = a[:, :, 0] + a[:, :, 1] + ((a[:, :, 0] - a[:, :, 1]) << _SH32)
        b1 = a[:, :, 2] + a[:, :, 3] + ((a[:, :, 2] - a[:, :, 3]) << _SH32)
        t0 = b0 + b1                                  # (B, 4) uint64
        t1 = b0 - b1
        total = np.zeros(s.shape[0], np.uint64)
        for tcol in (t0, t1):
            aa = _had4_u32(tcol[:, 0], tcol[:, 1], tcol[:, 2], tcol[:, 3])
            acc = np.zeros(s.shape[0], np.uint64)
            for k in range(4):
                acc += _abs2_hbd(aa[k])
            total += (acc & _M32) + (acc >> _SH32)
        return (total >> np.uint64(1)).astype(np.int64)


def psy_distortion(src: np.ndarray, recon: np.ndarray,
                   bit_depth: int = 8) -> int:
    """|energy(src) - energy(recon)| over the block (svt_psy_distortion
    / _hbd). src/recon: (h, w) with h, w multiples of 4."""
    h, w = src.shape
    zeros8 = np.zeros((1, 8, 8), np.int64)
    zeros4 = np.zeros((1, 4, 4), np.int64)
    if h >= 8 and w >= 8 and h % 8 == 0 and w % 8 == 0:
        s, r = _tile(src, 8), _tile(recon, 8)
        if bit_depth == 8:
            e_s = sa8d_8x8(s) - (np.abs(s.astype(np.int64)).sum(axis=(1, 2)) >> 2)
            e_r = sa8d_8x8(r) - (np.abs(r.astype(np.int64)).sum(axis=(1, 2)) >> 2)
        else:
            e_s = sa8d_8x8_hbd(s, zeros8) \
                - (np.abs(s.astype(np.int64)).sum(axis=(1, 2)) >> 2)
            e_r = sa8d_8x8_hbd(r, zeros8) \
                - (np.abs(r.astype(np.int64)).sum(axis=(1, 2)) >> 2)
    else:
        s, r = _tile(src, 4), _tile(recon, 4)
        if bit_depth == 8:
            e_s = satd_4x4(s) - (np.abs(s.astype(np.int64)).sum(axis=(1, 2)) >> 2)
            e_r = satd_4x4(r) - (np.abs(r.astype(np.int64)).sum(axis=(1, 2)) >> 2)
        else:
            e_s = satd_4x4_hbd(s, zeros4) \
                - (np.abs(s.astype(np.int64)).sum(axis=(1, 2)) >> 2)
            e_r = satd_4x4_hbd(r, zeros4) \
                - (np.abs(r.astype(np.int64)).sum(axis=(1, 2)) >> 2)
    # the C truncates each tile's energy to int32 before differencing
    e_s = e_s.astype(np.int64).astype(np.int32)
    e_r = e_r.astype(np.int64).astype(np.int32)
    total = int(np.abs(e_s.astype(np.int64) - e_r).sum())
    # 8-bit scales energy to 1/8th (>>1); 10-bit scales up (<<2) to match
    # equivalent strengths (psy_rd.c:166,275)
    return total >> 1 if bit_depth == 8 else total << 2


def hvs_modulation_factor(psy_rd: float, is_islice: bool,
                          temporal_layer: int) -> float:
    """get_hvs_modulation_factor (psy_rd.c:295)."""
    if is_islice:
        return psy_rd * 0.4
    if temporal_layer == 0:
        return psy_rd * 0.75
    if temporal_layer == 1:
        return psy_rd * 0.9
    if temporal_layer == 2:
        return psy_rd * 0.95
    return psy_rd
