"""AV1 codec enums and block geometry (spec section 6.10 / Appendix tables).

Fresh implementation of the geometry the reference keeps in
Source/Lib/Codec/definitions.h (block_size_wide/high, subsize tables,
partition context lookup); values follow the AV1 specification's
normative enumerations.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

MI_SIZE = 4  # mode-info unit in pixels
MI_SIZE_LOG2 = 2


class BlockSize(IntEnum):
    B4X4 = 0
    B4X8 = 1
    B8X4 = 2
    B8X8 = 3
    B8X16 = 4
    B16X8 = 5
    B16X16 = 6
    B16X32 = 7
    B32X16 = 8
    B32X32 = 9
    B32X64 = 10
    B64X32 = 11
    B64X64 = 12
    B64X128 = 13
    B128X64 = 14
    B128X128 = 15
    B4X16 = 16
    B16X4 = 17
    B8X32 = 18
    B32X8 = 19
    B16X64 = 20
    B64X16 = 21


BLOCK_SIZES_ALL = 22

BLOCK_W = np.array([4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64])
BLOCK_H = np.array([4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16])


class Partition(IntEnum):
    NONE = 0
    HORZ = 1
    VERT = 2
    SPLIT = 3
    HORZ_A = 4
    HORZ_B = 5
    VERT_A = 6
    VERT_B = 7
    HORZ_4 = 8
    VERT_4 = 9


EXT_PARTITION_TYPES = 10


# spec Partition_Subsize[partition][bsize] — only square bsizes can split.
# Derived generatively: square size s -> subsizes by halving dims.
_SQ = {4: BlockSize.B4X4, 8: BlockSize.B8X8, 16: BlockSize.B16X16,
       32: BlockSize.B32X32, 64: BlockSize.B64X64, 128: BlockSize.B128X128}
_BY_DIMS = {(int(BLOCK_W[b]), int(BLOCK_H[b])): BlockSize(b) for b in range(BLOCK_SIZES_ALL)}


def subsize(partition: int, bsize: int) -> int:
    """Partition_Subsize equivalent; -1 where invalid."""
    w, h = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    if w != h:
        return bsize if partition == Partition.NONE else -1
    p = Partition(partition)
    try:
        if p == Partition.NONE:
            return bsize
        if p == Partition.HORZ or p == Partition.HORZ_A or p == Partition.HORZ_B:
            return _BY_DIMS[(w, h // 2)]
        if p == Partition.VERT or p == Partition.VERT_A or p == Partition.VERT_B:
            return _BY_DIMS[(w // 2, h)]
        if p == Partition.SPLIT:
            return _BY_DIMS[(w // 2, h // 2)]
        if p == Partition.HORZ_4:
            return _BY_DIMS[(w, h // 4)]
        if p == Partition.VERT_4:
            return _BY_DIMS[(w // 4, h)]
    except KeyError:
        return -1
    return -1


class IntraMode(IntEnum):
    DC = 0
    V = 1
    H = 2
    D45 = 3
    D135 = 4
    D113 = 5
    D157 = 6
    D203 = 7
    D67 = 8
    SMOOTH = 9
    SMOOTH_V = 10
    SMOOTH_H = 11
    PAETH = 12


INTRA_MODES = 13
UV_CFL = 13  # chroma-only mode index
UV_INTRA_MODES = 14
MAX_ANGLE_DELTA = 3

# spec Intra_Mode_Context (ctx group per mode, 5 groups for kf_y_mode_cdf)
INTRA_MODE_CONTEXT = np.array([0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0])

# directional modes (angle deltas are coded for these)
DIRECTIONAL = {IntraMode.V, IntraMode.H, IntraMode.D45, IntraMode.D135,
               IntraMode.D113, IntraMode.D157, IntraMode.D203, IntraMode.D67}


class TxSize(IntEnum):
    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3
    TX_64X64 = 4
    TX_4X8 = 5
    TX_8X4 = 6
    TX_8X16 = 7
    TX_16X8 = 8
    TX_16X32 = 9
    TX_32X16 = 10
    TX_32X64 = 11
    TX_64X32 = 12
    TX_4X16 = 13
    TX_16X4 = 14
    TX_8X32 = 15
    TX_32X8 = 16
    TX_16X64 = 17
    TX_64X16 = 18


TX_W = np.array([4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64])
TX_H = np.array([4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16])

# spec Max_Tx_Size_Rect[bsize]: largest rect tx fitting the block
MAX_TX_SIZE_RECT = np.array([
    TxSize.TX_4X4, TxSize.TX_4X8, TxSize.TX_8X4, TxSize.TX_8X8,
    TxSize.TX_8X16, TxSize.TX_16X8, TxSize.TX_16X16, TxSize.TX_16X32,
    TxSize.TX_32X16, TxSize.TX_32X32, TxSize.TX_32X64, TxSize.TX_64X32,
    TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_64X64,
    TxSize.TX_4X16, TxSize.TX_16X4, TxSize.TX_8X32, TxSize.TX_32X8,
    TxSize.TX_16X64, TxSize.TX_64X16,
])

# spec Split_Tx_Size: tx size when splitting (square halving chain)
SPLIT_TX_SIZE = np.array([
    TxSize.TX_4X4, TxSize.TX_4X4, TxSize.TX_8X8, TxSize.TX_16X16,
    TxSize.TX_32X32, TxSize.TX_4X4, TxSize.TX_4X4, TxSize.TX_8X8,
    TxSize.TX_8X8, TxSize.TX_16X16, TxSize.TX_16X16, TxSize.TX_32X32,
    TxSize.TX_32X32, TxSize.TX_4X8, TxSize.TX_8X4, TxSize.TX_8X16,
    TxSize.TX_16X8, TxSize.TX_16X32, TxSize.TX_32X16,
])


def bsize_to_max_depth(bsize: int) -> int:
    """spec bsize_to_max_depth: split chain length from max-rect, cap 2."""
    tx = int(MAX_TX_SIZE_RECT[bsize])
    depth = 0
    while depth < 2 and tx != TxSize.TX_4X4:
        tx = int(SPLIT_TX_SIZE[tx])
        depth += 1
    return depth


def bsize_to_tx_size_cat(bsize: int) -> int:
    """libaom bsize_to_tx_size_cat: chain length - 1, cap MAX_TX_CATS-1."""
    tx = int(MAX_TX_SIZE_RECT[bsize])
    depth = 0
    while tx != TxSize.TX_4X4:
        tx = int(SPLIT_TX_SIZE[tx])
        depth += 1
    return min(depth - 1, 3)


def tx_size_sqr_up(tx: int) -> int:
    """Smallest square tx size >= both dims (spec Tx_Size_Sqr_Up)."""
    d = max(int(TX_W[tx]), int(TX_H[tx]))
    return {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16,
            32: TxSize.TX_32X32, 64: TxSize.TX_64X64}[d]


def tx_size_sqr(tx: int) -> int:
    d = min(int(TX_W[tx]), int(TX_H[tx]))
    return {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16,
            32: TxSize.TX_32X32, 64: TxSize.TX_64X64}[d]


class TxType(IntEnum):
    DCT_DCT = 0
    ADST_DCT = 1
    DCT_ADST = 2
    ADST_ADST = 3
    FLIPADST_DCT = 4
    DCT_FLIPADST = 5
    FLIPADST_FLIPADST = 6
    ADST_FLIPADST = 7
    FLIPADST_ADST = 8
    IDTX = 9
    V_DCT = 10
    H_DCT = 11
    V_ADST = 12
    H_ADST = 13
    V_FLIPADST = 14
    H_FLIPADST = 15


TX_TYPES = 16


def partition_ctx_lookup(bsize: int) -> tuple[int, int]:
    """(above, left) partition-context byte for a coded block of `bsize`.

    bit k set <=> no partition boundary at scale k; generatively:
    above = (31 << log2(w/4)) & 31, left analogous with height
    (matches spec Partition_Context tables).
    """
    w, h = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    above = (31 << (w // 4).bit_length() - 1) & 31
    left = (31 << (h // 4).bit_length() - 1) & 31
    return above, left


# inter prediction modes (spec PredictionMode tail)
class InterMode(IntEnum):
    NEARESTMV = 13
    NEARMV = 14
    GLOBALMV = 15
    NEWMV = 16
    NEAREST_NEARESTMV = 17
    NEAR_NEARMV = 18
    NEAREST_NEWMV = 19
    NEW_NEARESTMV = 20
    NEAR_NEWMV = 21
    NEW_NEARMV = 22
    GLOBAL_GLOBALMV = 23
    NEW_NEWMV = 24


def is_compound_mode(mode: int) -> bool:
    return mode >= InterMode.NEAREST_NEARESTMV


# per-component submode of a compound mode (spec compound_ref0/1_mode)
_COMP_SUB = {
    InterMode.NEAREST_NEARESTMV: (InterMode.NEARESTMV, InterMode.NEARESTMV),
    InterMode.NEAR_NEARMV: (InterMode.NEARMV, InterMode.NEARMV),
    InterMode.NEAREST_NEWMV: (InterMode.NEARESTMV, InterMode.NEWMV),
    InterMode.NEW_NEARESTMV: (InterMode.NEWMV, InterMode.NEARESTMV),
    InterMode.NEAR_NEWMV: (InterMode.NEARMV, InterMode.NEWMV),
    InterMode.NEW_NEARMV: (InterMode.NEWMV, InterMode.NEARMV),
    InterMode.GLOBAL_GLOBALMV: (InterMode.GLOBALMV, InterMode.GLOBALMV),
    InterMode.NEW_NEWMV: (InterMode.NEWMV, InterMode.NEWMV),
}


def compound_sub_modes(mode: int):
    return _COMP_SUB[InterMode(mode)]


# av1_mode_context_analyzer compression map for compound modes
# (inter_prediction.c:2431)
COMPOUND_MODE_CTX_MAP = (
    (0, 1, 1, 1, 1),
    (1, 2, 3, 4, 4),
    (4, 4, 5, 6, 7),
)


def mode_has_newmv(mode: int) -> bool:
    m = InterMode(mode)
    if m == InterMode.NEWMV:
        return True
    if is_compound_mode(m):
        return InterMode.NEWMV in _COMP_SUB[m]
    return False


# reference frames (spec)
NONE_FRAME = -1
INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7

# spec Size_Group[bsize] (for y_mode cdf context in inter frames)
# y-mode cdf size groups; NOTE the ext-size tail is 0,0,1,1,2,2 — one
# group LOWER than the squares of the same long dim (definitions.h:1600)
SIZE_GROUP = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2])

# compound prediction types (read_compound_type; the coded masked
# symbol is comp_type - COMPOUND_WEDGE)
COMPOUND_AVERAGE = 0
COMPOUND_DISTWTD = 1
COMPOUND_WEDGE = 2
COMPOUND_DIFFWTD = 3

# wedge codebook bits per bsize (wedge_params_lookup .bits,
# inter_prediction.c:1912): 16-entry codebooks exist for the 8x8..32x32
# family only; 0 = wedge unusable at this size
WEDGE_BITS = np.array([0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0,
                       0, 0, 0, 0, 0, 0, 0, 4, 4, 0, 0])

# Max/smallest dims
MAX_SB_SIZE = 128
MAX_MIB_SIZE = 32


def mi_size_wide(bsize: int) -> int:
    return int(BLOCK_W[bsize]) // MI_SIZE


def mi_size_high(bsize: int) -> int:
    return int(BLOCK_H[bsize]) // MI_SIZE


def block_size_of(w: int, h: int) -> int:
    return int(_BY_DIMS[(w, h)])
