"""AV1 forward/inverse 2D transforms — spec-exact, batched over blocks.

The 1D butterfly networks (normative: AV1 spec 7.13.3 and its 1D
sub-processes) are executed from data tables
(bitstream/tables/txfm_networks.json, see tools/gen_txfm_networks.py).
Execution is vectorized: arrays are (batch, h, w) int32; every stage is a
gather + weighted add (+ rounding for cos-weighted butterflies, + clamping
on the inverse side), so the same formulation maps directly onto the TPU
VPU in the Pallas port.

2D drivers mirror the normative process:
  inverse: rows first (with 1/sqrt2 pre-scale for 2:1 rect), shift0,
           columns, shift1, add-to-pred with pixel clamp
  forward: columns first (shift0 pre-scale), shift1, rows, shift2,
           sqrt2 post-scale for 2:1 rect
Counterpart: Source/Lib/Codec/inv_transforms.c / transforms.c.
"""

from __future__ import annotations

import json
import math
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..codec.constants import TX_H, TX_W, TxType

_NETS_PATH = Path(__file__).parent.parent / "bitstream" / "tables" / "txfm_networks.json"

# --- constant generators (normative values) -----------------------------------


@lru_cache(maxsize=None)
def cospi_arr(bit: int) -> np.ndarray:
    """cospi[i] ~ 2^bit * cos(i*pi/128) — normative table (spec 7.13.3)."""
    from ..bitstream.tables import get

    return get("cospi_arr_data")[bit - 10].astype(np.int64)


@lru_cache(maxsize=None)
def sinpi_arr(bit: int) -> np.ndarray:
    """sinpi[k] ~ 2^bit * (2*sqrt(2)/3) * sin(k*pi/9) — normative table.

    Not purely generative: some bit-widths in the normative table differ by
    one from direct rounding (e.g. 1901 vs 1902 at bit 11), hence extraction.
    """
    from ..bitstream.tables import get

    return get("sinpi_arr_data")[bit - 10].astype(np.int64)


NEW_SQRT2 = 5793  # round(2^12 * sqrt(2))
NEW_INV_SQRT2 = 2896  # round(2^12 / sqrt(2))
SQRT2_BITS = 12


def round_shift(x, bit: int):
    """Arithmetic rounding shift; bit<0 shifts left (exact)."""
    if bit == 0:
        return x
    if bit < 0:
        return x << (-bit)
    return (x + (1 << (bit - 1))) >> bit


def clamp_value(x, bit: int):
    lo = -(1 << (bit - 1))
    hi = (1 << (bit - 1)) - 1
    return np.clip(x, lo, hi)


# --- compiled stage networks ------------------------------------------------------


def _native_lib():
    """C net executor (native/ecenc.c svt_net_run); None => pure numpy."""
    import os

    if os.environ.get("SVT_TPU_PY_TXFM") == "1":
        return None
    from ..native.ecenc import get_lib

    return get_lib()


class _Net:
    __slots__ = ("stages", "size", "_wcache")

    def __init__(self, raw_stages):
        self._wcache = {}
        self.stages = []
        for ops in raw_stages:
            n = len(ops)
            dst = np.array([op[0] for op in ops])
            assert sorted(dst.tolist()) == list(range(n)), "stage must assign all lanes"
            order = np.argsort(dst)
            src0 = np.array([ops[i][1] for i in order])
            src1 = np.array([ops[i][3] for i in order])
            w0 = [ops[i][2] for i in order]
            w1 = [ops[i][4] for i in order]
            kind = [ops[i][5] for i in order]
            self.stages.append((src0, w0, src1, w1, kind))
        self.size = len(raw_stages[0])

    def _weights(self, wspecs, cos_bit: int) -> np.ndarray:
        cospi = cospi_arr(cos_bit)
        out = np.empty(len(wspecs), dtype=np.int64)
        for i, w in enumerate(wspecs):
            if w[0] == "c":
                out[i] = int(cospi[w[1]]) * w[2]
            elif w[0] == "i":
                out[i] = w[1]
            else:  # "z"
                out[i] = 0
        return out

    def _compiled_native(self, cos_bit: int):
        key = ("c", cos_bit)
        if key not in self._wcache:
            comp = self._compiled(cos_bit)
            n = self.size
            ns = len(comp)
            src0 = np.empty(ns * n, np.int32)
            src1 = np.empty(ns * n, np.int32)
            w0 = np.empty(ns * n, np.int64)
            w1 = np.empty(ns * n, np.int64)
            btf = np.empty(ns * n, np.uint8)
            clp = np.empty(ns * n, np.uint8)
            for s, (a0, b0, a1, b1, ib, dc) in enumerate(comp):
                src0[s * n : (s + 1) * n] = a0
                w0[s * n : (s + 1) * n] = b0
                src1[s * n : (s + 1) * n] = a1
                w1[s * n : (s + 1) * n] = b1
                btf[s * n : (s + 1) * n] = ib
                clp[s * n : (s + 1) * n] = dc
            self._wcache[key] = (src0, w0, src1, w1, btf, clp, ns)
        return self._wcache[key]

    def _native_args(self, cos_bit: int, clamp_bit: int):
        """Static svt_net_run argument tail (pointers stay alive through
        the _compiled_native cache entry)."""
        key = ("na", cos_bit, clamp_bit)
        a = self._wcache.get(key)
        if a is None:
            src0, w0, src1, w1, btf, clp, ns = self._compiled_native(cos_bit)
            a = (self.size, src0.ctypes.data, w0.ctypes.data,
                 src1.ctypes.data, w1.ctypes.data, btf.ctypes.data,
                 clp.ctypes.data, ns, cos_bit, clamp_bit)
            self._wcache[key] = a
        return a

    def _compiled(self, cos_bit: int):
        if cos_bit not in self._wcache:
            comp = []
            for src0, w0s, src1, w1s, kind in self.stages:
                comp.append((
                    src0,
                    self._weights(w0s, cos_bit),
                    src1,
                    self._weights(w1s, cos_bit),
                    np.array([k == "btf" for k in kind]),
                    np.array([k == "raw" for k in kind]),
                ))
            self._wcache[cos_bit] = comp
        return self._wcache[cos_bit]

    def run(self, x: np.ndarray, cos_bit: int, clamp_bit: int) -> np.ndarray:
        """x: (batch, N) int64 -> (batch, N) int64."""
        lib = _native_lib()
        if lib is not None:
            args = self._native_args(cos_bit, clamp_bit)
            x = np.asarray(x)
            if x.dtype == np.int64 and x.flags.c_contiguous:
                buf = x.copy()  # C mutates in place
            else:
                buf = np.array(x, np.int64, order="C")
            tmp = np.empty_like(buf)
            lib.svt_net_run(buf.ctypes.data, tmp.ctypes.data,
                            buf.shape[0], *args)
            return buf
        rnd = 1 << (cos_bit - 1)
        for src0, w0, src1, w1, is_btf, do_clamp in self._compiled(cos_bit):
            y = x[:, src0] * w0 + x[:, src1] * w1
            if is_btf.any():
                y = np.where(is_btf, (y + rnd) >> cos_bit, y)
            if clamp_bit > 0 and do_clamp.any():
                y = np.where(do_clamp, clamp_value(y, clamp_bit), y)
            x = y
        return x


@lru_cache(maxsize=None)
def _load_nets() -> dict[str, _Net]:
    raw = json.loads(_NETS_PATH.read_text())
    return {k: _Net(v) for k, v in raw.items()}


# --- special 1D transforms ---------------------------------------------------------


def _iadst4(x: np.ndarray, bit: int, clamp_bit: int) -> np.ndarray:
    sinpi = sinpi_arr(bit)
    x0, x1, x2, x3 = (x[:, i] for i in range(4))
    s0 = sinpi[1] * x0
    s1 = sinpi[2] * x0
    s2 = sinpi[3] * x1
    s3 = sinpi[4] * x2
    s4 = sinpi[1] * x2
    s5 = sinpi[2] * x3
    s6 = sinpi[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sinpi[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    o0 = s0 + s3
    o1 = s1 + s3
    o2 = s2
    o3 = (s0 + s1) - s3
    return np.stack(
        [round_shift(o0, bit), round_shift(o1, bit), round_shift(o2, bit), round_shift(o3, bit)],
        axis=1,
    )


def _fadst4(x: np.ndarray, bit: int) -> np.ndarray:
    sinpi = sinpi_arr(bit)
    x0, x1, x2, x3 = (x[:, i] for i in range(4))
    s0 = sinpi[1] * x0
    s1 = sinpi[4] * x0
    s2 = sinpi[2] * x1
    s3 = sinpi[1] * x1
    s4 = sinpi[3] * x2
    s5 = sinpi[4] * x3
    s6 = sinpi[2] * x3
    s7 = (x0 + x1) - x3
    y0 = s0 + s2 + s5
    y1 = sinpi[3] * s7
    y2 = s1 - s3 + s6
    y3 = s4
    o0 = y0 + y3
    o1 = y1
    o2 = y2 - y3
    o3 = (y2 - y0) + y3
    return np.stack(
        [round_shift(o0, bit), round_shift(o1, bit), round_shift(o2, bit), round_shift(o3, bit)],
        axis=1,
    )


def _identity(x: np.ndarray, n: int, _bit: int) -> np.ndarray:
    if n == 4:
        return round_shift(x * NEW_SQRT2, SQRT2_BITS)
    if n == 8:
        return x * 2
    if n == 16:
        return round_shift(x * 2 * NEW_SQRT2, SQRT2_BITS)
    if n == 32:
        return x * 4
    raise ValueError(n)


def _run_1d(kind: str, n: int, x: np.ndarray, cos_bit: int, clamp_bit: int,
            inverse: bool) -> np.ndarray:
    if kind == "identity":
        return _identity(x, n, cos_bit)
    if kind == "adst" and n == 4:
        return _iadst4(x, cos_bit, clamp_bit) if inverse else _fadst4(x, cos_bit)
    prefix = ("i" if inverse else "f") + ("dct" if kind == "dct" else "adst")
    return _load_nets()[f"{prefix}{n}"].run(x, cos_bit, clamp_bit if inverse else 0)


# --- 2D configuration tables -------------------------------------------------------

# tx_type -> (col 1D kind, row 1D kind, ud_flip, lr_flip)
_TX1D = {
    TxType.DCT_DCT: ("dct", "dct", 0, 0),
    TxType.ADST_DCT: ("adst", "dct", 0, 0),
    TxType.DCT_ADST: ("dct", "adst", 0, 0),
    TxType.ADST_ADST: ("adst", "adst", 0, 0),
    TxType.FLIPADST_DCT: ("adst", "dct", 1, 0),
    TxType.DCT_FLIPADST: ("dct", "adst", 0, 1),
    TxType.FLIPADST_FLIPADST: ("adst", "adst", 1, 1),
    TxType.ADST_FLIPADST: ("adst", "adst", 0, 1),
    TxType.FLIPADST_ADST: ("adst", "adst", 1, 0),
    TxType.IDTX: ("identity", "identity", 0, 0),
    TxType.V_DCT: ("dct", "identity", 0, 0),
    TxType.H_DCT: ("identity", "dct", 0, 0),
    TxType.V_ADST: ("adst", "identity", 0, 0),
    TxType.H_ADST: ("identity", "adst", 0, 0),
    TxType.V_FLIPADST: ("adst", "identity", 1, 0),
    TxType.H_FLIPADST: ("identity", "adst", 0, 1),
}

_INV_SHIFT = {
    (4, 4): (0, -4), (8, 8): (-1, -4), (16, 16): (-2, -4), (32, 32): (-2, -4),
    (64, 64): (-2, -4), (4, 8): (0, -4), (8, 4): (0, -4), (8, 16): (-1, -4),
    (16, 8): (-1, -4), (16, 32): (-1, -4), (32, 16): (-1, -4), (32, 64): (-1, -4),
    (64, 32): (-1, -4), (4, 16): (-1, -4), (16, 4): (-1, -4), (8, 32): (-2, -4),
    (32, 8): (-2, -4), (16, 64): (-2, -4), (64, 16): (-2, -4),
}

_FWD_SHIFT = {
    (4, 4): (2, 0, 0), (8, 8): (2, -1, 0), (16, 16): (2, -2, 0), (32, 32): (2, -4, 0),
    (64, 64): (0, -2, -2), (4, 8): (2, -1, 0), (8, 4): (2, -1, 0), (8, 16): (2, -2, 0),
    (16, 8): (2, -2, 0), (16, 32): (2, -4, 0), (32, 16): (2, -4, 0), (32, 64): (0, -2, -2),
    (64, 32): (2, -4, -2), (4, 16): (2, -1, 0), (16, 4): (2, -1, 0), (8, 32): (2, -2, 0),
    (32, 8): (2, -2, 0), (16, 64): (0, -2, 0), (64, 16): (2, -4, 0),
}

# fwd cos bits [txw_idx][txh_idx] (txw_idx = log2(w)-2)
_FWD_COS_BIT_COL = [
    [13, 13, 13, 0, 0], [13, 13, 13, 12, 0], [13, 13, 13, 12, 13],
    [0, 13, 13, 12, 13], [0, 0, 13, 12, 13]]
_FWD_COS_BIT_ROW = [
    [13, 13, 12, 0, 0], [13, 13, 13, 12, 0], [13, 13, 12, 13, 12],
    [0, 12, 13, 12, 11], [0, 0, 12, 11, 10]]
INV_COS_BIT = 12


def _rect_ratio1(w: int, h: int) -> bool:
    return abs(int(math.log2(w)) - int(math.log2(h))) == 1


# --- public 2D entry points -------------------------------------------------------


def inverse_txfm2d(coeffs: np.ndarray, tx_w: int, tx_h: int, tx_type: int,
                   bit_depth: int = 8) -> np.ndarray:
    """coeffs: (batch, min(h,32), min(w,32)) int32 -> residual (batch, h, w).

    Returns the integer residual to add to the prediction (caller clips).
    """
    col_kind, row_kind, ud_flip, lr_flip = _TX1D[TxType(tx_type)]
    shift = _INV_SHIFT[(tx_w, tx_h)]
    opt_row = {8: 16, 10: 18, 12: 20}[bit_depth]
    opt_col = {8: 16, 10: 16, 12: 18}[bit_depth]

    b = coeffs.shape[0]
    cw, ch = min(tx_w, 32), min(tx_h, 32)
    x = coeffs.astype(np.int64)
    # pad 64-dim coefficients with zeros
    if cw != tx_w or ch != tx_h:
        full = np.zeros((b, tx_h, tx_w), dtype=np.int64)
        full[:, :ch, :cw] = x
        x = full

    # rows
    rows = x.reshape(b * tx_h, tx_w)
    if _rect_ratio1(tx_w, tx_h):
        rows = round_shift(rows * NEW_INV_SQRT2, SQRT2_BITS)
    rows = clamp_value(rows, bit_depth + 8)
    rows = _run_1d(row_kind, tx_w, rows, INV_COS_BIT, opt_row, inverse=True)
    rows = round_shift(rows, -shift[0])
    buf = rows.reshape(b, tx_h, tx_w)

    # columns
    if lr_flip:
        buf = buf[:, :, ::-1]
    cols = buf.transpose(0, 2, 1).reshape(b * tx_w, tx_h)
    cols = clamp_value(cols, max(bit_depth + 6, 16))
    cols = _run_1d(col_kind, tx_h, cols, INV_COS_BIT, opt_col, inverse=True)
    cols = round_shift(cols, -shift[1])
    res = cols.reshape(b, tx_w, tx_h).transpose(0, 2, 1)
    if ud_flip:
        res = res[:, ::-1, :]
    return res.astype(np.int32)


def inverse_txfm2d_add(coeffs: np.ndarray, pred: np.ndarray, tx_w: int, tx_h: int,
                       tx_type: int, bit_depth: int = 8) -> np.ndarray:
    res = inverse_txfm2d(coeffs, tx_w, tx_h, tx_type, bit_depth)
    return np.clip(pred.astype(np.int32) + res, 0, (1 << bit_depth) - 1)


def forward_txfm2d(residual: np.ndarray, tx_w: int, tx_h: int, tx_type: int,
                   bit_depth: int = 8) -> np.ndarray:
    """residual: (batch, h, w) int -> coeffs (batch, min(h,32), min(w,32)) int32."""
    col_kind, row_kind, ud_flip, lr_flip = _TX1D[TxType(tx_type)]
    shift = _FWD_SHIFT[(tx_w, tx_h)]
    wi = int(math.log2(tx_w)) - 2
    hi = int(math.log2(tx_h)) - 2
    cos_bit_col = _FWD_COS_BIT_COL[wi][hi]
    cos_bit_row = _FWD_COS_BIT_ROW[wi][hi]

    b = residual.shape[0]
    x = residual.astype(np.int64)

    # columns
    if ud_flip:
        x = x[:, ::-1, :]
    cols = x.transpose(0, 2, 1).reshape(b * tx_w, tx_h)
    cols = round_shift(cols, -shift[0])
    cols = _run_1d(col_kind, tx_h, cols, cos_bit_col, 0, inverse=False)
    cols = round_shift(cols, -shift[1])
    buf = cols.reshape(b, tx_w, tx_h).transpose(0, 2, 1)
    if lr_flip:
        buf = buf[:, :, ::-1]

    # rows
    rows = buf.reshape(b * tx_h, tx_w)
    rows = _run_1d(row_kind, tx_w, rows, cos_bit_row, 0, inverse=False)
    rows = round_shift(rows, -shift[2])
    if _rect_ratio1(tx_w, tx_h):
        rows = round_shift(rows * NEW_SQRT2, SQRT2_BITS)
    out = rows.reshape(b, tx_h, tx_w)
    # 64-wide/tall: only top-left 32x32 is coded
    return out[:, : min(tx_h, 32), : min(tx_w, 32)].astype(np.int32)
