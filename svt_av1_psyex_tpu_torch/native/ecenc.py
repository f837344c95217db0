"""ctypes binding + on-demand build of the C entropy coder (native/ecenc.c).

The C sources are the repository's shared host tier (native/*.c at the
root, beside neither package); this binding compiles them with gcc into
build/torch_native/ at the root, which git ignores.

The reference keeps its range coder and packetization in C
(bitstream_unit.c, entropy_coding.c); this is our counterpart: the
Python TileWriter prepares contexts/symbols, the C backend does the
arithmetic coding and the per-txb coefficient emission loop.

Falls back to the pure-Python EntropyEncoder (bitstream/ec.py) when the
toolchain is unavailable or SVT_TPU_PY_EC=1 is set; both backends are
held bit-identical by tests/test_native_ec.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SRC = _NATIVE_DIR / "ecenc.c"
_SRCS = [_SRC, _NATIVE_DIR / "cdef.c", _NATIVE_DIR / "frame_enc.c",
         _NATIVE_DIR / "mvp.c", _NATIVE_DIR / "rdoq.c"]
_SO = Path(__file__).resolve().parents[2] / "build" / "torch_native" / "_ecenc.so"

_lib = None
_lib_failed = False

_I32P = ctypes.POINTER(ctypes.c_int32)


def _build() -> None:
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = ["gcc", "-O3", "-march=native", "-shared", "-fPIC",
           *[str(s) for s in _SRCS], "-o", str(tmp), "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not _SO.exists() or any(_SO.stat().st_mtime < s.stat().st_mtime
                                   for s in _SRCS):
            _build()
        lib = ctypes.CDLL(str(_SO))
        lib.svt_ec_create.restype = ctypes.c_void_p
        lib.svt_ec_free.argtypes = [ctypes.c_void_p]
        lib.svt_ec_symbol.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
        lib.svt_ec_literal.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_int]
        lib.svt_ec_done.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
        lib.svt_ec_done.restype = ctypes.c_int64
        lib.svt_ec_coeffs.argtypes = [ctypes.c_void_p] + [_I32P] * 3 + [
            ctypes.c_int, _I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ] + [_I32P] * 8 + [ctypes.c_int, ctypes.c_int]
        lib.svt_ec_coeffs.restype = ctypes.c_int64
        lib.svt_ec_txb.argtypes = ([ctypes.c_void_p] * 3 +
            [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9 +
            [ctypes.c_int, ctypes.c_int])
        lib.svt_ec_txb.restype = ctypes.c_int64
        lib.svt_txb_skip_ctx.restype = ctypes.c_int32
        lib.svt_txb_skip_ctx.argtypes = ([ctypes.c_void_p] * 2 +
                                         [ctypes.c_int] * 5)
        # pointers passed as raw addresses (array lifetimes owned by the
        # caller's cache) to avoid per-call ctypes cast overhead
        lib.svt_net_run.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3)
        _lib = lib
    except Exception:
        _lib_failed = True
    return _lib


def _ptr(arr: np.ndarray):
    return ctypes.cast(arr.ctypes.data, _I32P)


class NativeEntropyEncoder:
    """Drop-in for bitstream.ec.EntropyEncoder backed by native/ecenc.c."""

    def __init__(self) -> None:
        self._lib = get_lib()
        self._h = self._lib.svt_ec_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.svt_ec_free(self._h)
            self._h = None

    # EntropyEncoder-compatible surface -----------------------------------
    def encode_symbol(self, symbol: int, cdf: np.ndarray) -> None:
        cdf = np.ascontiguousarray(cdf, np.int32)
        self._lib.svt_ec_symbol(self._h, _ptr(cdf), None, len(cdf),
                                int(symbol), 0)

    def encode_bool(self, bit: int, p_cdf: np.ndarray) -> None:
        self.encode_symbol(int(bit), p_cdf)

    def encode_literal(self, value: int, n: int) -> None:
        self._lib.svt_ec_literal(self._h, int(value), int(n))

    def symbol_adapt(self, symbol: int, values_row: np.ndarray,
                     counter_row: np.ndarray, n: int, adapt: bool) -> None:
        self._lib.svt_ec_symbol(self._h, _ptr(values_row), _ptr(counter_row),
                                n, int(symbol), 1 if adapt else 0)

    def symbol_ptr(self, symbol: int, vptr: int, cptr: int, n: int,
                   adapt: bool) -> None:
        """Raw-address variant for callers that cache row pointers."""
        self._lib.svt_ec_symbol(self._h, vptr, cptr, n, int(symbol),
                                1 if adapt else 0)

    def txb(self, flat, scan, eob, cw, ch, tx_class, nz_off,
            base, base_cnt, beob, beob_cnt, br, br_cnt, dcs, dcs_cnt,
            dc_sign_ctx, adapt) -> int:
        """Whole-txb emission: levels + nz contexts + all coefficient
        symbols in one C call (native/ecenc.c svt_ec_txb)."""
        return int(self._lib.svt_ec_txb(
            self._h, _ptr(flat), _ptr(scan), int(eob), int(cw), int(ch),
            int(tx_class), _ptr(nz_off),
            _ptr(base), _ptr(base_cnt), _ptr(beob), _ptr(beob_cnt),
            _ptr(br), _ptr(br_cnt), _ptr(dcs), _ptr(dcs_cnt),
            int(dc_sign_ctx), 1 if adapt else 0))

    def coeffs(self, scan, flat, coeff_ctx, eob, levels, bwl, tx_class,
               base, base_cnt, beob, beob_cnt, br, br_cnt, dcs, dcs_cnt,
               dc_sign_ctx, adapt) -> int:
        return int(self._lib.svt_ec_coeffs(
            self._h, _ptr(scan), _ptr(flat), _ptr(coeff_ctx), int(eob),
            _ptr(levels), levels.shape[1], int(bwl), int(tx_class),
            _ptr(base), _ptr(base_cnt), _ptr(beob), _ptr(beob_cnt),
            _ptr(br), _ptr(br_cnt), _ptr(dcs), _ptr(dcs_cnt),
            int(dc_sign_ctx), 1 if adapt else 0))

    def done(self) -> bytes:
        cap = 1 << 16
        while True:
            out = (ctypes.c_uint8 * cap)()
            n = self._lib.svt_ec_done(self._h, out, cap)
            if n >= 0:
                return bytes(out[:n])
            cap = -n


def make_entropy_encoder():
    """Native if buildable (and not overridden), else pure Python."""
    if os.environ.get("SVT_TPU_PY_EC") != "1" and get_lib() is not None:
        return NativeEntropyEncoder()
    from ..bitstream.ec import EntropyEncoder

    return EntropyEncoder()
