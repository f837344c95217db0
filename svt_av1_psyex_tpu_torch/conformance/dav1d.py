"""Python harness around the dav1d conformance shim.

The gold-standard oracle: encode -> decode with the *real* dav1d ->
compare bit-exactly with the encoder's own reconstruction (same pattern as
the reference's e2e tests, test/e2e_test/SvtAv1E2EFramework.cc:97-309,
which use a vendored libaom decoder).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from pathlib import Path

import numpy as np

_SHIM_SRC = Path(__file__).parent.parent / "native" / "dav1d_shim.c"
# built at first use into build/torch_native/ at the repository root
_SHIM_SO = (Path(__file__).resolve().parents[2] / "build" / "torch_native"
            / "libdav1dshim.so")

_lib = None


def _build_shim() -> None:
    _SHIM_SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SHIM_SO.with_name(f"{_SHIM_SO.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["gcc", "-O2", "-shared", "-fPIC", str(_SHIM_SRC), "-o", str(tmp),
         "-l:libdav1d.so.6"],
        check=True,
    )
    os.replace(tmp, _SHIM_SO)


def _get_lib():
    global _lib
    if _lib is None:
        if not _SHIM_SO.exists():
            _build_shim()
        _lib = ctypes.CDLL(str(_SHIM_SO))
        _lib.shim_decode_ivf.restype = ctypes.c_int
        _lib.shim_decode_ivf.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
        _lib.shim_dav1d_version.restype = ctypes.c_char_p
    return _lib


def dav1d_version() -> str:
    return _get_lib().shim_dav1d_version().decode()


def decode_ivf(ivf_path: str | Path, raw_path: str | Path | None = None) -> list[list[np.ndarray]]:
    """Decode an IVF with dav1d; return per-frame plane lists."""
    ivf_path = Path(ivf_path)
    raw_path = Path(raw_path) if raw_path else ivf_path.with_suffix(".dav1d.raw")
    err = ctypes.create_string_buffer(256)
    n = _get_lib().shim_decode_ivf(
        str(ivf_path).encode(), str(raw_path).encode(), err, 256
    )
    if n < 0:
        raise RuntimeError(f"dav1d decode failed: {err.value.decode()}")
    return read_raw(raw_path)


def read_raw(path: str | Path) -> list[list[np.ndarray]]:
    frames = []
    data = Path(path).read_bytes()
    pos = 0
    while pos < len(data):
        magic, w, h, layout, bpc = struct.unpack_from("<5I", data, pos)
        assert magic == 0x46524D45, hex(magic)
        pos += 20
        nplanes = 1 if layout == 0 else 3
        dtype = np.uint16 if bpc > 8 else np.uint8
        planes = []
        for _ in range(nplanes):
            rows, cols = struct.unpack_from("<2I", data, pos)
            pos += 8
            nbytes = rows * cols * (2 if bpc > 8 else 1)
            planes.append(
                np.frombuffer(data, dtype, rows * cols, pos).reshape(rows, cols)
            )
            pos += nbytes
        frames.append(planes)
    return frames


def psnr(a: np.ndarray, b: np.ndarray, bit_depth: int = 8) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    peak = (1 << bit_depth) - 1
    return 10.0 * np.log10(peak * peak / mse)


def ssim(a: np.ndarray, b: np.ndarray, bit_depth: int = 8) -> float:
    """Global SSIM over 8x8 windows (the reference's aom_ssim2 shape:
    8x8 blocks stepped by 4, standard k1/k2 constants)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    peak = (1 << bit_depth) - 1
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    h, w = a.shape
    if h < 8 or w < 8:
        return 1.0

    def win_sums(x):
        c = x.cumsum(axis=0)
        v = np.vstack([c[7:8], c[8:] - c[:-8]])[::4]
        c = v.cumsum(axis=1)
        return np.hstack([c[:, 7:8], c[:, 8:] - c[:, :-8]])[:, ::4]

    n64 = 64.0
    sa, sb = win_sums(a), win_sums(b)
    saa, sbb, sab = win_sums(a * a), win_sums(b * b), win_sums(a * b)
    ma, mb = sa / n64, sb / n64
    va = saa / n64 - ma * ma
    vb = sbb / n64 - mb * mb
    cov = sab / n64 - ma * mb
    m = (((2 * ma * mb + c1) * (2 * cov + c2))
         / ((ma * ma + mb * mb + c1) * (va + vb + c2)))
    return float(m.mean())
