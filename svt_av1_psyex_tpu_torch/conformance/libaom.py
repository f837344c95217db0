"""Second-opinion conformance probe: validate IVF streams with libaom.

Counterpart of svt_av1_psyex_tpu/conformance/libaom.py. The system
libaom (libaom.so.3) carries the reference AV1 decoder, which enforces
bitstream requirements dav1d tolerates: an entropy termination that was
not od_ec-shaped decoded bit-exactly in dav1d while libaom flagged every
tile. This wrapper only VALIDATES (no pixel extraction; dav1d remains
the recon oracle); use it as the strict second gate.

ABI note: the decoder config struct is declared by hand, so no aom
headers are needed, and the ABI version is probed (init returns
AOM_CODEC_ABI_MISMATCH until the right version is passed).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

_LIB_PATHS = ("libaom.so.3",)

_lib = None
_failed = False


class _DecCfg(ctypes.Structure):
    _fields_ = [("threads", ctypes.c_uint), ("w", ctypes.c_uint),
                ("h", ctypes.c_uint), ("allow_lowbitdepth", ctypes.c_uint)]


def _get_lib():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(p)
            lib.aom_codec_av1_dx.restype = ctypes.c_void_p
            lib.aom_codec_error.restype = ctypes.c_char_p
            lib.aom_codec_error_detail.restype = ctypes.c_char_p
            _lib = lib
            return _lib
        except OSError:
            continue
    _failed = True
    return None


def available() -> bool:
    return _get_lib() is not None


def validate_ivf(ivf_path: str | Path) -> None:
    """Decode-validate every TU with libaom; raises RuntimeError with
    the TU index and aom's error detail on the first corrupt frame."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("libaom unavailable")
    iface = lib.aom_codec_av1_dx()
    ctx = ctypes.create_string_buffer(512)
    cfg = _DecCfg(1, 0, 0, 1)
    rc = -1
    for ver in range(0, 64):
        rc = lib.aom_codec_dec_init_ver(ctx, ctypes.c_void_p(iface),
                                        ctypes.byref(cfg), 0, ver)
        if rc == 0:
            break
    if rc != 0:
        raise RuntimeError("aom_codec_dec_init: no compatible ABI version")
    data = Path(ivf_path).read_bytes()
    if len(data) < 32 or data[:4] != b"DKIF":
        raise RuntimeError("not an IVF file")
    off = 32
    i = 0
    try:
        while off + 12 <= len(data):
            sz = struct.unpack("<I", data[off:off + 4])[0]
            off += 12
            tu = data[off:off + sz]
            off += sz
            if lib.aom_codec_decode(ctx, tu, len(tu), None) != 0:
                err = lib.aom_codec_error(ctx) or b""
                det = lib.aom_codec_error_detail(ctx) or b""
                raise RuntimeError(
                    f"libaom rejects TU {i}: {err.decode()} "
                    f"({det.decode()})")
            i += 1
    finally:
        lib.aom_codec_destroy(ctx)
