"""Clip and stream I/O for programs that drive the port.

The clip format (y4m VideoFormat), the IVF container and the dav1d
conformance decoder (utils/, conformance/) are re-exported here, beside
the conformance check every port encode shares: decode the stream with
dav1d and hold each frame against the encoder's reconstruction.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .conformance.dav1d import decode_ivf
from .utils.ivf import IvfWriter
from .utils.y4m import VideoFormat

__all__ = ["IvfWriter", "VideoFormat", "decode_ivf", "dav1d_loads",
           "write_ivf", "dav1d_mismatches", "dav1d_residue"]


def dav1d_loads() -> bool:
    """Whether libdav1d.so.6, which the conformance shim links, loads."""
    try:
        ctypes.CDLL("libdav1d.so.6")
    except OSError:
        return False
    return True


def write_ivf(path: Path, tus: list, width: int, height: int) -> Path:
    """Write one TU per frame into an IVF file at `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        wr = IvfWriter(fh, width, height)
        for t, tu in enumerate(tus):
            wr.write_frame(tu, t)
        wr.close()
    return path


def dav1d_residue(path: Path, tus: list, recons: list, width: int,
                  height: int) -> dict[int, tuple[int, int]]:
    """Decode `tus` with dav1d (via an IVF at `path`) and hold each frame
    against `recons` (per frame, the encoder's planes, cropped to the
    decoded size). Returns {frame index: (samples that differ over all
    planes, largest |difference|)} for the frames that differ. Raises if
    dav1d outputs another number of frames."""
    dec = decode_ivf(write_ivf(path, tus, width, height))
    if len(dec) != len(recons):
        raise RuntimeError(f"dav1d decoded {len(dec)} frames, the encoder "
                           f"made {len(recons)}")
    out = {}
    for i, (d, r) in enumerate(zip(dec, recons)):
        diffs = [np.abs(dp.astype(np.int32)
                        - rp[: dp.shape[0], : dp.shape[1]].astype(np.int32))
                 for dp, rp in zip(d, r)]
        n = sum(int(np.count_nonzero(x)) for x in diffs)
        if n:
            out[i] = (n, max(int(x.max()) for x in diffs))
    return out


def dav1d_mismatches(path: Path, tus: list, recons: list, width: int,
                     height: int) -> list[int]:
    """The indices of the frames whose dav1d output differs from
    `recons` (see dav1d_residue)."""
    return sorted(dav1d_residue(path, tus, recons, width, height))
