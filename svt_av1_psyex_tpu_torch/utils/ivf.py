"""IVF container writer/reader for AV1 streams.

Counterpart: Source/App/app_output_ivf.c (writer) in the reference; this is
a fresh implementation of the trivial 32-byte DKIF format.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator


@dataclass
class IvfWriter:
    fh: BinaryIO
    width: int
    height: int
    timebase_num: int = 1
    timebase_den: int = 30
    fourcc: bytes = b"AV01"
    _frame_count: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        self.fh.write(
            struct.pack(
                "<4sHH4sHHIII4x",
                b"DKIF",
                0,
                32,
                self.fourcc,
                self.width,
                self.height,
                self.timebase_den,
                self.timebase_num,
                0,  # frame count patched on close
            )
        )

    def write_frame(self, payload: bytes, pts: int) -> None:
        self.fh.write(struct.pack("<IQ", len(payload), pts))
        self.fh.write(payload)
        self._frame_count += 1

    def close(self) -> None:
        if self.fh.seekable():
            self.fh.seek(24)
            self.fh.write(struct.pack("<I", self._frame_count))
            self.fh.seek(0, 2)


def read_ivf(fh: BinaryIO) -> Iterator[tuple[int, bytes]]:
    """Yield (pts, payload) per temporal unit."""
    hdr = fh.read(32)
    magic, _ver, hdr_sz, fourcc, _w, _h = struct.unpack("<4sHH4sHH", hdr[:16])
    if magic != b"DKIF":
        raise ValueError("not an IVF file")
    fh.seek(hdr_sz)
    while True:
        fh_hdr = fh.read(12)
        if len(fh_hdr) < 12:
            return
        size, pts = struct.unpack("<IQ", fh_hdr)
        yield pts, fh.read(size)
