"""Y4M (YUV4MPEG2) reader/writer.

Counterpart: Source/App/app_input_y4m.c in the reference. Supports 420/422/
444 chroma, 8/10/12-bit (Cxxxp10 style tags), as planar numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import BinaryIO, Iterator

import numpy as np


@dataclass
class VideoFormat:
    width: int
    height: int
    bit_depth: int = 8
    subsampling: str = "420"  # "420" | "422" | "444" | "400"
    fps: Fraction = Fraction(30, 1)

    @property
    def ss_x(self) -> int:
        return 1 if self.subsampling in ("420", "422") else 0

    @property
    def ss_y(self) -> int:
        return 1 if self.subsampling == "420" else 0

    @property
    def chroma_size(self) -> tuple[int, int]:
        return (
            (self.height + self.ss_y) >> self.ss_y,
            (self.width + self.ss_x) >> self.ss_x,
        )

    @property
    def dtype(self):
        return np.uint8 if self.bit_depth == 8 else np.uint16


def _parse_colorspace(tag: str) -> tuple[str, int]:
    tag = tag.upper()
    if tag.startswith("C420"):
        ss = "420"
    elif tag.startswith("C422"):
        ss = "422"
    elif tag.startswith("C444"):
        ss = "444"
    elif tag.startswith("CMONO"):
        ss = "400"
    else:
        raise ValueError(f"unsupported colorspace {tag}")
    depth = 8
    if "P10" in tag:
        depth = 10
    elif "P12" in tag:
        depth = 12
    return ss, depth


class Y4MReader:
    def __init__(self, fh: BinaryIO):
        self.fh = fh
        header = bytearray()
        while not header.endswith(b"\n"):
            b = fh.read(1)
            if not b:
                raise ValueError("truncated y4m header")
            header += b
        parts = header.decode().strip().split(" ")
        if parts[0] != "YUV4MPEG2":
            raise ValueError("not a y4m file")
        w = h = None
        fps = Fraction(30, 1)
        ss, depth = "420", 8
        for p in parts[1:]:
            if p.startswith("W"):
                w = int(p[1:])
            elif p.startswith("H"):
                h = int(p[1:])
            elif p.startswith("F"):
                num, den = p[1:].split(":")
                fps = Fraction(int(num), int(den))
            elif p.startswith("C"):
                ss, depth = _parse_colorspace(p)
        assert w and h, "missing dimensions"
        self.fmt = VideoFormat(w, h, depth, ss, fps)

    def frames(self) -> Iterator[list[np.ndarray]]:
        fmt = self.fmt
        bpp = 1 if fmt.bit_depth == 8 else 2
        ch, cw = fmt.chroma_size
        y_sz = fmt.width * fmt.height * bpp
        c_sz = cw * ch * bpp
        while True:
            line = bytearray()
            b = self.fh.read(1)
            if not b:
                return
            while b != b"\n":
                line += b
                b = self.fh.read(1)
                if not b:
                    return
            if not line.startswith(b"FRAME"):
                raise ValueError(f"bad frame marker {bytes(line)!r}")
            y = np.frombuffer(self.fh.read(y_sz), fmt.dtype).reshape(fmt.height, fmt.width)
            if fmt.subsampling == "400":
                yield [y]
                continue
            u = np.frombuffer(self.fh.read(c_sz), fmt.dtype).reshape(ch, cw)
            v = np.frombuffer(self.fh.read(c_sz), fmt.dtype).reshape(ch, cw)
            yield [y, u, v]


class Y4MWriter:
    def __init__(self, fh: BinaryIO, fmt: VideoFormat):
        self.fh = fh
        self.fmt = fmt
        ctag = {"420": "C420jpeg", "422": "C422", "444": "C444", "400": "Cmono"}[fmt.subsampling]
        if fmt.bit_depth > 8:
            ctag = f"C{fmt.subsampling}p{fmt.bit_depth}"
        fh.write(
            f"YUV4MPEG2 W{fmt.width} H{fmt.height} "
            f"F{fmt.fps.numerator}:{fmt.fps.denominator} Ip A1:1 {ctag}\n".encode()
        )

    def write_frame(self, planes: list[np.ndarray]) -> None:
        self.fh.write(b"FRAME\n")
        for p in planes:
            self.fh.write(np.ascontiguousarray(p, dtype=self.fmt.dtype).tobytes())
