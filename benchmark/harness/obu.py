"""A small AV1 OBU reader, written from the AV1 specification (section 5)
and independent of the encoder under test.

It splits a temporal unit into OBUs, reads a sequence header whole
(5.5) and reads the first fields of each frame header (5.9.2:
show_existing_frame, frame_type, show_frame). That is enough to count
the frames a stream codes, to tell a coded frame from a show-existing
one, and to hold the stream's format and display order to what the
configuration states. It decodes no tile data.
"""

from __future__ import annotations

from dataclasses import dataclass

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_FRAME = 6

KEY_FRAME = 0


class StreamError(ValueError):
    pass


class Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise StreamError("read past the end of an OBU")
            v = (v << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uvlc(self) -> int:
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1


def leb128(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise StreamError("leb128 runs past the end of the TU")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    raise StreamError("leb128 longer than 8 bytes")


def split_obus(tu: bytes) -> list[tuple[int, bytes]]:
    """[(obu_type, payload)] of a temporal unit of sized OBUs."""
    out, pos = [], 0
    while pos < len(tu):
        h = tu[pos]
        if h & 0x80:
            raise StreamError("forbidden bit set in an OBU header")
        typ, ext, has_size = (h >> 3) & 0xF, (h >> 2) & 1, (h >> 1) & 1
        pos += 1 + ext
        if not has_size:
            raise StreamError("OBU without a size field")
        size, pos = leb128(tu, pos)
        if pos + size > len(tu):
            raise StreamError("OBU runs past the end of the TU")
        out.append((typ, tu[pos: pos + size]))
        pos += size
    return out


@dataclass
class SequenceHeader:
    profile: int
    width: int
    height: int
    bit_depth: int
    mono_chrome: bool
    subsampling_x: int
    subsampling_y: int
    reduced_still_picture_header: bool


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    b = Bits(payload)
    profile = b.f(3)
    b.f(1)                                   # still_picture
    reduced = bool(b.f(1))
    decoder_model = False
    buffer_delay_len = 0
    if reduced:
        b.f(5)                               # seq_level_idx[0]
    else:
        timing = b.f(1)
        if timing:
            b.f(32)
            b.f(32)                          # num_units, time_scale
            if b.f(1):                       # equal_picture_interval
                b.uvlc()
            decoder_model = bool(b.f(1))
            if decoder_model:
                buffer_delay_len = b.f(5) + 1
                b.f(32)                      # num_units_in_decoding_tick
                b.f(5)
                b.f(5)
        initial_delay = b.f(1)
        for _ in range(b.f(5) + 1):          # operating points
            b.f(12)
            level = b.f(5)
            if level > 7:
                b.f(1)
            if decoder_model:
                if b.f(1):
                    b.f(buffer_delay_len)
                    b.f(buffer_delay_len)
                    b.f(1)
            if initial_delay and b.f(1):
                b.f(4)
    wbits, hbits = b.f(4) + 1, b.f(4) + 1
    width, height = b.f(wbits) + 1, b.f(hbits) + 1
    if not reduced and b.f(1):               # frame_id_numbers_present
        b.f(4)
        b.f(3)
    b.f(3)                # 128x128 superblock, filter intra, intra edge
    if not reduced:
        b.f(4)            # interintra, masked compound, warped, dual filter
        order_hint = bool(b.f(1))
        if order_hint:
            b.f(2)        # jnt_comp, ref_frame_mvs
        if b.f(1):        # seq_choose_screen_content_tools
            sct = 2
        else:
            sct = b.f(1)
        if sct > 0 and not b.f(1):           # seq_choose_integer_mv
            b.f(1)
        if order_hint:
            b.f(3)
    b.f(3)                # superres, cdef, restoration
    high = b.f(1)
    bit_depth = 8
    if profile == 2 and high:
        bit_depth = 12 if b.f(1) else 10
    elif high:
        bit_depth = 10
    mono = bool(b.f(1)) if profile != 1 else False
    cp = tc = mc = 2
    if b.f(1):
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    if mono:
        b.f(1)
        ssx = ssy = 1
    elif cp == 1 and tc == 13 and mc == 0:
        ssx = ssy = 0
    else:
        b.f(1)                               # color_range
        if profile == 0:
            ssx = ssy = 1
        elif profile == 1:
            ssx = ssy = 0
        elif bit_depth == 12:
            ssx = b.f(1)
            ssy = b.f(1) if ssx else 0
        else:
            ssx, ssy = 1, 0
        if ssx and ssy:
            b.f(2)
    return SequenceHeader(profile, width, height, bit_depth, mono, ssx, ssy,
                          reduced)


@dataclass
class FrameInfo:
    show_existing_frame: bool
    frame_type: int | None     # None for a show-existing frame
    show_frame: bool


def parse_frame_start(payload: bytes, seq: SequenceHeader) -> FrameInfo:
    """The first fields of an uncompressed frame header."""
    b = Bits(payload)
    if seq.reduced_still_picture_header:
        return FrameInfo(False, KEY_FRAME, True)
    if b.f(1):
        return FrameInfo(True, None, True)
    return FrameInfo(False, b.f(2), bool(b.f(1)))


@dataclass
class TUInfo:
    """One temporal unit: its sequence header (if it carries one) and the
    frame headers it holds, in order."""
    sequence: SequenceHeader | None
    frames: list[FrameInfo]

    @property
    def coded(self) -> int:
        """Frames this TU codes (not show-existing)."""
        return sum(not f.show_existing_frame for f in self.frames)

    @property
    def shown(self) -> int:
        return sum(f.show_frame for f in self.frames)


def parse_tu(tu: bytes, seq: SequenceHeader | None) -> TUInfo:
    """Parse one TU; `seq` is the sequence header in force (the TU's own
    replaces it)."""
    obus = split_obus(tu)
    if not obus or obus[0][0] != OBU_TEMPORAL_DELIMITER:
        raise StreamError("a TU must start with a temporal delimiter")
    own, frames = None, []
    for typ, payload in obus:
        if typ == OBU_SEQUENCE_HEADER:
            own = seq = parse_sequence_header(payload)
        elif typ in (OBU_FRAME, OBU_FRAME_HEADER):
            if seq is None:
                raise StreamError("frame header before any sequence header")
            frames.append(parse_frame_start(payload, seq))
    return TUInfo(own, frames)
