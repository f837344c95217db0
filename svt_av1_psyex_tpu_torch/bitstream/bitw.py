"""Raw bit-level writer/reader for AV1 uncompressed syntax.

Implements the descriptor functions of the AV1 spec (section 4):
f(n), le(n), leb128(), uvlc(), su(n), ns(n).

Counterpart in the reference encoder: the WriteToBitstream helpers in
Source/Lib/Codec/bitstream_unit.c (aom_wb_write_bit family); this is a
clean-room reimplementation from the AV1 specification.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer (spec f(n) ordering)."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._bitpos = 0  # bits used in the last byte (0..7); 0 => aligned

    # ---- core -----------------------------------------------------------
    def f(self, value: int, n: int) -> None:
        """Write `value` as n bits, MSB first."""
        if n < 0 or (n < 64 and value >> n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        for i in range(n - 1, -1, -1):
            self._put_bit((value >> i) & 1)

    def _put_bit(self, bit: int) -> None:
        if self._bitpos == 0:
            self._bytes.append(0)
        self._bytes[-1] |= bit << (7 - self._bitpos)
        self._bitpos = (self._bitpos + 1) & 7

    # ---- derived descriptors ---------------------------------------------
    def su(self, value: int, n: int) -> None:
        """Signed integer: n-1 magnitude bits + sign handling per spec su(1+n)."""
        # spec su(n): value coded as n bits two's-complement-ish: f(n) of
        # value & mask. Decoder: v = f(n); if v >= 1<<(n-1): v -= 1<<n.
        self.f(value & ((1 << n) - 1), n)

    def ns(self, value: int, n: int) -> None:
        """Non-symmetric unsigned ns(n) per spec 4.10.7."""
        w = n.bit_length()  # FloorLog2(n) + 1
        m = (1 << w) - n
        if value < m:
            self.f(value, w - 1)
        else:
            extra = value - m
            self.f(m + (extra >> 1), w - 1)
            self.f(extra & 1, 1)

    def uvlc(self, value: int) -> None:
        """Unsigned variable-length code per spec 4.10.3."""
        v = value + 1
        leading = v.bit_length() - 1
        self.f(0, leading)
        self.f(v, leading + 1)

    def le(self, value: int, n_bytes: int) -> None:
        """Little-endian byte write (must be byte aligned)."""
        assert self._bitpos == 0, "le() requires byte alignment"
        self._bytes += int(value).to_bytes(n_bytes, "little")

    @staticmethod
    def leb128_bytes(value: int, fixed_size: int | None = None) -> bytes:
        """Encode leb128 (spec 4.10.5). fixed_size pads to that many bytes."""
        out = bytearray()
        v = value
        while True:
            byte = v & 0x7F
            v >>= 7
            more = v != 0
            if fixed_size is not None:
                more = len(out) + 1 < fixed_size
            out.append(byte | (0x80 if more else 0))
            if not more:
                break
        return bytes(out)

    def leb128(self, value: int) -> None:
        assert self._bitpos == 0
        self._bytes += self.leb128_bytes(value)

    # ---- alignment / trailing --------------------------------------------
    def byte_align(self) -> None:
        """Pad with zero bits to the next byte boundary (spec byte_alignment)."""
        while self._bitpos != 0:
            self._put_bit(0)

    def trailing_bits(self) -> None:
        """Spec 5.3.4: one 1 bit then zero bits to byte alignment."""
        self._put_bit(1)
        self.byte_align()

    # ---- output -----------------------------------------------------------
    @property
    def bit_count(self) -> int:
        return len(self._bytes) * 8 - ((8 - self._bitpos) & 7)

    def data(self) -> bytes:
        assert self._bitpos == 0, "unaligned bitstream; call byte_align()"
        return bytes(self._bytes)

    def data_unaligned(self) -> bytes:
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader mirroring BitWriter (test oracle / parser)."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self.pos = 0  # bit position

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        leading = 0
        while self.f(1) == 0:
            leading += 1
            if leading > 32:
                raise ValueError("uvlc too long")
        if leading == 0:
            return 0
        return (1 << leading) - 1 + self.f(leading)

    def le(self, n_bytes: int) -> int:
        assert self.pos % 8 == 0
        start = self.pos >> 3
        v = int.from_bytes(self._data[start : start + n_bytes], "little")
        self.pos += 8 * n_bytes
        return v

    def leb128(self) -> int:
        assert self.pos % 8 == 0
        v = 0
        for i in range(8):
            byte = self._data[self.pos >> 3]
            self.pos += 8
            v |= (byte & 0x7F) << (7 * i)
            if not (byte & 0x80):
                break
        return v

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def bits_left(self) -> int:
        return len(self._data) * 8 - self.pos
