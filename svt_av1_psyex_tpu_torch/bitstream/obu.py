"""OBU framing (AV1 spec 5.2/5.3).

Counterpart: OBU assembly in the reference's packetization process
(Source/Lib/Codec/packetization_process.c + entropy_coding.c
write_obu_header / write_uleb_obu_size); clean-room from spec.
"""

from __future__ import annotations

from enum import IntEnum

from .bitw import BitWriter


class ObuType(IntEnum):
    SEQUENCE_HEADER = 1
    TEMPORAL_DELIMITER = 2
    FRAME_HEADER = 3
    TILE_GROUP = 4
    METADATA = 5
    FRAME = 6
    REDUNDANT_FRAME_HEADER = 7
    TILE_LIST = 8
    PADDING = 15


def wrap_obu(obu_type: ObuType, payload: bytes, temporal_id: int = 0,
             spatial_id: int = 0) -> bytes:
    """obu_header (+ extension) + leb128 size + payload."""
    w = BitWriter()
    has_ext = temporal_id != 0 or spatial_id != 0
    w.f(0, 1)  # obu_forbidden_bit
    w.f(int(obu_type), 4)
    w.f(1 if has_ext else 0, 1)  # obu_extension_flag
    w.f(1, 1)  # obu_has_size_field
    w.f(0, 1)  # obu_reserved_1bit
    if has_ext:
        w.f(temporal_id, 3)
        w.f(spatial_id, 2)
        w.f(0, 3)
    return w.data() + BitWriter.leb128_bytes(len(payload)) + payload


def temporal_delimiter() -> bytes:
    return wrap_obu(ObuType.TEMPORAL_DELIMITER, b"")


def metadata_hdr_cll(max_cll: int, max_fall: int) -> bytes:
    """OBU_METADATA / METADATA_TYPE_HDR_CLL (spec 5.8.3)."""
    w = BitWriter()
    w.f(1, 8)  # metadata_type leb128 (< 128 => single byte)
    w.f(max_cll, 16)
    w.f(max_fall, 16)
    w.trailing_bits()
    return wrap_obu(ObuType.METADATA, w.data())


def metadata_hdr_mdcv(primaries, white_point, lum_max: float,
                      lum_min: float) -> bytes:
    """OBU_METADATA / METADATA_TYPE_HDR_MDCV (spec 5.8.4).

    primaries: [(rx, ry), (gx, gy), (bx, by)] chromaticities in 0..1
    coded in spec order R=0? — the spec stores them in the order
    G, B, R per CTA-861.3 convention used by the reference
    (metadata_handle.c:50-110); white_point likewise; luminances in
    cd/m^2 (24.8 and 18.14 fixed point).
    """
    w = BitWriter()
    w.f(2, 8)  # metadata_type
    for (x, y) in primaries:
        w.f(int(round(x * 50000)) & 0xFFFF, 16)
        w.f(int(round(y * 50000)) & 0xFFFF, 16)
    w.f(int(round(white_point[0] * 50000)) & 0xFFFF, 16)
    w.f(int(round(white_point[1] * 50000)) & 0xFFFF, 16)
    w.f(int(round(lum_max * 256)) & 0xFFFFFFFF, 32)
    w.f(int(round(lum_min * 16384)) & 0xFFFFFFFF, 32)
    w.trailing_bits()
    return wrap_obu(ObuType.METADATA, w.data())


def parse_mastering_display(s: str):
    """SVT --mastering-display string:
    G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min) -> (primaries GBR, wp, lmax, lmin)."""
    import re

    m = re.match(
        r"G\(([\d.]+),([\d.]+)\)B\(([\d.]+),([\d.]+)\)R\(([\d.]+),([\d.]+)\)"
        r"WP\(([\d.]+),([\d.]+)\)L\(([\d.]+),([\d.]+)\)", s.replace(" ", ""))
    if not m:
        raise ValueError(f"bad mastering-display string: {s!r}")
    v = [float(x) for x in m.groups()]
    return ([(v[0], v[1]), (v[2], v[3]), (v[4], v[5])], (v[6], v[7]),
            v[8], v[9])
