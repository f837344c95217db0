"""The benchmark's OBU reader on a stream of the port's encoder, and the
stream check on a broken one."""

import pytest

from benchmark.harness import check, obu


@pytest.fixture(scope="module")
def stream():
    """TUs of a 10-bit 128x64 encode through the port's API on the CPU."""
    from benchmark.harness.frames import FrameSource
    from benchmark.harness.program import make_encoder

    api = make_encoder({"source_width": 128, "source_height": 64,
                        "encoder_bit_depth": 10, "enc_mode": 8, "crf": 30},
                       "cpu")
    src = FrameSource("blobs", 128, 64, 10, 1, "cpu", span=6)
    for t in range(6):
        api.send_picture(src.frame(t), t)
    api.send_picture(None)
    tus = []
    while (p := api.get_packet()) is not None:
        if not p.is_eos:
            tus.append((p.pts, p.data))
    return tus


def test_sequence_header_and_frames(stream):
    first = obu.parse_tu(stream[0][1], None)
    seq = first.sequence
    assert (seq.width, seq.height, seq.bit_depth) == (128, 64, 10)
    assert (seq.subsampling_x, seq.subsampling_y, seq.mono_chrome) == \
        (1, 1, False)
    assert first.frames[0].frame_type == obu.KEY_FRAME
    coded = shown = 0
    for _, data in stream:
        info = obu.parse_tu(data, seq)
        coded += info.coded
        shown += info.shown
    assert coded == 6 and shown == 6
    assert check.stream_faults([stream], 128, 64, 10) == (0, [])


def test_stream_faults_found(stream):
    n, _ = check.stream_faults([stream], 128, 64, 8)     # wrong depth
    assert n == 1
    seq = obu.parse_tu(stream[0][1], None).sequence
    i = next(i for i, (_, d) in enumerate(stream)
             if i and obu.parse_tu(d, seq).shown)
    n, _ = check.stream_faults([stream[:i] + stream[i + 1:]], 128, 64, 10)
    assert n >= 1                                 # a shown frame dropped
    pts, data = stream[1]
    bad = bytearray(data)
    bad[2] = 0xFF                                         # a broken OBU size
    n, what = check.stream_faults([[stream[0], (pts, bytes(bad)),
                                    *stream[2:]]], 128, 64, 10)
    assert n >= 1 and what


def test_leb128_and_bits():
    assert obu.leb128(bytes([0x80 | 5, 1]), 0) == (133, 2)
    b = obu.Bits(bytes([0b10110000]))
    assert (b.f(1), b.f(2), b.f(1)) == (1, 1, 1)
    with pytest.raises(obu.StreamError):
        obu.split_obus(bytes([0x80]))
