"""The window rule and the end-to-end arithmetic on a made-up timeline."""

import numpy as np
import pytest

from benchmark.harness.window import TU, Timeline, mse_y8


def timeline(seconds=10.0, quality=3):
    tl = Timeline(seconds, quality)
    # (t, pts, bytes, coded): KF, hidden ARF, frame 8, show-existing 16...
    events = [(2.0, 0, 1000, 1), (5.0, 16, 500, 1), (7.0, 8, 250, 1),
              (9.5, 4, 125, 1), (9.6, 4, 3, 0), (11.0, 2, 100, 1),
              (12.0, 1, 90, 1)]
    closed = []
    for t, pts, n, coded in events:
        closed.append(tl.add(TU(t, pts, n, coded, 1)))
        if coded and tl.wants_quality():
            tl.add_quality(pts, n, None)
    return tl, closed


def test_window_closes_at_first_coded_tu_past_seconds():
    tl, closed = timeline()
    # 9.6 s is a show-existing TU: it codes nothing and cannot close
    assert closed == [False] * 5 + [True, False]
    assert tl.close == 5 and tl.window_s == 11.0
    assert tl.frames == 5                # the show-existing TU counts 0
    assert tl.fps() == pytest.approx(5 / 11.0)
    assert tl.first_packet_s() == 2.0


def test_quality_frames_are_the_first_coded():
    tl, _ = timeline(quality=3)
    assert [p for p, _, _ in tl.quality] == [0, 16, 8]
    assert tl.kbit_per_frame() == pytest.approx((1000 + 500 + 250) * 8
                                                / 1000 / 3)
    assert tl.done


def test_quality_past_the_window_keeps_the_run_going():
    tl, _ = timeline(seconds=1.0, quality=6)
    assert tl.close == 0 and tl.frames == 1
    assert len(tl.quality) == 6 and tl.done


def test_mse_scaled_to_8_bit_levels():
    src = np.zeros((4, 4), np.uint16)
    rec = np.full((4, 4), 4, np.uint16)
    assert mse_y8(rec, src, 8) == 16.0
    assert mse_y8(rec, src, 10) == 1.0
    tl = Timeline(1.0, 2)
    tl.add_quality(0, 10, rec)
    tl.add_quality(1, 10, src)
    tl.measure_quality(lambda p: src, 10)
    assert tl.mse == [1.0, 0.0] and tl.mse_y8() == 0.5
    assert tl.quality[0][2] is None      # the recons are dropped
