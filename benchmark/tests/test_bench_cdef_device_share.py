"""The reader of `filters.cdef_device_share` (benchmark/metrics/) on
hand-made records: the share of CDEF frames the CUDA kernel took, 0 where
it took none, and None on a clock that does not count CDEF frames."""

import pytest

from benchmark.harness.manifest import metric_reader


def _record(stages):
    return {"frames": 60, "window_s": 51.0, "stages": stages,
            "launches": {"fullloop": [], "sad": []}, "kernel_s": {},
            "busy_s": None}


@pytest.mark.parametrize("stages, share", [
    ({"cdef": 1.0, "n.cdef_frames": 60, "n.cdef_device": 60}, 100.0),
    ({"cdef": 1.0, "n.cdef_frames": 64, "n.cdef_device": 16}, 25.0),
    ({"cdef": 1.0, "n.cdef_frames": 60, "n.cdef_device": 0}, 0.0),
    ({"cdef": 15.9, "n.ec_sbs": 240, "n.ec_sbs_native": 240}, None),
    ({}, None),
])
def test_share_of_cdef_frames_the_kernel_took(stages, share):
    got = metric_reader("filters.cdef_device_share")(_record(stages))
    assert got == (None if share is None else pytest.approx(share))
