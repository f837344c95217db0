"""The reader of `ec.native_sb_share` (benchmark/metrics/) on hand-made
records: the share of superblocks the C writer coded, 0 where it coded
none, and None on a clock that does not count superblocks."""

import pytest

from benchmark.harness.manifest import metric_reader


def _record(stages):
    return {"frames": 4, "window_s": 50.0, "stages": stages,
            "launches": {"fullloop": [], "sad": []}, "kernel_s": {},
            "busy_s": None}


@pytest.mark.parametrize("stages, share", [
    ({"ec": 1.0, "n.ec_sbs": 240, "n.ec_sbs_native": 240}, 100.0),
    ({"ec": 1.0, "n.ec_sbs": 240, "n.ec_sbs_native": 60}, 25.0),
    ({"ec": 1.0, "n.ec_sbs": 240}, 0.0),
    ({"ec": 1.0, "n.ec_symbols": 3_000_000, "n.ec_calls": 400_000}, None),
    ({}, None),
])
def test_share_of_superblocks_the_c_writer_coded(stages, share):
    got = metric_reader("ec.native_sb_share")(_record(stages))
    assert got == (None if share is None else pytest.approx(share))
