"""The benchmark's frozen roofline arithmetic equals the port's at the
kernel shapes of PERF.md's kernel table."""

import pytest

from benchmark.harness import roofline as frozen
from svt_av1_psyex_tpu_torch.ops.cuda import roofline as port

FULLLOOP = [(228480, 32, False), (913920, 16, False), (3655680, 8, False),
            (913920, 4, False), (26880, 32, False), (3840, 16, True),
            (57120, 32, False), (240, 32, True), (960, 16, True)]


@pytest.mark.parametrize("b,n,inv", FULLLOOP)
def test_fullloop_bound(b, n, inv):
    assert frozen.fullloop_bound(b, n, inv) == port.fullloop_bound(b, n, inv)


@pytest.mark.parametrize("nsb", [240, 510, 60, 4])
def test_sad_bound(nsb):
    assert frozen.sad_bound(nsb) == port.sad_bound(nsb)


def test_table_values():
    """PERF.md's bounds: 0.8953 ms (n=32, 1080p x 16, FMA) and 0.0340 ms
    (sad, 720p, int32 operations)."""
    b = frozen.fullloop_bound(228480, 32)
    assert round(b["bound_ms"], 4) == 0.8953 and b["bound_by"] == "operations"
    s = frozen.sad_bound(240)
    assert round(s["bound_ms"], 4) == 0.0340 and s["bound_by"] == "operations"
