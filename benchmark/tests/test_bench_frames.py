"""The benchmark's synthetic frames: one seed gives one clip, seeds
differ, every kind stays in range."""

import numpy as np
import pytest

from benchmark.harness.frames import DEFAULTS, FrameSource

BIG = 2**31 + 12345          # seeds beyond 32 signed bits


def frames(kind, seed, n=3, bd=8, params=None):
    src = FrameSource(kind, 96, 64, bd, seed, "cpu", span=8, params=params)
    src.prepare(n)
    return [src.frame(t) for t in range(n)]


@pytest.mark.parametrize("kind", sorted(DEFAULTS))
def test_same_seed_same_frames(kind):
    a, b = frames(kind, BIG), frames(kind, BIG)
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            assert np.array_equal(pa, pb)


@pytest.mark.parametrize("kind", ["blobs", "texture", "noise"])
def test_seeds_differ(kind):
    a, b = frames(kind, BIG), frames(kind, BIG + 1)
    assert not np.array_equal(a[0][0], b[0][0])


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("kind", sorted(DEFAULTS))
def test_planes_in_range(kind, bd):
    for f in frames(kind, 5, bd=bd):
        y, u, v = f
        assert y.shape == (64, 96) and u.shape == v.shape == (32, 48)
        assert y.dtype == (np.uint8 if bd == 8 else np.uint16)
        assert int(y.max()) <= (1 << bd) - 1


def test_texture_translates_without_wrap():
    """Frame t + 1's texture is frame t's moved by (dx, dy) whole pixels,
    so the band-limited field moves continuously."""
    src = FrameSource("texture", 96, 64, 8, 9, "cpu", span=8,
                      params={"band": 0.0, "dx": 2.0, "dy": 1.0})
    t0 = src.device_planes(0, 1)[0][0]
    t1 = src.device_planes(1, 1)[0][0]
    assert np.array_equal(t1[:-1, :-2].numpy(), t0[1:, 2:].numpy())


def test_frame_outside_span_raises():
    src = FrameSource("flat", 96, 64, 8, 1, "cpu", span=2)
    with pytest.raises(IndexError):
        src.frame(2)
