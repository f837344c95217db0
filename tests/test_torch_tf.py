"""The port's temporal filter (svt_av1_psyex_tpu_torch/device/tf.py and
codec/tf.py) against the JAX package's device filter on the same frames:
200x120 (not a multiple of 16), 3 and 6 neighbours, strength 1 and 3,
8-bit and 10-bit.

The filtered ARF is the coded source, so one weight off by one changes
pixels and then the stream: the filtered planes must be equal. The JAX
side runs its jitted device program on the CPU, as the JAX package's
own tests run it."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu.codec import tf as jax_codec_tf  # noqa: E402
from svt_av1_psyex_tpu.device import tf as jax_tf  # noqa: E402
from svt_av1_psyex_tpu_torch.codec import tf as port_codec_tf  # noqa: E402
from svt_av1_psyex_tpu_torch.device import tf as port_tf  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: test files run
    in parallel worker processes, and torch's OpenMP pool in each of them
    would oversubscribe the cores (the many small ops here then run
    several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 200, 120
QINDEX = 120


def clip(n: int, bit_depth: int, w: int = W, h: int = H, seed: int = 3):
    """n frames of a smooth texture moving a few pixels a frame, with
    noise: [Y, U, V] per frame, uint8 or uint16. The chroma planes move
    with the luma (U) and flicker on their own (V)."""
    rng = np.random.default_rng(seed)
    sc = 1 << (bit_depth - 8)
    big = rng.integers(0, 256, (h + 40, w + 40)).astype(np.int64)
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    big = (big - 128) * 3 + 128
    dt = np.uint8 if bit_depth == 8 else np.uint16
    frames = []
    for t in range(n):
        dy, dx = 20 + t % 3 - 1, 20 + 2 * t - n
        y = big[dy: dy + h, dx: dx + w] * sc + rng.normal(0, 6 * sc, (h, w))
        u = (big[dy: dy + h: 2, dx + 1: dx + 1 + w: 2] * sc // 2 + 60 * sc
             + rng.normal(0, 3 * sc, (h // 2, w // 2)))
        v = (100 + 5 * t) * sc + rng.normal(0, 4 * sc, (h // 2, w // 2))
        frames.append([np.clip(a, 0, (1 << bit_depth) - 1).astype(dt)
                       for a in (y, u, v)])
    return frames


@pytest.mark.parametrize("bit_depth", [8, 10], ids=["8bit", "10bit"])
@pytest.mark.parametrize("strength", [1, 3])
@pytest.mark.parametrize("nbrs", [3, 6])
def test_filtered_planes_equal(nbrs, strength, bit_depth):
    frames = clip(nbrs + 1, bit_depth)
    want = jax_codec_tf._temporal_filter_device(
        frames[0], frames[1:], QINDEX, bit_depth, strength)
    got = port_codec_tf.temporal_filter(frames[0], frames[1:], QINDEX,
                                        bit_depth, strength, device="cpu")
    assert len(got) == 3
    for p, (g, w, src) in enumerate(zip(got, want, frames[0])):
        assert g.dtype == src.dtype and g.shape == src.shape, p
        assert np.array_equal(g, w), p
        # the filter did something on every plane
        assert (g != src).mean() > 0.1, p


@pytest.mark.parametrize("bit_depth", [8, 10], ids=["8bit", "10bit"])
def test_block_search_and_weights_equal(bit_depth):
    """The batched block search gives the JAX package's per-neighbour
    offsets and SSEs, and the block weights span the exp curve (neither
    all 1024 nor all 0)."""
    frames = clip(5, bit_depth, w=208, h=128)
    maxpix = (1 << bit_depth) - 1
    cy = frames[0][0].astype(np.int32)
    ny = np.stack([f[0] for f in frames[1:]]).astype(np.int32)
    want = jax.vmap(lambda r: jax_tf._block_search(
        jnp.asarray(cy), r, maxpix))(jnp.asarray(ny))
    got = port_tf._block_search(torch.from_numpy(cy), torch.from_numpy(ny),
                                maxpix)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    decay = np.float32(jax_codec_tf._decay_px(frames[0][0], QINDEX,
                                              bit_depth, 3))
    wgt = port_tf._weight(got[2].to(torch.float32) / 256,
                          torch.tensor(decay)).numpy()
    assert len(np.unique(wgt)) > 20
    assert 0 <= wgt.min() and wgt.max() <= port_tf.WEIGHT_SCALE
    assert np.array_equal(port_tf._offsets(), jax_tf._offsets())


def test_no_neighbours_returns_center():
    frames = clip(1, 8)
    assert port_codec_tf.temporal_filter(frames[0], [], QINDEX,
                                         device="cpu") is frames[0]


def test_denoises():
    """As the JAX package's test_temporal_filter_denoises: a static noisy
    gradient filtered with three neighbours moves toward the clean
    signal."""
    rng = np.random.RandomState(5)
    w, h = 64, 48
    base = np.add.outer(np.linspace(40, 200, h), np.linspace(0, 55, w))
    frames = []
    for _ in range(4):
        frames.append([
            np.clip(base + rng.normal(0, 8, (h, w)), 0, 255).astype(np.uint8),
            np.clip(120 + rng.normal(0, 4, (h // 2, w // 2)), 0,
                    255).astype(np.uint8),
            np.clip(130 + rng.normal(0, 4, (h // 2, w // 2)), 0,
                    255).astype(np.uint8)])
    out = port_codec_tf.temporal_filter(frames[0], frames[1:], QINDEX,
                                        device="cpu")
    before = np.mean((frames[0][0].astype(np.float64) - base) ** 2)
    after = np.mean((out[0].astype(np.float64) - base) ** 2)
    assert after < 0.7 * before, (before, after)
