"""The port's TPL dispenser (svt_av1_psyex_tpu_torch/device/tpl.py and
codec/tpl.py) against the JAX package's on the same frames: 192x128, 5
frames, 8-bit and 10-bit.

The JAX side runs its jnp chain, as the JAX package's own tests run it
on the CPU; the port runs the plain version of each kernel. Motion
vectors and the inter/intra choice are integer decisions and must be
equal. dist and rate are float32 sums of the same transforms in another
summation order, so they agree to rtol 1e-5. The host model built on
them must then give the same per-frame qindex, with r0 equal to float
rounding (rtol 1e-6)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu.codec import tpl as jax_codec_tpl  # noqa: E402
from svt_av1_psyex_tpu.device import tpl as jax_tpl  # noqa: E402
from svt_av1_psyex_tpu_torch.codec import tpl as port_codec_tpl  # noqa: E402
from svt_av1_psyex_tpu_torch.device import tpl as port_tpl  # noqa: E402
from svt_av1_psyex_tpu_torch.device.intra import qp_row_for  # noqa: E402


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


H, W, F = 128, 192, 5
QINDEX = 120
RTOL = 1e-5


def pan_clip(f: int, h: int, w: int, bit_depth: int, step: int = 3,
             seed: int = 0) -> np.ndarray:
    """Smooth texture panning down `step` rows a frame, with a little
    noise, and a flat patch where intra wins: (f, h, w) int32."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 1 << bit_depth,
                       (h + f * step + 64, w + 64)).astype(np.int64)
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    frames = [np.clip(big[i * step: i * step + h, 5: 5 + w]
                      + rng.integers(-3, 4, (h, w)), 0,
                      (1 << bit_depth) - 1) for i in range(f)]
    out = np.stack(frames).astype(np.int32)
    out[:, :32, :48] = 90 << (bit_depth - 8)
    return out


@pytest.fixture(scope="module", params=[8, 10], ids=["8bit", "10bit"])
def stats(request):
    bd = request.param
    srcs = pan_clip(F, H, W, bd)
    qp = qp_row_for(QINDEX, 0, 0, bd)
    want = np.asarray(jax_tpl.tpl_group_stats(
        jnp.asarray(srcs), jnp.asarray(qp), bit_depth=bd))
    got = port_tpl.tpl_group_stats(torch.from_numpy(srcs), qp,
                                   bit_depth=bd)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    return bd, srcs, got.numpy(), want


def test_stats_shape_and_frame0(stats):
    _, _, got, want = stats
    assert got.shape == want.shape == (F, len(port_tpl.STAT_FIELDS),
                                       H // 16, W // 16)
    assert port_tpl.STAT_FIELDS == jax_tpl.STAT_FIELDS
    # frame 0 is intra-only: srcrf == recrf, no motion
    assert np.array_equal(got[0, 0], got[0, 1])
    assert not got[0, 4:].any()


@pytest.mark.parametrize("field", ["mv_y", "mv_x", "is_inter"])
def test_integer_stats_equal(stats, field):
    _, _, got, want = stats
    k = port_tpl.STAT_FIELDS.index(field)
    assert np.array_equal(got[:, k], want[:, k])
    if field == "is_inter":
        # the clip exercises both choices
        assert 0.5 < want[1:, k].mean() < 1.0


@pytest.mark.parametrize("field", ["srcrf_dist", "recrf_dist", "srcrf_rate",
                                   "recrf_rate"])
def test_float_stats_within_rtol(stats, field):
    _, _, got, want = stats
    k = port_tpl.STAT_FIELDS.index(field)
    assert np.allclose(got[:, k], want[:, k], rtol=RTOL, atol=0)
    # recrf >= srcrf, as the reference enforces
    if field.startswith("recrf"):
        assert (got[:, k] >= got[:, k - 1]).all()


def test_r0_and_qindex_ladder_equal(stats):
    """run_tpl's r0 per frame and the crf_qindex_calc q ladder on it."""
    bd, srcs, _, _ = stats
    lumas = list(srcs)
    want = jax_codec_tpl.run_tpl(lumas, QINDEX, bd)
    got = port_codec_tpl.run_tpl(lumas, QINDEX, bd, device="cpu")
    assert got.f == want.f == F
    for i in range(F):
        assert got.r0(i) == pytest.approx(want.r0(i), rel=1e-6), i
        kw = dict(is_intra=i == 0, layer=0, hl=2, leaf=False, adj=0.0,
                  tpl_group_size=F, bit_depth=bd)
        q_got = port_codec_tpl.crf_qindex_calc(QINDEX, r0=got.r0(i), **kw)
        q_want = jax_codec_tpl.crf_qindex_calc(QINDEX, r0=want.r0(i), **kw)
        assert q_got == q_want, i
    # the ladder is not flat: propagation lowers the early frames' q
    assert got.r0(0) < got.r0(F - 1)


def test_long_group_capped_as_reference():
    """Groups longer than 32 frames drop their tail lookahead, as the
    reference's largest bucket does."""
    srcs = list(pan_clip(34, 64, 64, 8, step=1, seed=4))
    want = jax_codec_tpl.run_tpl(srcs, QINDEX, 8)
    got = port_codec_tpl.run_tpl(srcs, QINDEX, 8, device="cpu")
    assert port_codec_tpl.TPL_MAX_FRAMES == 32
    assert got.f == want.f == 32
    assert np.array_equal(got.mv_y, want.mv_y)
    assert np.array_equal(got.is_inter, want.is_inter)
    for i in (0, 15, 31):
        assert got.r0(i) == pytest.approx(want.r0(i), rel=1e-6), i


def test_run_tpl_needs_a_device():
    with pytest.raises(ValueError):
        port_codec_tpl.run_tpl([np.zeros((64, 64), np.uint8)] * 2, QINDEX,
                               device=None)
