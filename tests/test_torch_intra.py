"""The port's intra analysis lattice (svt_av1_psyex_tpu_torch/device/
intra.py) against the JAX package's device/intra.py on the same frames.

The JAX side runs as its own tests run it on the CPU: through the Pallas
fullloop kernel in interpret mode (SVT_TPU_PALLAS=1, as
tests/test_pallas.py does) and through its jnp chain. The lattice is
float: a coefficient on a quantization boundary may round to the other
level in another summation order, so the contract is the one
tests/test_pallas.py:131-135 holds the Pallas kernel to: modes agree on
>= 98% of the blocks of every depth, J within rtol 5e-3, atol 50."""

import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

from svt_av1_psyex_tpu.codec.md_device import DeviceIntraMD  # noqa: E402
from svt_av1_psyex_tpu.device import intra as jax_intra  # noqa: E402
from svt_av1_psyex_tpu_torch.device import intra as port_intra  # noqa: E402

DEPTHS = (64, 32, 16, 8)


def _ramp128():
    """tests/test_pallas.py's frame: a ramp with noise."""
    rng = np.random.RandomState(3)
    luma = np.add.outer(np.linspace(30, 220, 128),
                        np.linspace(0, 90, 128)).astype(np.int32)
    return np.clip(luma + rng.randint(-12, 13, luma.shape), 0,
                   255).astype(np.uint8)


def _blobs200x120():
    """tools/mkclip's "blobs" clip at 200x120, padded to 256x128 as the
    encoder pads it (DeviceIntraMD.pad_src)."""
    from mkclip import synth_frame

    from svt_av1_psyex_tpu.utils.y4m import VideoFormat

    y = synth_frame(VideoFormat(200, 120, fps=Fraction(30, 1)), 2)[0]
    return DeviceIntraMD.pad_src(y)


FRAMES = {"ramp128": _ramp128, "blobs200x120": _blobs200x120}


def _rows(qindex=140, psy=False, mode_rate=None):
    qp = jax_intra.qp_row_for(qindex, 0, 0, 8)
    if mode_rate is None:
        mode_rate = [300, 310, 320, 330, 340, 350, 360]
    rd = np.array([120, 100, 60] + list(mode_rate) + [77 if psy else 0],
                  np.int32)
    return qp, rd


def _jax(luma, qp, rd, psy, pallas, monkeypatch):
    monkeypatch.setenv("SVT_TPU_PALLAS", "1" if pallas else "0")
    jax.clear_caches()   # the env var is read while tracing
    packed = jax_intra.intra_analysis_batch(
        jnp.asarray(luma[None]), jnp.asarray(qp[None]),
        jnp.asarray(rd[None]), depths=DEPTHS, psy=psy)
    h, w = luma.shape
    return jax_intra.unpack_rd_analysis(np.asarray(packed[0]), h, w, DEPTHS)


def _port(luma, qp, rd, psy):
    packed = port_intra.intra_analysis_batch(
        torch.from_numpy(luma[None]), qp[None], rd[None], depths=DEPTHS,
        psy=psy)
    assert packed.dtype == torch.float32 and packed.device.type == "cpu"
    h, w = luma.shape
    return port_intra.unpack_rd_analysis(packed[0].numpy(), h, w, DEPTHS)


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas-interpret", "jnp"])
@pytest.mark.parametrize("psy", [False, True], ids=["psy-off", "psy-on"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_lattice_matches_jax(frame, psy, pallas, monkeypatch):
    luma = FRAMES[frame]()
    qp, rd = _rows(psy=psy)
    want = _jax(luma, qp, rd, psy, pallas, monkeypatch)
    got = _port(luma, qp, rd, psy)
    for blk in DEPTHS:
        same = np.mean(got[blk]["mode"] == want[blk]["mode"])
        assert same >= 0.98, (blk, same)
        assert np.allclose(got[blk]["j"], want[blk]["j"], rtol=5e-3,
                           atol=50), blk


def test_flat_frame_ties_keep_first_mode(monkeypatch):
    """On a flat frame every prediction is exact, and with equal mode
    rates every mode's J ties: argmin keeps the first index (DC), as
    jnp.argmin does."""
    luma = np.full((128, 128), 97, np.uint8)
    qp, rd = _rows(mode_rate=[300] * port_intra.N_MODES)
    want = _jax(luma, qp, rd, False, False, monkeypatch)
    got = _port(luma, qp, rd, False)
    for blk in DEPTHS:
        assert np.all(got[blk]["mode"] == 0), blk
        assert np.array_equal(got[blk]["mode"], want[blk]["mode"])
        assert np.array_equal(got[blk]["j"], want[blk]["j"])


def test_frames_fold_into_one_batch():
    """Two frames in one call give what each gives alone, with a
    distinct qp row per frame (one kernel call per distinct row)."""
    lumas = np.stack([_ramp128(), _blobs200x120()[:128, :128]])
    qp0, rd = _rows(qindex=140)
    qp1, _ = _rows(qindex=60)
    qps = np.stack([qp0, qp1])
    both = port_intra.intra_analysis_batch(
        torch.from_numpy(lumas), qps, np.stack([rd, rd]), depths=DEPTHS)
    for i in range(2):
        one = port_intra.intra_analysis_batch(
            torch.from_numpy(lumas[i: i + 1]), qps[i: i + 1], rd[None],
            depths=DEPTHS)
        assert torch.equal(both[i], one[0])


def test_unpack_rejects_wrong_size():
    with pytest.raises(ValueError):
        port_intra.unpack_rd_analysis(np.zeros(5, np.float32), 64, 64,
                                      DEPTHS)
