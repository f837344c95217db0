"""The port's device state (svt_av1_psyex_tpu_torch/params.py) against the
JAX package's numpy arrays: the constant tables must be equal exactly,
and so must the per-frame rows (qp_row, rd_row) and the RD constants the
port's DeviceIntraMD derives for a real frame."""

import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

from svt_av1_psyex_tpu_torch import params  # noqa: E402


@pytest.fixture(scope="module")
def consts():
    return params.reference_constants("cpu")


@pytest.mark.parametrize("n", params.TRANSFORM_SIZES)
def test_dct_matrices_equal(consts, n):
    from svt_av1_psyex_tpu.device.matdct import fwd_mats, inv_mats

    for got, want in ((consts["fwd_mats"][n], fwd_mats(n)),
                      (consts["inv_mats"][n], inv_mats(n))):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("cn", (4, 8, 16, 32))
def test_scan_pos_equal(consts, cn):
    from svt_av1_psyex_tpu.ops.pallas.fullloop import scan_pos

    assert np.array_equal(consts["scan_pos"][cn].numpy(), scan_pos(cn))


@pytest.mark.parametrize("blk", params.BLOCK_SIZES)
def test_smooth_weights_equal(consts, blk):
    from svt_av1_psyex_tpu.bitstream.tables import get as table_get

    want = table_get("sm_weight_arrays")[blk: 2 * blk].astype(np.int32)
    assert np.array_equal(consts["sm_weights"][blk].numpy(), want)


def test_hadamard_equal(consts):
    from svt_av1_psyex_tpu.device.intra import _had8

    assert np.array_equal(consts["had8"].numpy(), _had8())


def test_constants_shared_per_device():
    assert (params.reference_constants("cpu")
            is params.reference_constants(torch.device("cpu")))


@pytest.mark.parametrize("qindex,bit_depth", [(1, 8), (80, 8), (140, 8),
                                              (255, 8), (140, 10)])
def test_qp_row_equal(qindex, bit_depth):
    from svt_av1_psyex_tpu.device.intra import qp_row_for as jax_qp_row

    from svt_av1_psyex_tpu_torch.device.intra import qp_row_for

    got = qp_row_for(qindex, 3, 0, bit_depth)
    want = jax_qp_row(qindex, 3, 0, bit_depth)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("psy_rd", [0.0, 1.5])
def test_rd_row_and_costs_equal(psy_rd):
    """The port's DeviceIntraMD constructor (a copy, since the JAX one
    imports the device tier) derives the same RD state for a frame."""
    from mkclip import synth_frame

    from svt_av1_psyex_tpu.codec.md_device import DeviceIntraMD as JaxMD
    from svt_av1_psyex_tpu.utils.y4m import VideoFormat

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    w, h = 200, 120
    frame = synth_frame(VideoFormat(w, h, fps=Fraction(30, 1)), 0, "blobs")
    enc = Av1Encoder(SequenceConfig(width=w, height=h), preset=12,
                     device="cpu", psy_rd=psy_rd, tune=0)
    st = enc.begin_frame(frame, 140, force_key=True)
    dmd = st["dmd"]
    ref = JaxMD(st["md"], enc.seq, st["fr"], st["sb_qmap"])
    assert dmd.DEPTHS == ref.DEPTHS == (64, 32, 16, 8)
    assert np.array_equal(dmd.modes, ref.modes)
    assert np.array_equal(dmd.rd_row(), ref.rd_row())
    assert dmd.psy_fixed == ref.psy_fixed and (dmd.psy_fixed > 0) == (psy_rd > 0)
    assert (dmd.skip0, dmd.skip1) == (ref.skip0, ref.skip1)
    for blk in (16, 32, 64):
        assert np.array_equal(dmd.part_costs[blk], ref.part_costs[blk])
