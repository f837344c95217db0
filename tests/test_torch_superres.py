"""Super-resolution through the port, held against the JAX package: a
2-frame all-intra stream at superres_denom=16 (the frames coded at half
width, then upscaled by the normative filter), as tests/test_superres.py
encodes it. The streams must be byte-identical, and dav1d must decode
them, upscaled, to the encoder's upscaled recon."""

import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: test files run
    in parallel worker processes, and torch's OpenMP pool in each of them
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H, DENOM, QINDEX, FRAMES = 128, 96, 16, 60, 2


def _encode(cls, **kwargs):
    import importlib

    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    pkg = cls.__module__.split(".")[0]
    seq_cls = importlib.import_module(f"{pkg}.bitstream.headers").SequenceConfig
    seq = seq_cls(width=W, height=H)
    enc = cls(seq, superres_denom=DENOM, **kwargs)
    assert seq.enable_superres and seq.disp_width == W and seq.width < W
    fmt = VideoFormat(W, H, fps=Fraction(30, 1))
    tus, recons = [], []
    for t in range(FRAMES):
        tus.append(enc.encode_keyframe(synth_frame(fmt, t, "blobs"), QINDEX))
        recons.append(enc.last_recon)
    return tus, recons


def test_superres_all_intra_byte_identical(tmp_path):
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    tus, recons = _encode(Av1Encoder, device="cpu")
    ref_tus, ref_recons = _encode(JaxEncoder)
    assert tus == ref_tus
    for p, q in zip(recons, ref_recons):
        assert all(np.array_equal(a, b) for a, b in zip(p, q))
    assert recons[0][0].shape[1] >= W   # the recon is upscaled
    if dav1d_loads():
        assert dav1d_mismatches(tmp_path / "sr.ivf", tus, recons, W,
                                H) == []
