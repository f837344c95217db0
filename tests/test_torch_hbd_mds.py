"""hbd_mds=3 through the port, held against the JAX package: on a
10-bit clip it moves the device analysis to 8 bits (codec/md_device.py
_hbd8: the samples shifted down, the lambda scaled to 8-bit units). A
preset-6 10-bit 200x120 keyframe + 4-frame mini-GOP with loop
restoration on; the JAX side scores loop restoration exactly, as in
tests/test_torch_film_grain.py. The streams must be byte-identical and
dav1d must decode them to the recon."""

import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_film_grain import encode_clip  # noqa: E402
from test_torch_restoration import exact_jax_scoring  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: test files run
    in parallel worker processes, and torch's OpenMP pool in each of them
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 200, 120
BD, PRESET, QINDEX, FRAMES = 10, 6, 120, 5


def test_hbd_mds_3_p6_10bit_byte_identical(exact_jax_scoring, tmp_path):
    """Every device analysis of the port runs at 8 bits, and the GOP is
    byte-identical to the JAX package's, recons equal, dav1d-exact."""
    import svt_av1_psyex_tpu_torch.codec.md_device as MD
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    depths = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("intra_analysis_sharded", "inter_analysis_sharded"):
            def spy(*a, _orig=getattr(MD, name), **k):
                depths.append(k["bit_depth"])
                return _orig(*a, **k)

            mp.setattr(MD, name, spy)
        port, tus, recons = encode_clip(Av1Encoder, W, H, BD, FRAMES,
                                        PRESET, QINDEX, device="cpu",
                                        hbd_mds=3)
    assert depths == [8] * FRAMES
    assert port.seq.enable_restoration and port.seq.bit_depth == 10
    _, ref_tus, ref_recons = encode_clip(JaxEncoder, W, H, BD, FRAMES,
                                         PRESET, QINDEX, hbd_mds=3)
    assert len(tus) == len(ref_tus) == FRAMES + 2
    for i, (a, b) in enumerate(zip(tus, ref_tus)):
        assert a == b, f"TU {i} differs from the JAX package's"
    for p, q in zip(recons, ref_recons):
        assert all(np.array_equal(a, b) for a, b in zip(p, q))
    if dav1d_loads():
        assert dav1d_mismatches(tmp_path / "hbd3.ivf", tus, recons, W,
                                H) == []
