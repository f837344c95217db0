"""Presets <= 5 through the port, held against the JAX package: the
psy tools of BASELINE.json config 4 at preset 2 on a 10-bit clip,
complex_hvs=1 (codec/md.py's complex HVS distortion) with hbd_mds=1,
through the host mode decision. The JAX side scores loop restoration
exactly, as in tests/test_torch_film_grain.py; the streams must be
byte-identical and dav1d must decode them to the recon."""

import sys
import time
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


W = H = 64
BD, PRESET, QINDEX, FRAMES = 10, 2, 120, 2


def test_complex_hvs_p2_byte_identical(exact_jax_scoring, tmp_path):
    """A 64x64 10-bit preset-2 keyframe + one inter frame with
    complex_hvs=1 and hbd_mds=1: byte-identical TUs and recons in both
    packages, and dav1d-exact."""
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    kw = dict(complex_hvs=1, hbd_mds=1)
    t0 = time.perf_counter()
    port, tus, recons = encode_clip(Av1Encoder, W, H, BD, FRAMES, PRESET,
                                    QINDEX, device="cpu", **kw)
    t1 = time.perf_counter()
    _, ref_tus, ref_recons = encode_clip(JaxEncoder, W, H, BD, FRAMES,
                                         PRESET, QINDEX, **kw)
    print(f"{W}x{H} p{PRESET} {BD}-bit, {FRAMES} frames through the host "
          f"MD: the port {t1 - t0:.2f} s, the JAX package "
          f"{time.perf_counter() - t1:.2f} s")
    assert port.complex_hvs == 1 and port.hbd_mds == 1
    assert not port._device_md_precheck()   # the host MD coded every frame
    assert len(tus) == len(ref_tus) == FRAMES
    for i, (a, b) in enumerate(zip(tus, ref_tus)):
        assert a == b, f"TU {i} differs from the JAX package's"
    for p, q in zip(recons, ref_recons):
        assert all(np.array_equal(a, b) for a, b in zip(p, q))
    if dav1d_loads():
        assert dav1d_mismatches(tmp_path / "hvs.ivf", tus, recons, W,
                                H) == []
