"""Two tile columns with inter frames through the port, held against the
JAX package on the clip of tests/test_tiles.py::
test_two_tile_inter_bitexact: a 256x128 keyframe and a 4-frame
random-access mini-GOP at preset 8 (tile-local MVP scans and contexts,
motion compensation across tiles), through the host MD. The streams must
be byte-identical and decode in dav1d to the port's recon
(test_torch_host_paths.held)."""

import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

from test_torch_host_paths import held, jax_worker  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops (see
    test_torch_host_paths.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_tile_inter(jax_worker, tmp_path):
    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    w, h = 256, 128
    frames = [synth_frame(VideoFormat(w, h), t, "blobs") for t in range(5)]
    port, _ = held(jax_worker, tmp_path, "t2p", dict(width=w, height=h),
                   frames, 120, gop=4, preset=8, tile_cols_log2=1)
    assert not port._device_md_precheck()
