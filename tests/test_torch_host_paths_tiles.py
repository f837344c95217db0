"""Four tile columns through the port at preset 6, held against the JAX
package on the clip of tests/test_tiles.py::
test_four_tile_preset6_bitexact: a 384x128 keyframe with the full
preset-6 toolset (filter intra, CfL, loop restoration, TX_MODE_SELECT)
and per-tile LR running refs, through the host MD (tiles fail the
device-MD precheck). The streams must be byte-identical and decode in
dav1d to the port's recon (test_torch_host_paths.held)."""

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


def test_four_tile_preset6(jax_worker, tmp_path):
    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    w, h = 384, 128
    frames = [synth_frame(VideoFormat(w, h), 0, "blobs")]
    port, _ = held(jax_worker, tmp_path, "t4p6", dict(width=w, height=h),
                   frames, 100, gop=0, preset=6, tile_cols_log2=2)
    assert not port._device_md_precheck() and port.seq.enable_restoration
