"""4:4:4 with the full preset-6 toolset through the port, held against
the JAX package on the clip of tests/test_444.py::test_444_full_toolset:
a 128x96 keyframe and a 4-frame random-access mini-GOP (CfL at 4:4:4,
filter intra, loop restoration, TX select), through the host MD with the
port's device motion field under its inter frames. The streams must be
byte-identical and decode in dav1d to the port's recon, full-resolution
chroma included (test_torch_host_paths.held)."""

import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
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


def test_444_full_toolset(jax_worker, tmp_path):
    from test_444 import _mk

    rng = np.random.default_rng(2)
    frames = [_mk(128, 96, t, rng) for t in range(5)]
    port, _ = held(jax_worker, tmp_path, "i444p6",
                   dict(width=128, height=96, profile=1, subsampling_x=0,
                        subsampling_y=0), frames, 120, gop=4, preset=6)
    assert not port._device_md_precheck() and port.seq.enable_restoration
