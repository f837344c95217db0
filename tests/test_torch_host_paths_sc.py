"""Screen content through the port, held against the JAX package on the
clips of its own tests: the palette keyframe (tests/test_palette.py)
and the intra block copy keyframe (tests/test_intrabc.py), each at the
one q those tests use, with forced screen content (host MD), and the
config-5 knobs (complex_hvs=1, hbd_mds=3) on a 10-bit keyframe. The
streams must be byte-identical and decode in dav1d to the port's recon;
the port must really code palette and intra-BC blocks.

Also SVT_TPU_GROUP_CHUNK: a 3-keyframe group cut into chunks of 1 and 2
frames gives the port's unchunked stream, and the JAX package's under
the same switch."""

import sys
from fractions import Fraction
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


@pytest.fixture
def count_writes(monkeypatch):
    """count_writes(name): counts the calls of the port's
    TileWriter.<name> from now on; returns the counter dict."""
    import svt_av1_psyex_tpu_torch.bitstream.tile_writer as tw

    def install(name):
        state = {"n": 0}
        orig = getattr(tw.TileWriter, name)

        def spy(self, *args):
            state["n"] += 1
            return orig(self, *args)

        monkeypatch.setattr(tw.TileWriter, name, spy)
        return state

    return install


def test_palette_keyframe(jax_worker, tmp_path, count_writes):
    """tests/test_palette.py::test_palette_keyframe_dav1d_exact at q 100."""
    from test_palette import _sc_frame

    n = count_writes("_write_palette_tokens")
    held(jax_worker, tmp_path, "pal", dict(width=128, height=128),
         [_sc_frame()], 100, preset=6, screen_content_mode=1)
    assert n["n"] > 0, "no palette leaves chosen on screen content"


def test_intrabc_keyframe(jax_worker, tmp_path, count_writes):
    """tests/test_intrabc.py::test_intrabc_keyframe_dav1d_exact at q 120."""
    from test_intrabc import _repeat_rows

    n = count_writes("_write_dv")
    held(jax_worker, tmp_path, "ibc", dict(width=192, height=192),
         [_repeat_rows()], 120, preset=6, screen_content_mode=1)
    assert n["n"] > 0, "no intra-BC blocks chosen on repeating content"


def test_config5_knobs(jax_worker, tmp_path):
    """tests/test_palette.py::test_config5_knobs_conformant: a 10-bit
    128x128 keyframe at preset 8 with complex_hvs=1 and hbd_mds=3."""
    rng = np.random.default_rng(2)
    y = (rng.integers(0, 1024, (128, 128))).astype(np.uint16)
    u = np.full((64, 64), 512, np.uint16)
    port, _ = held(jax_worker, tmp_path, "c5",
                   dict(width=128, height=128, bit_depth=10),
                   [[y, u, u.copy()]], 120, preset=8, hbd_mds=3,
                   complex_hvs=1)
    assert port.complex_hvs == 1 and port.hbd_mds == 3


W, H, PRESET, QINDEX = 200, 120, 12, 140


@pytest.fixture(scope="module")
def group():
    """3 keyframes of tools/mkclip's "blobs" clip and the port's
    unchunked group encode of them (test_torch_slice.py's group)."""
    sys.path.insert(0, str(ROOT / "tools"))
    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig
    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    fmt = VideoFormat(W, H, fps=Fraction(30, 1))
    frames = [synth_frame(fmt, t, "blobs") for t in range(3)]
    enc = Av1Encoder(SequenceConfig(width=W, height=H), preset=PRESET,
                     device="cpu")
    return frames, enc.encode_keyframes(frames, QINDEX)


@pytest.mark.parametrize("chunk", [1, 2])
def test_group_chunk_byte_identical(group, chunk, monkeypatch):
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder
    from svt_av1_psyex_tpu.codec.encoder import SequenceConfig as JaxSeq

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    frames, whole = group
    monkeypatch.setenv("SVT_TPU_GROUP_CHUNK", str(chunk))
    port = Av1Encoder(SequenceConfig(width=W, height=H), preset=PRESET,
                      device="cpu")
    tus = port.encode_keyframes(frames, QINDEX)
    ref = JaxEncoder(JaxSeq(width=W, height=H), preset=PRESET)
    assert tus == whole
    assert tus == ref.encode_keyframes(frames, QINDEX)
    assert set(port.stage_seconds) == {"device_analysis", "frames", "cdef",
                                       "finalize", "host"}
