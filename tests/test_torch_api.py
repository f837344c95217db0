"""The port's SvtAv1Encoder and CLI (svt_av1_psyex_tpu_torch/api/,
app/) against the JAX package's SvtAv1Encoder on the same clip
(tools/mkclip "blobs", 200x120, 10 frames): preset 8, CRF 30,
hierarchical_levels 2 (4-frame mini-GOPs), random access, keyframe TF,
ARF TF and TPL on at their defaults.

On the CPU the port's device stages (TF, TPL, the mode-decision
analyses) run in PyTorch with the plain version of each kernel and the
JAX package's in jnp; both feed the same host tier, so the packets must
be byte-identical. The port's stream must decode in dav1d to its
reconstruction, and the CLI's IVF must equal the API's packets."""

import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))


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


W, H, N = 200, 120, 10
PRESET, CRF, HL = 8, 30, 2


def _frames(n=N, w=W, h=H):
    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    fmt = VideoFormat(w, h, fps=Fraction(30, 1))
    return [synth_frame(fmt, t, "blobs") for t in range(n)]


def _configure(handle, w=W, h=H, hl=HL, recon=True):
    cfg = handle.config
    cfg.source_width, cfg.source_height = w, h
    cfg.enc_mode = PRESET
    cfg.crf = CRF
    cfg.hierarchical_levels = hl
    cfg.frame_rate_numerator, cfg.frame_rate_denominator = 30, 1
    cfg.recon_enabled = recon
    handle.init()
    return handle


def _encode(handle, frames):
    """Send every frame and EOS; returns (packets, recons by pts)."""
    for t, f in enumerate(frames):
        handle.send_picture([p.copy() for p in f], t)
    handle.send_picture(None)
    pkts, recons = [], {}
    while (pkt := handle.get_packet()) is not None:
        if not pkt.is_eos:
            pkts.append(pkt)
    if handle.config.recon_enabled:
        while (rec := handle.get_recon()) is not None:
            recons[rec.pts] = rec.planes
    return pkts, recons


def _recording_encoder():
    """The port's encoder, counting its TF and TPL calls."""
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    class Recording(SvtAv1Encoder):
        def _temporal_filter(self, planes, nbrs, strength):
            self.tf_calls.append(len(nbrs))
            return super()._temporal_filter(planes, nbrs, strength)

        def _run_tpl(self, look, base_qindex):
            model = super()._run_tpl(look, base_qindex)
            self.tpl_models.append(model)
            return model

    enc = Recording(device="cpu")
    enc.tf_calls, enc.tpl_models = [], []
    return enc


@pytest.fixture(scope="module")
def encodes():
    from svt_av1_psyex_tpu.api.encoder import SvtAv1Encoder as JaxEncoder

    frames = _frames()
    port = _configure(_recording_encoder())
    port_out = _encode(port, frames)
    ref_out = _encode(_configure(JaxEncoder()), frames)
    return port, port_out, ref_out


def test_packets_byte_identical(encodes):
    _, (pkts, _), (ref_pkts, _) = encodes
    # KF, two 4-frame mini-GOPs (4 coded + 2 shown-existing each), 1 frame
    assert len(pkts) == len(ref_pkts) == 14
    for i, (a, b) in enumerate(zip(pkts, ref_pkts)):
        assert (a.pts, a.dts, a.frame_type) == (b.pts, b.dts, b.frame_type)
        assert a.data == b.data, f"packet {i} differs from the JAX package's"


def test_recons_equal(encodes):
    _, (_, recons), (_, ref_recons) = encodes
    assert sorted(recons) == sorted(ref_recons) == list(range(N))
    for t in recons:
        for a, b in zip(recons[t], ref_recons[t]):
            assert np.array_equal(a, b), t


def test_tf_and_tpl_ran_on_the_port(encodes):
    """Keyframe TF (3 neighbours), ARF TF (up to 6) and TPL (keyframe
    and each mini-GOP) all went through the port's stages."""
    port, _, _ = encodes
    assert port.tf_calls == [3, 3, 3]
    assert len(port.tpl_models) == 3
    assert all(m.is_inter[1:].any() for m in port.tpl_models)


def test_port_stream_decodes_to_recon(encodes, tmp_path):
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    if not dav1d_loads():
        pytest.skip("dav1d shim unavailable (libdav1d.so.6 does not load)")
    _, (pkts, recons), _ = encodes
    assert dav1d_mismatches(tmp_path / "api.ivf", [p.data for p in pkts],
                            [recons[t] for t in sorted(recons)], W,
                            H) == []


def test_cli_ivf_equals_api(tmp_path):
    """`python -m svt_av1_psyex_tpu_torch.app.main --device cpu` on a y4m
    writes the packets an in-process API run of the same config gives
    (the CLI's defaults for tune and variance octile differ from the
    API's, so the CLI is given the API's)."""
    from svt_av1_psyex_tpu.utils.ivf import read_ivf
    from svt_av1_psyex_tpu.utils.y4m import Y4MWriter

    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder
    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    w, h, n = 128, 64, 6
    frames = _frames(n, w, h)
    y4m, ivf = tmp_path / "in.y4m", tmp_path / "out.ivf"
    with open(y4m, "wb") as fh:
        wr = Y4MWriter(fh, VideoFormat(w, h, fps=Fraction(30, 1)))
        for f in frames:
            wr.write_frame(f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"   # as _one_torch_thread, per process
    proc = subprocess.run(
        [sys.executable, "-m", "svt_av1_psyex_tpu_torch.app.main",
         "-i", str(y4m), "-b", str(ivf), "--device", "cpu",
         "--preset", str(PRESET), "--crf", str(CRF),
         "--hierarchical-levels", str(HL), "--tune", "0",
         "--variance-octile", "5", "--progress", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"{n} frames in" in proc.stderr
    with open(ivf, "rb") as fh:
        cli = list(read_ivf(fh))
    pkts, _ = _encode(_configure(SvtAv1Encoder(device="cpu"), w, h,
                                 recon=False), frames)
    assert [(p.pts, p.data) for p in pkts] == cli


def test_cli_cuda_absent_raises():
    from svt_av1_psyex_tpu_torch.app.main import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-i", "unused.y4m", "-b", "unused.ivf", "--device", "cuda"])


def test_handle_wrappers_and_device_required():
    from svt_av1_psyex_tpu_torch.api import (
        SvtAv1Encoder,
        svt_av1_enc_init,
        svt_av1_enc_init_handle,
        svt_av1_enc_set_parameter,
        svt_av1_get_version,
    )

    if not torch.cuda.is_available():   # the default device is "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            SvtAv1Encoder()
    handle, cfg = svt_av1_enc_init_handle(device="cpu")
    assert isinstance(handle, SvtAv1Encoder) and cfg is handle.config
    assert handle.device.type == "cpu" and handle.kernels == "hand"
    cfg.source_width, cfg.source_height = 64, 64
    svt_av1_enc_set_parameter(handle, cfg)
    svt_av1_enc_init(handle)
    assert handle._enc.device.type == "cpu"
    assert handle.stream_header()
    assert svt_av1_get_version()
    with pytest.raises(ValueError):
        SvtAv1Encoder(device="cpu", kernels="fast")
