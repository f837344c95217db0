"""Presets <= 5 through the port, held against the JAX package: film
grain with its adaptive (denoise-and-model) estimate on a preset-4
10-bit clip, whose frames run the host mode decision (codec/md.py; the
device MD needs preset >= 6).

The JAX package's 10-bit loop-restoration scores are float32 and pick
otherwise than the port's exact ones (tests/test_torch_restoration.py),
so the JAX side runs with its two scoring functions made exact; every
other step is the same host code in both packages, so the streams must
be byte-identical. dav1d must decode each displayed frame to the
encoder's grained output (its recon plus the signalled grain)."""

import sys
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

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


def encode_clip(cls, w, h, bd, n, preset, qindex, kind="blobs",
                grained=False, **kwargs):
    """n frames of tools/mkclip's `kind` clip through cls (either
    package's Av1Encoder, with that package's SequenceConfig and plans):
    a keyframe, then one (n - 1)-frame random-access mini-GOP, each TU
    from encode_frame with its plan. Returns (encoder, TUs, per
    displayed frame the recon, or with `grained` the grained output)."""
    import importlib

    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    pkg = cls.__module__.split(".")[0]
    seq_cls = importlib.import_module(f"{pkg}.bitstream.headers").SequenceConfig
    gop = importlib.import_module(f"{pkg}.codec.gop")
    fmt = VideoFormat(w, h, bd, fps=Fraction(30, 1))
    frames = [synth_frame(fmt, t, kind) for t in range(n)]
    enc = cls(seq_cls(width=w, height=h, bit_depth=bd), preset=preset,
              **kwargs)
    plans = [gop.plan_key(0)]
    if n > 1:
        plans += gop.plan_minigop(0, 1, n - 1, future_slot=1)
    tus, shown = [], {}
    for pl in plans:
        src = frames[pl.disp_idx] if pl.show_existing_slot is None else None
        tus.append(enc.encode_frame(src, qindex, plan=pl))
        if pl.show_frame or pl.show_existing_slot is not None:
            out = enc.grained_output() if grained else enc.last_recon
            shown[pl.disp_idx] = [p.copy() for p in out]
    return enc, tus, [shown[t] for t in sorted(shown)]


W = H = 64
BD, PRESET, QINDEX, FRAMES = 10, 4, 120, 3


def test_film_grain_p4_10bit_byte_identical(exact_jax_scoring, tmp_path):
    """A 64x64 10-bit preset-4 keyframe + 2-frame mini-GOP with film
    grain (strength 8) and its adaptive estimate on: byte-identical TUs
    and grained outputs in both packages, every coded frame carrying
    grain parameters, and dav1d's output equal to the grained output."""
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    kw = dict(film_grain=8, adaptive_film_grain=True)
    t0 = time.perf_counter()
    port, tus, outs = encode_clip(Av1Encoder, W, H, BD, FRAMES, PRESET,
                                  QINDEX, grained=True, device="cpu", **kw)
    t1 = time.perf_counter()
    _, ref_tus, ref_outs = encode_clip(JaxEncoder, W, H, BD, FRAMES, PRESET,
                                       QINDEX, grained=True, **kw)
    print(f"{W}x{H} p{PRESET} {BD}-bit, {FRAMES} frames through the host "
          f"MD: the port {t1 - t0:.2f} s, the JAX package "
          f"{time.perf_counter() - t1:.2f} s")
    assert port.seq.film_grain_params_present and port.seq.enable_restoration
    assert not port._device_md_precheck()   # the host MD coded every frame
    assert len(tus) == len(ref_tus) == FRAMES + 1
    for i, (a, b) in enumerate(zip(tus, ref_tus)):
        assert a == b, f"TU {i} differs from the JAX package's"
    assert len(outs) == FRAMES
    for p, q in zip(outs, ref_outs):
        assert all(np.array_equal(a, b) for a, b in zip(p, q))
    assert port.last_film_grain is not None
    if dav1d_loads():
        assert dav1d_mismatches(tmp_path / "fg.ivf", tus, outs, W, H) == []
