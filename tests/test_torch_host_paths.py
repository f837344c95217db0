"""The host mode-decision paths through the port, held against the JAX
package on the clips, frames and plans of the JAX package's own tests:
two tile columns at preset 8 (tests/test_tiles.py), the 4:4:4 GOP at
preset 10 (tests/test_444.py) and the monochrome GOP at presets 8, 6
and 10 (tests/test_mono.py). Tiles and 4:4:4 fail the device-MD
precheck, so codec/md.py decides every block, with the port's device
motion field (device/me.py, the sad_lattice kernel) under its inter
frames; mono takes the device MD at presets 6+ and the host MD below.
The slower cases are in test_torch_host_paths_{sc,tiles,444}.py.

On the CPU the port's device stages run the plain version of each
kernel; every stream must equal the JAX package's byte for byte, and
dav1d must decode it to the port's recon wherever the JAX test checks
that."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

PORT, JAX = "svt_av1_psyex_tpu_torch", "svt_av1_psyex_tpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: test files run
    in parallel worker processes, and torch's OpenMP pool in each of them
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def encode(pkg: str, seq_kw: dict, frames: list, q: int, gop=None,
           **enc_kw):
    """`frames` through `pkg`'s Av1Encoder (the port on the CPU), as the
    JAX package's tests drive it: with gop None each frame through
    encode_keyframe; else a keyframe (codec.gop.plan_key) and, for gop >
    0, one gop-frame random-access mini-GOP (plan_minigop), each TU from
    encode_frame with its plan. Returns (encoder, TUs, the displayed
    frames' recons in display order)."""
    seq = importlib.import_module(
        f"{pkg}.bitstream.headers").SequenceConfig(**seq_kw)
    if pkg == PORT:
        enc_kw = dict(enc_kw, device="cpu")
    enc = importlib.import_module(f"{pkg}.codec.encoder").Av1Encoder(
        seq, **enc_kw)
    tus, recons = [], {}
    if gop is None:
        for t, f in enumerate(frames):
            tus.append(enc.encode_keyframe([p.copy() for p in f], q))
            recons[t] = [p.copy() for p in enc.last_recon]
        return enc, tus, [recons[t] for t in sorted(recons)]
    gp = importlib.import_module(f"{pkg}.codec.gop")
    plans = [gp.plan_key(0)]
    if gop:
        plans += gp.plan_minigop(0, 1, gop, future_slot=1)
    for pl in plans:
        src = (None if pl.show_existing_slot is not None
               else [p.copy() for p in frames[pl.disp_idx]])
        tus.append(enc.encode_frame(src, q, plan=pl))
        if pl.show_frame or pl.show_existing_slot is not None:
            recons[pl.disp_idx] = [p.copy() for p in enc.last_recon]
    return enc, tus, [recons[t] for t in sorted(recons)]


def encode_jax(seq_kw: dict, frames: list, q: int, gop, enc_kw: dict):
    """encode() through the JAX package, without the encoder (for a
    worker process)."""
    return encode(JAX, seq_kw, frames, q, gop, **enc_kw)[1:]


@pytest.fixture(scope="module")
def jax_worker():
    """One worker process for the JAX package's encodes of a module: the
    host MD runs for minutes on these clips in either package, so the
    JAX package encodes there while the port encodes here, and the
    worker keeps its compiled programs from one test to the next."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool


def held(jax_worker, tmp_path, name: str, seq_kw: dict, frames: list,
         q: int, gop=None, **enc_kw):
    """Both packages on the same frames: the TUs byte-identical, the
    recons equal, and dav1d decodes the port's stream to its recon.
    Returns the port's encoder and TUs."""
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    ref = jax_worker.submit(encode_jax, seq_kw, frames, q, gop, enc_kw)
    port, tus, recons = encode(PORT, seq_kw, frames, q, gop, **enc_kw)
    ref_tus, ref_recons = ref.result()
    assert len(tus) == len(ref_tus)
    for i, (a, b) in enumerate(zip(tus, ref_tus)):
        assert a == b, f"{name}: TU {i} differs from the JAX package's"
    for t, (p, r) in enumerate(zip(recons, ref_recons)):
        assert all(np.array_equal(a, b) for a, b in zip(p, r)), (name, t)
    if dav1d_loads():
        assert dav1d_mismatches(tmp_path / f"{name}.ivf", tus, recons,
                                seq_kw["width"], seq_kw["height"]) == []
    return port, tus


def test_two_tile_intra(jax_worker, tmp_path):
    """tests/test_tiles.py::test_two_tile_intra_bitexact: a 256x128
    keyframe in two tile columns at preset 8."""
    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    w, h = 256, 128
    frames = [synth_frame(VideoFormat(w, h), 0, "blobs")]
    port, _ = held(jax_worker, tmp_path, "t2i", dict(width=w, height=h),
                   frames, 120, gop=0, preset=8, tile_cols_log2=1)
    assert not port._device_md_precheck()


def test_444_device_path_gop(jax_worker, tmp_path):
    """tests/test_444.py::test_444_device_path_gop: a 128x96 4:4:4
    keyframe and a 4-frame mini-GOP at preset 10."""
    from test_444 import _mk

    rng = np.random.default_rng(2)
    frames = [_mk(128, 96, t, rng) for t in range(5)]
    port, _ = held(jax_worker, tmp_path, "i444p10",
                   dict(width=128, height=96, profile=1, subsampling_x=0,
                        subsampling_y=0), frames, 120, gop=4, preset=10)
    assert not port._device_md_precheck()


@pytest.mark.parametrize("preset", [8, 6, 10])
def test_mono_gop(jax_worker, tmp_path, preset):
    """tests/test_mono.py::test_mono_gop_bitexact_all_presets: a 128x96
    4:0:0 keyframe and a 4-frame mini-GOP (the device MD at presets 6+)."""
    from test_mono import _frames

    port, _ = held(jax_worker, tmp_path, f"mono{preset}",
                   dict(width=128, height=96, mono_chrome=True),
                   _frames(128, 96, 5), 120, gop=4, preset=preset)
    assert port._device_md_precheck()
