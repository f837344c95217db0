"""Cross-decoder conformance of the port's streams: libaom (the strict
second opinion, the port's conformance/libaom.py) validates every TU,
and dav1d (the recon oracle) decodes the stream to the port's recon.

The streams are those the port's tests hold against the JAX package:
the keyframe slice and the p8 GOP (tests/test_torch_slice.py), the 8-bit
p6 GOP with loop restoration (the same), the 10-bit p6 GOP with loop
restoration and the 10-bit p6 CRF 30 API packets
(tests/test_torch_restoration.py). The two 10-bit streams carry the
inter-frame residue inherited from the JAX package against dav1d
(ROADMAP.md section 3): their keyframe must be exact and the rest within
test_torch_restoration's bound."""

import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: test files run
    in parallel worker processes, and torch's OpenMP pool in each of them
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keyframes():
    from test_torch_slice import PRESET, QINDEX, H, W, _frames

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    enc = Av1Encoder(SequenceConfig(width=W, height=H), preset=PRESET,
                     device="cpu")
    return enc.encode_keyframes(_frames(), QINDEX), enc.recons, W, H


def _gop(preset):
    from test_torch_slice import H, W, encode_gop

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder

    enc, tus, recons = encode_gop(Av1Encoder, preset=preset, device="cpu")
    assert enc.seq.enable_restoration == (preset <= 6)
    return tus, recons, W, H


def _gop10():
    from test_torch_restoration import H, W, _gop

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder

    tus, recons, _ = _gop(Av1Encoder, 10, device="cpu")
    return tus, recons, W, H


def _api10():
    from test_torch_restoration import H, W, _api_p6

    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    pkts, recons = _api_p6(SvtAv1Encoder(device="cpu"), recon=True)
    return [p.data for p in pkts if not p.is_eos], recons, W, H


# name -> (the function that encodes it, whether dav1d must be exact on every
# frame)
STREAMS = {
    "keyframes-p12": (_keyframes, True),
    "gop-p8": (lambda: _gop(8), True),
    "gop-p6-lr-8bit": (lambda: _gop(6), True),
    "gop-p6-lr-10bit": (_gop10, False),
    "api-p6-crf30-10bit": (_api10, False),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_port_stream_passes_libaom_and_dav1d(name, tmp_path):
    from test_torch_restoration import RESIDUE_ABS, RESIDUE_SAMPLES

    from svt_av1_psyex_tpu_torch.conformance import libaom
    from svt_av1_psyex_tpu_torch.streams import (
        dav1d_loads,
        dav1d_residue,
        write_ivf,
    )

    if not libaom.available():
        pytest.skip("libaom unavailable (libaom.so.3 does not load)")
    encode, exact = STREAMS[name]
    tus, recons, w, h = encode()
    assert tus and all(tus)
    libaom.validate_ivf(write_ivf(tmp_path / f"{name}.ivf", tus, w, h))
    if dav1d_loads():
        res = dav1d_residue(tmp_path / f"{name}_dav1d.ivf", tus, recons, w,
                            h)
        if exact:
            assert res == {}
        else:
            assert 0 not in res
            assert all(n <= RESIDUE_SAMPLES and d <= RESIDUE_ABS
                       for n, d in res.values()), res


def test_libaom_rejects_a_corrupt_stream(tmp_path):
    """The probe is a gate: a keyframe TU cut short is refused."""
    from svt_av1_psyex_tpu_torch.conformance import libaom
    from svt_av1_psyex_tpu_torch.streams import write_ivf

    if not libaom.available():
        pytest.skip("libaom unavailable (libaom.so.3 does not load)")
    tus, _, w, h = _keyframes()
    cut = [tus[0][: len(tus[0]) // 2]] + tus[1:]
    with pytest.raises(RuntimeError, match="libaom rejects TU 0"):
        libaom.validate_ivf(write_ivf(tmp_path / "cut.ivf", cut, w, h))
