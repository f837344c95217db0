"""The port's stage clock (SVT_TPU_TIMING=1: `Av1Encoder._tick`, `_note`
and `.timing`, codec/encoder.py) on a small random-access encode through
the port's SvtAv1Encoder: the "blobs" clip at 128x96 8-bit, 6 frames,
preset 6 (device mode decision, CDEF and loop restoration), CRF 30,
hierarchical levels 2, keyframe and ARF TF and TPL at their defaults. Its
coding order holds a keyframe, two layer-0 inter frames (whose
motion-mode trials the whole-frame C commit declines: they take the
per-leaf commit, `commit_leaf`) and inter frames of the upper layers.

The clock's rule: top-level keys are spans closed through `_tick`,
disjoint in time; a key with a dot is a part of the stage before the dot,
in seconds; a key starting "n." is a count. Spans are collected by
wrapping the encoder's `_tick` attribute, as the benchmark's harness does
(benchmark/harness/program.py `watch_stages`)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

W, H, N = 128, 96, 6
PRESET, CRF, HL = 6, 30, 2
# every top-level stage the encode above runs, and the parts and counts
# the benchmark's per-layer metrics read
SPANS = {"tf", "tpl", "begin", "device_wait", "pick", "commit",
         "commit_leaf", "lf_grids", "dlf", "cdef", "lr", "ec"}
NOTES = {"begin.dispatch", "lr.build", "lr.exact", "n.ec_symbols",
         "n.ec_calls", "n.ec_sbs", "n.ec_sbs_native", "n.cdef_frames",
         "n.cdef_device"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: test files run in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=N, w=W, h=H):
    from svt_av1_psyex_tpu_torch.utils.clips import synth_frame
    from svt_av1_psyex_tpu_torch.utils.y4m import VideoFormat

    fmt = VideoFormat(w, h)
    return [synth_frame(fmt, t) for t in range(n)]


def _set_env(key, value):
    if value is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = value


def _encode(frames, clock: bool, encode_env: dict, watch: bool = False):
    """Encodes `frames` through a SvtAv1Encoder made with SVT_TPU_TIMING
    set (clock) or unset, the environment then set to `encode_env` for the
    encode itself. Returns (TUs, the encoder's timing, its spans
    [(key, t0, t1)], one record per coded frame: (intra, motion-mode
    switchable, temporal layer, keys ticked while it resumed))."""
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    keys = ("SVT_TPU_TIMING", "SVT_TPU_PY_EC")
    saved = {k: os.environ.get(k) for k in keys}
    try:
        _set_env("SVT_TPU_TIMING", "1" if clock else None)
        api = SvtAv1Encoder(device="cpu")
        cfg = api.config
        cfg.source_width, cfg.source_height = W, H
        cfg.enc_mode, cfg.crf, cfg.hierarchical_levels = PRESET, CRF, HL
        cfg.frame_rate_numerator, cfg.frame_rate_denominator = 30, 1
        api.init()
        enc = api._enc
        spans, frames_seen = [], []
        if watch:
            tick, begin, resume = enc._tick, enc.begin_frame, enc.resume_frame

            def _tick(key, t0):
                t1 = tick(key, t0)
                spans.append((key, t0, t1))
                return t1

            def _begin(*args, plan=None, **kw):
                st = begin(*args, plan=plan, **kw)
                if isinstance(st, dict) and plan is not None:
                    st["_layer"] = plan.layer
                return st

            def _resume(st):
                n0 = len(spans)
                out = resume(st)
                fr = st["fr"]
                frames_seen.append((
                    fr.frame_is_intra,
                    bool(getattr(fr, "is_motion_mode_switchable", False)),
                    st.get("_layer"), {k for k, _, _ in spans[n0:]}))
                return out

            enc._tick, enc.begin_frame, enc.resume_frame = _tick, _begin, _resume
        for k in keys:
            _set_env(k, encode_env.get(k))
        for t, f in enumerate(frames):
            api.send_picture([p.copy() for p in f], t)
        api.send_picture(None)
        tus = []
        while (pkt := api.get_packet()) is not None:
            if not pkt.is_eos:
                tus.append(pkt.data)
        return tus, dict(enc.timing), spans, frames_seen
    finally:
        for k, v in saved.items():
            _set_env(k, v)


@pytest.fixture(scope="module")
def runs():
    """The same clip three times: clock on (built with SVT_TPU_TIMING=1,
    encoded with it unset), clock off (built without it, encoded with it
    set), and clock on with the pure-Python entropy coder."""
    frames = _frames()
    return {
        "on": _encode(frames, True, {}, watch=True),
        "off": _encode(frames, False, {"SVT_TPU_TIMING": "1"}),
        "py": _encode(frames, True, {"SVT_TPU_TIMING": "1",
                                     "SVT_TPU_PY_EC": "1"}),
    }


def test_tus_are_byte_identical_with_the_clock_on_and_off(runs):
    on, off = runs["on"][0], runs["off"][0]
    assert len(on) >= N and all(on)
    assert on == off


def test_the_clock_is_read_once_when_the_encoder_is_built(runs):
    """The flag read at construction holds for the whole encode, whatever
    the environment says while it runs."""
    assert runs["off"][1] == {}
    assert set(runs["on"][1]) == SPANS | NOTES


def test_top_level_spans_are_disjoint_and_sum_to_their_keys(runs):
    _, timing, spans, _ = runs["on"]
    assert {k for k, _, _ in spans} == SPANS
    ordered = sorted(spans, key=lambda s: s[1])
    for (k0, a0, b0), (k1, a1, b1) in zip(ordered, ordered[1:]):
        assert a0 <= b0 <= a1, (k0, k1)
    for key in SPANS:
        assert timing[key] == pytest.approx(
            sum(b - a for k, a, b in spans if k == key), rel=1e-9)


def test_each_part_is_at_most_its_stage(runs):
    timing = runs["on"][1]
    parts: dict = {}
    for key in NOTES:
        if not key.startswith("n."):
            assert timing[key] > 0, key
            stage = key.split(".")[0]
            parts[stage] = parts.get(stage, 0.0) + timing[key]
    assert set(parts) == {"begin", "lr"}
    for stage, seconds in parts.items():
        assert seconds <= timing[stage], stage
    assert timing["n.ec_symbols"] > timing["n.ec_calls"] > 0
    assert all(isinstance(timing[k], int) for k in NOTES
               if k.startswith("n."))


def test_cdef_counts_every_coded_frame_and_no_kernel_on_the_cpu(runs):
    """Every coded frame of the clip runs CDEF's search: each counts in
    n.cdef_frames, and none in n.cdef_device, which counts the frames the
    CUDA kernel took (ops/cuda/cdef.py)."""
    timing = runs["on"][1]
    assert timing["n.cdef_frames"] == len(runs["on"][3]) >= N
    assert timing["n.cdef_device"] == 0


def test_commit_leaf_spans_exactly_the_frames_the_c_commit_declines(runs):
    """The whole-frame C commit declines the motion-mode frames, which at
    preset 6 are the layer-0 inter frames: those take `commit_leaf`, every
    other frame `commit`; each frame has one `pick` span."""
    frames = runs["on"][3]
    assert len(frames) >= N
    leaf = 0
    for intra, switchable, layer, keys in frames:
        assert switchable == (not intra and layer == 0)
        assert ("commit_leaf" in keys) == switchable
        assert ("commit" in keys) == (not switchable)
        assert "pick" in keys
        leaf += switchable
    assert 0 < leaf < len(frames) - 1
    spans = runs["on"][2]
    for key in ("pick", "commit_leaf"):
        assert sum(k == key for k, _, _ in spans) == sum(
            key in keys for _, _, _, keys in frames)


def test_symbol_count_is_the_same_under_the_native_and_python_coders(runs):
    on, py = runs["on"], runs["py"]
    assert py[0] == on[0]
    assert py[1]["n.ec_symbols"] == on[1]["n.ec_symbols"] > 0
    assert "n.ec_calls" not in py[1]   # no call into C there


def test_coder_counts_each_literal_bit_and_each_call():
    """Both coders count a literal's bits one symbol each; the native
    coder counts each entry from Python once, a whole txb included."""
    from svt_av1_psyex_tpu_torch.bitstream.ec import EntropyEncoder
    from svt_av1_psyex_tpu_torch.native import ecenc

    if ecenc.get_lib() is None:
        pytest.skip("the native host tier did not build (gcc)")
    rng = np.random.default_rng(13)
    cdf = np.array([8192, 20000, 28000, 32768], np.int32)
    coders = [ecenc.NativeEntropyEncoder(), EntropyEncoder()]
    symbols = calls = 0
    for _ in range(200):
        if rng.random() < 0.3:
            n = int(rng.integers(1, 17))
            v = int(rng.integers(0, 1 << n))
            for c in coders:
                c.encode_literal(v, n)
            symbols += n
        else:
            s = int(rng.integers(0, 4))
            for c in coders:
                c.encode_symbol(s, cdf)
            symbols += 1
        calls += 1
    native, python = coders
    assert native.done() == python.done()
    assert native.counts() == (symbols, calls)
    assert python.counts() == (symbols, 0)


def test_two_encoders_keep_their_own_lr_parts():
    """Two encoders in one process, and loop restoration's search run
    outside any encoder between their frames (as a test or the card's
    check runs it): each encoder's `lr.*` are its own search's, within its
    `lr` stage, and the search outside notes nothing anywhere."""
    from svt_av1_psyex_tpu_torch.bitstream.tables import FrameCdfs
    from svt_av1_psyex_tpu_torch.codec import restoration as CR
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig
    from svt_av1_psyex_tpu_torch.codec.rd import compute_rdmult

    saved = os.environ.get("SVT_TPU_TIMING")
    os.environ["SVT_TPU_TIMING"] = "1"
    try:
        a, b = (Av1Encoder(SequenceConfig(width=64, height=64), preset=6,
                           device="cpu") for _ in range(2))
        small = _frames(2, 64, 64)
        a.encode_frame(small[0], 120, force_key=True)
        # a far larger plane than the encoders': its search's host tier
        # takes longer than either encoder's whole `lr` stage
        src = _frames(1, 512, 512)[0][0].astype(np.int32)
        dgd = np.clip(src + np.random.default_rng(5).integers(
            -3, 4, src.shape), 0, 255).astype(np.int32)
        CR.search_plane(src, dgd, dgd, 512, 512, 0, 64, 8,
                        compute_rdmult(120, 8), False, 6,
                        CR.type_cost_tables(FrameCdfs(120)),
                        device=torch.device("cpu"))
        b.encode_frame(small[0], 120, force_key=True)
        a.encode_frame(small[1], 120, force_key=True)
    finally:
        _set_env("SVT_TPU_TIMING", saved)
    for enc in (a, b):
        t = enc.timing
        assert t["lr.build"] > 0 and t["lr.exact"] > 0
        assert t["lr.build"] + t["lr.exact"] <= t["lr"]
    assert a.timing is not b.timing
