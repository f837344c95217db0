"""The plain version of the CDEF kernel (svt_av1_psyex_tpu_torch/ops/
cdef_ref.py) against the host C (native/cdef.c through the port's native/
cdefc.py), and the kernel's frame runner (ops/cuda/cdef.py `CdefFrames`)
on the CPU, where it runs that plain version.

The C is the oracle, and the contract is equality: each case runs
`cdef_search_frame_c` with its C library wrapped, so that every input it
hands the C (the unit mask, the searched units, the directions, the
chosen strengths) and every output (directions and variances, the int64
mse tables, the filtered planes) is seen, and the plain version is held
to each, bit for bit. Then two short encodes through the frame runner
match the host C's bytes, and `_pick_cdef` picks the kernel on a CUDA
device only. The kernel itself is held to both on the card in
tests/test_torch_kernels.py (marked `cuda`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu_torch.codec.rd import compute_rdmult, rdcost  # noqa: E402
from svt_av1_psyex_tpu_torch.native import cdefc  # noqa: E402
from svt_av1_psyex_tpu_torch.ops import cdef_ref  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.cdef import candidate_strengths  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.cuda.cdef import CdefFrames  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: test files run in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def c_lib():
    if not cdefc.available():
        pytest.skip("the native C tier does not build here")
    return cdefc._lib()


def _frame(seed, mi_rows, mi_cols, bit_depth, mono, skip):
    """Aligned int32 smooth source planes (chroma with the encoder's +4
    overhang margin), a noisy recon that CDEF can clean, and a per-mi skip
    grid: "random" (30% skips), "dense" (70% skips) or "single" (random,
    but the first filter block all skipped and the second with a single
    unit that is not)."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    h, w = mi_rows * 4, mi_cols * 4
    shapes = [(h, w)] + [(h // 2 + 4, w // 2 + 4)] * (0 if mono else 2)
    src = []
    for sh in shapes:
        yy, xx = np.mgrid[0:sh[0], 0:sh[1]]
        wave = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
        src.append((wave * maxv).astype(np.int32))
    amp = 6 << (bit_depth - 8)
    recon = [np.clip(s + rng.integers(-amp, amp + 1, s.shape), 0,
                     maxv).astype(np.int32) for s in src]
    skip_g = (rng.random((mi_rows, mi_cols))
              < (0.7 if skip == "dense" else 0.3)).astype(np.uint8)
    if skip == "single":
        skip_g[:16, :32] = 1
        skip_g[6:8, 16:18] = 0   # unit (3, 8), in filter block (0, 1)
    return recon, src, skip_g


class _Spy:
    """The C library as cdefc calls it, keeping copies of what each entry
    point was given and gave back."""

    def __init__(self, lib):
        self.lib = lib
        self.seen = {}

    @staticmethod
    def _arr(ptr, n):
        return np.ctypeslib.as_array(ptr, shape=(n,)).copy()

    def svt_cdef_dirs(self, *a):
        self.lib.svt_cdef_dirs(*a)
        n = a[2] * a[3]
        self.seen.update(dirs=self._arr(a[5], n), var=self._arr(a[6], n))

    def svt_cdef_search(self, *a):
        n, nfb = a[11] * a[12], a[11] * a[12] // 64
        self.seen.update(smask=self._arr(a[10], n),
                         cands=self._arr(a[16], a[17]),
                         damp=(a[18], a[19], a[20]))
        self.lib.svt_cdef_search(*a)
        self.seen.update(mse0=self._arr(a[22], nfb * a[17]),
                         mse1=self._arr(a[23], nfb * a[17]))

    def svt_cdef_apply(self, *a):
        n = a[15] * a[16]
        self.seen.update(mask=self._arr(a[14], n), y_gi=self._arr(a[19], n),
                         uv_gi=self._arr(a[20], n))
        self.lib.svt_cdef_apply(*a)


def _rd_fn(q, bit_depth):
    rdm = compute_rdmult(q, bit_depth)
    return lambda rate, dist: rdcost(rdm, rate, dist)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = {  # mi_rows, mi_cols (200x136, 72x40, 320x192), bits, level,
    # monochrome, skips
    "200x136_8bit_l5": (34, 50, 8, 5, False, "random"),
    "72x40_10bit_l1": (10, 18, 10, 1, False, "random"),
    "200x136_10bit_l2_dense": (34, 50, 10, 2, False, "dense"),
    "320x192_8bit_l7_single": (48, 80, 8, 7, False, "single"),
    "200x136_10bit_l5_mono": (34, 50, 10, 5, True, "random"),
    "72x40_8bit_l7_mono_single": (10, 18, 8, 7, True, "single"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_equals_the_c(case, c_lib, monkeypatch):
    mi_rows, mi_cols, bd, level, mono, skip = CASES[case]
    recon, src, skip_g = _frame(len(case), mi_rows, mi_cols, bd, mono, skip)
    q, cs = 140 + 20 * level, bd - 8
    spy = _Spy(c_lib)
    monkeypatch.setattr(cdefc, "_lib", lambda: spy)
    rec_c = [p.copy() for p in recon]
    want = cdefc.cdef_search_frame_c(rec_c, src, skip_g, mi_rows, mi_cols, q,
                                     _rd_fn(q, bd), level=level,
                                     bit_depth=bd)
    seen = spy.seen
    assert want is not None

    mask = cdef_ref.unit_mask(skip_g, mi_rows, mi_cols)
    grid = mask.shape
    coded = (mi_rows * 4, mi_cols * 4)
    assert np.array_equal(mask.reshape(-1), seen["mask"])
    units = cdef_ref.search_units(mask, level)
    assert np.array_equal(units, np.flatnonzero(seen["smask"]))
    if skip == "single":
        fb_units = [u for u in units
                    if u // grid[1] // 8 == 0 and u % grid[1] // 8 == 1]
        assert fb_units == [3 * grid[1] + 8]
    cands = np.asarray(candidate_strengths(level), np.int32)
    assert np.array_equal(cands, seen["cands"])

    dirs, var = cdef_ref.cdef_dirs_ref(torch.from_numpy(recon[0]), coded,
                                       grid, cs)
    assert np.array_equal(dirs.numpy(), seen["dirs"])
    assert np.array_equal(var.numpy(), seen["var"])

    ydamp, cdamp, _ = seen["damp"]
    mse0, mse1 = cdef_ref.cdef_search_ref(
        _t(recon), _t(src[:len(recon)]), coded, torch.from_numpy(units),
        grid, dirs, var, torch.from_numpy(cands), ydamp, cdamp, cs)
    assert np.array_equal(mse0.numpy().reshape(-1), seen["mse0"])
    assert np.array_equal(mse1.numpy().reshape(-1), seen["mse1"])
    assert seen["mse0"].any() and (mono or seen["mse1"].any())

    gis = [seen["y_gi"], seen["uv_gi"]]
    rng = np.random.default_rng(7)
    for y_gi, uv_gi in (gis, cands[rng.integers(0, len(cands),
                                                (2, mask.size))]):
        planes = cdef_ref.cdef_apply_ref(
            _t(recon), coded, torch.from_numpy(mask), dirs, var,
            torch.from_numpy(y_gi.astype(np.int32)),
            torch.from_numpy(uv_gi.astype(np.int32)), ydamp, cdamp, cs)
        rec_ref = [p.copy() for p in recon]
        _c_apply(c_lib, recon, rec_ref, mask, seen, y_gi, uv_gi, cs,
                 mi_rows, mi_cols)
        for got, ref in zip(planes, rec_ref):
            assert np.array_equal(got.numpy(), ref)
        assert any(not np.array_equal(p.numpy(), r)
                   for p, r in zip(planes, recon))

    # the frame runner on the CPU: cdefc's result and planes
    rec_p = [p.copy() for p in recon]
    got = CdefFrames("cpu").search_frame(rec_p, src, skip_g, mi_rows, mi_cols,
                                         q, _rd_fn(q, bd), level=level,
                                         bit_depth=bd)
    assert got[:3] == want[:3] and got[4] == want[4]
    assert np.array_equal(got[3], want[3])
    for a, b in zip(rec_p, rec_c):
        assert np.array_equal(a, b)


def _c_apply(lib, recon, rec_out, mask, seen, y_gi, uv_gi, cs, mi_rows,
             mi_cols):
    """svt_cdef_apply on the C's padded planes, into rec_out."""
    from svt_av1_psyex_tpu_torch.device.cdef import _prep_frame

    skip_none = np.zeros((mi_rows, mi_cols), np.uint8)
    pads = _prep_frame(recon, recon, skip_none, mi_rows, mi_cols)[0]
    p32 = cdefc._p32
    chroma = len(recon) > 1
    pu, pv = (pads[1], pads[2]) if chroma else (pads[0], pads[0])
    ru, rv = (rec_out[1], rec_out[2]) if chroma else (rec_out[0],) * 2
    h, w = rec_out[0].shape
    hc, wc = rec_out[1].shape if chroma else (0, 0)
    ydamp, cdamp, _ = seen["damp"]
    lib.svt_cdef_apply(
        p32(pads[0]), pads[0].shape[1], p32(pu), p32(pv), pu.shape[1],
        p32(rec_out[0]), rec_out[0].shape[1], h, w, p32(ru), p32(rv),
        ru.shape[1], hc, wc,
        np.ascontiguousarray(mask.reshape(-1)).ctypes.data_as(cdefc._U8P),
        mask.shape[0], mask.shape[1], p32(seen["dirs"]), p32(seen["var"]),
        p32(np.ascontiguousarray(y_gi, np.int32)),
        p32(np.ascontiguousarray(uv_gi, np.int32)), ydamp, cdamp, cs,
        int(chroma))


def test_nothing_filterable_gives_none():
    recon, src, _ = _frame(3, 16, 16, 8, False, "random")
    skip_all = np.ones((16, 16), np.uint8)
    assert cdef_ref.unit_mask(skip_all, 16, 16) is None
    assert CdefFrames("cpu").search_frame(recon, src, skip_all, 16, 16, 140,
                                          lambda r, d: 0, level=5) is None


# ---- encodes: the frame runner's CPU path against the host C ----------


def _texture(w, h, n, bit_depth):
    """A band-limited texture translating 5 px right and 3 down a frame
    over a drifting sinusoid (tools/mkclip.py's texture), 4:2:0."""
    maxv = (1 << bit_depth) - 1
    dt = np.uint8 if bit_depth == 8 else np.uint16
    rng = np.random.RandomState(99)
    big = rng.normal(0, 1, (h + 64, w + 64)).astype(np.float32)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) * 0.25
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cyy, cxx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float32)
    frames = []
    for t in range(n):
        tex = big[3 * t: 3 * t + h, 5 * t: 5 * t + w]
        y = (0.5 + 0.28 * np.sin(2 * np.pi * (xx + 2.0 * t) / 97.0)) * maxv
        y = np.clip(y + tex * 0.18 * maxv, 0, maxv).astype(dt)
        u = (0.5 + 0.25 * np.sin(2 * np.pi * (cxx / (w // 2) + 0.02 * t)))
        v = (0.5 + 0.25 * np.cos(2 * np.pi * (cyy / (h // 2) - 0.015 * t)))
        frames.append([y] + [np.clip(c * maxv, 0, maxv).astype(dt)
                             for c in (u, v)])
    return frames


def _blobs(w, h, n, bit_depth):
    from svt_av1_psyex_tpu_torch.utils.clips import synth_frame
    from svt_av1_psyex_tpu_torch.utils.y4m import VideoFormat

    fmt = VideoFormat(w, h, bit_depth)
    return [synth_frame(fmt, t) for t in range(n)]


ENCODES = {  # clip, bits, preset: a keyframe and a 4-frame mini-GOP
    "p8_texture_8bit": (_texture, 8, 8),
    "p6_blobs_10bit": (_blobs, 10, 6),
}


def _encode(frames, bit_depth, preset):
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    api = SvtAv1Encoder(device="cpu")
    cfg = api.config
    cfg.source_height, cfg.source_width = frames[0][0].shape
    cfg.encoder_bit_depth = bit_depth
    cfg.enc_mode, cfg.crf, cfg.hierarchical_levels = preset, 30, 2
    cfg.frame_rate_numerator, cfg.frame_rate_denominator = 30, 1
    api.init()
    for t, f in enumerate(frames):
        api.send_picture([p.copy() for p in f], t)
    api.send_picture(None)
    tus = []
    while (pkt := api.get_packet()) is not None:
        if not pkt.is_eos:
            tus.append(pkt.data)
    return tus, api._enc


@pytest.mark.parametrize("case", list(ENCODES))
def test_encode_through_the_frame_runner_matches_the_host_c(
        case, monkeypatch):
    """The kernel's frame runner (taken here by making _pick_cdef think it
    is on a card: on the CPU it runs the plain version) codes the bytes of
    the host C, which a CPU device takes, frame for frame. (The numpy
    search that SVT_TPU_HOST_CDEF=1 selects is no oracle here: on the
    10-bit clip it codes one TU of the mini-GOP otherwise than the C.)"""
    clip, bd, preset = ENCODES[case]
    frames = clip(128, 96, 5, bd)
    host, enc = _encode(frames, bd, preset)
    assert enc._cdef_card is None
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder

    monkeypatch.setattr(Av1Encoder, "_cdef_on_card", lambda self: True)
    runner, enc = _encode(frames, bd, preset)
    assert len(runner) >= 5 and all(runner)
    assert enc._cdef_card is not None and not enc._cdef_card.uses_kernel
    assert runner == host


def _encoder():
    from svt_av1_psyex_tpu_torch.codec.encoder import (
        Av1Encoder,
        SequenceConfig,
    )

    return Av1Encoder(SequenceConfig(width=64, height=64), preset=8,
                      device="cpu")


@pytest.mark.parametrize("env", [None, "SVT_TPU_HOST_CDEF",
                                 "SVT_TPU_DEVICE_CDEF"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_pick_cdef(device, env, monkeypatch):
    """A CUDA device takes the kernel's frame runner, a CPU device the C;
    SVT_TPU_HOST_CDEF=1 keeps the host path (the numpy search) and
    SVT_TPU_DEVICE_CDEF=1 the plain device CDEF of device/cdef.py, on
    either device."""
    from svt_av1_psyex_tpu_torch.ops import cdef as ops_cdef

    for k in ("SVT_TPU_HOST_CDEF", "SVT_TPU_DEVICE_CDEF"):
        monkeypatch.delenv(k, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    enc = _encoder()
    enc.device = torch.device(device, 0) if device == "cuda" else enc.device
    got = enc._pick_cdef()
    if env == "SVT_TPU_DEVICE_CDEF":
        assert got.func.__name__ == "cdef_search_frame_device"
        assert got.keywords == {"device": enc.device}
    elif env == "SVT_TPU_HOST_CDEF":
        assert got is ops_cdef.cdef_search_frame
    elif device == "cuda":
        card = enc._cdef_card
        assert got == card.search_frame and card.uses_kernel
        assert card.device == enc.device and card.kernels == "hand"
    else:
        assert got is cdefc.cdef_search_frame_c
        assert enc._cdef_card is None


def test_cdef_bound():
    """ops/cuda/roofline.py cdef_bound: the taps of each strength index,
    the search's operations at one unit and candidate counted by hand,
    and at the 720p cell's search level the search bound by its
    operations, the direction search by its bytes."""
    from svt_av1_psyex_tpu_torch.ops.cuda import roofline as rl

    assert list(rl._cdef_taps([0, 1, 3, 4, 5, 63])) == [0, 8, 8, 4, 12, 12]
    ms = 1e3 / rl.INT32_OPS_PER_S
    for chroma, ops in ((True, 64 * (120 + 8) + 32 * (120 + 3)),
                        (False, 64 * (120 + 8))):
        b = rl.cdef_bound((64, 64), 1, [5], [5], [5], chroma)
        assert b["search"]["ops_ms"] == pytest.approx(ops * ms)
        assert b["apply"]["ops_ms"] == pytest.approx(
            (64 + (32 if chroma else 0)) * 120 * ms)
    n = 180 * 320 // 4
    b = rl.cdef_bound((720, 1280), 7200, candidate_strengths(5),
                      np.full(n, 5), np.full(n, 5), True)
    assert b["search"]["bound_by"] == "operations"
    assert b["dirs"]["bound_by"] == "bytes"
    assert b["search"]["bound_ms"] > b["dirs"]["bound_ms"]
