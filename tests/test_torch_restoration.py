"""The port's loop-restoration search (svt_av1_psyex_tpu_torch/device/
restoration.py, driven by codec/restoration.py) against the JAX
package's, on seeded inputs at small sizes.

The port scores in exact integers (int64 where the JAX package uses
float32, which the TPU forces there). Where the JAX package's float32
values are exact, the two agree bit for bit; where they are not (box
sums of x^2 past 2^24, and the JAX module's round-half-to-even of the
10-bit box sums), the port follows the host's exact arithmetic instead,
and a pick can differ. The stream tests show that every difference
comes from there: the JAX package with its two scoring functions
replaced by exact ones gives the port's stream byte for byte."""

import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: test files run
    in parallel worker processes, and torch's OpenMP pool in each of them
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _textured(w, h, bd, t=0, seed=5):
    """tests/test_restoration.py's textured frame at `bd` bits, moved 2
    px right per frame t, with fresh noise per frame."""
    rng = np.random.default_rng(seed + t)
    yy, xx = np.mgrid[0:h, 0:w]
    xx = xx + 2 * t
    y = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
         + 40 * ((xx // 24 + yy // 16) % 2) + rng.normal(0, 6, (h, w)))
    u = 110 + 30 * np.sin(xx[::2, ::2] / 9.0)
    v = 140 + 30 * np.cos(yy[::2, ::2] / 11.0)
    sc = 1 << (bd - 8)
    dt = np.uint8 if bd == 8 else np.uint16
    return [np.clip(p * sc, 0, 256 * sc - 1).astype(dt) for p in (y, u, v)]


def _stacks(bd, chroma, unit, w, h, seed=3):
    """The RU stacks that the port's codec.restoration._cand_device hands
    its device search for one plane of textured content and a noisy
    "CDEF output" of it: the grid's last row and column stretch, and
    each RU's mask covers its real extent. Returns the arguments of
    _device_search (pads, srcs, masks, init_taps, bit_depth, n_rounds,
    chroma, eps) as numpy."""
    import svt_av1_psyex_tpu_torch.codec.restoration as CR
    from svt_av1_psyex_tpu_torch.bitstream.tables import FrameCdfs
    from svt_av1_psyex_tpu_torch.codec.rd import compute_rdmult

    rng = np.random.default_rng(seed)
    src = _textured(w, h, bd, seed=seed)[0].astype(np.int32)
    amp = 3 << (bd - 8)
    dgd = np.clip(src + rng.integers(-amp, amp + 1, src.shape), 0,
                  (1 << bd) - 1).astype(np.int32)
    seen = []
    orig = CR._device_search

    def record(*args, **kwargs):
        seen.append(args[:8])
        return orig(*args, **kwargs)

    CR._device_search = record
    try:
        CR.search_plane(src, dgd, dgd, w, h, 1 if chroma else 0, unit, bd,
                        compute_rdmult(120, bd), chroma, 6,
                        CR.type_cost_tables(FrameCdfs(120)),
                        device=torch.device("cpu"))
    finally:
        CR._device_search = orig
    (args,) = seen
    return args


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


# small 8-bit RUs keep every float32 sum of the JAX package below 2^24
SMALL8 = dict(unit=16, w=40, h=36)
# 10-bit RUs of up to 48 x 48 samples
TEN = dict(unit=32, w=88, h=72)


def _jax_descent(args, n_rounds, t0):
    import jax.numpy as jnp

    from svt_av1_psyex_tpu.device.restoration import wiener_descent

    pads, srcs, masks, init, bd, _, chroma, _ = args
    t, b = wiener_descent(jnp.asarray(pads), jnp.asarray(srcs),
                          jnp.asarray(masks), jnp.asarray(init[:, :t0]), bd,
                          n_rounds, chroma)
    return np.asarray(t), np.asarray(b)


@pytest.mark.parametrize("bd", [8, 10])
def test_wiener_sse_matches_jax(bd):
    """Every (RU, tap set) SSE equals the JAX package's (its float32
    sums are exact here: below 2^24)."""
    import jax.numpy as jnp

    from svt_av1_psyex_tpu.device.restoration import wiener_sse as jax_sse

    from svt_av1_psyex_tpu_torch.device.restoration import _kern7, wiener_sse

    pads, srcs, masks, init, _, _, _, _ = _stacks(bd, False, **SMALL8)
    hks, vks = _kern7(_t(init[:, :, 0])), _kern7(_t(init[:, :, 1]))
    got = wiener_sse(_t(pads), _t(srcs), _t(masks), hks, vks, bd)
    want = np.asarray(jax_sse(jnp.asarray(pads), jnp.asarray(srcs),
                              jnp.asarray(masks), jnp.asarray(hks.numpy()),
                              jnp.asarray(vks.numpy()), bit_depth=bd))
    assert got.dtype == torch.int64 and got.shape == init.shape[:2]
    assert int(got.max()) < 1 << 24
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("n_rounds", [0, 2])
def test_wiener_descent_matches_jax_8bit(chroma, n_rounds):
    """Taps and best SSE equal the JAX package's, with one initial
    candidate and with several."""
    from svt_av1_psyex_tpu_torch.device.restoration import wiener_descent

    args = _stacks(8, chroma, **SMALL8)
    pads, srcs, masks, init = args[:4]
    assert init.shape[1] >= 2
    for t0 in (1, init.shape[1]):
        taps, best = wiener_descent(_t(pads), _t(srcs), _t(masks),
                                    _t(init[:, :t0]), 8, n_rounds, chroma)
        want_taps, want_best = _jax_descent(args, n_rounds, t0)
        assert np.array_equal(taps.numpy(), want_taps), t0
        assert np.array_equal(best.numpy(), want_best.astype(np.int64)), t0


@pytest.mark.parametrize("chroma", [False, True])
def test_wiener_descent_matches_jax_10bit(chroma):
    """10-bit RUs: the taps equal the JAX package's on every RU, except
    where the JAX package's own float32 SSEs of the two tap sets tie
    within float32 rounding (counted and printed; none on these
    inputs)."""
    import jax.numpy as jnp

    from svt_av1_psyex_tpu.device.restoration import wiener_sse as jax_sse

    from svt_av1_psyex_tpu_torch.device.restoration import (
        _kern7,
        wiener_descent,
        wiener_sse,
    )

    args = _stacks(10, chroma, **TEN)
    pads, srcs, masks, init = args[:4]
    ties = []
    for n_rounds in (0, 2):
        taps, best = wiener_descent(_t(pads), _t(srcs), _t(masks), _t(init),
                                    10, n_rounds, chroma)
        want, _ = _jax_descent(args, n_rounds, init.shape[1])
        for r in np.nonzero((taps.numpy() != want).any(axis=(1, 2)))[0]:
            both = np.stack([taps.numpy()[r], want[r]])[None]
            k = [_kern7(_t(both[:, :, d])) for d in (0, 1)]
            f32 = np.asarray(jax_sse(
                jnp.asarray(pads[r:r + 1]), jnp.asarray(srcs[r:r + 1]),
                jnp.asarray(masks[r:r + 1]), jnp.asarray(k[0].numpy()),
                jnp.asarray(k[1].numpy()), bit_depth=10))[0]
            exact = wiener_sse(_t(pads[r:r + 1]), _t(srcs[r:r + 1]),
                               _t(masks[r:r + 1]), *k, 10)[0]
            assert abs(float(f32[0]) - float(f32[1])) <= 4 * np.spacing(
                np.float32(f32.max())), (r, f32, exact)
            ties.append((n_rounds, int(r), f32.tolist(), exact.tolist()))
    print(f"10-bit Wiener descent, chroma={chroma}: {pads.shape[0]} RUs, "
          f"{len(ties)} float32 ties in the JAX package: {ties}")


def _corr_pair(bd, eps, chroma=False, **size):
    import jax.numpy as jnp

    from svt_av1_psyex_tpu.device.restoration import sgr_corr as jax_corr

    from svt_av1_psyex_tpu_torch.device.restoration import sgr_corr

    pads, srcs, masks = _stacks(bd, chroma, **size)[:3]
    got = sgr_corr(_t(pads), _t(srcs), _t(masks), tuple(eps), bd)
    want = np.asarray(jax_corr(jnp.asarray(pads), jnp.asarray(srcs),
                               jnp.asarray(masks), tuple(eps), bit_depth=bd))
    assert got.dtype == torch.int64
    assert got.shape == (pads.shape[0], len(eps), 6)
    return got.numpy(), want


P6_EPS = (0, 4, 9, 11, 14)


@pytest.mark.parametrize("eps", [P6_EPS, tuple(range(16))],
                         ids=["p6", "all"])
def test_sgr_corr_matches_jax_8bit(eps):
    """Below 2^24 the correlations equal the JAX package's as numbers."""
    got, want = _corr_pair(8, eps, **SMALL8)
    assert np.abs(got).max() < 1 << 24
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("eps", [P6_EPS, tuple(range(16))],
                         ids=["p6", "all"])
def test_sgr_corr_matches_jax_10bit(eps):
    """10-bit: the JAX package rounds its float32 B = (256 - A) * b * 1/n
    (about 10^9, so up to 128 units) before the floor that drops 12 bits,
    and its box sums of x^2 pass 2^24; the filtered planes then move by a
    unit here and there, and the correlations, sums of squares of the
    filters' small deviations, by up to 8% of each (RU, ep) row's largest
    term (4.3% on these inputs). ss involves no filter and is equal.
    Prints how many entries differ."""
    got, want = _corr_pair(10, eps, **TEN)
    scale = np.abs(got).max(axis=2, keepdims=True)
    err = np.abs(got - want) / scale
    print(f"10-bit sgr_corr, {len(eps)} eps: {(got != want).mean():.4f} of "
          f"the entries differ from the JAX package's, largest by "
          f"{err.max():.3g} of the row's largest term")
    assert np.array_equal(got[..., 5], want[..., 5].astype(np.int64))
    assert err.max() <= 0.08


@pytest.mark.parametrize("bd", [8, 10])
def test_sgr_flt_equals_host_exact(bd):
    """The batched guided filters equal the host's exact sgr_flt bit for
    bit, for every ep, on each RU's real extent (and on a stack of one
    unpadded RU)."""
    from svt_av1_psyex_tpu_torch.device.restoration import _sgr_flt
    from svt_av1_psyex_tpu_torch.ops.restoration import sgr_flt

    pads, _, masks = _stacks(bd, False, **TEN)[:3]
    rh = masks.any(axis=2).sum(axis=1)
    rw = masks.any(axis=1).sum(axis=1)
    assert len(set(rh)) > 1 and len(set(rw)) > 1   # stretched last row/col
    one = pads[-1:, :rh[-1] + 6, :rw[-1] + 6]
    for ep in range(16):
        batch = _sgr_flt(torch.from_numpy(pads).long(), ep, bd)
        alone = _sgr_flt(torch.from_numpy(one).long(), ep, bd)
        for i in range(pads.shape[0]):
            want = sgr_flt(pads[i, :rh[i] + 6, :rw[i] + 6], ep, bd)
            for g, a, wnt in zip(batch, alone, want):
                assert (g is None) == (wnt is None)
                if wnt is not None:
                    assert np.array_equal(g[i, :rh[i], :rw[i]].numpy(), wnt)
                    if i == pads.shape[0] - 1:
                        assert np.array_equal(a[0].numpy(), wnt)


def test_device_search_on_cpu_is_the_host_oracles_integers():
    """_device_search's Wiener SSE is the host search's exact integer
    (ops/restoration.wiener_convolve) for the winning taps."""
    import svt_av1_psyex_tpu_torch.codec.restoration as CR
    from svt_av1_psyex_tpu_torch.ops.restoration import wiener_convolve

    args = _stacks(10, False, **TEN)
    pads, srcs, masks = args[:3]
    taps, best, corr = CR._device_search(*args, torch.device("cpu"))
    assert taps.dtype == np.int32 and best.dtype == np.int64
    assert corr.dtype == np.int64 and corr.shape[1:] == (len(P6_EPS), 6)
    for r in range(pads.shape[0]):
        h, w = masks[r].any(axis=1).sum(), masks[r].any(axis=0).sum()
        out = wiener_convolve(pads[r, :h + 6, :w + 6], taps[r, 0], taps[r, 1],
                              10)
        assert int(((srcs[r, :h, :w] - out) ** 2).sum()) == best[r]


# ---- streams ----------------------------------------------------------

W, H, GOP, Q = 200, 120, 4, 120


def _frames(bd, n=GOP + 1):
    return [_textured(W, H, bd, t) for t in range(n)]


@pytest.fixture
def exact_jax_scoring(monkeypatch):
    """The JAX package's LR search with its two device scoring functions
    replaced by the port's exact ones (numpy in, numpy out)."""
    import svt_av1_psyex_tpu.device.restoration as JDR

    from svt_av1_psyex_tpu_torch.device import restoration as PDR

    def descent(pads, srcs, masks, init, bd, n_rounds, chroma):
        taps, best = PDR.wiener_descent(_t(pads), _t(srcs), _t(masks),
                                        _t(init), bd, n_rounds, chroma)
        return taps.numpy(), best.numpy()

    def corr(pads, srcs, masks, eps, bd):
        return PDR.sgr_corr(_t(pads), _t(srcs), _t(masks), eps, bd).numpy()

    monkeypatch.setattr(JDR, "wiener_descent", descent)
    monkeypatch.setattr(JDR, "sgr_corr", corr)


def _spy_lr(monkeypatch, cls):
    """Records, per coded frame, (lr_frame_types, per plane the units'
    (type, params)) of cls's loop-restoration pass."""
    seen = []
    orig = cls._search_apply_lr

    def spy(self, st):
        orig(self, st)
        seen.append((st["fr"].lr_frame_types,
                     [None if i is None else [u[:2] for u in i.units]
                      for i in st["tw"].lr_infos]))

    monkeypatch.setattr(cls, "_search_apply_lr", spy)
    return seen


def _gop(cls, bd, **kwargs):
    """KF + one 4-frame RA mini-GOP at preset 6 (LR on by default),
    driven as test_torch_slice.encode_gop drives it."""
    import importlib

    from svt_av1_psyex_tpu_torch.codec.encoder import encode_plans

    pkg = cls.__module__.split(".")[0]
    seq_cls = importlib.import_module(f"{pkg}.bitstream.headers").SequenceConfig
    plan_minigop = importlib.import_module(f"{pkg}.codec.gop").plan_minigop
    frames = _frames(bd)
    enc = cls(seq_cls(width=W, height=H, bit_depth=bd), preset=6, **kwargs)
    assert enc.seq.enable_restoration
    tus = [enc.encode_frame(frames[0], Q, force_key=True)]
    plans = plan_minigop(0, 1, GOP, future_slot=1)
    more, shown = encode_plans(enc, plans, dict(enumerate(frames)), Q)
    coded = [0] + [1 + i for i, pl in enumerate(plans)
                   if pl.show_existing_slot is None]
    return tus + more, [enc.last_recon] + shown, coded


@pytest.fixture(scope="module")
def gop10():
    """The 10-bit p6 GOP through the port and through the JAX package."""
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder

    mp = pytest.MonkeyPatch()
    try:
        lr_port = _spy_lr(mp, Av1Encoder)
        lr_jax = _spy_lr(mp, JaxEncoder)
        port = _gop(Av1Encoder, 10, device="cpu")
        ref = _gop(JaxEncoder, 10)
    finally:
        mp.undo()
    return port, lr_port, ref, lr_jax


def test_gop_10bit_p6_lr_equals_jax_with_exact_scoring(gop10,
                                                       exact_jax_scoring,
                                                       monkeypatch):
    """A 10-bit preset-6 KF + 4-frame mini-GOP with LR on: the port's
    stream equals, byte for byte, the JAX package's with exact LR
    scoring, and LR is engaged."""
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    (tus, recons, _), lr_port = gop10[0], gop10[1]
    lr_exact = _spy_lr(monkeypatch, JaxEncoder)
    ref_tus, ref_recons, _ = _gop(JaxEncoder, 10)
    assert len(tus) == len(ref_tus) == GOP + 3
    for i, (a, b) in enumerate(zip(tus, ref_tus)):
        assert a == b, f"TU {i} differs"
    for p, q in zip(recons, ref_recons):
        assert all(np.array_equal(a, b) for a, b in zip(p, q))
    assert lr_port == lr_exact
    assert any(any(t) for t, _ in lr_port)


def test_gop_10bit_p6_lr_against_jax_float32_scoring(gop10):
    """Against the JAX package as it is: the first TU that differs is a
    frame whose LR units differ (the float32 scoring picked otherwise);
    every TU before it is identical. Prints the differing TUs and RUs."""
    (tus, _, coded), lr_port, (ref_tus, _, _), lr_jax = gop10
    assert len(tus) == len(ref_tus)
    assert len(lr_port) == len(lr_jax) == len(coded)
    diff = [i for i, (a, b) in enumerate(zip(tus, ref_tus)) if a != b]
    units = [sum(a != b for pa, pb in zip(fp[1], fj[1]) if pa is not None
                 for a, b in zip(pa, pb))
             for fp, fj in zip(lr_port, lr_jax)]
    print(f"10-bit p6 GOP against the JAX package's float32 LR scoring: "
          f"TUs {diff} of {len(tus)} differ; RUs with another (type, "
          f"params) per coded frame: {units}")
    if diff:
        first = coded.index(diff[0])
        assert units[first] > 0
        assert all(u == 0 for u in units[:first])


def test_api_p6_crf30_lr_equals_jax_with_exact_scoring(exact_jax_scoring):
    """The same 5 frames through the port's SvtAv1Encoder at preset 6,
    CRF 30 (TF, TPL and LR on at their defaults): the packets equal the
    JAX API's with exact LR scoring."""
    from svt_av1_psyex_tpu.api.encoder import SvtAv1Encoder as JaxApi

    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    def run(api):
        c = api.config
        c.source_width, c.source_height = W, H
        c.encoder_bit_depth = 10
        c.enc_mode, c.crf, c.hierarchical_levels = 6, 30, 2
        c.frame_rate_numerator, c.frame_rate_denominator = 30, 1
        api.init()
        assert c.enable_tf and api._tpl_on()
        assert api._enc.seq.enable_restoration and api._enc.seq.bit_depth == 10
        for t, f in enumerate(_frames(10)):
            api.send_picture(f, t)
        api.send_picture(None)
        pkts = []
        while (p := api.get_packet()) is not None:
            pkts.append(p)
        return pkts

    got = run(SvtAv1Encoder(device="cpu"))
    want = run(JaxApi())
    assert len(got) == len(want) >= GOP + 2
    for a, b in zip(got, want):
        assert (a.pts, a.frame_type, a.data) == (b.pts, b.frame_type, b.data)
