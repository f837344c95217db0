"""The port's integer analysis tier (svt_av1_psyex_tpu_torch/ops/
int_kernels.py) against the JAX package's ops/jax_kernels.py, and the
port's analysis under SVT_TPU_INTDCT=1 (its `_USE_MATDCT` flag off)
against the JAX package's under the same switch.

The transforms and the quantizer are exact integers in both packages and
must be equal bit for bit, including the int32 products that wrap. The
float32 outputs are sums of those integers: `var8x8` is a mean of 64
rounded squares (to rtol 1e-5: 64 roundings of 2^-24 each bound the
difference by 3.8e-6 of the value), and J sums the float32 dist and the
log2 rate terms in another order than XLA (rtol 1e-5, as
tests/test_torch_inter.py holds the float path). Both packages read the
switch once, at import, so the tests patch their module flags, not the
environment, and drop the JAX package's traced programs around it."""

import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from svt_av1_psyex_tpu.device import intra as jax_intra  # noqa: E402
from svt_av1_psyex_tpu.ops import jax_kernels as jk  # noqa: E402
from svt_av1_psyex_tpu.ops.txfm import forward_txfm2d  # noqa: E402
from svt_av1_psyex_tpu_torch.device import intra as port_intra  # noqa: E402
from svt_av1_psyex_tpu_torch.ops import int_kernels as ik  # noqa: E402

SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (16, 8),
         (8, 32), (16, 64)]
DEPTHS = (64, 32, 16, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: test files run
    in parallel worker processes, and torch's OpenMP pool in each of them
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def intdct(monkeypatch):
    """Both packages' analysis on the integer networks."""
    jax.clear_caches()   # the JAX flag is read while tracing
    monkeypatch.setattr(jax_intra, "_USE_MATDCT", False)
    monkeypatch.setattr(port_intra, "_USE_MATDCT", False)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _types(w, h):
    return (0, 9) if max(w, h) <= 32 else (0,)


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_forward_matches_jax(size):
    """tests/test_jax_kernels.py's forward case, 8- and 10-bit residual
    amplitudes: the port equals forward_txfm2d_jnp and the numpy spec."""
    w, h = size
    rng = np.random.RandomState(0)
    for amp in (255, 1023):
        res = rng.randint(-amp, amp + 1, size=(3, h, w)).astype(np.int32)
        for tx_type in _types(w, h):
            got = ik.forward_txfm2d_int(torch.from_numpy(res), w, h, tx_type)
            assert got.dtype == torch.int32
            want = np.asarray(jk.forward_txfm2d_jnp(res, w, h, tx_type))
            assert np.array_equal(got.numpy(), want), (size, tx_type, amp)
            assert np.array_equal(want, forward_txfm2d(res, w, h, tx_type))


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_inverse_matches_jax(size):
    """tests/test_jax_kernels.py's inverse case (coefficients up to
    2^14, so the row clamp engages at 8 bits), at 8 and 10 bits."""
    w, h = size
    rng = np.random.RandomState(1)
    cw, ch = min(w, 32), min(h, 32)
    co = rng.randint(-(1 << 14), 1 << 14, size=(3, ch, cw)).astype(np.int32)
    for bd in (8, 10):
        for tx_type in _types(w, h):
            got = ik.inverse_txfm2d_int(torch.from_numpy(co), w, h, tx_type,
                                        bd)
            assert got.dtype == torch.int32 and got.shape == (3, h, w)
            want = np.asarray(jk.inverse_txfm2d_jnp(co, w, h, tx_type, bd))
            assert np.array_equal(got.numpy(), want), (size, tx_type, bd)


@pytest.mark.parametrize("qindex", [4, 60, 200])
@pytest.mark.parametrize("log_scale", [0, 1, 2])
def test_quantize_int_matches_jax(qindex, log_scale):
    """quantize_int equals quantize_jnp, including coefficients whose
    int32 product tmp5 * quant passes 2^31 (at small q) and wraps."""
    from svt_av1_psyex_tpu_torch.ops.quant import build_plane_quant

    pq = build_plane_quant(qindex, 0, 0, 8)
    dc = tuple(int(a[0]) for a in (pq.zbin, pq.round, pq.quant,
                                   pq.quant_shift, pq.dequant))
    ac = tuple(int(a[1]) for a in (pq.zbin, pq.round, pq.quant,
                                   pq.quant_shift, pq.dequant))
    rng = np.random.RandomState(qindex + log_scale)
    co = np.concatenate([
        rng.randint(-300, 301, (40, 64)),
        rng.randint(-(1 << 17), 1 << 17, (40, 64))]).astype(np.int32)
    q, dq = ik.quantize_int(torch.from_numpy(co), dc, ac, log_scale)
    wq, wdq = jk.quantize_jnp(jnp.asarray(co), dc, ac, log_scale)
    assert q.dtype == dq.dtype == torch.int32
    assert np.array_equal(q.numpy(), np.asarray(wq))
    assert np.array_equal(dq.numpy(), np.asarray(wdq))
    if qindex == 4:
        rnd = (ac[1] + (1 << log_scale >> 1)) >> log_scale
        tmp5 = np.minimum(np.abs(co[40:]).astype(np.int64) + rnd, 32767) << 5
        prod = tmp5 * ac[2]
        # the product leaves int32 and wraps
        assert ((prod >= 1 << 31) | (prod < -(1 << 31))).any()


def _frames_for_analysis():
    rng = np.random.RandomState(2)
    luma = rng.randint(0, 256, size=(128, 192)).astype(np.int32)
    smooth = np.add.outer(np.linspace(20, 230, 128),
                          np.linspace(0, 60, 192)).astype(np.int32)
    return {"noise": luma, "ramp": smooth,
            "flat": np.full((64, 64), 128, np.int32)}


@pytest.mark.parametrize("blk", [64, 32])
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_frame_intra_analysis_matches_jax(blk, bit_depth):
    """sse, sad and pred_dc equal the JAX function's; var8x8 to rtol
    1e-5; the shapes and the flat frame of tests/test_jax_kernels.py."""
    for name, luma in _frames_for_analysis().items():
        luma = luma << (bit_depth - 8)
        got = ik.frame_intra_analysis(torch.from_numpy(luma), blk=blk,
                                      bit_depth=bit_depth)
        want = jk.frame_intra_analysis(jnp.asarray(luma), blk=blk,
                                       bit_depth=bit_depth)
        b = (luma.shape[0] // blk) * (luma.shape[1] // blk)
        assert got["sse"].shape == (5, b)
        assert got["var8x8"].shape == (b, blk * blk // 64)
        for k in ("sse", "sad", "pred_dc"):
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (
                name, k)
        assert np.allclose(got["var8x8"].numpy(), np.asarray(want["var8x8"]),
                           rtol=1e-5, atol=1e-4), name
        if name == "flat" and bit_depth == 8:
            assert int(got["sse"][0, 0]) == 0
            assert float(got["var8x8"].max()) == 0.0


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_fullloop_int_matches_jax_chain(n, bit_depth, intdct):
    """fullloop_int against the JAX package's integer chain
    (device/intra.py _fwd_dct2d -> _quantize_analysis -> _rate_dist,
    SVT_TPU_INTDCT=1): eob and the inverse equal, sse and dist equal to
    float32 rounding, the rate proxy within 1 (of its 1/512-bit units:
    its up to 1024 float32 log2 terms are summed in another order before
    the truncation, which moves it by one on up to an eighth of the
    blocks of the large sizes). sse is held
    to the exact float64 sum (rtol 1e-6); dist to the JAX package's
    float32 sum of up to 4096 terms in another order (rtol 1e-4, below
    the 4096 * 2^-24 = 2.4e-4 bound of either order's rounding)."""
    from svt_av1_psyex_tpu_torch.device.intra import qp6_for

    rng = np.random.RandomState(n + bit_depth)
    amp = 1 << (bit_depth - 8)
    resid = ((rng.randint(-64, 65, (120, n, n))
              + rng.randint(-2, 3, (120, n, n)) * 40) * amp).astype(np.int32)
    resid[0] = 0
    ls = 2 if n == 64 else (1 if n == 32 else 0)
    qp = jax_intra.qp_row_for(120, 0, 0, bit_depth)
    r = jnp.asarray(resid)
    coeffs = jax_intra._fwd_dct2d(r, n)
    q = [int(v) for v in qp]
    rp2 = jax_intra._rp2
    qabs, dq = jax_intra._quantize_analysis(
        coeffs, q[4], q[9], rp2(q[1], ls), rp2(q[6], ls), rp2(q[0], ls),
        rp2(q[5], ls), ls)
    dist, rate, eob, inv = (np.asarray(a) for a in jax_intra._rate_dist(
        qabs, dq, r, n, bit_depth))
    got, ginv = ik.fullloop_int(torch.from_numpy(resid), qp6_for(qp, ls), n,
                                ls, bit_depth, want_inv=True)
    m = got.numpy()
    assert ginv.dtype == torch.int32
    assert np.array_equal(ginv.numpy(), inv)
    assert np.array_equal(m[:, 2], eob) and m[0, 2] == 0
    sse = (resid.astype(np.float64) ** 2).sum(axis=(1, 2))
    assert np.allclose(m[:, 3], sse, rtol=1e-6, atol=0)
    assert np.allclose(m[:, 0], dist, rtol=1e-4, atol=0)
    assert np.abs(m[:, 1] - rate).max() <= 1
    assert not m[:, 4:].any()
    _, none = ik.fullloop_int(torch.from_numpy(resid), qp6_for(qp, ls), n,
                              ls, bit_depth)
    assert none is None


@pytest.mark.parametrize("psy", [False, True], ids=["psy-off", "psy-on"])
def test_intra_analysis_batch_under_intdct_matches_jax(psy, intdct):
    """The port's intra lattice with the integer networks at every depth
    against the JAX package's: modes equal, J to rtol 1e-5."""
    from test_torch_intra import FRAMES, _rows

    for name, make in sorted(FRAMES.items()):
        luma = make()
        qp, rd = _rows(psy=psy)
        want = jax_intra.unpack_rd_analysis(np.asarray(
            jax_intra.intra_analysis_batch(
                jnp.asarray(luma[None]), jnp.asarray(qp[None]),
                jnp.asarray(rd[None]), depths=DEPTHS, psy=psy)[0]),
            *luma.shape, DEPTHS)
        got = port_intra.unpack_rd_analysis(port_intra.intra_analysis_batch(
            torch.from_numpy(luma[None]), qp[None], rd[None], depths=DEPTHS,
            psy=psy)[0].numpy(), *luma.shape, DEPTHS)
        for blk in DEPTHS:
            assert np.array_equal(got[blk]["mode"], want[blk]["mode"]), (
                name, blk)
            assert np.allclose(got[blk]["j"], want[blk]["j"], rtol=1e-5,
                               atol=0), (name, blk)


def test_intdct_bypasses_the_fullloop(intdct, monkeypatch):
    """Under the switch no depth reaches the fullloop registry or the
    float32 matmul chain, as in the JAX package (device/intra.py:62)."""
    import svt_av1_psyex_tpu_torch.device.intra as PI

    def fail(*a, **k):
        raise AssertionError("the float32 analysis chain ran")

    monkeypatch.setattr(PI, "fullloop_ref", fail)
    monkeypatch.setattr(PI, "fullloop_impl", fail)
    luma = np.random.RandomState(4).randint(0, 256, (64, 128)).astype(
        np.uint8)
    qp = port_intra.qp_row_for(100, 0, 0, 8)
    rd = np.array([120, 100, 60, 300, 310, 320, 330, 340, 350, 360, 0],
                  np.int32)
    out = port_intra.intra_analysis_batch(torch.from_numpy(luma[None]),
                                          qp[None], rd[None], depths=DEPTHS)
    assert out.shape == (1, 2 * sum((64 // b) * (128 // b) for b in DEPTHS))
    assert port_intra.analysis_loop(64, "hand", 8).func is ik.fullloop_int


@pytest.mark.parametrize("nrefs, psy", [(1, False), (2, True)],
                         ids=["1-psy-off", "2-psy-on"])
def test_inter_analysis_under_intdct_matches_jax(nrefs, psy, intdct):
    """The fused inter analysis (tests/test_torch_inter.py's frames)
    under the switch: candidates and MVs equal, J to rtol 1e-5."""
    from test_torch_inter import DEPTHS as D
    from test_torch_inter import H, W, analyses

    got, want = analyses(nrefs, psy)
    for blk in D:
        for f in ("cand", "mv_y", "mv_x", "mv_y1", "mv_x1"):
            assert np.array_equal(got[blk][f], want[blk][f]), (blk, f)
        assert np.allclose(got[blk]["j"], want[blk]["j"], rtol=1e-5,
                           atol=0), blk
    assert (H, W) == (128, 192)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_tpl_stats_under_intdct_match_jax(bit_depth, intdct):
    """TPL's dispenser under the switch (its recon carried in integers):
    motion and the inter choice equal, dist and rate to rtol 1e-5."""
    from test_torch_tpl import F, H, QINDEX, W, pan_clip

    from svt_av1_psyex_tpu.device import tpl as jax_tpl
    from svt_av1_psyex_tpu_torch.device import tpl as port_tpl

    srcs = pan_clip(F, H, W, bit_depth)
    qp = port_intra.qp_row_for(QINDEX, 0, 0, bit_depth)
    want = np.asarray(jax_tpl.tpl_group_stats(
        jnp.asarray(srcs), jnp.asarray(qp), bit_depth=bit_depth))
    got = port_tpl.tpl_group_stats(torch.from_numpy(srcs), qp,
                                   bit_depth=bit_depth).numpy()
    fields = port_tpl.STAT_FIELDS
    for k, name in enumerate(fields):
        if name in ("mv_y", "mv_x", "is_inter"):
            assert np.array_equal(got[:, k], want[:, k]), name
        else:
            assert np.allclose(got[:, k], want[:, k], rtol=1e-5, atol=0), name
    assert 0 < want[1:, fields.index("is_inter")].mean() < 1


def test_gop_under_intdct_byte_identical(intdct, tmp_path):
    """The 200x120 p8 KF + 4-frame mini-GOP of test_torch_slice under
    the switch in both packages: byte-identical TUs and recons, and the
    port's stream decodes in dav1d to its recon."""
    from test_torch_slice import GOP_LEN, H, W, encode_gop

    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    _, tus, recons = encode_gop(Av1Encoder, device="cpu")
    _, ref_tus, ref_recons = encode_gop(JaxEncoder)
    assert len(tus) == len(ref_tus) == GOP_LEN + 3
    for i, (a, b) in enumerate(zip(tus, ref_tus)):
        assert a == b, f"TU {i} differs from the JAX package's"
    for p, q in zip(recons, ref_recons):
        assert all(np.array_equal(a, b) for a, b in zip(p, q))
    if dav1d_loads():
        assert dav1d_mismatches(tmp_path / "intdct.ivf", tus, recons, W,
                                H) == []
