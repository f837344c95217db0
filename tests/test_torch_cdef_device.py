"""The port's device CDEF backend (svt_av1_psyex_tpu_torch/device/cdef.py)
against the JAX package's (svt_av1_psyex_tpu/device/cdef.py) and against
the port's exact host filter (ops/cdef.py), on seeded frames with skip
masks; and the streams of both packages with SVT_TPU_DEVICE_CDEF=1.

The directions, variances and filtered planes are exact integers in both
packages and must be equal. The distortions are search-only float32: the
port sums their integer terms exactly before rounding to float32, which
equals the JAX package's float32 sums wherever those are exact (always at
8 bits) and differs from them by float32 rounding at 10 bits; and XLA
evaluates the luma distortion's quotient through its own rsqrt, which
can move a block's rounding by one unit (_check_search)."""

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


# the 200x120 clip's mi grid, so that the stream tests below reuse the
# JAX package's compiled programs
MI_ROWS, MI_COLS, Q, LEVEL = 30, 50, 140, 5


def _prepped(seed, bd):
    """One frame of test_torch_cdefc's recipe, prepared as the device
    backend prepares it: (pads, srcs, maskg, geometry, damping pair,
    recon planes)."""
    from test_torch_cdefc import _frame

    from svt_av1_psyex_tpu_torch.device.cdef import _prep_frame

    recon, src, skip = _frame(seed, MI_ROWS, MI_COLS, bd)
    pads, srcs, maskg, geo = _prep_frame(recon, src, skip, MI_ROWS, MI_COLS)
    damping = 3 + (Q >> 6) + bd - 8
    return pads, srcs, maskg, geo, (damping, max(0, damping - 1)), recon


def _coded():
    """Mask of the 8x8 units inside the coded area, over the padded grid
    (beyond it the JAX package's int32 (hi, lo) direction costs overflow
    on the large padding value; those units are never filtered)."""
    nv8p, nh8p = (MI_ROWS + 15) // 16 * 8, (MI_COLS + 15) // 16 * 8
    m = np.zeros((nv8p, nh8p), bool)
    m[:MI_ROWS // 2, :MI_COLS // 2] = True
    return m.reshape(-1)


def _jax_search_batch(frames, bd):
    import jax.numpy as jnp

    from svt_av1_psyex_tpu.device.cdef import cdef_search_kernel_batch
    from svt_av1_psyex_tpu_torch.ops.cdef import candidate_strengths

    nvfb, nhfb, nv8p, nh8p = frames[0][3]
    packed = np.asarray(cdef_search_kernel_batch(
        tuple(jnp.asarray(np.stack([f[0][k] for f in frames]))
              for k in range(3)),
        tuple(jnp.asarray(np.stack([f[1][k] for f in frames]))
              for k in range(3)),
        jnp.asarray(np.stack([f[2].reshape(-1) for f in frames])),
        jnp.asarray(np.array([f[4][0] for f in frames], np.int32)),
        jnp.asarray(np.array([f[4][1] for f in frames], np.int32)),
        level=LEVEL, bit_depth=bd, nv8p=nv8p, nh8p=nh8p, chroma=True))
    nfb, nc, n = nvfb * nhfb, len(candidate_strengths(LEVEL)), nv8p * nh8p
    return [(row[:nfb * nc].reshape(nfb, nc),
             row[nfb * nc:2 * nfb * nc].reshape(nfb, nc),
             row[2 * nfb * nc:2 * nfb * nc + n].astype(np.int64),
             row[2 * nfb * nc + n:].astype(np.int64)) for row in packed]


def _check_search(got, want, bd):
    mse0, mse1, dirs, var = (t.numpy() for t in got)
    w0, w1, wd, wv = want
    coded = _coded()
    assert np.array_equal(dirs[coded], wd[coded])
    assert np.array_equal(var[coded], wv[coded])
    # XLA rewrites dist_8xn's num / sqrt(x) as num * rsqrt(x) with its
    # own rsqrt, so a block whose float32 quotient lands on .5 can round
    # one unit apart (one of the 48 entries in test_search_kernel's
    # 8-bit frame); at 10 bits the JAX package's float32 sums of 64
    # squares also pass 2^24 (measured: up to 4.8e-5 of the entry). The
    # chroma SSE has no division: equal at 8 bits.
    if bd == 8:
        assert np.abs(mse0 - w0).max() <= 1
        assert np.array_equal(mse1, w1)
    else:
        assert np.allclose(mse0, w0, rtol=2e-4, atol=0)
        assert np.allclose(mse1, w1, rtol=2e-4, atol=0)


def _tt(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("bd", [8, 10])
def test_search_kernel_matches_jax(bd):
    """One frame: directions and variances equal the JAX package's on
    every coded unit; the MSE columns as _check_search states."""
    from svt_av1_psyex_tpu_torch.device.cdef import cdef_search_kernel

    f = _prepped(11, bd)
    (nvfb, nhfb, nv8p, nh8p), (yd, cd) = f[3], f[4]
    got = cdef_search_kernel(_tt(f[0]), _tt(f[1]),
                             torch.from_numpy(f[2].reshape(-1)), yd, cd,
                             level=LEVEL, bit_depth=bd, nv8p=nv8p,
                             nh8p=nh8p, chroma=True)
    _check_search(got, _jax_search_batch([f], bd)[0], bd)


def test_search_kernel_batch_matches_jax():
    """Two 10-bit frames through the batch form, each checked as one."""
    from svt_av1_psyex_tpu_torch.device.cdef import cdef_search_kernel_batch

    bd = 10
    frames = [_prepped(21 + i, bd) for i in range(2)]
    nvfb, nhfb, nv8p, nh8p = frames[0][3]
    got = cdef_search_kernel_batch(
        [torch.from_numpy(np.stack([f[0][k] for f in frames]))
         for k in range(3)],
        [torch.from_numpy(np.stack([f[1][k] for f in frames]))
         for k in range(3)],
        torch.from_numpy(np.stack([f[2].reshape(-1) for f in frames])),
        [f[4][0] for f in frames], [f[4][1] for f in frames], level=LEVEL,
        bit_depth=bd, nv8p=nv8p, nh8p=nh8p, chroma=True)
    for i, want in enumerate(_jax_search_batch(frames, bd)):
        _check_search([g[i] for g in got], want, bd)


def test_find_dir_equals_host_exact():
    """_find_dir equals ops.cdef.find_dir_batch on every unit, padding
    included, at 8 and 10 bits."""
    from svt_av1_psyex_tpu_torch.device.cdef import _blocked, _find_dir
    from svt_av1_psyex_tpu_torch.ops.cdef import find_dir_batch

    for bd in (8, 10):
        pads, _, _, (_, _, nv8p, nh8p), _, _ = _prepped(5, bd)
        blocks = _blocked(torch.from_numpy(pads[0])[2:-2, 2:-2], nv8p,
                          nh8p, 8)
        dirs, var = _find_dir(blocks, bd - 8)
        want_d, want_v = find_dir_batch(blocks.numpy(), bd - 8)
        assert np.array_equal(dirs.numpy(), want_d)
        assert np.array_equal(var.numpy(), want_v)


def _strength_maps(n, seed):
    from svt_av1_psyex_tpu_torch.ops.cdef import candidate_strengths

    rng = np.random.default_rng(seed)
    cands = np.asarray(candidate_strengths(1), np.int32)
    return (cands[rng.integers(0, cands.size, n)],
            cands[rng.integers(0, cands.size, n)])


def _port_apply(f, bd, seed):
    from svt_av1_psyex_tpu_torch.device.cdef import (
        _blocked,
        _find_dir,
        cdef_apply_kernel,
    )

    pads, _, maskg, (_, _, nv8p, nh8p), (yd, cd), recon = f
    n = nv8p * nh8p
    dirs, var = _find_dir(_blocked(torch.from_numpy(pads[0])[2:-2, 2:-2],
                                   nv8p, nh8p, 8), bd - 8)
    y_gi, uv_gi = _strength_maps(n, seed)
    (h, w), (hc, wc) = recon[0].shape, recon[1].shape
    out = cdef_apply_kernel(_tt(pads), dirs, var, torch.from_numpy(y_gi),
                            torch.from_numpy(uv_gi),
                            torch.from_numpy(maskg.reshape(-1)), yd, cd,
                            bit_depth=bd, nv8p=nv8p, nh8p=nh8p, chroma=True,
                            h=h, w=w, hc=hc, wc=wc)
    return out, dirs.numpy(), var.numpy(), y_gi, uv_gi


@pytest.mark.parametrize("bd", [8, 10])
def test_apply_kernel_matches_jax(bd):
    """The filtered planes equal the JAX package's for the same per-unit
    strengths (every primary and secondary strength)."""
    import jax.numpy as jnp

    from svt_av1_psyex_tpu.device.cdef import cdef_apply_kernel_batch

    f = _prepped(31, bd)
    pads, _, maskg, (_, _, nv8p, nh8p), (yd, cd), recon = f
    out, dirs, var, y_gi, uv_gi = _port_apply(f, bd, 1)
    (h, w), (hc, wc) = recon[0].shape, recon[1].shape
    want = np.asarray(cdef_apply_kernel_batch(
        tuple(jnp.asarray(p[None]) for p in pads), jnp.asarray(dirs[None]),
        jnp.asarray(var[None]), jnp.asarray(y_gi[None]),
        jnp.asarray(uv_gi[None]), jnp.asarray(maskg.reshape(1, -1)),
        jnp.asarray(np.array([yd], np.int32)),
        jnp.asarray(np.array([cd], np.int32)), bit_depth=bd, nv8p=nv8p,
        nh8p=nh8p, chroma=True, h=h, w=w, hc=hc, wc=wc))[0]
    got = np.concatenate([o.numpy().reshape(-1) for o in out])
    assert np.array_equal(got, want)
    assert not np.array_equal(out[0].numpy(), recon[0])


@pytest.mark.parametrize("bd", [8, 10])
def test_apply_kernel_batch_equals_per_frame(bd):
    from svt_av1_psyex_tpu_torch.device.cdef import cdef_apply_kernel_batch

    frames = [_prepped(41 + i, bd) for i in range(2)]
    singles = [_port_apply(f, bd, 7 + i) for i, f in enumerate(frames)]
    nv8p, nh8p = frames[0][3][2:]
    (h, w), (hc, wc) = frames[0][5][0].shape, frames[0][5][1].shape

    def stack(i):
        return torch.from_numpy(np.stack([s[i] for s in singles]))

    planes = cdef_apply_kernel_batch(
        [torch.from_numpy(np.stack([f[0][k] for f in frames]))
         for k in range(3)], stack(1), stack(2), stack(3), stack(4),
        torch.from_numpy(np.stack([f[2].reshape(-1) for f in frames])),
        [f[4][0] for f in frames], [f[4][1] for f in frames], bit_depth=bd,
        nv8p=nv8p, nh8p=nh8p, chroma=True, h=h, w=w, hc=hc, wc=wc)
    for i, s in enumerate(singles):
        for k in range(3):
            assert torch.equal(planes[k][i], s[0][k])


@pytest.mark.parametrize("bd", [8, 10])
def test_apply_equals_host_filter(bd):
    """On every filtered unit (masked in, strength not 0) the device
    apply equals the port's exact host filter (ops.cdef.filter_blocks)
    for the same strengths, luma (variance-adjusted primary) and
    chroma."""
    from svt_av1_psyex_tpu_torch.ops.cdef import adjust_strength, filter_blocks

    f = _prepped(51, bd)
    pads, _, maskg, (_, _, nv8p, nh8p), (yd, cd), _ = f
    out, dirs, var, y_gi, uv_gi = _port_apply(f, bd, 3)
    cs = bd - 8
    m = maskg.reshape(-1) > 0
    for plane, gi, bs, damp in ((0, y_gi, 8, yd), (1, uv_gi, 4, cd),
                                (2, uv_gi, 4, cd)):
        blk = np.nonzero(m & (gi != 0))[0]
        pri = (gi[blk] // 4) << cs
        sec = gi[blk] % 4
        sec = (sec + (sec == 3)) << cs
        if plane == 0:
            pri = np.array([adjust_strength(int(p), var[b:b + 1])[0]
                            for p, b in zip(pri, blk)])
        d = np.where(pri != 0, dirs[blk], 0)
        ys, xs = 2 + (blk // nh8p) * bs, 2 + (blk % nh8p) * bs
        want = filter_blocks(pads[plane], ys, xs, bs, bs, pri, sec, d, damp,
                             damp, cs)
        got = out[plane].numpy()
        for i, b in enumerate(blk):
            r, c = (b // nh8p) * bs, (b % nh8p) * bs
            assert np.array_equal(got[r:r + bs, c:c + bs], want[i]), (plane,
                                                                      b)
        assert blk.size > 0


def test_nothing_filterable_gives_none():
    from test_torch_cdefc import _frame

    from svt_av1_psyex_tpu_torch.device.cdef import cdef_search_frame_device

    recon, src, _ = _frame(3, 16, 16, 8)
    skip_all = np.ones((16, 16), np.uint8)
    assert cdef_search_frame_device(recon, src, skip_all, 16, 16, 140,
                                    lambda r, d: 0, level=5,
                                    device=torch.device("cpu")) is None


# ---- streams with SVT_TPU_DEVICE_CDEF=1 --------------------------------


@pytest.fixture
def device_cdef(monkeypatch):
    monkeypatch.setenv("SVT_TPU_DEVICE_CDEF", "1")


def test_keyframe_group_streams_byte_identical(device_cdef):
    """A 3-keyframe group (encode_keyframes, one cdef_group_device call):
    byte-identical in both packages, through the device backend."""
    import svt_av1_psyex_tpu_torch.device.cdef as PC
    from test_torch_slice import PRESET, QINDEX, H, W, _frames

    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder
    from svt_av1_psyex_tpu.codec.encoder import SequenceConfig as JaxSeq

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    calls = []
    orig = PC.cdef_group_device

    def spy(jobs, *a, **k):
        calls.append(len(jobs))
        return orig(jobs, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(PC, "cdef_group_device", spy)
    try:
        port = Av1Encoder(SequenceConfig(width=W, height=H), preset=PRESET,
                          device="cpu").encode_keyframes(_frames(), QINDEX)
    finally:
        mp.undo()
    ref = JaxEncoder(JaxSeq(width=W, height=H),
                     preset=PRESET).encode_keyframes(_frames(), QINDEX)
    assert calls == [3]
    assert port == ref


def test_minigop_streams_byte_identical(device_cdef):
    """A KF + 4-frame mini-GOP (the per-frame path): byte-identical in
    both packages, every frame through the device backend."""
    import svt_av1_psyex_tpu_torch.device.cdef as PC
    from test_torch_slice import encode_gop

    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder

    calls = []
    orig = PC.cdef_search_frame_device

    def spy(*a, **k):
        calls.append(k["device"])
        return orig(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(PC, "cdef_search_frame_device", spy)
    try:
        _, tus, _ = encode_gop(Av1Encoder, device="cpu")
    finally:
        mp.undo()
    _, ref_tus, _ = encode_gop(JaxEncoder)
    assert len(calls) == 5 and all(d.type == "cpu" for d in calls)
    assert tus == ref_tus


def test_host_cdef_switch_streams_byte_identical(monkeypatch):
    """SVT_TPU_HOST_CDEF=1 selects the numpy search (ops/cdef.py
    cdef_search_frame) in both packages even where native C builds: the
    KF + 4-frame mini-GOP runs it on every frame, never the native
    search, and the streams are byte-identical."""
    from test_torch_slice import encode_gop

    import svt_av1_psyex_tpu.ops.cdef as JC
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder

    import svt_av1_psyex_tpu_torch.native.cdefc as PCC
    import svt_av1_psyex_tpu_torch.ops.cdef as PC
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder

    calls = {"port": 0, "jax": 0}

    def spy(mod, key):
        orig = mod.cdef_search_frame

        def run(*a, **k):
            calls[key] += 1
            return orig(*a, **k)

        monkeypatch.setattr(mod, "cdef_search_frame", run)

    def native(*a, **k):
        raise AssertionError("the native C search ran")

    spy(PC, "port")
    spy(JC, "jax")
    monkeypatch.setattr(PCC, "cdef_search_frame_c", native)
    monkeypatch.setenv("SVT_TPU_HOST_CDEF", "1")
    _, tus, _ = encode_gop(Av1Encoder, device="cpu")
    _, ref_tus, _ = encode_gop(JaxEncoder)
    assert calls == {"port": 5, "jax": 5}
    assert tus == ref_tus
