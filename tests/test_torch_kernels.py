"""The port's kernel wrappers and registry, without JAX: the plain
versions' edge cases, the wrappers' CPU path, device handling, and the
hand-written CUDA kernels (fullloop, sad_lattice) against their plain
versions on the card (tests marked `cuda`: they skip without a card, and
this file needs no JAX, so they also run where JAX is not installed).

The sad_lattice contract is bit-exactness: the lattice is integer.

The fullloop contract (assert_contract) is the one tests/test_pallas.py
:64-75 holds the Pallas kernel to against the jnp chain: the analysis
tier is float, so a coefficient on a quantization boundary may round to
the other level in another summation order; metrics agree to float
order, eob and rate on >= 98% of the blocks, the all-zero block has eob
0. test_torch_fullloop.py holds the plain version to it against JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu_torch import runtime  # noqa: E402
from svt_av1_psyex_tpu_torch.device.intra import qp6_for, qp_row_for  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as cuda_fullloop  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.cuda import sad as cuda_sad  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.fullloop_ref import fullloop_ref  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.sad_ref import sad_lattice_ref  # noqa: E402

B = 150  # not a multiple of any kernel tile: exercises the ragged edge


def resid_blocks(n, b=B, seed=None):
    """Seeded intra-like residuals (tests/test_pallas.py's recipe); block
    0 is all zero, whose eob must be 0."""
    rng = np.random.RandomState(7 + n if seed is None else seed)
    resid = (rng.randint(-64, 65, (b, n, n))
             + rng.randint(-2, 3, (b, n, n)) * 40).astype(np.int32)
    resid[0] = 0
    return resid


def log_scale(n):
    return 2 if n == 64 else (1 if n == 32 else 0)


def assert_contract(metrics, inv, resid, d_ref, r_ref, e_ref, inv_ref):
    """tests/test_pallas.py:64-75, and columns 4-7 zero."""
    sse_ref = (resid.astype(np.float64) ** 2).sum(axis=(1, 2))
    assert np.allclose(metrics[:, 3], sse_ref, rtol=1e-5)
    assert np.allclose(metrics[:, 0], d_ref, rtol=1e-3, atol=2.0)
    eob_eq = np.mean(metrics[:, 2] == e_ref)
    assert eob_eq > 0.98, eob_eq
    rdiff = np.abs(metrics[:, 1] - r_ref) / np.maximum(r_ref, 512)
    assert np.mean(rdiff < 0.02) > 0.98
    assert metrics[0, 2] == 0
    assert np.all(metrics[:, 4:] == 0)
    assert np.allclose(inv[1:], inv_ref[1:], rtol=1e-2, atol=2.0)


def plain(resid, n, qindex=80):
    ls = log_scale(n)
    qp6 = qp6_for(qp_row_for(qindex, 0, 0, 8), ls)
    m, inv = fullloop_ref(torch.from_numpy(resid), qp6, n, ls, want_inv=True)
    return m.numpy(), inv.numpy()


def test_plain_without_inverse_and_empty_batch():
    resid = torch.from_numpy(resid_blocks(8))
    qp6 = qp6_for(qp_row_for(140, 0, 0, 8), 0)
    m_inv, inv = fullloop_ref(resid, qp6, 8, 0, want_inv=True)
    m, none = fullloop_ref(resid, qp6, 8, 0)
    assert none is None and inv.shape == (B, 8, 8)
    assert torch.equal(m, m_inv)
    m0, _ = fullloop_ref(resid[:0], qp6, 8, 0)
    assert m0.shape == (0, 8)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_plain_is_deterministic(n):
    """One answer per input: 50 calls of the plain fullloop on one input,
    copied to buffers at different offsets, under 1, 2 and 6 torch
    threads, with and without the inverse, all torch.equal."""
    resid = torch.from_numpy(resid_blocks(n, b=48))
    ls = log_scale(n)
    qp6 = qp6_for(qp_row_for(140, 0, 0, 8), ls)
    threads = torch.get_num_threads()
    want_m = want_inv = None
    try:
        for i in range(50):
            torch.set_num_threads((1, 2, 6)[i % 3])
            off = i % 7
            buf = torch.empty(resid.numel() + off, dtype=torch.int32)
            x = buf[off:].view(resid.shape)
            x.copy_(resid)
            m, inv = fullloop_ref(x, qp6, n, ls, want_inv=i % 2 == 1)
            if want_m is None:
                want_m = m
            assert torch.equal(m, want_m), (i, off)
            if inv is not None:
                if want_inv is None:
                    want_inv = inv
                assert torch.equal(inv, want_inv), (i, off)
    finally:
        torch.set_num_threads(threads)


def test_wrapper_on_cpu_runs_plain_version():
    """On a CPU tensor the kernel wrapper runs the plain version and
    launches (and counts) nothing."""
    resid = torch.from_numpy(resid_blocks(16))
    qp6 = qp6_for(qp_row_for(140, 0, 0, 8), 0)
    before = cuda_fullloop.launches
    got, got_inv = cuda_fullloop.fullloop(resid, qp6, 16, 0, want_inv=True)
    want, want_inv = fullloop_ref(resid, qp6, 16, 0, want_inv=True)
    assert torch.equal(got, want) and torch.equal(got_inv, want_inv)
    assert cuda_fullloop.launches == before


def sad_inputs(nsb, bit_depth=8, seed=0):
    """Seeded SB tiles and windows; at 10 bits up to 1023."""
    rng = np.random.RandomState(seed)
    hi = 1 << bit_depth
    return (rng.randint(0, hi, (nsb, 64, 64)).astype(np.int32),
            rng.randint(0, hi, (nsb, 80, 80)).astype(np.int32))


def sad_brute(tile, win):
    """One SB's lattice straight from the definition (numpy)."""
    out = np.empty((289, 8, 8), np.int64)
    for dy in range(17):
        for dx in range(17):
            d = np.abs(tile - win[dy: dy + 64, dx: dx + 64])
            out[dy * 17 + dx] = d.reshape(8, 8, 8, 8).sum(axis=(1, 3))
    return out


def test_sad_plain_matches_definition_and_empty_batch():
    tiles, wins = sad_inputs(2, 10, seed=3)
    got = sad_lattice_ref(torch.from_numpy(tiles), torch.from_numpy(wins))
    assert got.dtype == torch.int32 and got.shape == (2, 289, 8, 8)
    for i in range(2):
        assert np.array_equal(got[i].numpy(), sad_brute(tiles[i], wins[i]))
    # other integer types are cast to int32
    u8 = sad_lattice_ref(torch.from_numpy(tiles.astype(np.int16)),
                         torch.from_numpy(wins.astype(np.int16)))
    assert torch.equal(u8, got)
    empty = sad_lattice_ref(torch.zeros((0, 64, 64), dtype=torch.int32),
                            torch.zeros((0, 80, 80), dtype=torch.int32))
    assert empty.shape == (0, 289, 8, 8)


def test_sad_wrapper_on_cpu_runs_plain_version():
    tiles, wins = (torch.from_numpy(a) for a in sad_inputs(3))
    before = cuda_sad.launches
    assert torch.equal(cuda_sad.sad_lattice(tiles, wins),
                       sad_lattice_ref(tiles, wins))
    assert cuda_sad.launches == before


def test_registry_and_device_handling(monkeypatch):
    assert runtime.fullloop_impl("plain") is fullloop_ref
    assert runtime.fullloop_impl("hand") is cuda_fullloop.fullloop
    assert runtime.sad_impl("plain") is sad_lattice_ref
    assert runtime.sad_impl("hand") is cuda_sad.sad_lattice
    with pytest.raises(ValueError):
        runtime.fullloop_impl("triton")
    with pytest.raises(ValueError):
        runtime.sad_impl("triton")
    with pytest.raises(ValueError):
        runtime.resolve_device(None)
    with pytest.raises(ValueError):
        runtime.resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        runtime.resolve_device("cuda")
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cdef_registry_and_wrappers_on_cpu():
    """runtime.cdef_impl names the plain version and the kernel's
    wrappers; on CPU tensors the wrappers run the plain version and count
    no launch."""
    from test_torch_cdef_kernel import _frame

    from svt_av1_psyex_tpu_torch.ops import cdef_ref
    from svt_av1_psyex_tpu_torch.ops.cuda import cdef as cuda_cdef

    assert runtime.cdef_impl("plain") == (
        cdef_ref.cdef_dirs_ref, cdef_ref.cdef_search_ref,
        cdef_ref.cdef_apply_ref)
    assert runtime.cdef_impl("hand") == (
        cuda_cdef.cdef_dirs, cuda_cdef.cdef_search, cuda_cdef.cdef_apply)
    with pytest.raises(ValueError):
        runtime.cdef_impl("triton")
    recon, src, skip_g = _frame(5, 10, 18, 8, False, "random")
    mask = cdef_ref.unit_mask(skip_g, 10, 18)
    planes = [torch.from_numpy(p) for p in recon]
    srcs = [torch.from_numpy(p) for p in src]
    args = ((40, 72), mask.shape, 0)
    units = torch.from_numpy(cdef_ref.search_units(mask, 5))
    cands = torch.tensor([0, 2, 28, 30], dtype=torch.int32)
    before = cuda_cdef.launches
    dirs, var = cuda_cdef.cdef_dirs(planes[0], *args)
    want = cdef_ref.cdef_dirs_ref(planes[0], *args)
    assert torch.equal(dirs, want[0]) and torch.equal(var, want[1])
    got = cuda_cdef.cdef_search(planes, srcs, (40, 72), units, mask.shape,
                                dirs, var, cands, 5, 4, 0)
    want = cdef_ref.cdef_search_ref(planes, srcs, (40, 72), units,
                                    mask.shape, dirs, var, cands, 5, 4, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gi = torch.full((mask.size,), 30, dtype=torch.int32)
    mask_t = torch.from_numpy(mask)
    got = cuda_cdef.cdef_apply(planes, (40, 72), mask_t, dirs, var, gi, gi,
                               5, 4, 0)
    want = cdef_ref.cdef_apply_ref(planes, (40, 72), mask_t, dirs, var, gi,
                                   gi, 5, 4, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cuda_cdef.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return runtime.resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_kernel_matches_plain_on_card(cuda_device, n):
    resid = resid_blocks(n)
    ls = log_scale(n)
    qp6 = qp6_for(qp_row_for(80, 0, 0, 8), ls)
    x = torch.from_numpy(resid).to(cuda_device)
    before = cuda_fullloop.launches
    got_m, got_inv = cuda_fullloop.fullloop(x, qp6, n, ls, want_inv=True)
    got_m0, none = cuda_fullloop.fullloop(x.float(), qp6, n, ls)
    torch.cuda.synchronize()
    assert cuda_fullloop.launches == before + 2
    assert none is None and torch.equal(got_m, got_m0)
    want_m, want_inv = fullloop_ref(x, qp6, n, ls, want_inv=True)
    want_m = want_m.cpu().numpy()
    assert_contract(got_m.cpu().numpy(), got_inv.cpu().numpy(), resid,
                    want_m[:, 0], want_m[:, 1], want_m[:, 2],
                    want_inv.cpu().numpy())


@pytest.mark.cuda
def test_kernel_batch_edges_and_bad_input_on_card(cuda_device):
    qp6 = qp6_for(qp_row_for(80, 0, 0, 8), 0)
    for b in (1, 3, 65):
        x = torch.from_numpy(resid_blocks(4, b=b, seed=b)).to(cuda_device)
        got, _ = cuda_fullloop.fullloop(x, qp6, 4, 0)
        want, _ = fullloop_ref(x, qp6, 4, 0)
        assert got.shape == (b, 8) and got[0, 2].item() == 0
        assert torch.allclose(got, want, rtol=1e-3, atol=2.0)
    empty, inv = cuda_fullloop.fullloop(
        torch.zeros((0, 8, 8), dtype=torch.int32, device=cuda_device), qp6,
        8, 0, want_inv=True)
    assert empty.shape == (0, 8) and inv.shape == (0, 8, 8)
    x = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_fullloop.fullloop(x, qp6, 16, 0)
    with pytest.raises(ValueError):
        cuda_fullloop.fullloop(x.transpose(1, 2), qp6, 8, 0)
    with pytest.raises(TypeError):
        cuda_fullloop.fullloop(x.to(torch.int64), qp6, 8, 0)


@pytest.mark.cuda
def test_lattice_kernel_vs_plain_on_card(cuda_device):
    """The intra lattice on the card through the kernel and through the
    plain version: modes agree on >= 98% of every depth's blocks
    (tests/test_pallas.py:131-135)."""
    from svt_av1_psyex_tpu_torch.device import intra

    rng = np.random.RandomState(3)
    luma = np.add.outer(np.linspace(30, 220, 256),
                        np.linspace(0, 90, 384)).astype(np.int32)
    luma = np.clip(luma + rng.randint(-12, 13, luma.shape), 0,
                   255).astype(np.uint8)
    qp = qp_row_for(140, 0, 0, 8)
    rd = np.array([120, 100, 60, 300, 310, 320, 330, 340, 350, 360, 77],
                  np.int32)
    depths = (64, 32, 16, 8)
    x = torch.from_numpy(luma[None]).to(cuda_device)
    out = {}
    for kernels in ("hand", "plain"):
        for psy in (False, True):
            packed = intra.intra_analysis_batch(
                x, qp[None], rd[None], depths=depths, psy=psy,
                kernels=kernels)
            out[kernels, psy] = intra.unpack_rd_analysis(
                packed[0].cpu().numpy(), 256, 384, depths)
    for psy in (False, True):
        for blk in depths:
            a, b = out["hand", psy][blk], out["plain", psy][blk]
            assert np.mean(a["mode"] == b["mode"]) >= 0.98, (psy, blk)
            assert np.allclose(a["j"], b["j"], rtol=5e-3, atol=50)


@pytest.mark.cuda
@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("nsb", [1, 7, 240, 510])
def test_sad_kernel_matches_plain_on_card(cuda_device, nsb, bit_depth):
    """Bit-exact at an off-tile batch and at the 720p (240 SBs) and 1080p
    (510 SBs) frames' batches."""
    tiles, wins = (torch.from_numpy(a).to(cuda_device)
                   for a in sad_inputs(nsb, bit_depth, seed=nsb))
    before = cuda_sad.launches
    got = cuda_sad.sad_lattice(tiles, wins)
    torch.cuda.synchronize()
    assert cuda_sad.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (nsb, 289, 8, 8)
    assert torch.equal(got, sad_lattice_ref(tiles, wins))


@pytest.mark.cuda
def test_sad_kernel_edges_and_bad_input_on_card(cuda_device):
    z = dict(dtype=torch.int32, device=cuda_device)
    empty = cuda_sad.sad_lattice(torch.zeros((0, 64, 64), **z),
                                 torch.zeros((0, 80, 80), **z))
    assert empty.shape == (0, 289, 8, 8) and empty.dtype == torch.int32
    # the extremes: 1023 against 0 everywhere
    hi = cuda_sad.sad_lattice(torch.full((2, 64, 64), 1023, **z),
                              torch.zeros((2, 80, 80), **z))
    assert bool((hi == 64 * 1023).all())
    tiles, wins = torch.zeros((2, 64, 64), **z), torch.zeros((2, 80, 80), **z)
    with pytest.raises(ValueError):
        cuda_sad.sad_lattice(tiles, wins[:1])
    with pytest.raises(ValueError):
        cuda_sad.sad_lattice(tiles[:, :32], wins)
    with pytest.raises(ValueError):
        cuda_sad.sad_lattice(tiles, wins.transpose(1, 2))
    with pytest.raises(ValueError):
        cuda_sad.sad_lattice(tiles, wins.cpu())
    with pytest.raises(TypeError):
        cuda_sad.sad_lattice(tiles.to(torch.int16), wins)


@pytest.mark.cuda
def test_inter_lattice_kernels_vs_plain_on_card(cuda_device):
    """The fused inter analysis on the card through the kernels and
    through the plain versions: ME (integer) equal, the winning candidate
    agreeing on >= 98% of every depth's blocks (a coefficient on a
    quantization boundary may round to the other level)."""
    from svt_av1_psyex_tpu_torch.device import inter, me

    rng = np.random.RandomState(5)
    big = np.add.outer(np.linspace(30, 220, 320),
                       np.linspace(0, 90, 448)).astype(np.int32)
    big = np.clip(big + rng.randint(-12, 13, big.shape), 0, 255)
    src = big[:256, :384].astype(np.uint8)
    refs = np.stack([big[3:259, 5:389], big[40:296, 60:444]]).astype(np.uint8)
    x = torch.from_numpy(src).to(cuda_device)
    r = torch.from_numpy(refs).to(cuda_device)
    rows = [me.me_fullpel(x, r, kernels=k) for k in ("hand", "plain")]
    assert torch.equal(rows[0], rows[1])
    qp = qp_row_for(120, 0, 0, 8)
    rd = np.concatenate([[3467, 200, 900], [600, 1100, 1100, 1500, 1700,
                                            1700, 1600],
                         [1900, 2050] + [1 << 28] * 6,
                         [1400, 1550] + [1 << 28] * 6, [3500, 2900], [77]])
    depths = (64, 32, 16, 8)
    out = {}
    for kernels in ("hand", "plain"):
        packed = inter.inter_analysis(x, r, qp, rd.astype(np.int32),
                                      depths=depths, psy=True,
                                      kernels=kernels)
        out[kernels] = inter.unpack_inter_analysis(packed.cpu().numpy(),
                                                   256, 384, depths)
    for blk in depths:
        a, b = out["hand"][blk], out["plain"][blk]
        assert np.mean(a["cand"] == b["cand"]) >= 0.98, blk
        same = a["cand"] == b["cand"]
        for f in ("mv_y", "mv_x", "mv_y1", "mv_x1"):
            assert np.array_equal(a[f][same], b[f][same]), (blk, f)
        assert np.allclose(a["j"], b["j"], rtol=5e-3, atol=50)


# ---- CDEF (ops/cuda/cdef.cu): bit-exact with its plain version and the C


def _cdef_case(mi_rows, mi_cols, bit_depth, level, seed):
    """One frame of tests/test_torch_cdef_kernel.py's kind, its C result
    and the tables and planes the C computed (native/cdefc.py with its
    library wrapped)."""
    from test_torch_cdef_kernel import _frame, _rd_fn, _Spy

    from svt_av1_psyex_tpu_torch.native import cdefc

    if not cdefc.available():
        pytest.skip("the native C tier does not build here")
    recon, src, skip_g = _frame(seed, mi_rows, mi_cols, bit_depth, False,
                                "random")
    q = 160
    spy = _Spy(cdefc._lib())
    rec_c = [p.copy() for p in recon]
    orig = cdefc._lib
    cdefc._lib = lambda: spy
    try:
        want = cdefc.cdef_search_frame_c(rec_c, src, skip_g, mi_rows, mi_cols,
                                         q, _rd_fn(q, bit_depth),
                                         level=level, bit_depth=bit_depth)
    finally:
        cdefc._lib = orig
    return dict(recon=recon, src=src, skip_g=skip_g, q=q, want=want,
                rec_c=rec_c, seen=spy.seen, rd_fn=_rd_fn(q, bit_depth))


@pytest.mark.cuda
@pytest.mark.parametrize("mi_rows, mi_cols, bit_depth", [
    (180, 320, 8),     # the 720p cell's frame
    (270, 480, 10),    # the 1080p cell's
    (34, 50, 10),      # ragged: 200x136
])
def test_cdef_kernel_matches_plain_and_c_on_card(cuda_device, mi_rows,
                                                 mi_cols, bit_depth):
    """Directions, variances, both mse tables and the filtered planes of
    the kernel equal the plain version's on the card and the C's, and the
    frame runner returns the C's result and planes, through three
    launches."""
    from svt_av1_psyex_tpu_torch.ops import cdef_ref
    from svt_av1_psyex_tpu_torch.ops.cdef import candidate_strengths
    from svt_av1_psyex_tpu_torch.ops.cuda import cdef as cuda_cdef

    level, cs = 5, bit_depth - 8
    case = _cdef_case(mi_rows, mi_cols, bit_depth, level, mi_rows)
    seen = case["seen"]
    mask = cdef_ref.unit_mask(case["skip_g"], mi_rows, mi_cols)
    grid, coded = mask.shape, (mi_rows * 4, mi_cols * 4)
    ydamp, cdamp, _ = seen["damp"]

    def dev(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                for a in arrays]

    planes, srcs = dev(case["recon"]), dev(case["src"])
    units, cands, mask_t, y_gi, uv_gi = dev([
        cdef_ref.search_units(mask, level),
        np.asarray(candidate_strengths(level), np.int32), mask,
        seen["y_gi"], seen["uv_gi"]])
    out = {}
    for kernels in ("hand", "plain"):
        dirs_fn, search_fn, apply_fn = runtime.cdef_impl(kernels)
        before = cuda_cdef.launches
        dirs, var = dirs_fn(planes[0], coded, grid, cs)
        mse0, mse1 = search_fn(planes, srcs, coded, units, grid, dirs, var,
                               cands, ydamp, cdamp, cs)
        filt = apply_fn(planes, coded, mask_t, dirs, var, y_gi, uv_gi,
                        ydamp, cdamp, cs)
        torch.cuda.synchronize()
        assert cuda_cdef.launches == before + (3 if kernels == "hand" else 0)
        out[kernels] = [t.cpu().numpy() for t in (dirs, var, mse0, mse1)] + [
            [p.cpu().numpy() for p in filt]]
    for kernels in ("hand", "plain"):
        dirs, var, mse0, mse1, filt = out[kernels]
        assert np.array_equal(dirs, seen["dirs"]), kernels
        assert np.array_equal(var, seen["var"]), kernels
        assert np.array_equal(mse0.reshape(-1), seen["mse0"]), kernels
        assert np.array_equal(mse1.reshape(-1), seen["mse1"]), kernels
        for got, want in zip(filt, case["rec_c"]):
            assert np.array_equal(got, want), kernels

    for kernels in ("hand", "plain"):
        frames = cuda_cdef.CdefFrames(cuda_device, kernels)
        for _ in range(2):   # the second on the staging buffers kept
            rec = [p.copy() for p in case["recon"]]
            before = cuda_cdef.launches
            got = frames.search_frame(rec, case["src"], case["skip_g"],
                                      mi_rows, mi_cols, case["q"],
                                      case["rd_fn"], level=level,
                                      bit_depth=bit_depth)
            assert cuda_cdef.launches == before + (3 if kernels == "hand"
                                                   else 0)
            want = case["want"]
            assert got[:3] == want[:3] and got[4] == want[4], kernels
            assert np.array_equal(got[3], want[3]), kernels
            for a, b in zip(rec, case["rec_c"]):
                assert np.array_equal(a, b), kernels


@pytest.mark.cuda
def test_cdef_kernel_bad_input_and_refused_launch_on_card(cuda_device,
                                                          monkeypatch):
    from svt_av1_psyex_tpu_torch.ops.cuda import cdef as cuda_cdef

    z = dict(dtype=torch.int32, device=cuda_device)
    y = torch.zeros((64, 64), **z)
    with pytest.raises(ValueError):
        cuda_cdef.cdef_dirs(y, (72, 64), (8, 8), 0)   # smaller than coded
    with pytest.raises(ValueError):
        cuda_cdef.cdef_dirs(y.t(), (64, 64), (8, 8), 0)
    with pytest.raises(ValueError):
        cuda_cdef.cdef_dirs(y[:, :32], (64, 32), (8, 4), 0)
    with pytest.raises(TypeError):
        cuda_cdef.cdef_dirs(y.to(torch.int16), (64, 64), (8, 8), 0)
    with pytest.raises(ValueError):
        cuda_cdef.cdef_search([y], [y.cpu()], (64, 64), y[0, :1], (8, 8),
                              y.reshape(-1), y.reshape(-1), y[0, :6], 5, 4,
                              0)

    class Refused:
        """A library whose launches the card refuses."""

        def svt_cdef_dirs_launch(self, *a):
            return 1

        def svt_cdef_error_string(self, err):
            return b"invalid argument"

    monkeypatch.setattr(cuda_cdef, "_lib", lambda: Refused())
    before = cuda_cdef.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        cuda_cdef.cdef_dirs(y, (64, 64), (8, 8), 0)
    assert cuda_cdef.launches == before
