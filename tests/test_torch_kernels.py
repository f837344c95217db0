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
