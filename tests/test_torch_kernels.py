"""The port's kernel wrappers and registry, without JAX: the plain fullloop
version's edge cases, the wrapper's CPU path, device handling, and the
hand-written CUDA kernel against its plain version on the card (tests
marked `cuda`: they skip without a card, and this file needs no JAX, so
they also run where JAX is not installed).

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
from svt_av1_psyex_tpu_torch.ops.fullloop_ref import fullloop_ref  # noqa: E402

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


def test_registry_and_device_handling(monkeypatch):
    assert runtime.fullloop_impl("plain") is fullloop_ref
    assert runtime.fullloop_impl("hand") is cuda_fullloop.fullloop
    with pytest.raises(ValueError):
        runtime.fullloop_impl("triton")
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
