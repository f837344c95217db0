"""Port matmul DCTs (svt_av1_psyex_tpu_torch/device/matdct.py) against the
JAX package's device/matdct.py on the same inputs.

The probed matrices are the same numpy computation, so they must be
equal. The 2-D transforms are float32 matmuls in both; summation order
differs between XLA and PyTorch, hence rtol 1e-5 (float32 has ~7 digits
and each output sums at most 64*64 products), with an absolute floor of
1e-5 of the largest output for outputs that cancel to near zero."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu.device import matdct as jmat  # noqa: E402
from svt_av1_psyex_tpu_torch.device import matdct as tmat  # noqa: E402
from svt_av1_psyex_tpu_torch.params import reference_constants  # noqa: E402

SIZES = (4, 8, 16, 32, 64)


def _close(got, want):
    return np.allclose(got, want, rtol=1e-5,
                       atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", SIZES)
def test_probed_matrices_equal(n):
    for inverse in (False, True):
        cb = 12 if inverse else 13
        assert np.array_equal(tmat.dct1d_mat(n, cb, inverse),
                              jmat.dct1d_mat(n, cb, inverse))
    for a, b in zip(tmat.fwd_mats(n), jmat.fwd_mats(n)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    for a, b in zip(tmat.inv_mats(n), jmat.inv_mats(n)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_sep2d_matches_jnp(n):
    rng = np.random.RandomState(100 + n)
    consts = reference_constants("cpu")
    resid = rng.randint(-255, 256, (9, n, n)).astype(np.int32)
    got = tmat.fwd_dct2d_mat(torch.from_numpy(resid), n, consts).numpy()
    want = np.asarray(jmat.fwd_dct2d_mat(jnp.asarray(resid), n))
    cn = min(n, 32)
    assert got.shape == want.shape == (9, cn, cn)
    assert _close(got, want)

    dq = rng.randint(-2000, 2001, (9, cn, cn)).astype(np.int32)
    got = tmat.inv_dct2d_mat(torch.from_numpy(dq), n, consts).numpy()
    want = np.asarray(jmat.inv_dct2d_mat(jnp.asarray(dq), n))
    assert got.shape == want.shape == (9, n, n)
    assert _close(got, want)
