"""The port's fullloop plain version against the JAX package's Pallas
kernel (run in interpret mode on the CPU, as tests/test_pallas.py runs
it) and against the JAX jnp chain, on the same seeded residuals, with
the contract of tests/test_pallas.py:64-75 (see
test_torch_kernels.assert_contract)."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("torch")

from test_torch_kernels import assert_contract, log_scale, plain, resid_blocks  # noqa: E402

from svt_av1_psyex_tpu_torch.device.intra import qp6_for, qp_row_for  # noqa: E402

B = 150  # not a multiple of any kernel tile: exercises the ragged edge


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_plain_matches_pallas_interpret(n):
    from svt_av1_psyex_tpu.ops.pallas.fullloop import fullloop

    resid = resid_blocks(n)
    ls = log_scale(n)
    qp6 = qp6_for(qp_row_for(80, 0, 0, 8), ls)
    want_m, want_inv = fullloop(jnp.asarray(resid), jnp.asarray(qp6), n, ls,
                                want_inv=True)
    want_m = np.asarray(want_m)
    got_m, got_inv = plain(resid, n)
    assert_contract(got_m, got_inv, resid, want_m[:, 0], want_m[:, 1],
                    want_m[:, 2], np.asarray(want_inv))


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_plain_matches_jnp_chain(n):
    """Against the JAX package's jnp chain (device/intra.py
    _fwd_dct2d -> _quantize_analysis -> _rate_dist), n = 64 included:
    the port runs blk 64 through the plain version on every device."""
    from svt_av1_psyex_tpu.device import intra as di

    resid = resid_blocks(n, b=40 if n == 64 else B)
    qp_row = qp_row_for(80, 0, 0, 8)
    ls = log_scale(n)
    coeffs = di._fwd_dct2d(jnp.asarray(resid), n)
    qabs, dq = di._quantize_analysis(
        coeffs, qp_row[4], qp_row[9], di._rp2(qp_row[1], ls),
        di._rp2(qp_row[6], ls), di._rp2(qp_row[0], ls),
        di._rp2(qp_row[5], ls), ls)
    dist, rate, eob, inv = di._rate_dist(qabs, dq, jnp.asarray(resid), n, 8)
    got_m, got_inv = plain(resid, n)
    assert_contract(got_m, got_inv, resid, np.asarray(dist),
                    np.asarray(rate), np.asarray(eob), np.asarray(inv))
