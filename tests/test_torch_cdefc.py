"""The port's native CDEF frontend (svt_av1_psyex_tpu_torch/native/
cdefc.py, which copies the JAX package's two host helpers out of the
jax-importing device/cdef.py) against the JAX package's frontend on the
same frame: the same search result and the same filtered planes, bit
for bit (both call the same C entry points)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from svt_av1_psyex_tpu.codec.rd import compute_rdmult, rdcost  # noqa: E402
from svt_av1_psyex_tpu.native import cdefc as jax_cdefc  # noqa: E402
from svt_av1_psyex_tpu_torch.native import cdefc as port_cdefc  # noqa: E402


def _frame(seed, mi_rows, mi_cols, bit_depth):
    """Aligned int32 smooth source planes (chroma with the encoder's +4
    overhang margin), a noisy recon that CDEF can clean, and a per-mi
    skip grid."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    h, w = mi_rows * 4, mi_cols * 4
    shapes = [(h, w), (h // 2 + 4, w // 2 + 4), (h // 2 + 4, w // 2 + 4)]
    src = []
    for sh in shapes:
        yy, xx = np.mgrid[0:sh[0], 0:sh[1]]
        wave = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
        src.append((wave * maxv).astype(np.int32))
    amp = 6 << (bit_depth - 8)
    recon = [np.clip(s + rng.integers(-amp, amp + 1, s.shape), 0,
                     maxv).astype(np.int32) for s in src]
    skip_g = (rng.random((mi_rows, mi_cols)) < 0.3).astype(np.uint8)
    return recon, src, skip_g


@pytest.mark.parametrize("bit_depth,level", [(8, 5), (8, 7), (10, 5)])
def test_port_cdef_matches_jax_frontend(bit_depth, level):
    if not jax_cdefc.available():
        pytest.skip("native toolchain unavailable")
    assert port_cdefc.available()
    mi_rows, mi_cols, q = 24, 40, 140
    recon, src, skip_g = _frame(11 + level, mi_rows, mi_cols, bit_depth)
    rdm = compute_rdmult(q, bit_depth)

    def rd_fn(rate, dist):
        return rdcost(rdm, rate, dist)

    rec_j = [p.copy() for p in recon]
    rec_p = [p.copy() for p in recon]
    want = jax_cdefc.cdef_search_frame_c(rec_j, src, skip_g, mi_rows,
                                         mi_cols, q, rd_fn, level=level,
                                         bit_depth=bit_depth)
    got = port_cdefc.cdef_search_frame_c(rec_p, src, skip_g, mi_rows,
                                         mi_cols, q, rd_fn, level=level,
                                         bit_depth=bit_depth)
    assert want is not None
    bits, y_str, uv_str, fb_map, damping = got
    assert (bits, y_str, uv_str, damping) == (want[0], want[1], want[2],
                                              want[4])
    assert np.array_equal(fb_map, want[3])
    for a, b, r in zip(rec_p, rec_j, recon):
        assert np.array_equal(a, b)
    assert any(not np.array_equal(a, r) for a, r in zip(rec_p, recon))


def test_nothing_filterable_gives_none():
    recon, src, _ = _frame(3, 16, 16, 8)
    skip_all = np.ones((16, 16), np.uint8)
    assert port_cdefc.cdef_search_frame_c(recon, src, skip_all, 16, 16, 140,
                                          lambda r, d: 0, level=5) is None
