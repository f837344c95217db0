"""The port's fused inter analysis (svt_av1_psyex_tpu_torch/device/
inter.py) against the JAX package's device/inter.py on the same frames,
with 1, 2 and 3 references, psy off and on.

The JAX side runs its jnp route, as the JAX package's own tests run it
on the CPU. ME is integer and bit-exact (tests/test_torch_me.py); the
analysis transforms are float32 in both packages, in the same operation
order, so every block's winning candidate and motion vectors must be
equal and its J agree to float rounding (rtol 1e-5)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu.codec.rd import compute_rdmult  # noqa: E402
from svt_av1_psyex_tpu.device import inter as jax_inter  # noqa: E402
from svt_av1_psyex_tpu.device.intra import qp_row_for  # noqa: E402
from svt_av1_psyex_tpu_torch.device import inter as port_inter  # noqa: E402

H, W = 128, 192
DEPTHS = (64, 32, 16, 8)
QINDEX = 120


def frames():
    """A src and three refs: the src moved by (2, -3), the src moved the
    other way with noise (a backward ref: their average is a better
    prediction than either), and an unrelated frame."""
    rng = np.random.default_rng(21)
    big = rng.integers(0, 255, (H + 64, W + 64)).astype(np.int64)
    for _ in range(3):   # smooth: blocks with a clean SAD basin
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    big = np.clip((big - 128) * 3 + 128, 0, 255)
    src = big[32: 32 + H, 32: 32 + W]
    noise = rng.integers(-6, 7, (3, H, W))
    ref0 = np.clip(big[34: 34 + H, 29: 29 + W] + noise[0], 0, 255)
    ref1 = np.clip(big[30: 30 + H, 35: 35 + W] + noise[1], 0, 255)
    ref2 = rng.integers(0, 255, (H, W))
    # a flat patch: intra wins there
    src = src.copy()
    src[:32, :64] = 90
    stack = np.stack([ref0, ref1, ref2])
    return src.astype(np.uint8), stack.astype(np.uint8)


def rd_row(nrefs: int, psy: bool) -> np.ndarray:
    new_base = np.full(8, 1 << 28, np.int64)
    zero_base = np.full(8, 1 << 28, np.int64)
    new_base[:nrefs] = 1900 + 150 * np.arange(nrefs)
    zero_base[:nrefs] = 1400 + 150 * np.arange(nrefs)
    comp = [3500, 2900] if nrefs >= 2 else [1 << 28, 1 << 28]
    return np.concatenate([
        [compute_rdmult(QINDEX, 8), 200, 900],
        [600, 1100, 1100, 1500, 1700, 1700, 1600],
        new_base, zero_base, comp, [77 if psy else 0]]).astype(np.int32)


def analyses(nrefs: int, psy: bool):
    src, refs = frames()
    refs = refs[:nrefs]
    qp = qp_row_for(QINDEX, 0, 0, 8)
    rd = rd_row(nrefs, psy)
    want = np.asarray(jax_inter.inter_analysis(
        jnp.asarray(src), jnp.asarray(refs), jnp.asarray(qp),
        jnp.asarray(rd), depths=DEPTHS, psy=psy))
    got = port_inter.inter_analysis(torch.from_numpy(src),
                                    torch.from_numpy(refs), qp, rd,
                                    depths=DEPTHS, psy=psy)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    return (port_inter.unpack_inter_analysis(got.numpy(), H, W, DEPTHS),
            jax_inter.unpack_inter_analysis(want, H, W, DEPTHS))


@pytest.mark.parametrize("psy", [False, True], ids=["psy-off", "psy-on"])
@pytest.mark.parametrize("nrefs", [1, 2, 3])
def test_inter_analysis_matches_jax(nrefs, psy):
    got, want = analyses(nrefs, psy)
    cands = set()
    for blk in DEPTHS:
        g, w = got[blk], want[blk]
        for f in ("cand", "mv_y", "mv_x", "mv_y1", "mv_x1"):
            assert np.array_equal(g[f], w[f]), (blk, f)
        assert np.allclose(g["j"], w["j"], rtol=1e-5, atol=0), blk
        cands |= set(np.unique(g["cand"]).tolist())
    # the frames exercise intra, single-ref and (with 2+ refs) compound
    assert any(c < 10 for c in cands), cands
    assert any(10 <= c < 40 for c in cands), cands
    if nrefs >= 2:
        assert cands & {port_inter.CAND_COMP_NEW,
                        port_inter.CAND_COMP_ZERO}, cands


def test_unpack_rejects_wrong_size():
    with pytest.raises(ValueError):
        port_inter.unpack_inter_analysis(np.zeros(5, np.float32), 64, 64,
                                         DEPTHS)
