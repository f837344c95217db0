"""The port's motion estimation (svt_av1_psyex_tpu_torch/device/me.py)
against the JAX package's device/me.py on the same planes. ME is integer
end to end (HME sums, floor decimation, SAD lattices, first-index
argmins, the distance tie-break), so every lattice, motion vector and
SAD must agree bit for bit. The JAX side runs its jnp route, as the JAX
package's own tests run it on the CPU."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu.device import me as jax_me  # noqa: E402
from svt_av1_psyex_tpu_torch.device import me as port_me  # noqa: E402


def shifted_pair(h, w, dy, dx, seed, smooth=True):
    """A ref and a src equal to ref moved by (dy, dx): src[y] = ref[y+dy]
    (tests/test_device_me.py's recipe)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 255, (h + 256, w + 256), np.int32)
    if smooth:
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    ref = big[128: 128 + h, 128: 128 + w].copy()
    src = big[128 + dy: 128 + dy + h, 128 + dx: 128 + dx + w].copy()
    return src, ref


def coarse_pair(h, w, dy, dx, seed):
    """Bilinear-upsampled coarse noise moved by (dy, dx): low-frequency
    content whose decimated levels carry the motion, so a shift beyond
    the +-8 full-pel window is found by the HME (tests/test_device_me.py
    test_recovers_large_shift_via_hme)."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 255, ((h + 256) // 32 + 2,
                                   (w + 256) // 32 + 2)).astype(np.float64)
    yy = np.arange(h + 256) / 32.0
    xx = np.arange(w + 256) / 32.0
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = (yy - y0)[:, None], (xx - x0)[None, :]
    big = ((coarse[y0][:, x0] * (1 - fy) * (1 - fx)
            + coarse[y0 + 1][:, x0] * fy * (1 - fx)
            + coarse[y0][:, x0 + 1] * (1 - fy) * fx
            + coarse[y0 + 1][:, x0 + 1] * fy * fx)).astype(np.int32)
    ref = big[128: 128 + h, 128: 128 + w].copy()
    src = big[128 + dy: 128 + dy + h, 128 + dx: 128 + dx + w].copy()
    return src, ref


# name -> (src, ref, bit_depth); every plane a multiple of 64
CASES = {
    # under 128 px: no L0 level
    "64x128-no-L0": shifted_pair(64, 128, 2, -3, seed=1) + (8,),
    # random content, so SAD ties are common in flat decimated levels
    "128x192-noise": shifted_pair(128, 192, -5, 4, seed=2,
                                  smooth=False) + (8,),
    # 80 px shift: needs the HME pyramid
    "192x256-hme": coarse_pair(192, 256, 48, -80, seed=3) + (8,),
    # 10-bit samples up to 1023
    "128x128-10bit": tuple(p * 4 + 3 for p in shifted_pair(
        128, 128, 1, 6, seed=4)) + (10,),
}


# jitted as inter_analysis and me_fullpel run them (eager JAX dispatches
# every op on its own and is slow)
jax_fullpel_lattice = jax.jit(jax_me.fullpel_lattice, static_argnums=2)
jax_geometry_best = jax.jit(jax_me.geometry_best, static_argnums=(4, 5))


def jax_lattice(src, ref, bd):
    out = jax_fullpel_lattice(jnp.asarray(src), jnp.asarray(ref),
                              (1 << bd) - 1)
    return [np.asarray(a) for a in out]


def port_lattice(src, ref, bd):
    out = port_me.fullpel_lattice(torch.from_numpy(src),
                                  torch.from_numpy(ref), (1 << bd) - 1)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fullpel_lattice_and_geometry_best_bit_exact(case):
    src, ref, bd = CASES[case]
    want = jax_lattice(src, ref, bd)
    got = port_lattice(src, ref, bd)
    for name, a, b in zip(("sad8_h", "sad8_z", "cyf", "cxf"), got, want):
        assert a.shape == b.shape and np.array_equal(a, b), name
    for gh, gw in port_me.GEOMETRIES:
        g = port_me.geometry_best(*(torch.from_numpy(a) for a in got),
                                  gh, gw)
        w = jax_geometry_best(*(jnp.asarray(a) for a in want), gh, gw)
        for x, y in zip(g, w):
            assert np.array_equal(x.numpy(), np.asarray(y)), (gh, gw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_me_fullpel_bit_exact(case):
    src, ref, bd = CASES[case]
    refs = np.stack([ref, src[::-1].copy()])       # two refs, one unrelated
    want = np.asarray(jax_me.me_fullpel(jnp.asarray(src), jnp.asarray(refs),
                                        bit_depth=bd))
    got = port_me.me_fullpel(torch.from_numpy(src), torch.from_numpy(refs),
                             bit_depth=bd)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_hme_recovers_large_shift():
    src, ref, bd = CASES["192x256-hme"]
    row = port_me.me_fullpel(torch.from_numpy(src),
                             torch.from_numpy(ref[None]))[0].numpy()
    m = port_me.unpack_me(row, 192, 256)[(64, 64)]
    # SB (0, 2) sees its true match wholly inside the frame
    assert tuple(m["mv"][0, 2]) == (48, -80) and m["sad"][0, 2] == 0


def test_run_device_me_pads_and_lookup_matches_jax():
    """A 100x150 frame (not 64-aligned) is edge-padded to 128x192 by
    run_device_me; the field and every lookup equal the JAX package's."""
    src, ref = shifted_pair(100, 150, 3, -2, seed=5)
    planes = {1: ref, 4: src[::-1].copy()}
    want = jax_me.run_device_me(src, planes)
    got = port_me.run_device_me(src, planes, device="cpu")
    assert (got.h, got.w) == (want.h, want.w) == (128, 192)
    assert sorted(got.maps) == sorted(want.maps) == [1, 4]
    for name in planes:
        for geo in port_me.GEOMETRIES:
            for k in ("mv", "sad"):
                assert np.array_equal(got.maps[name][geo][k],
                                      want.maps[name][geo][k]), (name, geo)
    for args in [(1, 64, 64, 64, 64), (4, 8, 16, 8, 8), (1, 0, 0, 48, 24),
                 (1, 140, 96, 16, 32), (1, 190, 120, 4, 4),
                 (2, 0, 0, 64, 64)]:
        assert got.lookup(*args) == want.lookup(*args), args
    assert got.lookup(2, 0, 0, 64, 64) is None


def test_unpack_rejects_wrong_size():
    with pytest.raises(ValueError):
        port_me.unpack_me(np.zeros(7, np.int32), 64, 64)
