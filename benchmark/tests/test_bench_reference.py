"""The benchmark's plain reference against the port's plain versions on
the CPU: the tables the reference makes from AV1's definitions agree
with the port's, and the reference computes what the program's plain
path computes."""

import numpy as np
import pytest
import torch

from benchmark.reference import dct
from benchmark.reference import fullloop as ref_fl
from benchmark.reference import inter as ref_inter
from benchmark.reference import intra as ref_intra
from benchmark.reference import partition as ref_partition
from benchmark.reference import sad as ref_sad
from benchmark.reference.tables import numpy_tables


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
def test_dct_networks_are_dcts(size):
    """The specification's networks, made here, are the scaled DCT-II
    (to the cosines' rounding) and the inverse is the forward's
    transpose."""
    k, j = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    ideal = np.cos(np.pi * (2 * j + 1) * k / (2 * size))
    ideal[0] /= np.sqrt(2.0)
    fwd = dct.dct1d_map(size, 12, False)
    assert np.abs(fwd - ideal).max() < 2e-3 * np.sqrt(size)
    assert np.abs(dct.dct1d_map(size, 12, True) - fwd.T).max() < 1e-5


def test_tables_cross_check_the_port():
    from svt_av1_psyex_tpu_torch.params import reference_numpy

    port = reference_numpy()
    t = numpy_tables()
    for n, (c, r) in port["fwd_mats"].items():
        assert np.array_equal(t[f"fwd_col_{n}"], c)
        assert np.array_equal(t[f"fwd_row_{n}"], r)
    for n, (c, r) in port["inv_mats"].items():
        assert np.array_equal(t[f"inv_col_{n}"], c)
        assert np.array_equal(t[f"inv_row_{n}"], r)
    for cn, p in port["scan_pos"].items():
        assert np.array_equal(t[f"scan_pos_{cn}"], p)
    for blk, w in port["sm_weights"].items():
        assert np.array_equal(t[f"sm_weights_{blk}"], w)
    assert np.array_equal(t["had8"], port["had8"])


def _resid(b, n, seed, scale=1):
    g = torch.Generator().manual_seed(seed)
    r = (torch.randint(-64, 65, (b, n, n), generator=g, dtype=torch.int32)
         + torch.randint(-2, 3, (b, n, n), generator=g,
                         dtype=torch.int32) * 40) * scale
    r[0] = 0
    return r


@pytest.mark.parametrize("n,log_scale", [(4, 0), (8, 0), (16, 0), (32, 1)])
def test_fullloop_matches_port_plain(n, log_scale):
    from svt_av1_psyex_tpu_torch.device.intra import qp6_for, qp_row_for
    from svt_av1_psyex_tpu_torch.ops.fullloop_ref import fullloop_ref

    resid = _resid(64, n, n)
    qp6 = qp6_for(qp_row_for(120, 0, 0, 8), log_scale)
    mp, ip = fullloop_ref(resid, qp6, n, log_scale, want_inv=True)
    mr, ir = ref_fl.fullloop(resid, qp6, n, log_scale, want_inv=True)
    assert torch.equal(mp[:, 2], mr[:, 2]) and torch.equal(mp[:, 1],
                                                           mr[:, 1])
    assert torch.allclose(mp[:, [0, 3]], mr[:, [0, 3]], rtol=1e-5)
    assert torch.allclose(ip, ir, rtol=1e-4, atol=1e-3)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.14159265])
    r = ref_fl.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10 and r[2] == 1.0 + 2**-10
    assert abs(r[3] - 3.14159265) <= 3.14159265 * 2**-11


def test_sad_matches_port_plain_exactly():
    from svt_av1_psyex_tpu_torch.ops.sad_ref import sad_lattice_ref

    g = torch.Generator().manual_seed(3)
    tiles = torch.randint(0, 1024, (3, 64, 64), generator=g,
                          dtype=torch.int32)
    wins = torch.randint(0, 1024, (3, 80, 80), generator=g,
                         dtype=torch.int32)
    got = ref_sad.sad_lattice(tiles, wins)
    assert torch.equal(got, sad_lattice_ref(tiles, wins))
    # the control's bfloat16 sums cannot hold these integers
    assert (ref_sad.sad_lattice(tiles, wins, "bf16") != got).any()


@pytest.mark.parametrize("bd,psy", [(8, False), (8, True), (10, True)])
def test_intra_analysis_matches_port_plain(bd, psy):
    from svt_av1_psyex_tpu_torch.device.intra import (intra_analysis_batch,
                                                      qp_row_for)

    g = np.random.default_rng(bd)
    lumas = g.integers(0, 1 << bd, (1, 128, 128)).astype(np.int32)
    lumas = (lumas + np.roll(lumas, 1, 1) + np.roll(lumas, 1, 2)) // 3
    qp = qp_row_for(120, 0, 0, bd)[None]
    rd = np.array([[900, 300, 700, 10, 20, 20, 40, 40, 40, 50, 256]],
                  np.int32)
    port = intra_analysis_batch(torch.from_numpy(lumas), qp, rd,
                                bit_depth=bd, psy=psy,
                                kernels="plain").numpy()
    ref = ref_intra.intra_analysis(lumas, qp, rd, (64, 32, 16, 8), bd, psy,
                                   "cpu")
    assert ref.shape == port.shape
    assert np.allclose(ref, port, rtol=1e-5)


def _moving_planes(bd, n_refs, h=128, w=192, seed=0):
    """A smooth random field and references shifted from it."""
    g = np.random.default_rng(seed)
    base = g.integers(0, 1 << bd, (h + 40, w + 40)).astype(np.float64)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    src = base[20:20 + h, 20:20 + w].astype(np.int32)
    refs = np.stack([base[20 + dy:20 + dy + h, 20 + dx:20 + dx + w]
                     for dy, dx in ((3, -2), (-5, 7), (0, 11))[:n_refs]])
    return src, refs.astype(np.int32)


@pytest.mark.parametrize("bd,psy,n_refs", [(8, False, 1), (8, True, 2),
                                           (10, True, 3)])
def test_inter_analysis_matches_port_plain(bd, psy, n_refs):
    from svt_av1_psyex_tpu_torch.device.inter import inter_analysis
    from svt_av1_psyex_tpu_torch.device.intra import qp_row_for

    src, refs = _moving_planes(bd, n_refs)
    qp = qp_row_for(110, 0, 0, bd)
    rd = np.array([900, 300, 700, 10, 20, 20, 40, 40, 40, 50]
                  + [200, 260, 320] + [1 << 28] * 5
                  + [150, 210, 270] + [1 << 28] * 5 + [500, 400, 256],
                  np.int32)
    port = inter_analysis(torch.from_numpy(src), torch.from_numpy(refs),
                          qp, rd, bit_depth=bd, psy=psy,
                          kernels="plain").numpy()
    ref = ref_inter.inter_analysis(src, refs, qp, rd, (64, 32, 16, 8), bd,
                                   psy, "cpu")
    assert ref.shape == port.shape
    assert np.allclose(ref, port, rtol=1e-5)


class _Lattice:
    """What the port's plan_frame reads of its DeviceIntraMD."""


@pytest.mark.parametrize("h,w,pmin", [(128, 192, 8), (120, 200, 16),
                                      (72, 136, 8)])
def test_partition_dp_matches_port(h, w, pmin):
    from svt_av1_psyex_tpu_torch.codec.md_device import DeviceIntraMD

    g = np.random.default_rng(h + w)
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    depths = (64, 32, 16, 8)
    dmd = _Lattice()
    dmd._hp, dmd._wp = hp, wp
    dmd.mi_rows, dmd.mi_cols = h // 4, w // 4
    dmd.DEPTHS = depths
    dmd.md = _Lattice()
    dmd.md.min_bsize = {8: 3, 16: 6}[pmin]
    # J rising with the block's area, so that both choices occur
    dmd.stats = {b: {"j": (g.random((hp // b, wp // b)) * b * b * 900
                           ).astype(np.float32)} for b in depths}
    costs = {b: g.integers(100, 3000, 10) for b in (16, 32, 64)}
    dmd.part_costs = costs
    rdg = g.integers(200, 4000, (hp // 64, wp // 64))
    DeviceIntraMD.plan_frame(dmd, rdg)
    rec = {"j": {b: dmd.stats[b]["j"] for b in depths}, "rdmult_sb": rdg,
           "costs": {b: (int(c[0]), int(c[3])) for b, c in costs.items()},
           "h": h, "w": w, "hp": hp, "wp": wp, "depths": depths,
           "pmin": pmin}
    ref = ref_partition.decide(rec)
    assert set(ref) == set(dmd._split)
    for b in ref:
        assert np.array_equal(ref[b], dmd._split[b]), b
    assert any(v.any() for v in ref.values())
    assert not all(v.all() for v in ref.values())
