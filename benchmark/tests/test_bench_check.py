"""The check that decides `correct`, driven through a whole run of a
small cell: the program passes, the control (the reference one
precision lower in the program's place) fails, and each fault planted
in the timed path under the run fails.

On the CPU the cell is cut to a 128x64 clip; the card tests run the same
on the card. The control at the cells' own sizes is read on the card by
benchmark/control.py (PERF.md gives its readings)."""

import time

import numpy as np
import pytest

from benchmark.harness import check
from benchmark.harness.probes import FAULTS, Probes, Sampling
from benchmark.harness.runner import run_cell
from benchmark.tests.conftest import small_cell

CELLS = ["p8_720p.texture", "p6_1080p10.blobs"]
SEED = 2**33 + 5


def run(cell, device, fault=None, control=False):
    # every launch sampled whole, so that one altered answer is seen; the
    # window holds the keyframe and inter frames (a frame takes about
    # 0.1-0.5 s at this size)
    probes = Probes(SEED, Sampling(1.0, 10**6, 1 << 40),
                    Sampling(1.0, 10**6, 1 << 40), fault=fault)
    return run_cell(cell, SEED, 2.0, False, device, time.perf_counter(),
                    probes=probes, control=control)


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_control_fails(name):
    cell = small_cell(name)
    out = run(cell, "cpu", control=True)
    assert out["correct"], out["lines"]
    ctrl = dict(out["control"], stream_faults=0)
    ok, checks = check.judge(ctrl, cell.limits)
    assert not ok, checks
    for k in ("fullloop_off", "sad_off", "intra_off", "inter_off"):
        assert out["control"][k] > cell.limits[k]["limit"], k


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_fail(fault):
    out = run(small_cell(), "cpu", fault=fault)
    assert not out["correct"], out["lines"]


@pytest.mark.cuda
def test_card_program_passes_control_fails(card):
    cell = small_cell(width=256, height=128)
    out = run(cell, card, control=True)
    assert out["correct"], out["lines"]
    ok, _ = check.judge(dict(out["control"], stream_faults=0), cell.limits)
    assert not ok


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_card_faults_fail(card, fault):
    out = run(small_cell(width=256, height=128), card, fault=fault)
    assert not out["correct"], out["lines"]


def _packed_inter(depths=(64, 32), hp=128, wp=128, seed=0):
    g = np.random.default_rng(seed)
    n = sum(6 * (hp // b) * (wp // b) for b in depths)
    row = g.integers(0, 9, n).astype(np.float32)
    return {"src": np.zeros((hp, wp)), "depths": depths}, row


def test_inter_off_sees_an_altered_answer():
    a, row = _packed_inter()
    assert check.inter_off([a], [row], [row.copy()]) == 0.0
    for field in range(6):          # j, cand, mv_y, mv_x, mv_y1, mv_x1
        bad = row.copy()
        bad[field * 4] += 1         # the 64 depth has 4 blocks a field
        assert check.inter_off([a], [bad], [row]) == pytest.approx(1 / 20)


def test_dp_off_sees_an_altered_decision():
    got = {64: np.zeros((2, 2), bool), 32: np.zeros((4, 4), bool)}
    ref = {k: v.copy() for k, v in got.items()}
    assert check.dp_off([{"split": got}], [ref]) == 0.0
    got[32][1, 2] = True
    assert check.dp_off([{"split": got}], [ref]) == pytest.approx(1 / 20)


def test_dp_sample_is_drawn_from_the_seed():
    plans = [{"i": i} for i in range(30)]
    a = check.dp_sample(plans, 7)
    assert len(a) == check.DP_FRAMES and a == check.dp_sample(plans, 7)
    assert a != check.dp_sample(plans, 8)
    assert check.dp_sample(plans[:3], 7) == plans[:3]
