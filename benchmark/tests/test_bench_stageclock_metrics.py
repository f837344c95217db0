"""The readers of the stage clock's parts and counts (benchmark/metrics/
`md.leaf_commit_ms`, `frame.dispatch_ms`, `filters.lr_host_ms`,
`ec.us_per_symbol`, `ec.symbols_per_call`) on hand-made records: each
reads its keys, and gives None where they are absent, as on a program
whose clock lacks them."""

import pytest

from benchmark.harness.manifest import metric_reader

NEW = ("md.leaf_commit_ms", "frame.dispatch_ms", "filters.lr_host_ms",
       "ec.us_per_symbol", "ec.symbols_per_call")


def _record(stages, frames=4):
    return {"frames": frames, "window_s": 50.0, "stages": stages,
            "launches": {"fullloop": [], "sad": []}, "kernel_s": {},
            "busy_s": None}


FULL = {"begin": 1.2, "begin.dispatch": 0.8, "pick": 0.4,
        "commit_leaf": 6.0, "commit": 2.0, "lr": 4.0, "lr.build": 1.0,
        "lr.exact": 2.0, "ec": 12.0, "n.ec_symbols": 3_000_000,
        "n.ec_calls": 400_000}


def test_readings_of_a_full_record():
    rec = _record(FULL)
    assert metric_reader("md.leaf_commit_ms")(rec) == pytest.approx(1500.0)
    assert metric_reader("frame.dispatch_ms")(rec) == pytest.approx(200.0)
    assert metric_reader("filters.lr_host_ms")(rec) == pytest.approx(750.0)
    assert metric_reader("ec.us_per_symbol")(rec) == pytest.approx(4.0)
    assert metric_reader("ec.symbols_per_call")(rec) == pytest.approx(7.5)


def test_lr_host_reads_either_part_alone():
    read = metric_reader("filters.lr_host_ms")
    assert read(_record({"lr": 1.0, "lr.build": 0.4})) == pytest.approx(100.0)
    assert read(_record({"lr": 1.0, "lr.exact": 0.8})) == pytest.approx(200.0)


@pytest.mark.parametrize("metric", NEW)
def test_none_on_the_parents_clock(metric):
    """The keys the clock had before these parts and counts: no reading."""
    old = {"tf": 0.2, "tpl": 0.2, "begin": 1.2, "device_wait": 0.01,
           "pick": 8.0, "commit": 2.0, "lf_grids": 0.1, "dlf": 1.0,
           "cdef": 1.0, "lr": 4.0, "lr_build": 1.0, "lr_exact": 2.0,
           "lr_up": 0.1, "lr_wd": 0.1, "lr_sg": 0.1, "filters": 0.01,
           "ec": 12.0}
    assert metric_reader(metric)(_record(old)) is None


@pytest.mark.parametrize("metric", NEW)
def test_none_without_frames_or_stages(metric):
    read = metric_reader(metric)
    assert read(_record({})) is None
    if metric.endswith("_ms"):
        assert read(_record(FULL, frames=0)) is None


@pytest.mark.parametrize("drop", ["ec", "n.ec_symbols", "n.ec_calls"])
def test_ec_readers_need_each_of_their_keys(drop):
    stages = {k: v for k, v in FULL.items() if k != drop}
    per_symbol = metric_reader("ec.us_per_symbol")(_record(stages))
    per_call = metric_reader("ec.symbols_per_call")(_record(stages))
    assert (per_symbol is None) == (drop in ("ec", "n.ec_symbols"))
    assert (per_call is None) == (drop in ("n.ec_symbols", "n.ec_calls"))
    assert metric_reader("ec.us_per_symbol")(
        _record(dict(stages, **{"n.ec_symbols": 0}))) is None
