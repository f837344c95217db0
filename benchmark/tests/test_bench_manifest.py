"""BENCHMARK.json against the benchmark's contract, and every file a
cell, a mix or a metric names found by that name."""

import json
import re

import pytest

from benchmark.harness.manifest import (BENCH, ROOT, load_cell,
                                        load_manifest, metric_reader)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
        assert c["source"].startswith("https://")
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"fps", "kbit_per_frame", "mse_y8", "setup_s"}
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert e2e["setup_s"]["bound"] == 0.25
    # every cell reports setup_s and another end-to-end metric
    for cell in CELLS:
        names = [x["name"] for x in load_cell(cell).end_to_end]
        assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = load_cell(cell)
    assert c.config["name"] == c.config_name
    assert {"kind", "chunk_frames", "quality_frames"} <= set(c.traffic)
    assert (BENCH / "checks" / f"{cell}.json").is_file()
    assert {"fullloop_off", "sad_off", "intra_off", "inter_off", "dp_off",
            "stream_faults"} == set(c.limits)
    for key in ("source_width", "source_height", "enc_mode", "crf"):
        assert key in c.settings


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    MANIFEST["per_layer"]])
def test_per_layer_readers(metric):
    m = next(x for x in MANIFEST["per_layer"] if x["name"] == metric)
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["moves"] in {x["name"] for x in MANIFEST["end_to_end"]}
    assert set(m["workloads"]) <= set(CELLS)
    read = metric_reader(metric)
    empty = {"frames": 0, "window_s": 0.0, "stages": {},
             "launches": {"fullloop": [], "sad": []}, "kernel_s": {},
             "busy_s": None}
    assert read(empty) is None          # nothing to read: no number


def test_readers_on_a_record():
    rec = {"frames": 4, "window_s": 50.0,
           "stages": {"tf": 0.2, "tpl": 0.2, "begin": 1.0, "ec": 8.0,
                      "dlf": 1.0, "cdef": 1.0, "lr": 2.0},
           "launches": {"fullloop": [(228480, 32, False, 4)],
                        "sad": [(240,)]},
           "kernel_s": {"fullloop": 0.0025137, "sad": 0.0000481},
           "busy_s": 5.0}
    assert metric_reader("api.tf_tpl_ms")(rec) == pytest.approx(100.0)
    assert metric_reader("filters.ms")(rec) == pytest.approx(1000.0)
    assert metric_reader("ec.ms")(rec) == pytest.approx(2000.0)
    assert metric_reader("device.idle_pct")(rec) == pytest.approx(90.0)
    # PERF.md's kernel table: 35.6% and 70.6%
    assert metric_reader("fullloop_roofline")(rec) == pytest.approx(35.6,
                                                                    abs=0.1)
    assert metric_reader("sad_roofline")(rec) == pytest.approx(70.6,
                                                               abs=0.1)


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        load_cell("no_such.cell")
