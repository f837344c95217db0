"""Finding a cell's files by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; each is a JSON file of
its own (benchmark/configs/<config>.json, benchmark/traffic/<traffic>
.json), and each per-layer metric is a reader of its own
(benchmark/metrics/<name>.py, a function `read(record)`). The limits of
a cell's correctness numbers are in benchmark/checks/<cell>.json. A new
cell, mix or metric is new files and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict

    @property
    def settings(self) -> dict:
        """The encoder's settings: the configuration's, then the mix's."""
        return {**self.config["settings"], **self.traffic.get("settings", {})}


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None,
              bench: Path = BENCH) -> Cell:
    manifest = load_manifest() if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(bench.parent / configs[w["config"]]["file"])
    traffic = _json(bench / "traffic" / f"{w['traffic']}.json")
    limits_file = bench / "checks" / f"{name}.json"
    limits = _json(limits_file)["limits"] if limits_file.exists() else {}
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic,
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)],
                limits)


def pin_host_threads(cell: Cell) -> int:
    """Sets the deployment's host threads (`host_threads` of the
    configuration) for the math libraries, before numpy and torch load;
    returns it for torch.set_num_threads."""
    n = int(cell.config["host_threads"])
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(n)
    return n


def metric_reader(name: str, bench: Path = BENCH):
    """The `read(record)` function of benchmark/metrics/<name>.py."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
