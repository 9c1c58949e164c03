"""A cell, resolved from ``BENCHMARK.json`` by name: its configuration, its
traffic mix, the limits of its check and the metrics it reports. Each piece
is a file found by its name, so that a new cell is an entry in the
manifest plus, where needed, new files:

  configs/<config>.json   (the ``file`` the manifest gives the configuration)
  traffic/<traffic>.json  (the mix; its ``loop`` names loops/<loop>.py)
  limits/<workload>.json  (each compared number's limit)
  metrics/<metric>.py     (a per-layer metric's reader: ``read(records)``)
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path

    @property
    def bench(self) -> Path:
        return self.root / BENCH.name


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str, e2e_of_cell: set[str] | None = None) -> bool:
    """Whether a metric belongs in a cell's line: listed for it, or, with no
    list, an end-to-end metric in every cell, a per-layer one in every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return e2e_of_cell is None or metric["moves"] in e2e_of_cell


def resolve(workload: str, root: Path = ROOT) -> Cell:
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in m["configs"]}
    bench = root / BENCH.name
    e2e = [e for e in m["end_to_end"] if reports(e, workload)]
    names = {e["name"] for e in e2e}
    per_layer = [p for p in m["per_layer"] if reports(p, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                config=_read(root / configs[w["config"]]["file"]),
                traffic_name=w["traffic"],
                traffic=_read(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_read(bench / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(cell: Cell):
    """The loop class the cell's traffic names."""
    name = cell.traffic["loop"]
    return importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.loops.{name}").Loop


def reader(cell: Cell, metric: str):
    """``read(records)`` of metrics/<metric>.py."""
    return _load(cell.bench / "metrics" / f"{metric}.py", f"_metric_{metric}").read
