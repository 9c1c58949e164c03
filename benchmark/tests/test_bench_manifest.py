"""The manifest holds to the benchmark's format, every workload and
metric resolves to its files by name, and a configuration, a traffic mix
and a per-layer metric can each be added as new files plus a manifest
entry, with no edit to a file that is there."""

from __future__ import annotations

import json
import re
import shutil
import time

from benchmark.core import cell, harness, trace
from benchmark.core.cell import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_manifest_keys_and_names():
    m = cell.manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    assert all(0.01 <= e["bound"] <= 0.25 for e in m["end_to_end"])
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_workload_resolves_and_reports():
    m = cell.manifest()
    for w in m["workloads"]:
        c = cell.resolve(w["name"])
        assert c.chips == 1
        assert cell.loop(c) is not None
        e2e = {e["name"] for e in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert set(e2e) - {"setup_s"} <= set(c.traffic["report"])
        assert c.per_layer, w["name"]
        for p in c.per_layer:
            assert p["moves"] in e2e, (p["name"], w["name"])
            assert callable(cell.reader(c, p["name"]))
        assert c.limits


COPY_BYTES = """
def read(records):
    t = records.get("trace")
    if not t or not t["units"]:
        return None
    n = sum((e.get("args") or {}).get("bytes", 0)
            for e in t["events"] if e.get("cat") == "gpu_memcpy" and t["t0"] <= e["ts"] < t["t1"])
    return n / t["units"] if n else None
"""

COUNTED = """
def read(records):
    c = records["counters"]
    assert set(c) == {"before", "after"} and records["trace"]["counters"]["after"] is not None
    return 42.0 + 0 * records["window"]["units"]
"""


def _copies(path, nbytes):
    """A trace of one window on one thread with two host-to-device copies of
    ``nbytes`` each inside it and one outside."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 1000, "tid": 1}]
    for k, t in enumerate((100, 500, 1500)):
        ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
                   "ts": t, "dur": 40, "tid": 7, "args": {"bytes": nbytes, "correlation": k}})
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(str(path))


def test_new_config_traffic_and_metric_are_picked_up(tiny):
    """A new configuration, traffic mix, limits and per-layer metrics, as new
    files and manifest entries only, run through the harness: one reads the
    program's counters, one the bytes of the trace's copies (which a CPU run
    has none of, so it is left out of the line there)."""
    bench = tiny / BENCH.name
    shutil.copy(bench / "configs" / "kdlaes_fp32.json", bench / "configs" / "dummy_cfg.json")
    mix = json.loads((bench / "traffic" / "stacks18x7_512.json").read_text())
    mix.update(batch=2, frame=[32, 64])
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "limits" / "dummy_cell.json").write_text(json.dumps({"differ": 0.01}))
    (bench / "metrics" / "dummy_metric.py").write_text(COUNTED)
    (bench / "metrics" / "dummy_bytes.py").write_text(COPY_BYTES)
    m = json.loads((tiny / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dummy_cfg", "source": "https://example.org/dummy",
                         "file": "benchmark/configs/dummy_cfg.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mix",
                           "chips": 1, "why": "a test"})
    m["end_to_end"][1]["workloads"].append("dummy_cell")  # frames_per_s
    m["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "frames_per_s", "workloads": ["dummy_cell"]})
    m["per_layer"].append({"name": "dummy_bytes", "unit": "B", "better": "lower",
                           "source": "device_trace", "layer": "device",
                           "moves": "frames_per_s", "workloads": ["dummy_cell"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(m))
    c = cell.resolve("dummy_cell", tiny)
    assert c.traffic["frame"] == [32, 64] and c.config_name == "dummy_cfg"
    assert [p["name"] for p in c.per_layer] == ["dummy_metric", "dummy_bytes"]
    res, _ = harness.run("dummy_cell", 3, 0.2, True, "cpu", time.perf_counter(), tiny,
                         log=lambda *a: None)
    assert res["correct"] and res["metrics"]["dummy_metric"]["value"] == 42.0
    assert "dummy_bytes" not in res["metrics"]
    copies = {**_copies(tiny / "copies.json", 3 << 20), "units": 2}
    assert cell.reader(c, "dummy_bytes")({"trace": copies}) == 3 << 20
    res, _ = harness.run("dummy_cell", 3, 0.2, False, "cpu", time.perf_counter(), tiny,
                         log=lambda *a: None)
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
