"""A copy of the benchmark's manifest and data files, cut to sizes that a
CPU test run holds: the same cells, loops and checks on a narrow teacher
and student, small frames and short mixes."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.core.cell import BENCH, ROOT

TEACHER = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
           "heads": [1, 1, 2, 2]}
STUDENT = {"hidden_channels": [4, 8, 16]}
TRAFFIC = {
    "group8_seq64_512": {"frame": [32, 32], "pool": 6, "sequence": 8, "group": 4,
                         "warmup_sequence": 4, "check_frames": 4, "trace_items": 1},
    "request_512": {"frame": [32, 32], "pool": 4, "check_frames": 3, "warmup": 1,
                    "trace_items": 2},
    "stacks18x7_512": {"frame": [32, 32], "batch": 3, "pool_batches": 2, "check_stacks": 4,
                       "warmup": 1, "trace_items": 2},
    "train_4x7_384": {"frame": [48, 48], "corpus_frames": 12, "batch_size_per_gpu": 2,
                      "trace_items": 2},
}


def _edit(path: Path, change) -> None:
    data = json.loads(path.read_text())
    change(data)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path) -> Path:
    """A checkout-like directory: BENCHMARK.json and benchmark/, cut small."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp / BENCH.name
    _edit(bench / "configs" / "kdlaet_bf16.json", lambda d: d["network"].update(TEACHER))

    def student(d):
        d["network"].update(STUDENT)
        d["datasets_train"]["gt_sizes"] = [16, 16, 16, 16, 16, 32]

    _edit(bench / "configs" / "kdlaes_fp32.json", student)
    for name, change in TRAFFIC.items():
        _edit(bench / "traffic" / f"{name}.json", lambda d, c=change: d.update(c))
    return tmp
