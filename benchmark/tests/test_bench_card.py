"""On the card: a short run of each cell through ``python3 -m
benchmark.run`` ends with a correct result line, and the real TF32 control
of the student's check separates from the program."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.core.cell import ROOT, manifest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", "2147483713", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_student_tf32_control_fails_on_the_card(card):
    import time

    from benchmark.core import harness

    res, checks = harness.run("kdlaes_512x7_batch18", 2147483717, 2.0, False, card,
                              time.perf_counter(), controls=("control_cudnn_tf32",))
    assert res["correct"]
    control = res["controls"]["control_cudnn_tf32"]
    assert control["correct"] is False, control
