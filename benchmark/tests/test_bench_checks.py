"""Each cell's check, driven through a whole run on the CPU at a small size
with the harness's look for a CUDA card skipped: a sound run comes out correct;
with the timed path broken underneath (each fault the cell can have,
``benchmark/faults.py``) ``correct`` comes out false; the control (the
reference in the configuration's lower precision in the program's place),
held to the cell's limits by the harness's own rule, comes out not
correct."""

from __future__ import annotations

import time

import pytest

from benchmark.core import cell, harness
from benchmark.faults import BY_LOOP, FAULTS

CELLS = ["kdlaet_512_group8", "kdlaet_512_request", "kdlaes_512x7_batch18",
         "kdlaes_train_4x7_384"]
CASES = [(w, f) for w in CELLS for f in BY_LOOP[cell.resolve(w).traffic["loop"]]]


def _run(tiny, workload, **kw):
    return harness.run(workload, 2 ** 31 + 5, 0.3, False, "cpu", time.perf_counter(), tiny,
                       log=lambda *a: None, **kw)


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(tiny, workload, fault):
    with FAULTS[fault]():
        res, _ = _run(tiny, workload)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_and_control(tiny, workload):
    res, checks = _run(tiny, workload, controls=("control",))
    assert res["correct"] is True and res["failed"] == 0
    control = res["controls"]["control"]
    assert control["correct"] is False, control
    assert set(control["checks"]) == set(checks)
    assert any(control["checks"][k]["value"] > c["limit"] for k, c in checks.items()), control
