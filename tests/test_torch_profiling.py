"""The port's profiler (``utils/profiling.py``) and ``train
--profile-steps``, on the CPU:

  * ``raie-torch train --profile-steps 2 --device cpu`` on a narrow
    device-resident student writes a Chrome trace under <log>/profile, logs
    ``profile (ms by kernel over 2 steps): ...`` with a non-empty split and
    records it in metrics.jsonl;
  * ``aggregate_trace`` sums device events by name and counts them, and on
    a trace without device events takes the host's top-level operators;
    ``h2d_copies`` reads the host-to-device copies' bytes; ``annotate``
    names a region of the trace;
  * ``StepTimer`` gives the JAX package's readings under the same clock.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.utils import profiling as jprof
from rethink_acoustic_image_enhancement_tpu_torch import cli
from rethink_acoustic_image_enhancement_tpu_torch.utils import profiling as tprof
from torch_train_corpus import device_student_config, write_student_corpus, write_yml

torch.set_num_threads(2)


def test_train_profile_steps_on_the_cpu(tmp_path, monkeypatch):
    roots = write_student_corpus(str(tmp_path / "frames"), 10, 16, 16, seed=3)
    cfg = device_student_config(roots, 6)
    yml = write_yml(cfg, tmp_path / "opt.yml")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "-opt", yml, "--profile-steps", "2", "--device", "cpu"]) == 0
    log_dir = tmp_path / "experiments" / cfg["name"]
    assert glob.glob(str(log_dir / "profile" / "trace_*.json"))
    (log_file,) = glob.glob(str(log_dir / "train_*.log"))
    with open(log_file) as f:
        lines = [ln for ln in f if "profile (ms by kernel over 2 steps): " in ln]
    assert len(lines) == 1 and "=" in lines[0].split("steps): ")[1], lines
    with open(log_dir / "metrics.jsonl") as f:
        (rec,) = [r for r in map(json.loads, f) if r["kind"] == "profile"]
    assert rec["iter"] == 5 and rec["steps"] == 2 and rec["events"] > 0
    assert rec["ms_by_kernel"] and all(v >= 0 for v in rec["ms_by_kernel"].values())


def _write_trace(d, events):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "trace_1000000000000000000.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_aggregate_trace_sums_device_events(tmp_path):
    ev = lambda cat, name, ts, dur, **args: {"ph": "X", "cat": cat, "name": name,  # noqa: E731
                                             "ts": ts, "dur": dur, "pid": 0, "tid": 7,
                                             "args": args}
    _write_trace(tmp_path, [
        ev("kernel", "gemm", 0, 500), ev("kernel", "gemm", 600, 700),
        ev("kernel", "relu", 1400, 100),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1600, 5, bytes=32),
        ev("cpu_op", "aten::mm", 0, 2000),
    ])
    ms, n = tprof.aggregate_trace(str(tmp_path))
    assert n == 4 and list(ms) == ["gemm", "relu", "Memcpy HtoD (Pageable -> Device)"]
    assert ms["gemm"] == pytest.approx(1.2) and ms["relu"] == pytest.approx(0.1)
    assert tprof.h2d_copies(str(tmp_path)) == [32]
    assert tprof.aggregate_trace(str(tmp_path / "none")) == ({}, 0)


def test_aggregate_trace_on_a_host_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("my_region"):
            for _ in range(3):
                x = torch.relu(x @ x)
    names = {e["name"] for e in tprof.trace_events(str(tmp_path))}
    assert "my_region" in names
    ms, n = tprof.aggregate_trace(str(tmp_path))
    assert n > 0 and ms
    # top level only: aten::matmul, not the aten::mm it calls
    assert "aten::matmul" in ms and "aten::mm" not in ms, ms
    assert tprof.h2d_copies(str(tmp_path)) == []


def test_uploads_counts_host_to_device_copies():
    """On the meta device here, as it counts copies to the GPU on the card."""
    with tprof.uploads() as copies:
        torch.zeros(4).to("meta")
        torch.as_tensor(np.arange(6), device="meta")
        torch.empty(3, device="meta").copy_(torch.ones(3))
        torch.ones(2) + 1  # no copy
        torch.ones(2).to("cpu", copy=True)  # host to host
    assert copies == [16, 48, 12]


def test_step_timer_matches_jax(monkeypatch):
    readings = []
    for mod in (jprof, tprof):
        ticks = iter([0.0, 0.5, 2.0, 2.25, 3.0, 3.5, 4.75])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(momentum=0.8)
        got = []
        for _ in range(3):
            timer.data_ready()
            timer.step_done()
            got.append((timer.data_time, timer.iter_time, timer.avg_iter_time))
        got.append(timer.eta_seconds(10))
        readings.append(got)
        monkeypatch.undo()
    assert readings[0] == readings[1]
