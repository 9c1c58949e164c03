"""The yardstick's arithmetic against hand counts, and the trace reader on
a synthetic trace."""

from __future__ import annotations

import json

import pytest

from benchmark.core import readers, trace
from benchmark.core.cell import BENCH
from benchmark.core.work import PEAK_BYTES_PER_S, PEAK_FLOPS, stage_bound_s, stage_work
from benchmark.families import kdlae_student, kdlae_teacher


def _net(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["network"]


def test_stage_bound_at_512_96_four_blocks():
    """(1, 512, 512, 96), 4 blocks, one head, hidden 255, bf16: 271,836
    FLOPs a pixel and block, operation-bound at 0.2882 ms."""
    flops, nbytes = stage_work(1, 512, 512, 96, 4, 1, 255, 2)
    assert flops == 271836 * 512 * 512 * 4
    assert flops / PEAK_FLOPS["bfloat16"] > nbytes / PEAK_BYTES_PER_S
    assert stage_bound_s(1, 512, 512, 96, 4, 1, 255, 2) * 1e3 == pytest.approx(0.2882, abs=5e-5)


def test_teacher_flops_per_512_frame():
    assert kdlae_teacher.flops_per_frame(_net("kdlaet_bf16"), 512, 512) / 1e12 == \
        pytest.approx(1.918, abs=5e-4)


def test_student_flops_per_frame_and_step():
    net = _net("kdlaes_fp32")
    assert kdlae_student.flops_per_stack(net, 7, 512, 512) / 7 / 1e9 == \
        pytest.approx(29.76, abs=5e-3)
    step = kdlae_student.flops_per_step(net, 4, 7, 384, {"l1loss_weight": 0.9,
                                                         "temporal_weight": 0.1})
    fwd = kdlae_student.flops_per_stack(net, 7, 384, 384) * 4
    assert 2.5 * fwd < step < 3.5 * fwd  # backward about twice the forward


def _synthetic(path, kernel_us):
    """One window of 1000 us on one thread: two stage spans, each launching
    one kernel of ``kernel_us``, and one kernel outside them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 1000, "tid": 1}]
    spans = [("stage|1|512|512|96|1|4|255|2", 100), ("stage|1|256|256|96|2|6|255|2", 400)]
    corr = 1
    for name, t in spans:
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": t, "dur": 50, "tid": 1})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 10,
                   "dur": 5, "tid": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": t + 20,
                   "dur": kernel_us, "tid": 7, "args": {"correlation": corr}})
        corr += 1
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 700, "dur": 5,
               "tid": 1, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "kernel", "name": "conv", "ts": 710, "dur": 100, "tid": 7,
               "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 850, "dur": 100, "tid": 1})
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(str(path))


@pytest.mark.parametrize("kernel_us", [400.0, 2000.0])
def test_roofline_share_in_range_on_a_synthetic_trace(tmp_path, kernel_us):
    rec = {**_synthetic(tmp_path / "t.json", kernel_us), "units": 1}
    summary = trace.summary(rec)
    assert summary["unmatched"] == 0 and len(summary["stage_spans"]) == 2
    assert [s for _, _, s in summary["kernels"]].count(None) == 1
    share = readers.stages_roofline({"trace": rec})
    bound = (stage_bound_s(1, 512, 512, 96, 4, 1, 255, 2)
             + stage_bound_s(1, 256, 256, 96, 6, 2, 255, 2))
    assert share == pytest.approx(100 * bound / (2 * kernel_us / 1e6))
    assert 0 < share <= 100
    idle = readers.idle_share({"trace": rec})
    assert 0 < idle < 100
    assert readers.outside_stages_ms({"trace": rec}) == pytest.approx(0.1)
    assert summary["breakdown"]["device_ops"][0][0] in ("k1", "k2")
