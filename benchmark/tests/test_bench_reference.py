"""The plain references agree with the program's plain paths on seeded
weights at small sizes: the teacher with ``fused=False`` (and the bf16
fused route's CPU stage at the serving boundary), the student, and the
training step."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark.core import harness
from benchmark.core.cell import BENCH
from benchmark.families import kdlae_student, kdlae_teacher
from benchmark.reference import serving
from benchmark.reference import student as ref_student
from benchmark.reference import teacher as ref_teacher
from benchmark.tests.tiny import STUDENT, TEACHER


def _config(name, **net):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["network"].update(net)
    return cfg


@pytest.mark.parametrize("static", ["train", "test"])
def test_teacher_matches_program_plain_path(static):
    net = _config("kdlaet_bf16", **TEACHER, static=static)["network"]
    params = kdlae_teacher.init_params(net, 7, "cpu", "float32")
    model = kdlae_teacher.program_model(net, params).eval()
    gen = torch.Generator().manual_seed(1)
    img = torch.rand((2, 3, 32, 40), generator=gen)
    rate = torch.full((2, 1, 32, 40), 0.7)
    with torch.no_grad():
        want = model({"img": img, "denoise_rate": rate})
        hq, sr = ref_teacher.forward(params, net, img, rate)
    torch.testing.assert_close(hq, want["hq"], rtol=1e-4, atol=1e-5)
    if static == "train":
        torch.testing.assert_close(sr, want["sr"], rtol=1e-4, atol=1e-5)
    else:
        assert sr is None and want["sr"] is None


def test_teacher_serving_boundary_matches_predictor():
    """uint8 in and out, padding, rounding and the zero mask, through the
    program's TeacherPredictor (fp32, unfused) and the reference."""
    from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor

    from benchmark.core import sonar

    net = _config("kdlaet_bf16", **TEACHER)["network"]
    params = kdlae_teacher.init_params(net, 3, "cpu", "float32")
    pred = TeacherPredictor(kdlae_teacher.program_model(net, params), device="cpu")
    frame = sonar.frames_rgb(1, 36, 44, torch.Generator().manual_seed(2))[0].numpy()
    got = pred(frame, 1.0)
    hq, sr = serving.teacher_frame(params, net, frame, 1.0, 8, "cpu")
    assert np.abs(got["hq"].astype(int) - hq).max() <= 1
    assert np.abs(got["sr"].astype(int) - sr).max() <= 1
    assert not hq[np.all(frame == 0, axis=-1)].any()


def test_student_matches_program():
    net = _config("kdlaes_fp32", **STUDENT)["network"]
    params = kdlae_student.init_params(net, 5, "cpu")
    model = kdlae_student.program_model(net, params).eval()
    x = torch.rand((2, 7, 16, 24), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = model(x)
    torch.testing.assert_close(ref_student.forward(params, net, x), want, rtol=1e-5, atol=1e-6)


def test_training_reference_follows_program_steps(tiny):
    """The tiny training cell: the reference's three steps from the same
    weights and draws agree with the program's to round-off."""
    res, checks = harness.run("kdlaes_train_4x7_384", 2 ** 31 + 11, 0.3, False, "cpu",
                              time.perf_counter(), tiny, log=lambda *a: None)
    assert res["correct"]
    assert checks["loss"]["value"] < 1e-6
    assert checks["grad"]["value"] < 1e-5
    assert checks["change"]["value"] < 1e-5
