"""Each predictor serves its own copy of the module it is given: building a
second predictor on the same module, with another dtype and other flags,
changes neither the first predictor (its parameters' dtypes, its flags, its
outputs, bit for bit) nor the caller's module (device, dtype, values, flags,
training mode). Before the copy, the last predictor built decided the dtype
and the flags of all of them, and an fp32 predictor built after a bf16 one
on the same module served weights that had been through bfloat16."""

import copy

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import (
    ASDQEScorer,
    StudentPredictor,
    TeacherPredictor,
)
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    DenoiseRatePredictor,
    KDLAEStudent,
    KDLAETeacher,
    TransformerStage,
    init_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import Downsample, Upsample

torch.set_num_threads(2)

NARROW = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
              params="cat")


def _teacher():
    return init_weights_(KDLAETeacher(**NARROW), torch.Generator().manual_seed(0))


def _flags(model):
    return ([m.fused for m in model.modules() if isinstance(m, TransformerStage)]
            + [m.fused for m in model.modules() if isinstance(m, (Downsample, Upsample))])


def _snapshot(model):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {p.dtype for p in model.parameters()}, model.training,
            {p.device.type for p in model.parameters()})


def _same_module(model, snap):
    state, dtypes, training, devices = snap
    now = model.state_dict()
    assert now.keys() == state.keys()
    for k, v in state.items():
        assert now[k].dtype == v.dtype and torch.equal(now[k], v), k
    assert {p.dtype for p in model.parameters()} == dtypes
    assert model.training == training
    assert {p.device.type for p in model.parameters()} == devices


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(1, 256, size=(32, 40, 3), dtype=np.uint8)
    img[:4] = 0
    return img


def test_second_teacher_predictor_leaves_the_first_and_the_module_alone():
    model = _teacher()
    snap = _snapshot(model)
    first = TeacherPredictor(model, device="cpu")
    img = _frame()
    before = first(img, 0.7)
    flags_before = _flags(first.model)
    second = TeacherPredictor(model, dtype=torch.bfloat16, fused=True,
                              fused_resample=True, device="cpu")
    assert all(_flags(second.model)) and not any(flags_before)
    second(img, 0.7)
    assert {p.dtype for p in first.model.parameters()} == {torch.float32}
    assert _flags(first.model) == flags_before
    after = first(img, 0.7)
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    _same_module(model, snap)
    assert not any(_flags(model))


def test_fp32_predictor_after_a_bf16_one_serves_untouched_weights():
    """The re-anchor probe: a bf16-serving predictor, then an fp32 one, on
    one module; the fp32 one gives the bits of a predictor on a fresh copy
    of the weights (it was 1 level off on 1.8% of pixels)."""
    model = _teacher()
    fresh = TeacherPredictor(copy.deepcopy(model), device="cpu")
    bf16 = TeacherPredictor(model, dtype=torch.bfloat16, device="cpu")
    fp32 = TeacherPredictor(model, device="cpu")
    img = _frame(1)
    bf16(img, 1.0)
    want, got = fresh(img, 1.0), fp32(img, 1.0)
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # a bf16 input does not cast the predictor's fp32 weights
    assert {p.dtype for p in bf16.model.parameters()} == {torch.float32}


def test_casting_the_callers_module_later_leaves_the_predictor_alone():
    model = _teacher()
    pred = TeacherPredictor(model, device="cpu")
    img = _frame(2)
    before = pred(img, 0.5)
    model.to(torch.bfloat16).set_fused(True)
    after = pred(img, 0.5)
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)


@pytest.mark.parametrize("kind", ["student", "scorer"])
def test_student_and_scorer_serve_their_own_copy(kind):
    rng = np.random.default_rng(3)
    if kind == "student":
        torch.manual_seed(0)
        model = KDLAEStudent(residual=True, hidden_channels=(4, 8))
        build = lambda m, dtype: StudentPredictor(m, dtype=dtype, device="cpu")  # noqa: E731
        stack = rng.integers(0, 256, (7, 16, 16), dtype=np.uint8)
        serve = lambda pred: pred(stack)  # noqa: E731
    else:
        model = DenoiseRatePredictor()
        build = lambda m, dtype: ASDQEScorer(m, dtype=dtype, device="cpu")  # noqa: E731
        a, b = (rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2))
        serve = lambda pred: pred(a, b)  # noqa: E731
    snap = _snapshot(model)
    first = build(model, torch.float32)
    before = serve(first)
    assert first.model is not model
    model.to(torch.bfloat16)  # the caller casts its own module
    second = build(model, torch.bfloat16)
    serve(second)
    np.testing.assert_array_equal(serve(first), before)
    assert {p.dtype for p in first.model.parameters()} == {torch.float32}
    model.float()
    assert model.training == snap[2]
