"""fp32 serving runs with TF32 off: every forward of a float32 teacher, of
the student (both serving dtypes compute in float32) and of the scorer sees
``cudnn.allow_tf32`` and ``cuda.matmul.allow_tf32`` off, and both flags are
back as they were afterwards, also when the forward raises. The flags are
process-wide Python settings, so the CPU shows this as well as the GPU."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import (
    ASDQEScorer,
    StudentPredictor,
    TeacherPredictor,
    highest_precision,
)
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    DenoiseRatePredictor,
    KDLAEStudent,
    KDLAETeacher,
)

torch.set_num_threads(2)

NARROW = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
              params="cat")


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _serve(kind, dtype):
    """(predictor, its model, a call that serves one small input)."""
    rng = np.random.default_rng(0)
    if kind == "teacher":  # the weights' dtype is the compute dtype
        pred = TeacherPredictor(KDLAETeacher(**NARROW).to(dtype), dtype=dtype,
                                device="cpu")
        img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
        return pred.model, lambda: pred(img, 0.7)
    if kind == "teacher_group":
        pred = TeacherPredictor(KDLAETeacher(**NARROW), dtype=dtype, device="cpu")
        imgs = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2)]
        return pred.model, lambda: pred.denoise_group(imgs, group_size=2)
    if kind == "teacher_tiled":
        pred = TeacherPredictor(KDLAETeacher(**NARROW), dtype=dtype, device="cpu")
        imgs = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)]
        return pred.model, lambda: pred.denoise_tiled(imgs, tile=16, tile_batch=4)
    if kind == "student":
        pred = StudentPredictor(KDLAEStudent(hidden_channels=(4, 8)), dtype=dtype,
                                device="cpu")
        stack = rng.integers(0, 256, (7, 8, 8), dtype=np.uint8)
        return pred.model, lambda: pred(stack)
    pred = ASDQEScorer(DenoiseRatePredictor(), dtype=dtype, device="cpu")
    a, b = (rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2))
    return pred.model, lambda: pred(a, b)


CASES = [("teacher", torch.float32), ("teacher_group", torch.float32),
         ("teacher_tiled", torch.float32), ("student", torch.float32),
         ("student", torch.bfloat16), ("scorer", torch.float32),
         ("scorer", torch.bfloat16)]


@pytest.mark.parametrize("kind,dtype", CASES)
def test_forward_runs_with_tf32_off_and_restores_the_flags(tf32_on, kind, dtype):
    model, serve = _serve(kind, dtype)
    seen = []
    model.register_forward_hook(lambda *_: seen.append(_flags()))
    serve()
    assert seen and all(f == (False, False) for f in seen), seen
    assert _flags() == (True, True)


@pytest.mark.parametrize("kind,dtype", CASES[::2])
def test_flags_are_restored_when_the_forward_raises(tf32_on, kind, dtype):
    model, serve = _serve(kind, dtype)

    def fail(*_):
        assert _flags() == (False, False)
        raise RuntimeError("forward failed")

    model.register_forward_hook(fail)
    with pytest.raises(RuntimeError, match="forward failed"):
        serve()
    assert _flags() == (True, True)


def test_bf16_teacher_leaves_the_flags_alone(tf32_on):
    model, serve = _serve("teacher", torch.bfloat16)
    seen = []
    model.register_forward_hook(lambda *_: seen.append(_flags()))
    serve()
    assert seen == [(True, True)]


def test_highest_precision_nests(tf32_on):
    torch.backends.cuda.matmul.allow_tf32 = False
    with highest_precision():
        with highest_precision():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, False)
