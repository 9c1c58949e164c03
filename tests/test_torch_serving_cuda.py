"""The serving predictors on an NVIDIA GPU: fp32 serving pinned off TF32,
grouped teacher serving bit-identical to per-image calls, and the student
and the scorer against the same predictors on the CPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

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
    flagship_teacher,
    init_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import (
    init_weights_ as init_scorer_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

NARROW = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
              params="cat")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _set_tf32(conv, matmul):
    torch.backends.cudnn.allow_tf32 = conv
    torch.backends.cuda.matmul.allow_tf32 = matmul


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    img = (rng.gamma(2.0, 40.0, size=(h, w, 1)).clip(1, 255)
           * np.ones((1, 1, 3))).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.abs(np.arctan2(xx - w / 2, yy + 1.0)) > 0.75] = 0
    return img


def _student(seed=0):
    torch.manual_seed(seed)
    return KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))


def _scorer_model(seed=0):
    """Seeded weights and non-trivial BatchNorm running statistics."""
    return init_scorer_weights_(DenoiseRatePredictor(), torch.Generator().manual_seed(seed))


def _serve(kind, device):
    """A fresh fp32 predictor of ``kind`` on ``device`` and a call of it."""
    rng = np.random.default_rng(1)
    if kind == "teacher":
        model = init_weights_(KDLAETeacher(**NARROW), torch.Generator().manual_seed(0))
        pred = TeacherPredictor(model, device=device)
        img = _frame(96, 128, 2)
        return lambda: pred(img, 0.8)["sr"]
    if kind == "student":
        pred = StudentPredictor(_student(), device=device)
        stacks = rng.integers(0, 256, (2, 7, 64, 96), dtype=np.uint8)
        return lambda: pred.denoise_batch(stacks)
    pred = ASDQEScorer(_scorer_model(), device=device)
    lq, gt = (rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8) for _ in range(2))
    return lambda: pred(lq, gt)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["teacher", "student", "scorer"])
def test_fp32_serving_ignores_the_global_tf32_flags(cuda, kind):
    serve = _serve(kind, cuda)
    _set_tf32(True, False)  # PyTorch's defaults
    at_defaults = serve()
    _set_tf32(False, False)
    forced_off = serve()
    _set_tf32(True, True)
    all_on = serve()
    np.testing.assert_array_equal(at_defaults, forced_off)
    np.testing.assert_array_equal(all_on, forced_off)


@pytest.mark.cuda
def test_the_tf32_flag_matters_without_the_pin(cuda):
    """The control: the student's bare model on the card gives other float
    outputs with cuDNN's TF32 on than off, so the test above can fail."""
    model = _student().to(cuda).eval()
    x = torch.rand(1, 7, 64, 96, device=cuda)
    with torch.no_grad():
        _set_tf32(True, False)
        tf32 = model(x)
        _set_tf32(False, False)
        fp32 = model(x)
    assert not torch.equal(tf32, fp32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_is_bit_identical_to_per_image_calls_on_the_card(cuda, dtype):
    """The flagship teacher with the stage kernel (three stages admitted at
    256^2): two groups of two and a tail of one."""
    model = init_weights_(flagship_teacher(static="train"), torch.Generator().manual_seed(0))
    # the weights' dtype is the compute dtype: bf16 serving casts the model
    pred = TeacherPredictor(model.to(dtype), fused=True, dtype=dtype, device=cuda)
    imgs = [_frame(256, 256, 10 + i) for i in range(5)]
    pstage.fused_transformer_stage.launches = 0
    got = pred.denoise_group(imgs, 0.8, group_size=2)
    torch.cuda.synchronize()
    assert pstage.fused_transformer_stage.launches == 3 * len(imgs)
    for g, im in zip(got, imgs):
        want = pred(im, 0.8)
        for key in ("hq", "sr"):
            np.testing.assert_array_equal(g[key], want[key], err_msg=key)


@pytest.mark.cuda
def test_student_on_the_card_matches_the_cpu(cuda):
    stack = np.random.default_rng(3).gamma(2.0, 40.0, (7, 128, 128)).clip(0, 255).astype(np.uint8)
    for dtype in (torch.float32, torch.bfloat16):
        cpu = StudentPredictor(_student(seed=4), dtype=dtype, device="cpu")(stack)
        got = StudentPredictor(_student(seed=4), dtype=dtype, device=cuda)(stack)
        d = np.abs(got.astype(np.int16) - cpu.astype(np.int16))
        assert float((d <= 1).mean()) >= 0.999, (dtype, float((d <= 1).mean()))


@pytest.mark.cuda
def test_scorer_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(5)
    lq = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    gt = (lq // 2 + rng.integers(0, 60, lq.shape)).astype(np.uint8)
    cpu = ASDQEScorer(_scorer_model(seed=6), device="cpu")(lq, gt)
    got = ASDQEScorer(_scorer_model(seed=6), device=cuda)(lq, gt)
    np.testing.assert_allclose(got, cpu, rtol=0, atol=1e-4)
