"""Data-parallel serving and the kernels' device guard on NVIDIA GPUs: the
stage kernel on ``cuda:1`` called while ``cuda:0`` is current equals the
same call on ``cuda:0`` (two cards); two copies sharing ``cuda:0`` match
one copy (any card); a weight on another device than x raises.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_dp_serving_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU (the
first also where there is only one)."""

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
    flagship_teacher,
    init_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import (
    init_weights_ as init_scorer_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _stage_weights(rng, device, n=2, c=96, heads=2, f=255):
    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    return dict(
        ln1_w=t(n, c, scale=0.1, shift=1.0), w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
        dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
        w_proj=t(n, 1, 1, c, c, scale=c ** -0.5), ln2_w=t(n, c, scale=0.1, shift=1.0),
        w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5), w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
        w_out=t(n, 1, 1, f, c, scale=f ** -0.5))


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(1, 256, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.abs(np.arctan2(xx - w / 2, yy + 1.0)) > 0.7] = 0
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stage_on_the_second_card_equals_the_first(cuda, dtype):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs (the stage kernel on cuda:1 while cuda:0 is current)")
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.normal(size=(2, 40, 56, 96)).astype(np.float32)).to(cuda, dtype)
    w0 = _stage_weights(np.random.default_rng(5), cuda)
    one = torch.device("cuda", 1)
    x1, w1 = x0.to(one), {k: v.to(one) for k, v in w0.items()}
    torch.cuda.set_device(0)
    before = pstage.fused_transformer_stage.launches
    a = pstage.fused_transformer_stage(x0, **w0)
    b = pstage.fused_transformer_stage(x1, **w1)  # cuda:0 stays current
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert pstage.fused_transformer_stage.launches == before + 2
    assert b.device == one
    assert torch.equal(a, b.to(cuda))


@pytest.mark.cuda
def test_weight_on_another_device_raises(cuda):
    rng = np.random.default_rng(6)
    w = _stage_weights(rng, cuda, n=1)
    w["w_proj"] = w["w_proj"].cpu()
    x = torch.zeros(1, 16, 16, 96, device=cuda)
    with pytest.raises(ValueError, match="w_proj is on cpu, x on cuda:0"):
        pstage.fused_transformer_stage(x, **w)


@pytest.mark.cuda
def test_two_copies_on_one_card_match_one_copy(cuda):
    """The flagship teacher in bf16 through the stage kernel in 256^2 tiles,
    the student and the scorer, each on [cuda:0, cuda:0] against one
    copy: within 1 level (the scorer within 1e-5), the stage-kernel count
    the same per tile."""
    devices = [cuda, cuda]
    teacher = init_weights_(flagship_teacher(static="train"),
                            torch.Generator().manual_seed(0)).to(torch.bfloat16)
    imgs = [_frame(256, 512, 1), _frame(500, 256, 2)]
    kw = dict(denoise_rate=0.8, tile=256, tile_batch=2)
    counts = []
    outs = []
    for pred in (TeacherPredictor(teacher, fused=True, dtype=torch.bfloat16, device=cuda),
                 TeacherPredictor(teacher, fused=True, dtype=torch.bfloat16,
                                  devices=devices)):
        pstage.fused_transformer_stage.launches = 0
        outs.append(pred.denoise_tiled(imgs, **kw))
        torch.cuda.synchronize()
        counts.append(pstage.fused_transformer_stage.launches)
    # 4 tiles: 2 chunks of 2 on one copy; the same chunks in halves on two
    assert counts[0] > 0 and counts[1] == 2 * counts[0], counts
    for a, b, im in zip(*outs, imgs):
        for key in ("hq", "sr"):
            d = np.abs(a[key].astype(np.int16) - b[key].astype(np.int16))
            assert float((d <= 1).mean()) >= 0.99, key
        assert not b["hq"][np.all(im == 0, axis=-1)].any()

    torch.manual_seed(0)
    student = KDLAEStudent(residual=True, hidden_channels=(16, 32, 64))
    stacks = np.random.default_rng(3).integers(0, 256, (5, 7, 64, 96), dtype=np.uint8)
    s1 = StudentPredictor(student, device=cuda).denoise_batch(stacks)
    s2 = StudentPredictor(student, devices=devices).denoise_batch(stacks)
    d = np.abs(s1.astype(np.int16) - s2.astype(np.int16))
    assert s2.shape == stacks.shape and float((d <= 1).mean()) >= 0.999

    scorer = init_scorer_weights_(DenoiseRatePredictor(), torch.Generator().manual_seed(7))
    rng = np.random.default_rng(8)
    lq = rng.integers(0, 256, (5, 96, 96, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (5, 96, 96, 3), dtype=np.uint8)
    np.testing.assert_allclose(ASDQEScorer(scorer, devices=devices)(lq, gt),
                               ASDQEScorer(scorer, device=cuda)(lq, gt),
                               rtol=1e-5, atol=1e-5)
