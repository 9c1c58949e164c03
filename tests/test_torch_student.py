"""Port KDLAE-S student and StudentPredictor against the JAX package (CPU):
the model against flax in float32, the predictor's uint8 output within one
level of the JAX predictor, the folder paths, the trained zoo students and
the weight bridges."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.convert.torch_export import (
    export_student,
    save_pth,
)
from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    StudentPredictor as JaxStudentPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_student import (
    KDLAEStudent as JaxStudent,
)
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import StudentPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    KDLAEStudent,
    build_network,
)
from rethink_acoustic_image_enhancement_tpu_torch.models.kdlae_student import (
    ConvTranspose3dS2,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = dict(residual=True, hidden_channels=(16, 32, 64))


def _flax_params(cfg, seed=0):
    """A seeded flax KDLAEStudent parameter tree (numpy; flax's own init
    takes seconds on the CPU): LeCun-normal kernels, small non-zero biases."""
    rng = np.random.default_rng(seed)
    hidden = cfg["hidden_channels"]
    levels = len(hidden) - 1

    def conv(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return {"kernel": (rng.normal(size=shape) * fan_in ** -0.5).astype(np.float32),
                "bias": (rng.normal(size=shape[-1:]) * 0.05).astype(np.float32)}

    def block(cin, cout):
        return {"conv1": conv(3, 3, 3, cin, cout), "conv2": conv(3, 3, 3, cout, cout)}

    p = {f"encoders_{i}": block(1 if i == 0 else hidden[i - 1], hidden[i])
         for i in range(levels)}
    p["st_fusion"] = block(hidden[levels - 1], hidden[-1])
    for j, i in enumerate(range(levels - 1, -1, -1)):
        p[f"upconv_{j}"] = conv(2, 2, hidden[i + 1], hidden[i])
        p[f"decoders_{j}"] = block(hidden[i], hidden[i])
    p["out_conv"] = conv(1, 1, 1, hidden[0], 1)
    return p


def _stack(f, h, w, seed):
    """uint8 speckle-like frames."""
    rng = np.random.default_rng(seed)
    return rng.gamma(2.0, 40.0, size=(f, h, w)).clip(0, 255).astype(np.uint8)


def _within_one_level(got, ref, share=0.999):
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert float((d <= 1).mean()) >= share, (float((d <= 1).mean()), int(d.max()))


def _pair(cfg, params, dtype=torch.float32):
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jpred = JaxStudentPredictor(params=params, model=JaxStudent(**cfg), dtype=jdtype)
    model = weights.load_student_params(KDLAEStudent(**cfg), params)
    return jpred, StudentPredictor(model, dtype=dtype, device="cpu")


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("hidden", [(16, 32, 64), (8, 16, 32, 64)])
def test_student_matches_flax(residual, hidden):
    cfg = dict(residual=residual, hidden_channels=hidden)
    p = _flax_params(cfg, seed=len(hidden) + residual)
    x = np.random.default_rng(1).random((2, 7, 32, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(JaxStudent(**cfg).apply)({"params": p}, x))
    model = weights.load_student_params(KDLAEStudent(**cfg), p).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 7, 32, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_upconv_block_k_pq_lands_at_phase_pq():
    up = ConvTranspose3dS2(2, 3)
    with torch.no_grad():
        up.weight.copy_(torch.randn(2, 3, 1, 2, 2))
        up.bias.zero_()
        x = torch.randn(1, 2, 1, 3, 4)
        y = up(x)
    assert y.shape == (1, 3, 1, 6, 8)
    for p in (0, 1):
        for q in (0, 1):
            want = torch.einsum("bidhw,io->bodhw", x, up.weight[:, :, 0, p, q])
            torch.testing.assert_close(y[:, :, :, p::2, q::2], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predictor_matches_jax(dtype):
    p = _flax_params(SHIPPED, seed=3)
    jpred, ppred = _pair(SHIPPED, p, dtype)
    stack = _stack(7, 40, 56, seed=4)
    _within_one_level(ppred(stack), jpred(stack))
    if dtype == torch.float32:  # a float stack ships as it is
        fstack = stack.astype(np.float32) / 255.0
        _within_one_level(ppred(fstack), jpred(fstack))


def test_bf16_serving_rounds_only_the_input():
    p = _flax_params(SHIPPED, seed=5)
    stack = _stack(7, 32, 32, seed=6)
    _, bf = _pair(SHIPPED, p, torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in bf.model.state_dict().values())
    x = torch.from_numpy(stack).float() / 255.0
    with torch.no_grad():
        want = bf.model(x.bfloat16().float()[None])
    want = torch.round(want.clamp(0, 1) * 255).to(torch.uint8)[0].numpy()
    np.testing.assert_array_equal(bf(stack), want)


def test_denoise_batch_equals_per_stack_calls():
    p = _flax_params(SHIPPED, seed=7)
    _, ppred = _pair(SHIPPED, p)
    stacks = np.stack([_stack(7, 20, 36, seed=10 + i) for i in range(3)])
    batch = ppred.denoise_batch(stacks)
    assert batch.shape == stacks.shape and batch.dtype == np.uint8
    for i in range(3):
        np.testing.assert_array_equal(batch[i], ppred(stacks[i]))


@pytest.mark.parametrize("mixed", [False, True])
def test_denoise_all_frames_matches_jax(tmp_path, mixed):
    cv2 = pytest.importorskip("cv2")
    p = _flax_params(SHIPPED, seed=8)
    jpred, ppred = _pair(SHIPPED, p)
    frames = _stack(10, 24, 40, seed=9)
    for i, fr in enumerate(frames):
        if mixed and i % 4 == 3:
            fr = cv2.resize(fr, (44, 28), interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(str(tmp_path / f"f{i:02d}.png"), fr)
    ref = jpred.denoise_all_frames(str(tmp_path), stack_batch=2)
    got = ppred.denoise_all_frames(str(tmp_path), stack_batch=2)
    assert got.shape == (10, 24, 40)
    _within_one_level(got, ref)
    np.testing.assert_array_equal(ppred.load_stack(str(tmp_path), 3),
                                  jpred.load_stack(str(tmp_path), 3))
    with pytest.raises(ValueError, match="need 7 frames"):
        ppred.load_stack(str(tmp_path / "missing"))


@pytest.mark.parametrize("run", ["kdlaes_full100k/weights/net_g_100000",
                                 "kdlaes_flsft5k/weights/net_g_5000"])
def test_trained_zoo_student_matches_jax(run):
    pytest.importorskip("orbax.checkpoint")
    from rethink_acoustic_image_enhancement_tpu.train.checkpoints import load_weights

    params = jax.tree_util.tree_map(
        np.asarray, load_weights(os.path.join(REPO, "artifacts", run)))
    jpred, ppred = _pair(SHIPPED, params)
    stack = _stack(7, 64, 64, seed=11)
    _within_one_level(ppred(stack), jpred(stack))


def test_export_student_loads_strictly_with_the_same_output(tmp_path):
    p = _flax_params(SHIPPED, seed=12)
    bridged = weights.load_student_params(KDLAEStudent(**SHIPPED), p).eval()
    exported = KDLAEStudent(**SHIPPED)
    exported.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in export_student(p).items()}, strict=True)
    path = str(tmp_path / "student.pth")
    save_pth(path, p, "KDLAE_student")
    from_pth = weights.load_pth(KDLAEStudent(**SHIPPED), path).eval()
    x = torch.rand(1, 7, 16, 24)
    with torch.no_grad():
        want = bridged(x)
        torch.testing.assert_close(exported.eval()(x), want, rtol=0, atol=0)
        torch.testing.assert_close(from_pth(x), want, rtol=0, atol=0)


def test_registry_builds_the_student_and_default_device_raises(monkeypatch):
    net = build_network({"type": "KDLAE_student", "inp_channels": 1,
                         "out_channels": 1, "residual": True,
                         "hidden_channels": [16, 32, 64]})
    assert isinstance(net, KDLAEStudent) and net.residual
    assert set(net.state_dict()) == set(weights.student_state_dict(
        _flax_params(SHIPPED)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StudentPredictor()


def test_reading_frames_without_cv2_or_pil_raises(tmp_path, monkeypatch):
    from rethink_acoustic_image_enhancement_tpu_torch.utils import image_io

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    # PNG has a numpy/zlib route (utils/png.py); other formats need a library
    with pytest.raises(ImportError, match="cv2 or PIL"):
        image_io.imread_gray(str(tmp_path / "f.jpg"))
    with pytest.raises(ImportError, match="cv2 or PIL"):
        image_io.resize_area(np.zeros((4, 4), np.float32), 2, 2)
