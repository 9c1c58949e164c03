"""Port TeacherPredictor against the JAX TeacherPredictor (CPU, float32):
uint8 outputs within one level."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    TeacherPredictor as JaxPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models import (
    build_network as jax_build_network,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    KDLAETeacher as JaxTeacher,
)
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    KDLAETeacher,
    build_network,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "artifacts", "kdlaet_full50k")
NARROW = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
              params="cat")


def _sonar_frame(h, w, seed):
    """uint8 RGB noise with a fan-shaped region of exact zeros."""
    rng = np.random.default_rng(seed)
    img = rng.integers(1, 256, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    angle = np.abs(np.arctan2(xx - w / 2, yy + 1.0))
    img[angle > 0.6] = 0
    return img


def _level_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.fixture(scope="module")
def narrow_params():
    img = jnp.zeros((1, 16, 16, 3))
    p = JaxTeacher(**NARROW).init(jax.random.PRNGKey(0),
                                  {"img": img, "denoise_rate": img[..., :1]})
    return jax.tree_util.tree_map(np.asarray, p["params"])


@pytest.mark.parametrize("hw", [(64, 48), (61, 45)])
def test_predictor_matches_jax(narrow_params, hw):
    img = _sonar_frame(*hw, seed=hw[0])
    jpred = JaxPredictor(params=narrow_params, model=JaxTeacher(**NARROW))
    model = weights.load_teacher_params(KDLAETeacher(**NARROW), narrow_params)
    ppred = TeacherPredictor(model, device="cpu")
    ref = jpred(img, 0.8, zero_mask=True)
    got = ppred(img, 0.8, zero_mask=True)
    for key, scale in (("hq", 1), ("sr", 2)):
        assert got[key].dtype == np.uint8
        assert got[key].shape == (hw[0] * scale, hw[1] * scale, 3)
        assert _level_diff(got[key], ref[key]) <= 1, key
    mask = np.all(img == 0, axis=-1)
    assert not got["hq"][mask].any()
    assert not got["sr"][np.repeat(np.repeat(mask, 2, 0), 2, 1)].any()


def test_predictor_float_input_and_file(narrow_params, tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = _sonar_frame(40, 32, seed=3)
    model = weights.load_teacher_params(KDLAETeacher(**NARROW), narrow_params)
    ppred = TeacherPredictor(model, device="cpu")
    from_u8 = ppred(img, 1.0)
    from_f32 = ppred(img.astype(np.float32) / 255.0, 1.0)
    for key in ("hq", "sr"):
        assert _level_diff(from_u8[key], from_f32[key]) <= 1
    path = str(tmp_path / "frame.png")
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    from_file = ppred.denoise_file(path, 1.0)
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(from_file[key], from_u8[key])


def test_shape_bucket_must_be_multiple(narrow_params):
    with pytest.raises(ValueError):
        TeacherPredictor(KDLAETeacher(**NARROW), shape_bucket=12, device="cpu")
    img = _sonar_frame(20, 20, seed=5)
    out = TeacherPredictor(KDLAETeacher(**NARROW), shape_bucket=32,
                           device="cpu")(img)
    assert out["hq"].shape == (20, 20, 3) and out["sr"].shape == (40, 40, 3)


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TeacherPredictor(KDLAETeacher(**NARROW))


@pytest.fixture(scope="module")
def zoo_teacher():
    pytest.importorskip("orbax.checkpoint")
    import yaml

    from rethink_acoustic_image_enhancement_tpu.train.checkpoints import (
        load_weights,
    )

    with open(os.path.join(ZOO, "config.yml")) as f:
        cfg = yaml.safe_load(f)["network_g"]
    params = load_weights(os.path.join(ZOO, "weights", "net_g_50000_bf16"))
    params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params


@pytest.mark.parametrize("rate", [1.0, 0.6])
def test_trained_zoo_teacher_matches_jax(zoo_teacher, rate):
    cfg, params = zoo_teacher
    img = _sonar_frame(64, 64, seed=int(rate * 10))
    jpred = JaxPredictor(params=params, model=jax_build_network(cfg))
    model = weights.load_teacher_params(build_network(cfg), params)
    ppred = TeacherPredictor(model, device="cpu")
    ref = jpred(img, rate)
    got = ppred(img, rate)
    for key in ("hq", "sr"):
        assert _level_diff(got[key], ref[key]) <= 1, key
