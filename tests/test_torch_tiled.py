"""Port ``TeacherPredictor.denoise_tiled`` against the JAX one (CPU,
float32, a narrow teacher): uint8 outputs within one level. Tiled output is
held to tiled output, never to whole-image output (MDTA statistics are per
tile)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    TeacherPredictor as JaxPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    KDLAETeacher as JaxTeacher,
)
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher

torch.set_num_threads(2)

NARROW = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
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


@pytest.fixture(scope="module")
def predictors():
    img = jnp.zeros((1, 16, 16, 3))
    p = JaxTeacher(**NARROW).init(jax.random.PRNGKey(1),
                                  {"img": img, "denoise_rate": img[..., :1]})
    params = jax.tree_util.tree_map(np.asarray, p["params"])
    jpred = JaxPredictor(params=params, model=JaxTeacher(**NARROW))
    model = weights.load_teacher_params(KDLAETeacher(**NARROW), params)
    return jpred, TeacherPredictor(model, device="cpu")


def _check(got, ref, imgs, zero_mask=True):
    assert len(got) == len(ref) == len(imgs)
    for g, r, im in zip(got, ref, imgs):
        h, w = im.shape[:2]
        for key, s in (("hq", 1), ("sr", 2)):
            assert g[key].dtype == np.uint8 and g[key].shape == (h * s, w * s, 3)
            d = np.abs(g[key].astype(np.int16) - r[key].astype(np.int16))
            assert int(d.max()) <= 1, (key, int(d.max()))
        if zero_mask:
            mask = np.all(im == 0, axis=-1)
            assert not g["hq"][mask].any()
            assert not g["sr"][np.repeat(np.repeat(mask, 2, 0), 2, 1)].any()


@pytest.mark.parametrize("tile,halo", [
    (32, 0), (32, 4), (32, 8), ((32, 96), (8, 0)), ((32, 96), 0)])
def test_tiled_matches_jax(predictors, tile, halo):
    """Two 64x96 frames and one 50x96 frame (a partial last grid row): 14
    square tiles, or 6 full-width strips, in chunks of 4 with a partial last
    chunk."""
    jpred, ppred = predictors
    imgs = [_sonar_frame(64, 96, 0), _sonar_frame(64, 96, 1),
            _sonar_frame(50, 96, 2)]
    kw = dict(denoise_rate=0.8, tile=tile, halo=halo, tile_batch=4)
    _check(ppred.denoise_tiled(imgs, **kw), jpred.denoise_tiled(imgs, **kw), imgs)


def test_tiled_partial_batch_and_float_input(predictors):
    """3 tiles in a batch of 8 (the last tile repeated to fill the batch),
    float input, no zero mask."""
    jpred, ppred = predictors
    imgs = [_sonar_frame(32, 96, 3).astype(np.float32) / 255.0]
    kw = dict(denoise_rate=1.0, zero_mask=False, tile=32, halo=0, tile_batch=8)
    _check(ppred.denoise_tiled(imgs, **kw), jpred.denoise_tiled(imgs, **kw),
           imgs, zero_mask=False)


def test_tiled_small_image_takes_the_whole_image_path(predictors):
    """An image smaller than a tile along an axis is served whole, between
    tiled ones, in the caller's order."""
    jpred, ppred = predictors
    imgs = [_sonar_frame(16, 40, 4), _sonar_frame(64, 64, 5),
            _sonar_frame(16, 16, 6)]
    kw = dict(denoise_rate=0.6, tile=32, halo=4, tile_batch=4)
    got = ppred.denoise_tiled(imgs, **kw)
    _check(got, jpred.denoise_tiled(imgs, **kw), imgs)
    whole = ppred(imgs[0], 0.6)
    for key in ("hq", "sr"):
        np.testing.assert_array_equal(got[0][key], whole[key])
    # all small: nothing is tiled
    _check(ppred.denoise_tiled(imgs[::2], **kw),
           jpred.denoise_tiled(imgs[::2], **kw), imgs[::2])


def test_tiled_many_chunks_drain_in_order(predictors):
    """More chunks than the in-flight bound: 20 chunks of 1 tile."""
    _, ppred = predictors
    imgs = [_sonar_frame(32, 32 * 5, 7 + i) for i in range(4)]
    one = ppred.denoise_tiled(imgs, tile=32, tile_batch=1)
    four = ppred.denoise_tiled(imgs, tile=32, tile_batch=4)
    for a, b in zip(one, four):
        for key in ("hq", "sr"):
            # the batch size moves float sums by an ulp at most
            d = np.abs(a[key].astype(np.int16) - b[key].astype(np.int16))
            assert int(d.max()) <= 1


def test_tiled_rejects_bad_tile_and_empty_list(predictors):
    _, ppred = predictors
    assert ppred.denoise_tiled([]) == []
    with pytest.raises(ValueError, match="multiples of 8"):
        ppred.denoise_tiled([_sonar_frame(64, 64, 0)], tile=32, halo=3)
    with pytest.raises(ValueError, match="multiples of 8"):
        ppred.denoise_tiled([_sonar_frame(64, 64, 0)], tile=(30, 32))
