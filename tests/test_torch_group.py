"""Grouped teacher serving, the folded resamplers and the vanilla Restormer
against the JAX package (CPU, float32, narrow seeded models).

``denoise_group`` runs each image of a group through the same forward as
``__call__``, so its outputs are bit-identical to per-image calls; against
the JAX ``denoise_group`` they agree within one uint8 level."""

import numpy as np
import pytest
import torch

import jax

from rethink_acoustic_image_enhancement_tpu.convert.torch_import import (
    convert_teacher,
)
from rethink_acoustic_image_enhancement_tpu.eval.infer import (
    TeacherPredictor as JaxPredictor,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    KDLAETeacher as JaxTeacher,
)
from rethink_acoustic_image_enhancement_tpu.models.kdlae_teacher import (
    Restormer as JaxRestormer,
)
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models.blocks import Downsample, Upsample
from rethink_acoustic_image_enhancement_tpu_torch.models import (
    KDLAETeacher,
    Restormer,
    build_network,
    init_weights_,
)

torch.set_num_threads(2)

NARROW = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
              heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
              params="cat")


def _sonar_frame(h, w, seed):
    """uint8 RGB noise with a fan-shaped region of exact zeros."""
    rng = np.random.default_rng(seed)
    img = rng.integers(1, 256, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[np.abs(np.arctan2(xx - w / 2, yy + 1.0)) > 0.6] = 0
    return img


def _seeded_flax_params(model, seed):
    """Seeded port weights carried to a flax tree by the JAX package's own
    converter (flax's init takes seconds on the CPU)."""
    init_weights_(model, torch.Generator().manual_seed(seed))
    return convert_teacher({k: v.numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def params():
    return _seeded_flax_params(KDLAETeacher(**NARROW), seed=2)


def _port(params, **kw):
    model = weights.load_teacher_params(KDLAETeacher(**NARROW), params)
    return TeacherPredictor(model, device="cpu", **kw)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"hq", "sr"}
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _within_one_level(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for key in ("hq", "sr"):
            assert g[key].shape == r[key].shape and g[key].dtype == np.uint8
            d = np.abs(g[key].astype(np.int16) - r[key].astype(np.int16))
            assert int(d.max()) <= 1, (key, int(d.max()))


CASES = {
    # 5 images in groups of 2: two groups and a tail of one
    "tail": (lambda: [_sonar_frame(16, 32, i) for i in range(5)], None),
    # mixed shapes without a bucket: per-image calls
    "mixed": (lambda: [_sonar_frame(16, 24, 0), _sonar_frame(24, 16, 1)], None),
    # mixed shapes that one bucket maps to a single target
    "bucketed": (lambda: [_sonar_frame(14, 30, 2), _sonar_frame(16, 25, 3),
                          _sonar_frame(13, 17, 4), _sonar_frame(16, 32, 5)], 16),
    # a uint8 and a float image in one group
    "mixed_dtype": (lambda: [_sonar_frame(16, 24, 6),
                             _sonar_frame(16, 24, 7).astype(np.float32) / 255.0], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_is_bit_identical_to_per_image_calls(params, case):
    make, bucket = CASES[case]
    imgs = make()
    pred = _port(params, shape_bucket=bucket)
    got = pred.denoise_group(imgs, denoise_rate=0.7, group_size=2)
    _same(got, [pred(im, 0.7) for im in imgs])
    for g, im in zip(got, imgs):
        mask = np.all(im == 0, axis=-1)
        assert not g["hq"][mask].any()


@pytest.fixture(scope="module")
def jax_bucketed(params):
    """One JAX predictor for both cases below: every image pads to 16x32,
    so its group and per-image programs compile once."""
    return JaxPredictor(params=params, model=JaxTeacher(**NARROW), shape_bucket=16)


@pytest.mark.parametrize("case", ["tail", "bucketed"])
def test_group_matches_jax_within_one_level(params, jax_bucketed, case):
    imgs = CASES[case][0]()
    ref = jax_bucketed.denoise_group(imgs, denoise_rate=0.7, group_size=2)
    _within_one_level(_port(params, shape_bucket=16).denoise_group(
        imgs, denoise_rate=0.7, group_size=2), ref)


def test_empty_group_and_zero_mask_off(params):
    pred = _port(params)
    assert pred.denoise_group([]) == []
    imgs = [_sonar_frame(16, 16, 8 + i) for i in range(2)]
    _same(pred.denoise_group(imgs, zero_mask=False, group_size=2),
          [pred(im, zero_mask=False) for im in imgs])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("group_size", [2, 4])
def test_scan_eligible_agrees_with_jax(params, case, group_size):
    make, bucket = CASES[case]
    imgs = make()[:group_size]
    jpred = JaxPredictor(params=params, model=JaxTeacher(**NARROW), shape_bucket=bucket)
    pred = _port(params, shape_bucket=bucket)
    assert pred.scan_eligible(imgs, group_size) == jpred.scan_eligible(imgs, group_size)


def test_dispatch_and_fetch_group(params):
    pred = _port(params)
    imgs = [_sonar_frame(16, 24, 10 + i) for i in range(3)]
    assert pred.scan_eligible(imgs, 3)
    handles = [pred.dispatch_group(imgs, 0.5), pred.dispatch_group(imgs[::-1], 0.5)]
    _same(pred.fetch_group(handles[1]), [pred(im, 0.5) for im in imgs[::-1]])
    _same(pred.fetch_group(handles[0]), [pred(im, 0.5) for im in imgs])


def test_fused_resample_matches_unfused_and_jax(params):
    rng = np.random.default_rng(11)
    img = rng.random((1, 24, 16, 3)).astype(np.float32)
    rate = np.full((1, 24, 16, 1), 0.6, np.float32)
    ref = jax.jit(JaxTeacher(**NARROW, fused_resample=True).apply)(
        {"params": params}, {"img": img, "denoise_rate": rate})
    outs = []
    for fused in (False, True):
        model = weights.load_teacher_params(
            KDLAETeacher(**NARROW, fused_resample=fused), params).eval()
        with torch.no_grad():
            outs.append(model({"img": torch.from_numpy(img).permute(0, 3, 1, 2),
                               "denoise_rate": torch.from_numpy(rate).permute(0, 3, 1, 2)}))
    for key in ("hq", "sr"):
        fused = outs[1][key].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(fused, outs[0][key].permute(0, 2, 3, 1).numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(fused, np.asarray(ref[key]), rtol=0, atol=1e-5)
    # the predictor option, and the same uint8 output within one level
    frame = _sonar_frame(24, 32, 12)
    folding = _port(params, fused_resample=True)
    resamplers = [m for m in folding.model.modules()
                  if isinstance(m, (Downsample, Upsample))]
    assert len(resamplers) == 7 and all(m.fused for m in resamplers)
    _within_one_level([folding(frame, 0.6)], [_port(params)(frame, 0.6)])


@pytest.mark.parametrize("dual", [False, True])
def test_restormer_matches_flax(dual):
    """The global residual path against flax; the dual-pixel head by its
    parameter names (flax's program for it would compile a second time)."""
    cfg = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
               heads=(1, 2, 4, 8), dual_pixel_task=dual)
    x = np.random.default_rng(13).random((1, 16, 24, 3)).astype(np.float32)
    p = _seeded_flax_params(Restormer(**cfg), seed=14)
    model = build_network({"type": "Restormer", "dim": 8, "num_blocks": [1, 1, 1, 1],
                           "num_refinement_blocks": 1, "heads": [1, 2, 4, 8],
                           "dual_pixel_task": dual})
    assert isinstance(model, Restormer)
    model.load_state_dict(weights.teacher_state_dict(p), strict=True)
    if dual:
        assert "skip_conv.weight" in model.state_dict()
        return
    ref = np.asarray(jax.jit(JaxRestormer(**cfg).apply)({"params": p}, x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
