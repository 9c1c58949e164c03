"""The port's PSNR and SSIM against the JAX package's on seeded images:
3D and 2D SSIM, HWC and CHW, the Y channel and crop borders, within
1e-4."""

import numpy as np
import pytest

from rethink_acoustic_image_enhancement_tpu import metrics as jm
from rethink_acoustic_image_enhancement_tpu_torch import metrics as tm

TOL = 1e-4


def _pair(seed, h=40, w=36, c=3, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, c)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    return a * scale, b * scale


def _order(a, order):
    return a.transpose(2, 0, 1) if order == "CHW" else a


@pytest.mark.parametrize("fn", ["calculate_psnr", "calculate_ssim"])
@pytest.mark.parametrize("order", ["HWC", "CHW"])
@pytest.mark.parametrize("scale", [1.0, 255.0])
@pytest.mark.parametrize("crop,y", [(0, False), (4, False), (0, True), (3, True)])
def test_psnr_ssim(fn, order, scale, crop, y):
    a, b = _pair(0, scale=scale)
    kw = dict(crop_border=crop, input_order=order, test_y_channel=y)
    want = getattr(jm, fn)(_order(a, order), _order(b, order), **kw)
    got = getattr(tm, fn)(_order(a, order), _order(b, order), **kw)
    assert got == pytest.approx(want, rel=TOL, abs=TOL)


@pytest.mark.parametrize("order", ["HWC", "CHW"])
@pytest.mark.parametrize("crop", [0, 2])
@pytest.mark.parametrize("c", [1, 3])
def test_ssim_2d(order, crop, c):
    a, b = _pair(1, c=c, scale=255.0)
    kw = dict(crop_border=crop, input_order=order)
    want = jm.calculate_ssim_2d(_order(a, order), _order(b, order), **kw)
    got = tm.calculate_ssim_2d(_order(a, order), _order(b, order), **kw)
    assert got == pytest.approx(want, rel=TOL, abs=TOL)


@pytest.mark.parametrize("fn", ["calculate_psnr", "calculate_ssim"])
def test_gray_and_batch_of_one(fn):
    a, b = _pair(2, c=1)
    want = getattr(jm, fn)(a[None, ..., 0][..., None], b[..., 0])
    got = getattr(tm, fn)(a[None, ..., 0][..., None], b[..., 0])
    assert got == pytest.approx(want, rel=TOL, abs=TOL)


def test_identical_images():
    a, _ = _pair(3)
    assert tm.calculate_psnr(a, a) == float("inf") == jm.calculate_psnr(a, a)
    assert tm.calculate_ssim(a, a) == pytest.approx(1.0, abs=1e-9)


def test_registry():
    """The JAX registry's keys; NIQE is ported, an unknown name (FID, which
    is no per-image metric, among them) is a KeyError in both."""
    assert set(tm.METRICS) == set(jm.METRICS)
    assert tm.get_metric("calculate_psnr") is tm.calculate_psnr
    assert tm.get_metric("calculate_niqe") is tm.calculate_niqe
    for name in ("calculate_fid", "nope"):
        with pytest.raises(KeyError):
            jm.get_metric(name)
        with pytest.raises(KeyError):
            tm.get_metric(name)
