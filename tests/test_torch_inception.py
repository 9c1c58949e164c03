"""The port's InceptionV3 pool3 against the JAX package's (CPU), on seeded
random weights and running statistics in the torchvision / pytorch-fid
layout fed through JAX's ``convert_inception_state_dict``: both
``fid_variant``s within 2e-4 and the 299 resize within 5e-4 (the JAX
tests' tolerances), a ``.pth`` with the keys features do not use loading
strictly, and ``make_inception_feature_fn``'s feature space named as in
JAX."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.metrics import inception as jinc
from rethink_acoustic_image_enhancement_tpu_torch.metrics import fid as tfid
from rethink_acoustic_image_enhancement_tpu_torch.metrics import inception as tinc

torch.set_num_threads(4)


def _state_dict(seed=0, fid_variant=True):
    """A seeded torch-layout state dict with the keys a torchvision file
    also holds (the auxiliary classifier, fc, num_batches_tracked)."""
    model = tinc.init_weights_(tinc.InceptionV3(fid_variant),
                               torch.Generator().manual_seed(seed))
    sd = dict(model.state_dict())
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(7)
    return sd


def _port(sd, fid_variant):
    model = tinc.InceptionV3(fid_variant)
    model.load_state_dict(tinc.inception_state_dict(sd), strict=True)
    return model.eval()


@pytest.mark.parametrize("fid_variant", [True, False])
def test_pool3_matches_jax(fid_variant):
    sd = _state_dict(fid_variant=fid_variant)
    x = np.random.default_rng(3).random((2, 299, 299, 3), np.float32)
    with torch.no_grad():
        got = _port(sd, fid_variant)(
            tinc.pool3_input(torch.from_numpy(x), resize=False)).numpy()
    want = np.asarray(jinc.inception_pool3(jinc.convert_inception_state_dict(sd), x,
                                           resize=False, fid_variant=fid_variant))
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want).max() > 1e-2  # the seeded network keeps its signal
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_resize_to_299_matches_jax():
    """Bilinear, align_corners=False, no antialiasing: jax.image.resize's
    sampling of a 64x80 input."""
    sd = _state_dict(seed=1)
    x = np.random.default_rng(5).random((1, 64, 80, 3), np.float32)
    with torch.no_grad():
        got = _port(sd, True)(tinc.pool3_input(torch.from_numpy(x))).numpy()
    want = np.asarray(jinc.inception_pool3(jinc.convert_inception_state_dict(sd), x,
                                           resize=True))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_feature_fn_from_a_pth(tmp_path):
    """A saved .pth through ``make_inception_feature_fn`` on the CPU: its
    feature space named as JAX names it, features equal to the module's,
    batched in ``batch``-image forwards, FID zero on the same set."""
    sd = _state_dict(seed=2)
    path = str(tmp_path / "inception.pth")
    torch.save(sd, path)
    fn = tinc.make_inception_feature_fn(path, batch=2, device="cpu")
    assert fn.feature_space == jinc.make_inception_feature_fn(path).feature_space
    assert fn.feature_space == f"inception-pool3(fid:{path})"
    tv = tinc.make_inception_feature_fn(path, fid_variant=False, device="cpu")
    assert tv.feature_space.startswith("inception-pool3(torchvision:")
    x = np.random.default_rng(7).random((3, 64, 64, 3), np.float32)
    feats = fn(x)
    with torch.no_grad():
        ref = _port(sd, True)(tinc.pool3_input(torch.from_numpy(x))).numpy()
    assert feats.shape == (3, 2048)
    np.testing.assert_allclose(feats, ref, rtol=1e-5, atol=1e-6)
    assert tfid.fid_between_feature_sets(feats, feats) == pytest.approx(0.0, abs=1e-3)
    with pytest.raises(RuntimeError, match="Missing key"):
        tinc.InceptionV3().load_state_dict(
            {k: v for k, v in tinc.inception_state_dict(sd).items()
             if not k.startswith("Mixed_7c")}, strict=True)
