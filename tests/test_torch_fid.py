"""The port's FID against the JAX package's (CPU): the statistics and the
distance on seeded features within 1e-9, the default feature space (the
trained zoo scorer, reached without orbax) within 1e-4 relative of JAX's
orbax scorer, its seeded-random fallback and a user's scorer, and FID
between two folders within 1e-3."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu.metrics import fid as jfid
from rethink_acoustic_image_enhancement_tpu.train.checkpoints import shipped_asdqe_dir
from rethink_acoustic_image_enhancement_tpu_torch.metrics import fid as tfid
from rethink_acoustic_image_enhancement_tpu_torch.models.asdqe import (
    DenoiseRatePredictor,
    init_weights_,
)
from rethink_acoustic_image_enhancement_tpu_torch.utils.image_io import imwrite

torch.set_num_threads(2)


def _images(n, size, seed):
    """Speckled fans on [0, 1], (n, size, size, 3) float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    fan = (np.abs(xx - size / 2) < (yy + 1) * 0.8).astype(np.float32)
    img = rng.gamma(2.0, 0.15, size=(n, size, size, 1)).clip(0, 1) * fan[..., None]
    return np.repeat(img, 3, axis=-1).astype(np.float32)


@pytest.mark.parametrize("n,d,shift", [(60, 8, 0.3), (40, 48, 0.0), (12, 48, 1.0), (30, 1, 0.5)])
def test_stats_and_fid_match_jax(n, d, shift):
    """Full-rank and rank-deficient covariances (12 samples of 48
    features), and one feature (where the JAX package raises)."""
    rng = np.random.default_rng(n + d)
    f1 = rng.normal(size=(n, d))
    f2 = rng.normal(size=(n, d)) * 1.3 + shift
    for a, b in zip(tfid.calculate_stats(f1), jfid.calculate_stats(f1)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    got = tfid.fid_between_feature_sets(f1, f2)
    if d == 1:  # a fault of the JAX package: sqrtm(..., disp=False) of 1x1
        (m1, s1), (m2, s2) = tfid.calculate_stats(f1), tfid.calculate_stats(f2)
        want = float((m1 - m2) @ (m1 - m2) + s1 + s2 - 2 * np.sqrt(s1 * s2))
        with pytest.raises(ValueError):
            jfid.fid_between_feature_sets(f1, f2)
    else:
        want = jfid.fid_between_feature_sets(f1, f2)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    scale = np.trace(np.atleast_2d(tfid.calculate_stats(f1)[1]))
    assert tfid.fid_between_feature_sets(f1, f1) == pytest.approx(0.0, abs=1e-6 * scale)
    with pytest.raises(ValueError, match="mismatched"):
        tfid.calculate_fid(*tfid.calculate_stats(f1), np.zeros(d + 1), np.eye(d + 1))


def test_zoo_feature_space_matches_jax(capsys):
    """The default space is the trained scorer: artifacts/torch_zoo/
    asdqe.pth in the port, the orbax directory it was exported from in
    JAX; 4 images of 64^2."""
    x = _images(4, 64, seed=1)
    port = tfid.make_asdqe_feature_fn(device="cpu")
    assert port.feature_space == f"asdqe-trained({tfid.ZOO_SCORER})"
    assert "[fid] feature space: asdqe-trained(" in capsys.readouterr().out
    jax_fn = jfid.make_asdqe_feature_fn()
    assert jax_fn.feature_space == f"asdqe-trained({shipped_asdqe_dir()})"
    got, want = port(x), jax_fn(x)
    assert got.shape == want.shape == (4, 48) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(port(x[0]), got[:1], rtol=1e-6, atol=1e-7)


def test_fallback_and_user_feature_spaces(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tfid, "ZOO_SCORER", str(tmp_path / "absent.pth"))
    fn = tfid.make_asdqe_feature_fn(seed=3, device="cpu")
    assert fn.feature_space == "asdqe-seeded-random(seed=3)"
    assert "[fid] feature space: asdqe-seeded-random(seed=3)" in capsys.readouterr().out
    mine = init_weights_(DenoiseRatePredictor(), torch.Generator().manual_seed(3))
    x = _images(2, 64, seed=2)
    np.testing.assert_array_equal(fn(x), tfid.make_asdqe_feature_fn(
        seed=3, device="cpu")(x))
    capsys.readouterr()
    user = tfid.make_asdqe_feature_fn(mine, device="cpu")
    assert user.feature_space == "asdqe-user-params"
    assert capsys.readouterr().out == ""
    np.testing.assert_array_equal(user(x), fn(x))
    assert mine.training  # the caller's module is left as it was


def test_fid_between_folders_matches_jax(tmp_path):
    """Two folders of 4 PNGs each, scored one image a forward in the zoo
    scorer's space."""
    dirs = []
    for k, shift in enumerate((0.0, 0.15)):
        d = tmp_path / f"set{k}"
        d.mkdir()
        for i, im in enumerate(_images(4, 64, seed=10 + k)):
            imwrite(str(d / f"{i:02d}.png"), np.clip(im + shift, 0, 1))
        dirs.append(str(d))
    fn = tfid.make_asdqe_feature_fn(device="cpu")
    got = tfid.fid_between_folders(*dirs, feature_fn=fn)
    want = jfid.fid_between_folders(*dirs)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-3)
    with pytest.raises(ValueError, match="need >=2 images"):
        tfid.fid_between_folders(dirs[0], str(tmp_path), feature_fn=fn)
