"""The port's training augmentations against the JAX package's: the
deterministic cores (mix at a given lam and permutation, crop at given
offsets, mask by a given keep) fed JAX's own draws, exact to float32
rounding; and the port's drawing wrappers fed the same draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.ops import mask as jmask
from rethink_acoustic_image_enhancement_tpu.train import mixup as jmix
from rethink_acoustic_image_enhancement_tpu.train import progressive as jprog
from rethink_acoustic_image_enhancement_tpu_torch.ops import mask as tmask
from rethink_acoustic_image_enhancement_tpu_torch.train import mixup as tmix
from rethink_acoustic_image_enhancement_tpu_torch.train import progressive as tprog

TOL = 1e-6


def _batch(seed, b=4, h=16, w=16):
    rng = np.random.default_rng(seed)
    lq = {"img": rng.random((b, h, w, 3)).astype(np.float32),
          "denoise_rate": np.repeat(rng.random((b, 1, 1, 1)), h, 1).repeat(
              w, 2).astype(np.float32)}
    gt = {"hq": rng.random((b, h, w, 3)).astype(np.float32),
          "sr": rng.random((b, 2 * h, 2 * w, 3)).astype(np.float32)}
    return lq, gt


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in tree.items()}


def _close(port_tree, jax_tree):
    for k, v in jax_tree.items():
        np.testing.assert_allclose(port_tree[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(v), rtol=TOL, atol=TOL)


class _Fake:
    """A numpy-generator stand-in that hands out given draws."""

    def __init__(self, ints=(), beta=None, perm=None, uniform=None):
        self.ints, self._beta, self._perm = list(ints), beta, perm
        self._uniform = uniform

    def integers(self, lo, hi):
        return self.ints.pop(0)

    def beta(self, a, b):
        return self._beta

    def permutation(self, n):
        return self._perm

    def random(self, shape, dtype=None):
        return self._uniform


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_core_with_jax_draws(seed):
    lq, gt = _batch(seed)
    key = jax.random.PRNGKey(seed)
    want_gt, want_lq = jmix.mixing_augment(key, gt, lq, 1.2, use_identity=False)
    _, r_lam, r_perm = jax.random.split(key, 3)
    lam = float(jax.random.beta(r_lam, 1.2, 1.2))
    perm = np.asarray(jax.random.permutation(r_perm, 4))
    _close(tmix._mix_tree(_t(gt), lam, perm), want_gt)
    _close(tmix._mix_tree(_t(lq), lam, perm), want_lq)
    # the drawing wrapper, fed the same lam and permutation
    got_gt, got_lq = tmix.mixing_augment(_Fake(beta=lam, perm=perm), _t(gt),
                                         _t(lq), 1.2, use_identity=False)
    _close(got_gt, want_gt)
    _close(got_lq, want_lq)


@pytest.mark.parametrize("seed", range(4))
def test_mixup_identity_branch(seed):
    """use_identity: JAX's 50% choice; the port, fed the same choice, mixes
    or returns its inputs unchanged."""
    lq, gt = _batch(seed)
    key = jax.random.PRNGKey(seed)
    want_gt, want_lq = jmix.mixing_augment(key, gt, lq, 1.2, use_identity=True)
    r_choice, r_lam, r_perm = jax.random.split(key, 3)
    choice = int(jax.random.randint(r_choice, (), 0, 2))
    lam = float(jax.random.beta(r_lam, 1.2, 1.2))
    perm = np.asarray(jax.random.permutation(r_perm, 4))
    got_gt, got_lq = tmix.mixing_augment(
        _Fake(ints=[choice], beta=lam, perm=perm), _t(gt), _t(lq), 1.2,
        use_identity=True)
    _close(got_gt, want_gt)
    _close(got_lq, want_lq)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mini", [8, 12])
def test_stage_crop_with_jax_offsets(seed, mini):
    """Crops of lq at (y0, x0), of hq at scale 1 and of sr at 2 (y0, x0)."""
    lq, gt = _batch(seed)
    key = jax.random.PRNGKey(seed)
    want_lq, want_gt = jprog.stage_crop(lq, gt, key, 16, mini, scale=1)
    ry, rx = jax.random.split(key)
    y0 = int(jax.random.randint(ry, (), 0, 16 - mini))
    x0 = int(jax.random.randint(rx, (), 0, 16 - mini))
    got_lq, got_gt = tprog.stage_crop(_t(lq), _t(gt), _Fake(ints=[y0, x0]), 16,
                                      mini, scale=1)
    _close(got_lq, want_lq)
    _close(got_gt, want_gt)
    core = tprog.crop_at(_t(gt)["sr"], y0, x0, mini, 2)
    np.testing.assert_array_equal(core.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_gt["sr"]))


def test_stage_crop_at_full_size_is_identity():
    lq, gt = _batch(0)
    got_lq, got_gt = tprog.stage_crop(_t(lq), _t(gt), None, 16, 16)
    _close(got_lq, lq)
    _close(got_gt, gt)


@pytest.mark.parametrize("prob", [0.05, 0.3, 1.0])
def test_mask_core_with_jax_keep(prob):
    img = np.random.default_rng(7).random((2, 10, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jmask.input_mask(jnp.asarray(img), key, prob)
    keep = np.asarray(jax.random.uniform(key, img.shape, jnp.float32) >= prob)
    got = tmask.mask_with_keep(torch.from_numpy(img), torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the drawing wrapper, fed the same uniform draw
    u = np.asarray(jax.random.uniform(key, img.shape, jnp.float32))
    got = tmask.input_mask(torch.from_numpy(img), _Fake(uniform=u), prob)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_stage_extra_mask_on_img_only_and_off_at_zero():
    lq, _ = _batch(3)
    key = jax.random.PRNGKey(3)
    want = jprog.stage_extra_mask(lq, key, 0.2)
    u = np.asarray(jax.random.uniform(key, lq["img"].shape, jnp.float32))
    u = np.ascontiguousarray(u.transpose(0, 3, 1, 2))  # the port's NCHW draw
    got = tprog.stage_extra_mask(_t(lq), _Fake(uniform=u), 0.2)
    _close(got, want)
    same = tprog.stage_extra_mask(_t(lq), None, 0.0)  # draws nothing
    _close(same, lq)


def test_input_mask_np_matches():
    img = np.random.default_rng(1).random((6, 7)).astype(np.float32)
    got = tmask.input_mask_np(img, np.random.default_rng(5), 0.4)
    want = jmask.input_mask_np(img, np.random.default_rng(5), 0.4)
    np.testing.assert_array_equal(got, want)


def test_subsample_numpy_and_torch():
    lq, gt = _batch(4)
    idx = np.array([3, 1])
    want = jprog.subsample_batch(gt, idx)
    got_np = tprog.subsample_batch(gt, idx)
    got_t = tprog.subsample_batch(_t(gt), idx)
    for k in gt:
        np.testing.assert_array_equal(got_np[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got_t[k].permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want[k]))
