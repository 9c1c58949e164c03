"""Port ops against the JAX ops on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.ops import attention as jattn
from rethink_acoustic_image_enhancement_tpu.ops import layout as jlayout
from rethink_acoustic_image_enhancement_tpu.ops import mask as jmask
from rethink_acoustic_image_enhancement_tpu.ops import norm as jnorm
from rethink_acoustic_image_enhancement_tpu_torch.ops import attention as pattn
from rethink_acoustic_image_enhancement_tpu_torch.ops import layout as playout
from rethink_acoustic_image_enhancement_tpu_torch.ops import mask as pmask
from rethink_acoustic_image_enhancement_tpu_torch.ops import norm as pnorm

torch.set_num_threads(2)


@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_layernorm(bias_free, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 7, 48)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32)
    b = None if bias_free else rng.normal(size=48).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = jnorm.channel_layernorm(jx, jnp.asarray(w),
                                  None if b is None else jnp.asarray(b))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = pnorm.channel_layernorm(tx, torch.from_numpy(w),
                                  None if b is None else torch.from_numpy(b))
    assert got.dtype == tx.dtype
    ref32 = np.asarray(ref.astype(jnp.float32))
    got32 = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got32, ref32, rtol=0, atol=1e-6 * np.abs(ref32).max())
    else:
        # both round the same float32 result to bf16: at most one bf16 ulp
        np.testing.assert_allclose(got32, ref32, rtol=2 ** -7, atol=1e-6)


def test_channel_layernorm_nchw_axis():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 16, 4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    a = pnorm.channel_layernorm(x, w, dim=1)
    b = pnorm.channel_layernorm(x.permute(0, 2, 3, 1), w).permute(0, 3, 1, 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_mdta_attention(heads):
    rng = np.random.default_rng(heads)
    q, k, v = (rng.normal(size=(2, 6, 5, 32)).astype(np.float32)
               for _ in range(3))
    temp = rng.uniform(0.5, 2.0, size=(heads, 1, 1)).astype(np.float32)
    ref = np.asarray(jattn.mdta_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          jnp.asarray(temp), heads))
    got = pattn.mdta_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(temp), heads).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_l2_normalize_pixels():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 30, 2, 8)).astype(np.float32)
    x[:, :, 0, 0] = 0.0  # all-zero channel: the eps clamp
    ref = np.asarray(jattn.l2_normalize_pixels(jnp.asarray(x)))
    got = pattn.l2_normalize_pixels(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_roundtrip_and_torch_order(r):
    rng = np.random.default_rng(r)
    x = rng.normal(size=(2, 8, 12, 3 * r * r)).astype(np.float32)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(playout.pixel_shuffle(tx, r).numpy(),
                                  np.asarray(jlayout.pixel_shuffle(jx, r)))
    np.testing.assert_array_equal(playout.pixel_unshuffle(tx, r).numpy(),
                                  np.asarray(jlayout.pixel_unshuffle(jx, r)))
    # torch channel order: equal to F.pixel_shuffle on the NCHW view
    nchw = tx.permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        playout.pixel_shuffle(tx, r).numpy(),
        F.pixel_shuffle(nchw, r).permute(0, 2, 3, 1).numpy())
    np.testing.assert_array_equal(
        playout.pixel_unshuffle(playout.pixel_shuffle(tx, r), r).numpy(), x)


@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("hw", [(13, 10), (16, 8), (9, 17)])
def test_pad_to_multiple_and_crop(mode, hw):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    ref, ref_pad = jlayout.pad_to_multiple(jnp.asarray(x), 8, mode=mode)
    got, got_pad = playout.pad_to_multiple(torch.from_numpy(x), 8, mode=mode)
    assert got_pad == ref_pad
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        playout.crop_to(got, *hw).numpy(),
        np.asarray(jlayout.crop_to(ref, *hw)))


def test_zero_mask():
    rng = np.random.default_rng(11)
    lq = rng.integers(0, 3, size=(20, 24, 3), dtype=np.uint8)
    lq[:5, :7] = 0
    gray = rng.integers(0, 2, size=(20, 24), dtype=np.uint8)
    out = rng.integers(0, 255, size=(40, 48, 3), dtype=np.uint8)
    for src in (lq, gray):
        np.testing.assert_array_equal(pmask.zero_mask_from_input(src),
                                      jmask.zero_mask_from_input(src))
    m = jmask.zero_mask_from_input(lq)
    np.testing.assert_array_equal(pmask.apply_zero_mask(out[:20, :24], m),
                                  jmask.apply_zero_mask(out[:20, :24], m))
    np.testing.assert_array_equal(pmask.apply_zero_mask(out, m, scale=2),
                                  jmask.apply_zero_mask(out, m, scale=2))
