"""Port channel LayerNorm (``ops/layernorm.py``) against the JAX Pallas
kernel in interpret mode, on the CPU. The CUDA kernel itself is held to the
plain version in tests/test_torch_kernels_cuda.py and by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.ops.pallas import layernorm as jln
from rethink_acoustic_image_enhancement_tpu_torch.ops import layernorm as pln

torch.set_num_threads(2)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32)
    b = (0.5 * rng.normal(size=c)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape", [(1, 16, 24, 48), (2, 16, 24, 96),
                                   (3, 7, 5, 192), (40, 384)])
def test_layernorm_matches_pallas_interpret(shape, bias_free):
    x, w, b = _inputs(shape, seed=shape[-1] + bias_free)
    ref = np.asarray(jln.fused_channel_layernorm(
        jnp.asarray(x), jnp.asarray(w), None if bias_free else jnp.asarray(b),
        bias_free=bias_free, interpret=True))
    got = pln.fused_channel_layernorm(
        torch.from_numpy(x), torch.from_numpy(w),
        None if bias_free else torch.from_numpy(b), bias_free=bias_free)
    assert got.shape == x.shape and got.dtype == torch.float32
    # both take the two-pass variance in float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_layernorm_bf16_keeps_dtype_and_missing_bias_is_zero():
    x, w, _ = _inputs((1, 8, 8, 48), seed=3)
    xb = torch.from_numpy(x).bfloat16()
    got = pln.fused_channel_layernorm(xb, torch.from_numpy(w), None,
                                      bias_free=False)
    ref = np.asarray(jln.fused_channel_layernorm(
        jnp.asarray(xb.float().numpy()), jnp.asarray(w), None,
        bias_free=False, interpret=True))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the result
    assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -8 * np.abs(ref).max()


def test_layernorm_bias_free_ignores_bias():
    x, w, b = _inputs((4, 6, 48), seed=4)
    a = pln.fused_channel_layernorm(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), bias_free=True)
    c = pln.fused_channel_layernorm(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(a, c)


def test_layernorm_cpu_tensor_leaves_launch_counter_and_meta_raises():
    x, w, _ = _inputs((2, 4, 48), seed=5)
    pln.fused_channel_layernorm.launches = 0
    pln.fused_channel_layernorm(torch.from_numpy(x), torch.from_numpy(w))
    assert pln.fused_channel_layernorm.launches == 0
    with pytest.raises(ValueError):
        pln.fused_channel_layernorm(torch.zeros(2, 48, device="meta"),
                                    torch.from_numpy(w))
