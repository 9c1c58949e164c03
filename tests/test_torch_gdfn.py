"""Port LN+GDFN (``ops/gdfn.py``: plain version and gate) against the JAX
package on the CPU: the Pallas kernel in interpret mode where the LayerNorm
bias is zero, and the XLA composition (ChannelLayerNorm + GDFN) with
non-zero biases on every pixel, border ring included. The CUDA kernel
itself is held to the plain version in tests/test_torch_kernels_cuda.py and
by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.models.blocks import (
    GDFN,
    ChannelLayerNorm,
)
from rethink_acoustic_image_enhancement_tpu.ops.pallas import gdfn as jgdfn
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

torch.set_num_threads(2)

TOL = 5e-3  # tests/test_pallas_kernels.py's bar: bf16 operands


def _params(c, bias_free, seed, bias_scale):
    """Flax ChannelLayerNorm and GDFN parameter trees (numpy), the
    LayerNorm's weight and bias made non-trivial."""
    rng = np.random.default_rng(seed)
    ffn = GDFN(dim=c).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))
    ffn = jax.tree_util.tree_map(np.asarray, ffn["params"])
    ln = {"weight": (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)}
    if not bias_free:
        ln["bias"] = (bias_scale * rng.normal(size=c)).astype(np.float32)
    return ln, ffn


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _port(x, ln, ffn, bias_free, apply_ln=True):
    return pgdfn.fused_ln_gdfn(
        t(x), t(ln["weight"]), t(ln["bias"]) if "bias" in ln else None,
        *weights.gdfn_kernel_args(ffn), bias_free=bias_free,
        apply_ln=apply_ln).numpy()


def _pallas(x, ln, ffn, bias_free, apply_ln=True):
    return np.asarray(jgdfn.fused_ln_gdfn(
        jnp.asarray(x), jnp.asarray(ln["weight"]),
        jnp.asarray(ln["bias"]) if "bias" in ln else None,
        jnp.asarray(ffn["project_in"]["kernel"]),
        jnp.asarray(ffn["dwconv"]["kernel"]),
        jnp.asarray(ffn["project_out"]["kernel"]), bias_free=bias_free,
        apply_ln=apply_ln, interpret=True))


def _xla(x, ln, ffn, bias_free):
    c = x.shape[-1]
    xj = jnp.asarray(x)
    y = ChannelLayerNorm(c, bias_free).apply({"params": ln}, xj)
    return np.asarray(xj + GDFN(dim=c).apply({"params": ffn}, y))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _ring(a):
    m = np.ones(a.shape[1:3], bool)
    m[1:-1, 1:-1] = False
    return a[:, m]


@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape", [(1, 16, 24, 48), (2, 16, 24, 96)])
def test_gdfn_matches_pallas_interpret(shape, bias_free):
    """BiasFree, and WithBias with a zero bias (where the TPU kernel's
    zero-padded x is right)."""
    ln, ffn = _params(shape[-1], bias_free, seed=shape[0], bias_scale=0.0)
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    # bf16 operand rounding and the TPU kernel's one-pass LN variance
    assert _rel(_port(x, ln, ffn, bias_free), _pallas(x, ln, ffn, bias_free)) <= TOL


def test_gdfn_without_layernorm_matches_pallas_interpret():
    ln, ffn = _params(48, True, seed=2, bias_scale=0.0)
    x = np.random.default_rng(8).normal(size=(1, 16, 24, 48)).astype(np.float32)
    assert _rel(_port(x, ln, ffn, True, apply_ln=False),
                _pallas(x, ln, ffn, True, apply_ln=False)) <= TOL


@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape", [(1, 16, 24, 48), (2, 16, 24, 96),
                                   (1, 13, 9, 48)])
def test_gdfn_matches_xla_composition_on_every_pixel(shape, bias_free):
    """Non-zero LayerNorm bias: the depthwise conv sees 0 outside the image,
    so the border ring is as close as the interior."""
    ln, ffn = _params(shape[-1], bias_free, seed=shape[1], bias_scale=0.5)
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    got, ref = _port(x, ln, ffn, bias_free), _xla(x, ln, ffn, bias_free)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale
    assert np.abs(_ring(got) - _ring(ref)).max() <= TOL * scale


def test_gdfn_border_fault_of_the_tpu_kernel_is_not_carried_over():
    """The TPU kernel zero-pads x, so with a LayerNorm bias its depthwise
    conv sees W_in @ bias outside the image: its border ring is far off the
    XLA composition while the port's is not."""
    ln, ffn = _params(48, False, seed=16, bias_scale=0.5)
    x = np.random.default_rng(9).normal(size=(1, 16, 24, 48)).astype(np.float32)
    ref = _xla(x, ln, ffn, False)
    scale = np.abs(ref).max()
    ring_pallas = np.abs(_ring(_pallas(x, ln, ffn, False)) - _ring(ref)).max() / scale
    ring_port = np.abs(_ring(_port(x, ln, ffn, False)) - _ring(ref)).max() / scale
    print(f"border ring, relative max-abs error: TPU kernel {ring_pallas:.3e}, "
          f"port {ring_port:.3e}")
    assert ring_port <= TOL < 10 * TOL < ring_pallas


def test_gdfn_bf16_keeps_dtype():
    ln, ffn = _params(48, False, seed=4, bias_scale=0.5)
    x = np.random.default_rng(1).normal(size=(1, 8, 16, 48)).astype(np.float32)
    args = (t(ln["weight"]), t(ln["bias"]), *weights.gdfn_kernel_args(ffn))
    y16 = pgdfn.gdfn_plain(t(x).bfloat16(), *args, bias_free=False)
    y32 = pgdfn.gdfn_plain(t(x).bfloat16().float(), *args, bias_free=False)
    assert y16.dtype == torch.bfloat16
    assert _rel(y16.float().numpy(), y32.numpy()) <= 2.0 ** -7


@pytest.mark.parametrize("h,w,c", [
    (512, 512, 96), (256, 256, 96), (512, 512, 48), (128, 128, 192),
    (504, 384, 96), (64, 64, 384), (500, 380, 96), (256, 256, None),
    (100, 256, None)])
def test_gdfn_gate_matches_jax(h, w, c):
    assert stage_gate.supports_shape(h, w, c) == jgdfn.supports_shape(h, w, c)
    if c is not None:
        assert stage_gate.worthwhile(h, w, c) == jgdfn.worthwhile(h, w, c)


def test_gdfn_cpu_tensor_leaves_launch_counter_and_meta_raises():
    ln, ffn = _params(48, True, seed=6, bias_scale=0.0)
    pgdfn.fused_ln_gdfn.launches = 0
    _port(np.zeros((1, 8, 8, 48), np.float32), ln, ffn, True)
    assert pgdfn.fused_ln_gdfn.launches == 0
    with pytest.raises(ValueError):
        pgdfn.fused_ln_gdfn(
            torch.zeros(1, 8, 8, 48, device="meta"), t(ln["weight"]), None,
            *weights.gdfn_kernel_args(ffn))
