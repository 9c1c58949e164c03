"""The port's parts that the main models never call, against the flax
modules with the same parameters (carried across by convert/weights.py):
flow_warp, arch_utils and the embeds (CPU, float32, within 1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.models import arch_utils as jarch
from rethink_acoustic_image_enhancement_tpu.models import embeds as jembeds
from rethink_acoustic_image_enhancement_tpu.ops.warp import flow_warp as jax_flow_warp
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.models import arch_utils, embeds
from rethink_acoustic_image_enhancement_tpu_torch.ops.warp import flow_warp

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _seeded(module, *args, seed, collection="params"):
    """Seeded flax variables of ``module`` at ``args``' shapes, drawn with
    numpy (shapes from ``jax.eval_shape``: no eager init): kernels normal
    at 1/sqrt(fan_in), every other leaf (LN weights, temperatures, biases,
    position maps, BatchNorm statistics) off its init."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)[collection]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = leaf.shape
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("b,h,w,c", [(2, 10, 12, 3), (1, 7, 9, 5)])
def test_flow_warp_matches_jax(padding_mode, b, h, w, c):
    rng = np.random.default_rng(h)
    x = rng.random((b, h, w, c)).astype(np.float32)
    flow = (rng.random((b, h, w, 2)) * 6 - 3).astype(np.float32)
    ref = np.asarray(jax_flow_warp(jnp.asarray(x), jnp.asarray(flow), padding_mode))
    got = flow_warp(_nchw(x), torch.from_numpy(flow), padding_mode)
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


def test_flow_warp_agrees_with_grid_sample_and_refuses_bad_input():
    """The reference's own formulation (grid_sample, align_corners=True)
    within float32 rounding of the sample position."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((2, 3, 9, 11), dtype=np.float32))
    flow = torch.from_numpy((rng.random((2, 9, 11, 2)) * 4 - 2).astype(np.float32))
    gy, gx = torch.meshgrid(torch.arange(9.0), torch.arange(11.0), indexing="ij")
    grid = torch.stack((2 * (gx + flow[..., 0]) / 10 - 1, 2 * (gy + flow[..., 1]) / 8 - 1), -1)
    ref = torch.nn.functional.grid_sample(x, grid, align_corners=True)
    np.testing.assert_allclose(flow_warp(x, flow).numpy(), ref.numpy(), **TOL)
    with pytest.raises(ValueError, match="flow"):
        flow_warp(torch.zeros(1, 3, 4, 5), torch.zeros(1, 5, 4, 2))
    with pytest.raises(ValueError, match="padding_mode"):
        flow_warp(torch.zeros(1, 3, 4, 5), torch.zeros(1, 4, 5, 2), "reflection")


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_scaled_lecun_init_matches_flax_statistics(scale):
    shape = (64, 64, 3, 3)  # OIHW; flax's HWIO (3, 3, 64, 64), fan_in 576
    got = arch_utils.scaled_lecun_init(scale)(torch.empty(shape),
                                              torch.Generator().manual_seed(0))
    ref = np.asarray(jarch.scaled_lecun_init(scale)(jax.random.PRNGKey(0), (3, 3, 64, 64)))
    std = scale * (1 / 576) ** 0.5
    assert got.std().item() == pytest.approx(std, rel=0.03)
    assert float(ref.std()) == pytest.approx(std, rel=0.03)
    # truncated at two standard deviations of the untruncated normal
    bound = 2 * std / 0.87962566103423978
    assert got.abs().max().item() <= bound * (1 + 1e-6)
    assert float(np.abs(ref).max()) <= bound * (1 + 1e-6)


@pytest.mark.parametrize("res_scale", [1.0, 0.2])
def test_residual_block_and_make_layer_match_flax(res_scale):
    x = np.random.default_rng(3).random((2, 8, 10, 16)).astype(np.float32)
    stack = jarch.make_layer(jarch.ResidualBlockNoBN, 3, num_feat=16, res_scale=res_scale)
    p = _seeded(stack, jnp.asarray(x), seed=1)
    ref = np.asarray(stack.apply({"params": p}, jnp.asarray(x)))
    port = arch_utils.make_layer(arch_utils.ResidualBlockNoBN, 3, num_feat=16,
                                 res_scale=res_scale)
    assert [n for n, _ in port.named_children()] == ["0", "1", "2"]
    port.load_state_dict(weights.module_state_dict(p), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port(_nchw(x))), ref, **TOL)


def test_residual_block_init_scales_its_second_conv():
    torch.manual_seed(0)
    blk = arch_utils.ResidualBlockNoBN(num_feat=64)
    std = (1 / 576) ** 0.5
    assert blk.conv1.weight.std().item() == pytest.approx(std, rel=0.05)
    assert blk.conv2.weight.std().item() == pytest.approx(0.1 * std, rel=0.05)
    assert not blk.conv1.bias.any() and not blk.conv2.bias.any()


@pytest.mark.parametrize("variant", ["default", "wd"])
def test_sinusoidal_encodings_equal_jax(variant):
    np.testing.assert_array_equal(
        embeds.sinusoidal_position_encoding(8, 10, 6, variant),
        jembeds.sinusoidal_position_encoding(8, 10, 6, variant))
    for pos in (1, 3):
        np.testing.assert_array_equal(embeds.sinusoidal_time_encoding(pos, 6, 2.0),
                                      jembeds.sinusoidal_time_encoding(pos, 6, 2.0))


@pytest.mark.parametrize("variant,size", [("default", (16, 16)), ("default", (24, 20)),
                                          ("wd", (24, 20))])
def test_time_pose_embed_matches_flax(variant, size):
    kw = dict(in_frames=3, embed_dim=8, out_dim=16, base_size=(16, 16), variant=variant)
    x = np.random.default_rng(0).random((2, *size, 3)).astype(np.float32)
    m = jembeds.OverlapPatchTimePoseEmbed(**kw)
    init = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = embeds.OverlapPatchTimePoseEmbed(**kw)
    # the learned encodings start at the reference's sinusoids, as in flax
    fresh = port.state_dict()
    for name, val in weights.module_state_dict(init).items():
        if "embed_" in name:
            np.testing.assert_array_equal(fresh[name].numpy(), val.numpy())
    p = _seeded(m, jnp.asarray(x), seed=2)
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    port.load_state_dict(weights.module_state_dict(p), strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("which", ["BasicSpy", "WDSpybottle"])
def test_spy_blocks_match_flax(which, train):
    x = np.random.default_rng(1).random((2, 16, 16, 4)).astype(np.float32)
    if which == "BasicSpy":
        m, port = jembeds.BasicSpy(out_c=8), embeds.BasicSpy(4, 8)
    else:
        m, port = jembeds.WDSpybottle(in_dim=4, out_dim=6), embeds.WDSpybottle(4, 6)
    p = _seeded(m, jnp.asarray(x), seed=3)
    stats = _seeded(m, jnp.asarray(x), seed=4, collection="batch_stats")
    ref = m.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train,
                  mutable=["batch_stats"] if train else False)
    ref = np.asarray(ref[0] if train else ref)
    port.load_state_dict(weights.module_state_dict(p, stats), strict=True)
    port.train(train)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-5, atol=2e-5)
