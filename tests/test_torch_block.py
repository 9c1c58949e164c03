"""Port whole-block function (``ops/block.py``: plain version) and
``TransformerBlock(fused=...)`` against the JAX package on the CPU: the
Pallas block kernel in interpret mode where the LayerNorm biases are zero,
and the XLA composition (``TransformerBlock.apply``) with non-zero biases on
every pixel, border ring included. The CUDA kernels themselves are held to
the plain version in tests/test_torch_kernels_cuda.py and by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.models.blocks import (
    TransformerBlock as JaxBlock,
)
from rethink_acoustic_image_enhancement_tpu.ops.pallas import block as jblock
from rethink_acoustic_image_enhancement_tpu_torch.convert import weights
from rethink_acoustic_image_enhancement_tpu_torch.models import blocks as pblocks
from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

torch.set_num_threads(2)

TOL = 2e-2  # tests/test_megakernel.py's bar: bf16 operands through five products


def _params(c, heads, bias_free, seed, bias_scale):
    """One flax TransformerBlock parameter tree (numpy) with non-unit
    temperatures and LayerNorm weights, and LayerNorm biases of the given
    scale."""
    rng = np.random.default_rng(seed)
    block = JaxBlock(dim=c, num_heads=heads, bias_free_ln=bias_free)
    p = block.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, c)))["params"]
    p = jax.tree_util.tree_map(np.array, p)
    p["attn"]["temperature"] = (0.5 + rng.uniform(size=(heads, 1, 1))).astype(np.float32)
    for name in ("norm1", "norm2"):
        p[name]["weight"] = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
        if not bias_free:
            p[name]["bias"] = (bias_scale * rng.normal(size=c)).astype(np.float32)
    return block, p


def _args(p, conv):
    return (conv(p["norm1"]["weight"]),
            conv(p["norm1"]["bias"]) if "bias" in p["norm1"] else None,
            conv(p["attn"]["qkv"]["kernel"]), conv(p["attn"]["qkv_dwconv"]["kernel"]),
            conv(p["attn"]["temperature"]), conv(p["attn"]["project_out"]["kernel"]),
            conv(p["norm2"]["weight"]),
            conv(p["norm2"]["bias"]) if "bias" in p["norm2"] else None,
            conv(p["ffn"]["project_in"]["kernel"]), conv(p["ffn"]["dwconv"]["kernel"]),
            conv(p["ffn"]["project_out"]["kernel"]))


def _port(x, p, bias_free, heads):
    return pblock.fused_transformer_block(
        torch.from_numpy(x), *weights.block_kernel_args(p), bias_free=bias_free,
        num_heads=heads).numpy()


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _ring(a):
    m = np.ones(a.shape[1:3], bool)
    m[1:-1, 1:-1] = False
    return a[:, m]


@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("c,heads", [(48, 1), (48, 2), (48, 4), (48, 8), (96, 2)])
def test_block_matches_pallas_interpret(c, heads, bias_free):
    """BiasFree, and WithBias with zero biases (where the TPU kernel's
    zero-padded x is right); 24, 12 and 6 channels a head included."""
    _, p = _params(c, heads, bias_free, seed=heads, bias_scale=0.0)
    x = np.random.default_rng(c + heads).normal(size=(1, 16, 24, c)).astype(np.float32)
    ref = np.asarray(jblock.fused_transformer_block(
        jnp.asarray(x), *_args(p, jnp.asarray), bias_free=bias_free,
        num_heads=heads, interpret=True))
    # bf16 operand rounding and the TPU kernel's one-pass LN variance
    assert _rel(_port(x, p, bias_free, heads), ref) <= TOL


@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("c,heads,hw", [(48, 1, (16, 24)), (48, 4, (16, 24)),
                                        (96, 2, (16, 24)), (48, 8, (13, 9))])
def test_block_matches_xla_composition_on_every_pixel(c, heads, hw, bias_free):
    """Non-zero LayerNorm biases: both depthwise convs see 0 outside the
    image, so the border ring is as close as the interior."""
    block, p = _params(c, heads, bias_free, seed=10 + heads, bias_scale=0.5)
    x = np.random.default_rng(heads).normal(size=(1, *hw, c)).astype(np.float32)
    ref = np.asarray(block.apply({"params": p}, jnp.asarray(x)))
    got = _port(x, p, bias_free, heads)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale
    assert np.abs(_ring(got) - _ring(ref)).max() <= TOL * scale


def test_block_border_fault_of_the_tpu_kernel_is_not_carried_over():
    """The TPU kernel zero-pads x and masks LN2's ring but not LN1's, so
    with LayerNorm biases q, k and v are off on the border ring, and through
    the image-wide Gram and norms every pixel ends up further from the XLA
    composition than the port is anywhere."""
    block, p = _params(48, 1, False, seed=11, bias_scale=1.0)
    x = np.random.default_rng(1).normal(size=(1, 16, 24, 48)).astype(np.float32)
    ref = np.asarray(block.apply({"params": p}, jnp.asarray(x)))
    pallas = np.asarray(jblock.fused_transformer_block(
        jnp.asarray(x), *_args(p, jnp.asarray), bias_free=False, num_heads=1,
        interpret=True))
    got = _port(x, p, False, 1)
    scale = np.abs(ref).max()

    def ring_and_inside(a):
        d = np.abs(a - ref)
        return float(_ring(d).max() / scale), float(d[:, 1:-1, 1:-1].max() / scale)

    (ring_pallas, in_pallas), (ring_port, in_port) = ring_and_inside(pallas), ring_and_inside(got)
    print(f"relative max-abs error ring/inside: TPU kernel {ring_pallas:.3e}/"
          f"{in_pallas:.3e}, port {ring_port:.3e}/{in_port:.3e}")
    assert ring_port <= TOL and in_port <= TOL
    assert min(ring_pallas, in_pallas) > 5 * max(ring_port, in_port)


def test_block_equals_one_block_stage():
    _, p = _params(48, 2, True, seed=3, bias_scale=0.0)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 16, 24, 48)).astype(np.float32))
    one = pblock.block_plain(x, *weights.block_kernel_args(p), num_heads=2)
    stage = pstage.stage_plain(x, **pstage.stack_block_params([p]))
    assert torch.equal(one, stage)


def test_block_bf16_keeps_dtype_and_heads_must_divide():
    _, p = _params(48, 2, False, seed=4, bias_scale=0.5)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 8, 16, 48)).astype(np.float32))
    args = weights.block_kernel_args(p)
    y16 = pblock.block_plain(x.bfloat16(), *args, bias_free=False, num_heads=2)
    y32 = pblock.block_plain(x.bfloat16().float(), *args, bias_free=False, num_heads=2)
    assert y16.dtype == torch.bfloat16
    assert _rel(y16.float().numpy(), y32.numpy()) <= 2.0 ** -7
    with pytest.raises(ValueError):
        pblock.block_plain(x, *args, bias_free=False, num_heads=5)
    with pytest.raises(ValueError):
        pblock.block_plain(x, *args, bias_free=False, num_heads=4)  # 2 temperatures


def test_block_cpu_tensor_leaves_launch_counter_and_meta_raises():
    _, p = _params(48, 1, True, seed=5, bias_scale=0.0)
    pblock.fused_transformer_block.launches = 0
    _port(np.zeros((1, 8, 8, 48), np.float32), p, True, 1)
    assert pblock.fused_transformer_block.launches == 0
    with pytest.raises(ValueError):
        pblock.fused_transformer_block(
            torch.zeros(1, 8, 8, 48, device="meta"), *weights.block_kernel_args(p))


# ---- models/blocks.py::TransformerBlock(fused=...) ------------------------

def _port_module(c, heads, bias_free, p, fused):
    blk = pblocks.TransformerBlock(c, heads, bias_free_ln=bias_free, fused=fused)
    blk.load_state_dict(weights.block_state_dict(p), strict=True)
    return blk.eval()


@pytest.mark.parametrize("bias_free", [True, False])
def test_module_tree_feeds_the_block_function(bias_free):
    """flax tree -> module -> flax_block_tree gives the tree back, LN biases
    included."""
    _, p = _params(32, 2, bias_free, seed=6, bias_scale=0.5)
    tree = pblocks.flax_block_tree(_port_module(32, 2, bias_free, p, False))
    flat_ref = weights.flatten(p)
    flat_got = weights.flatten(tree)
    assert set(flat_got) == set(flat_ref)
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_got[k].detach().numpy(), v)


@pytest.mark.parametrize("bias_free", [True, False])
def test_fused_module_routes_by_the_gate(monkeypatch, bias_free):
    """fused=True goes through fused_transformer_block exactly where
    mega_worthwhile admits the shape, and then agrees with the JAX block."""
    c, heads = 48, 2
    block, p = _params(c, heads, bias_free, seed=7, bias_scale=0.5)
    x = np.random.default_rng(7).normal(size=(1, 16, 24, c)).astype(np.float32)
    calls = []
    real = pblocks.fused_transformer_block

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(pblocks, "fused_transformer_block", counted)
    fused = _port_module(c, heads, bias_free, p, True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        eager = fused(xt)  # 16x24 is below the gate's 256x256 pixels
        assert not calls
        monkeypatch.setattr(stage_gate, "mega_worthwhile", lambda *a, **kw: True)
        got = fused(xt)
        assert len(calls) == 1 and calls[0]["num_heads"] == heads
        assert calls[0]["bias_free"] == bias_free
        unfused = _port_module(c, heads, bias_free, p, False)(xt)
    assert torch.equal(unfused, eager)
    ref = np.asarray(block.apply({"params": p}, jnp.asarray(x)))
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= TOL
    assert _rel(eager.permute(0, 2, 3, 1).numpy(), ref) <= 1e-4


@pytest.mark.parametrize("args", [
    (1, 512, 512, 96, 1, True, False), (1, 256, 256, 96, 2, False, False),
    (2, 512, 512, 96, 1, True, False), (1, 512, 512, 96, 1, True, True),
    (1, 512, 512, 48, 1, True, False), (1, 128, 128, 192, 4, True, False),
    (1, 256, 256, 96, 5, True, False), (1, 500, 380, 96, 1, True, False)])
def test_block_gate_matches_jax(args):
    assert (stage_gate.mega_worthwhile(*args, 2.66)
            == jblock.mega_worthwhile(*args, 2.66))
