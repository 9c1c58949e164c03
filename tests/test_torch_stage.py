"""Port stage (plain version, gate, stacking) against the JAX stage.

The JAX Pallas stage runs in interpret mode on the CPU. The CUDA kernel
itself is held to the plain version in tests/test_torch_stage_cuda.py and
by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rethink_acoustic_image_enhancement_tpu.models.blocks import TransformerBlock
from rethink_acoustic_image_enhancement_tpu.ops.pallas import stage as jstage
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage_gate

torch.set_num_threads(2)


def _block_params(c, heads, n_blocks, seed=0):
    """Seeded flax block params (numpy) with non-unit temperatures."""
    block = TransformerBlock(dim=c, num_heads=heads, bias_free_ln=True)
    params = []
    for i in range(n_blocks):
        p = block.init(jax.random.PRNGKey(seed + i),
                       jnp.zeros((1, 16, 16, c)))["params"]
        p = jax.tree_util.tree_map(np.asarray, p)
        p["attn"]["temperature"] = (np.arange(1, heads + 1, dtype=np.float32)
                                    .reshape(-1, 1, 1) * (0.5 + i))
        params.append(p)
    return block, params


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("heads,batch,n_blocks", [
    (1, 1, 3), (2, 1, 2), (4, 1, 2), (1, 3, 2)])
def test_plain_stage_matches_pallas_interpret(heads, batch, n_blocks):
    c = 48
    _, params = _block_params(c, heads, n_blocks, seed=heads * 10 + batch)
    x = np.random.default_rng(batch).normal(size=(batch, 16, 24, c)).astype(np.float32)
    ref = np.asarray(jstage.fused_transformer_stage(
        jnp.asarray(x), **jstage.stack_block_params(params), interpret=True))
    got = pstage.stage_plain(torch.from_numpy(x),
                             **pstage.stack_block_params(params)).numpy()
    # bf16 operand rounding and the TPU kernel's one-pass LN variance
    assert _rel(got, ref) <= 1e-2


@pytest.mark.parametrize("heads", [1, 2])
def test_plain_stage_matches_sequential_xla_blocks(heads):
    c = 48
    block, params = _block_params(c, heads, 3, seed=5)
    x = np.random.default_rng(2).normal(size=(2, 16, 24, c)).astype(np.float32)
    ref = jnp.asarray(x)
    for p in params:
        ref = block.apply({"params": p}, ref)
    got = pstage.fused_transformer_stage(
        torch.from_numpy(x), **pstage.stack_block_params(params)).numpy()
    assert _rel(got, np.asarray(ref)) <= 3e-2  # tests/test_stage_kernel.py's bar


def test_plain_stage_bf16_input_keeps_dtype():
    c = 48
    _, params = _block_params(c, 2, 2, seed=9)
    x = np.random.default_rng(4).normal(size=(1, 8, 16, c)).astype(np.float32)
    stacked = pstage.stack_block_params(params)
    y16 = pstage.stage_plain(torch.from_numpy(x).bfloat16(), **stacked)
    y32 = pstage.stage_plain(torch.from_numpy(x).bfloat16().float(), **stacked)
    assert y16.dtype == torch.bfloat16
    assert _rel(y16.float().numpy(), y32.numpy()) <= 2e-2


def test_stack_block_params_matches_jax():
    _, params = _block_params(32, 2, 3, seed=1)
    ref = jstage.stack_block_params(params)
    got = pstage.stack_block_params(params)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


_GATE_SHAPES = [
    (1, 512, 512, 96, 1), (1, 256, 256, 96, 2), (1, 512, 512, 48, 1),
    (1, 128, 128, 192, 4), (1, 504, 384, 96, 1), (1, 252, 192, 96, 2),
    (2, 256, 256, 96, 2), (1, 1024, 1024, 48, 1), (1, 256, 256, 192, 4),
    (1, 64, 64, 384, 8), (1, 500, 380, 96, 1), (1, 256, 256, 96, 5),
]


@pytest.mark.parametrize("shape", _GATE_SHAPES)
@pytest.mark.parametrize("bias_free", [True, False])
def test_gate_matches_jax(shape, bias_free):
    b, h, w, c, heads = shape
    for use_bias in (False, True):
        args = (b, h, w, c, heads, bias_free, use_bias, 2.66)
        assert (stage_gate.stage_worthwhile(*args)
                == jstage.stage_worthwhile(*args)), args


def test_gate_admits_the_five_flagship_stages():
    admitted = [s for s in _GATE_SHAPES[:6]
                if stage_gate.stage_worthwhile(*s, True, False)]
    assert admitted == [(1, 512, 512, 96, 1), (1, 256, 256, 96, 2),
                        (1, 504, 384, 96, 1)]


def test_cpu_tensor_leaves_launch_counter_at_zero():
    _, params = _block_params(48, 1, 1, seed=3)
    pstage.fused_transformer_stage.launches = 0
    x = torch.zeros(1, 8, 8, 48)
    pstage.fused_transformer_stage(x, **pstage.stack_block_params(params))
    assert pstage.fused_transformer_stage.launches == 0


def test_unknown_device_raises():
    _, params = _block_params(48, 1, 1, seed=3)
    x = torch.zeros(1, 8, 8, 48, device="meta")
    with pytest.raises(ValueError):
        pstage.fused_transformer_stage(x, **pstage.stack_block_params(params))
