"""The CUDA LayerNorm, GDFN and block kernels against their plain versions,
on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn
from rethink_acoustic_image_enhancement_tpu_torch.ops import layernorm as pln
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, device, *shape, scale=1.0, shift=0.0):
    a = rng.normal(size=shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(device)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _block_weights(rng, c, heads, bias_free, device):
    f = int(c * 2.66)
    bias = (lambda: None) if bias_free else (lambda: _t(rng, device, c, scale=0.5))
    return (_t(rng, device, c, scale=0.1, shift=1.0), bias(),
            _t(rng, device, 1, 1, c, 3 * c, scale=c ** -0.5),
            _t(rng, device, 3, 3, 1, 3 * c, scale=1 / 3),
            _t(rng, device, heads, 1, 1, scale=0.2, shift=1.0),
            _t(rng, device, 1, 1, c, c, scale=c ** -0.5),
            _t(rng, device, c, scale=0.1, shift=1.0), bias(),
            _t(rng, device, 1, 1, c, 2 * f, scale=c ** -0.5),
            _t(rng, device, 3, 3, 1, 2 * f, scale=1 / 3),
            _t(rng, device, 1, 1, f, c, scale=f ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape", [(1, 32, 48, 96), (3, 7, 5, 48), (37, 192),
                                   (2, 9, 384), (5, 8), (11, 1000)])
def test_layernorm_kernel_matches_plain(cuda, shape, bias_free, dtype):
    """Row counts that fill no warp, and 1 to 32 lanes to a row."""
    if dtype == torch.float32 and shape[-1] > 512:
        pytest.skip("float32 rows go up to 512 channels")
    rng = np.random.default_rng(shape[-1])
    x = _t(rng, cuda, *shape, scale=2.0, shift=0.5).to(dtype)
    w = _t(rng, cuda, shape[-1], scale=0.2, shift=1.0)
    b = None if bias_free else _t(rng, cuda, shape[-1], scale=0.5)
    before = pln.fused_channel_layernorm.launches
    got = pln.fused_channel_layernorm(x, w, b, bias_free=bias_free)
    torch.cuda.synchronize()
    assert pln.fused_channel_layernorm.launches == before + 1
    ref = pln.layernorm_plain(x, w, b, bias_free=bias_free)
    assert got.dtype == dtype and got.shape == x.shape
    # float32: another order of the sums; bf16: one ulp of the result
    assert _rel(got, ref) <= (1e-5 if dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.cuda
def test_layernorm_kernel_refuses_odd_widths(cuda):
    w = torch.ones(12, device=cuda)
    with pytest.raises(ValueError, match="multiple of"):
        pln.fused_channel_layernorm(torch.zeros(4, 12, device=cuda).bfloat16(), w)
    with pytest.raises(ValueError, match="at most"):
        pln.fused_channel_layernorm(torch.zeros(4, 516, device=cuda),
                                    torch.ones(516, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias_free,apply_ln", [(True, True), (False, True),
                                                (True, False)])
@pytest.mark.parametrize("shape", [(1, 32, 48, 96), (2, 20, 28, 48),
                                   (1, 13, 9, 192), (1, 12, 20, 384)])
def test_gdfn_kernel_matches_plain(cuda, shape, bias_free, apply_ln, dtype):
    """Partial tiles, both chunk widths (C = 384 takes 32) and a non-zero
    LayerNorm bias, whose border ring must see zeros."""
    c = shape[-1]
    f = int(c * 2.66)
    rng = np.random.default_rng(c + shape[1])
    x = _t(rng, cuda, *shape).to(dtype)
    args = (_t(rng, cuda, c, scale=0.1, shift=1.0),
            None if bias_free else _t(rng, cuda, c, scale=0.5),
            _t(rng, cuda, 1, 1, c, 2 * f, scale=c ** -0.5),
            _t(rng, cuda, 3, 3, 1, 2 * f, scale=1 / 3),
            _t(rng, cuda, 1, 1, f, c, scale=f ** -0.5))
    before = pgdfn.fused_ln_gdfn.launches
    got = pgdfn.fused_ln_gdfn(x, *args, bias_free=bias_free, apply_ln=apply_ln)
    torch.cuda.synchronize()
    assert pgdfn.fused_ln_gdfn.launches == before + 1
    ref = pgdfn.gdfn_plain(x, *args, bias_free=bias_free, apply_ln=apply_ln)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, ref) <= 1e-2
    ring = torch.ones(shape[1:3], dtype=torch.bool, device=cuda)
    ring[1:-1, 1:-1] = False
    assert _rel(got[:, ring], ref[:, ring]) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape", [(1, 52, 44, 96), (1, 504, 384, 96), (8, 64, 72, 96)])
def test_gdfn_kernel_on_ragged_edges_and_batches(cuda, shape, bias_free):
    """Heights and widths that are no multiple of the 8x8 tile, where the
    accumulator fragments' rows fall outside the image, and a batch."""
    c, f = 96, 255
    rng = np.random.default_rng(shape[1])
    x = _t(rng, cuda, *shape).bfloat16()
    args = (_t(rng, cuda, c, scale=0.1, shift=1.0),
            None if bias_free else _t(rng, cuda, c, scale=0.5),
            _t(rng, cuda, 1, 1, c, 2 * f, scale=c ** -0.5),
            _t(rng, cuda, 3, 3, 1, 2 * f, scale=1 / 3),
            _t(rng, cuda, 1, 1, f, c, scale=f ** -0.5))
    got = pgdfn.fused_ln_gdfn(x, *args, bias_free=bias_free)
    again = pgdfn.fused_ln_gdfn(x, *args, bias_free=bias_free)
    assert torch.equal(got, again)  # deterministic
    ref = pgdfn.gdfn_plain(x, *args, bias_free=bias_free)
    assert _rel(got, ref) <= 1e-2
    ring = torch.ones(shape[1:3], dtype=torch.bool, device=cuda)
    ring[1:-1, 1:-1] = False
    assert _rel(got[:, ring], ref[:, ring]) <= 1e-2


@pytest.mark.cuda
def test_two_blocks_are_resident_per_sm_at_96_channels(cuda):
    """What the device itself answers for the layouts the planners pick."""
    plan = pblock.plan_tiles(pblock.lib(), 96, 1)
    assert plan.apply_tile == (8, 8) and plan.apply_blocks >= 2
    assert plan.gram_blocks >= 1
    from rethink_acoustic_image_enhancement_tpu_torch.ops import _build
    fc, tile, blocks = pgdfn.plan_ffn(_build.bind("gdfn", pgdfn._SIGNATURES), 96)
    assert tile == (8, 8) and blocks >= 2
    # wider than the two-block layout reaches: one block per SM, still taken
    assert pblock.plan_tiles(pblock.lib(), 192, 4).apply_blocks >= 1


@pytest.mark.cuda
def test_gdfn_kernel_refuses_odd_channels(cuda):
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="multiple of 16"):
        pgdfn.fused_ln_gdfn(
            torch.zeros(1, 8, 8, 40, device=cuda), torch.ones(40, device=cuda), None,
            _t(rng, cuda, 40, 212), _t(rng, cuda, 3, 3, 212), _t(rng, cuda, 106, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape,heads", [
    ((1, 32, 48, 96), 1), ((1, 20, 28, 96), 2), ((1, 24, 40, 48), 2),
    ((1, 24, 40, 48), 4), ((1, 13, 9, 48), 8), ((1, 16, 16, 192), 4),
    ((1, 16, 24, 128), 1), ((1, 12, 20, 160), 5)])
def test_block_kernel_matches_plain(cuda, shape, heads, bias_free, dtype):
    """24, 12 and 6 channels a head go through the full Gram with the
    softmax masked per head; partial tiles and non-zero biases included.
    Above 96 channels several warps share a row of the residual; at 128
    channels in one head the Gram is too wide for the registers and
    accumulates in shared memory."""
    rng = np.random.default_rng(shape[1] * 10 + heads)
    wts = _block_weights(rng, shape[-1], heads, bias_free, cuda)
    x = _t(rng, cuda, *shape).to(dtype)
    before = pblock.fused_transformer_block.launches
    got = pblock.fused_transformer_block(x, *wts, bias_free=bias_free,
                                         num_heads=heads)
    torch.cuda.synchronize()
    assert pblock.fused_transformer_block.launches == before + 1
    ref = pblock.block_plain(x, *wts, bias_free=bias_free, num_heads=heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, ref) <= 1e-2
    ring = torch.ones(shape[1:3], dtype=torch.bool, device=cuda)
    ring[1:-1, 1:-1] = False
    assert _rel(got[:, ring], ref[:, ring]) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("shape", [(1, 52, 44, 96), (1, 504, 384, 96)])
def test_block_kernel_on_ragged_edges(cuda, shape, bias_free, dtype):
    """Heights and widths that are no multiple of the 8x8 tile: rows of the
    accumulator fragments that hold r fall outside the image, where the
    WithBias LayerNorms (non-zero biases here) must still give the
    depthwise steps zeros; the border ring is held separately. Twice the
    same call gives the same bits."""
    rng = np.random.default_rng(shape[2])
    wts = _block_weights(rng, 96, 1, bias_free, cuda)
    x = _t(rng, cuda, *shape).to(dtype)
    got = pblock.fused_transformer_block(x, *wts, bias_free=bias_free)
    again = pblock.fused_transformer_block(x, *wts, bias_free=bias_free)
    assert torch.equal(got, again)
    ref = pblock.block_plain(x, *wts, bias_free=bias_free)
    assert _rel(got, ref) <= 1e-2
    ring = torch.ones(shape[1:3], dtype=torch.bool, device=cuda)
    ring[1:-1, 1:-1] = False
    assert _rel(got[:, ring], ref[:, ring]) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((1, 40, 24, 96), 2), ((1, 52, 44, 96), 1)])
def test_block_kernel_equals_one_block_stage(cuda, shape, heads):
    rng = np.random.default_rng(7)
    wts = _block_weights(rng, 96, heads, True, cuda)
    x = _t(rng, cuda, *shape)
    one = pblock.fused_transformer_block(x, *wts, num_heads=heads)
    names = ("ln1_w", None, "w_qkv", "dw_qkv", "temperature", "w_proj", "ln2_w",
             None, "w_in", "w_dw", "w_out")
    stacked = {n: w[None] for n, w in zip(names, wts) if n}
    stage = pstage.fused_transformer_stage(x, **stacked)
    assert torch.equal(one, stage)


@pytest.mark.cuda
def test_block_kernel_refuses_batches_and_odd_channels(cuda):
    rng = np.random.default_rng(8)
    wts = _block_weights(rng, 48, 1, True, cuda)
    with pytest.raises(ValueError, match="batch 1"):
        pblock.fused_transformer_block(torch.zeros(2, 16, 16, 48, device=cuda), *wts)
    wts = _block_weights(rng, 40, 1, True, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        pblock.fused_transformer_block(torch.zeros(1, 16, 16, 40, device=cuda), *wts)
