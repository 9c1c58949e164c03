"""The CUDA stage kernel against its plain version, on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_stage_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage


def _weights(rng, n, c, heads, device):
    f = int(c * 2.66)

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    return dict(
        ln1_w=t(n, c, scale=0.1, shift=1.0),
        w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
        dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
        w_proj=t(n, 1, 1, c, c, scale=c ** -0.5),
        ln2_w=t(n, c, scale=0.1, shift=1.0),
        w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5),
        w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
        w_out=t(n, 1, 1, f, c, scale=f ** -0.5),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,heads", [
    ((1, 32, 48, 96), 1), ((2, 20, 28, 96), 2), ((1, 24, 40, 192), 4),
    ((1, 13, 9, 48), 3)])
def test_kernel_matches_plain(cuda, dtype, shape, heads):
    """Partial tiles (20x28, 13x9) and several head widths included."""
    rng = np.random.default_rng(shape[1] * 100 + heads)
    wts = _weights(rng, 2, shape[-1], heads, cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    before = pstage.fused_transformer_stage.launches
    got = pstage.fused_transformer_stage(x, **wts)
    torch.cuda.synchronize()
    assert pstage.fused_transformer_stage.launches == before + 1
    ref = pstage.stage_plain(x, **wts)
    assert got.dtype == dtype and got.shape == x.shape
    rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [
    ((1, 52, 44, 96), 1), ((1, 504, 384, 96), 1), ((8, 256, 256, 96), 1),
    ((2, 52, 44, 96), 2)])
def test_kernel_on_ragged_edges_and_tile_batches(cuda, shape, heads):
    """Two blocks in bf16 at the model's width: heights and widths that are no
    multiple of the 8x8 tile (the padded 500x380 request is 504x384), and the
    batch of 8 tiles that tiled serving sends."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    wts = _weights(rng, 2, 96, heads, cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda).bfloat16()
    got = pstage.fused_transformer_stage(x, **wts)
    ref = pstage.stage_plain(x, **wts)
    rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 64, 64, 96), torch.float32), ((1, 52, 44, 96), torch.bfloat16),
    ((8, 40, 24, 96), torch.bfloat16)])
def test_kernel_is_deterministic(cuda, shape, dtype):
    """Three launches a block and no atomics: the same call twice gives the
    same bits."""
    rng = np.random.default_rng(5)
    wts = _weights(rng, 2, 96, 2, cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    a = pstage.fused_transformer_stage(x, **wts)
    b = pstage.fused_transformer_stage(x, **wts)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_unsupported_head_width_raises(cuda):
    rng = np.random.default_rng(6)
    wts = _weights(rng, 1, 48, 4, cuda)  # 12 channels per head
    x = torch.zeros(1, 16, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        pstage.fused_transformer_stage(x, **wts)
