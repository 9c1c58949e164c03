"""The Hopper kernels (A) and (C) at C = 96 (``csrc/stage_sm90.cu``) against
the plain versions, on an NVIDIA GPU, at the shapes of a 512^2 teacher
request's stages and of the padded 500 x 380 frame.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_stage_sm90_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU."""

import ctypes

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import LocalBands

TOL = 1e-2  # of max|ref|: bf16 operands, sums in another order than the plain version's


def _weights(rng, n, c, heads, device, bias=False):
    f = int(c * 2.66)

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    w = dict(ln1_w=t(n, c, scale=0.1, shift=1.0), w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
             dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
             temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
             w_proj=t(n, 1, 1, c, c, scale=c ** -0.5), ln2_w=t(n, c, scale=0.1, shift=1.0),
             w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5), w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
             w_out=t(n, 1, 1, f, c, scale=f ** -0.5))
    if bias:
        w.update(ln1_b=t(n, c, scale=0.5), ln2_b=t(n, c, scale=0.5))
    return w


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_library_agrees_with_the_host_on_the_tile(cuda):
    lib = pblock.wg_lib()
    vals = [ctypes.c_int() for _ in range(4)]
    assert lib.raie_stage_sm90_geometry(*[ctypes.byref(v) for v in vals]) == 0
    th, tw, fc, threads = (v.value for v in vals)
    assert (th, tw) == pblock.WGMMA_TILE and fc == pblock.WGMMA_FC and threads == 512
    assert lib.raie_stage_sm90_blocks_per_sm() == 1
    assert lib.raie_stage_sm90_gram_blocks_per_sm() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,n,heads", [
    ((1, 512, 512, 96), 4, 1), ((1, 256, 256, 96), 6, 2), ((8, 256, 256, 96), 4, 1),
    ((1, 504, 384, 96), 2, 6)])
def test_stage_matches_plain_and_repeats_its_bits(cuda, dtype, shape, n, heads):
    rng = np.random.default_rng(shape[1] + n * 10 + heads)
    wts = _weights(rng, n, 96, heads, cuda)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    before = pstage.fused_transformer_stage.launches
    got = pstage.fused_transformer_stage(x, **wts)
    torch.cuda.synchronize()
    assert pstage.fused_transformer_stage.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got).all()
    assert _rel(got, pstage.stage_plain(x, **wts)) <= TOL
    assert torch.equal(got, pstage.fused_transformer_stage(x, **wts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_free", [True, False])
@pytest.mark.parametrize("heads", [1, 2, 4, 6])
def test_block_matches_plain(cuda, dtype, bias_free, heads):
    """Both LayerNorms; 4 heads (24 channels) take the full Gram masked per
    head; a ragged 44 x 70 frame cuts the last tiles in both directions."""
    names = ("ln1_w", "ln1_b", "w_qkv", "dw_qkv", "temperature", "w_proj", "ln2_w", "ln2_b",
             "w_in", "w_dw", "w_out")
    rng = np.random.default_rng(heads * 2 + bias_free)
    wts = {k: v[0] for k, v in _weights(rng, 1, 96, heads, cuda, bias=not bias_free).items()}
    args = tuple(wts.get(k) for k in names)
    x = torch.from_numpy(rng.normal(size=(1, 44, 70, 96)).astype(np.float32)).to(cuda, dtype)
    got = pblock.fused_transformer_block(x, *args, bias_free=bias_free, num_heads=heads)
    ref = pblock.block_plain(x, *args, bias_free=bias_free, num_heads=heads)
    assert got.dtype == dtype and _rel(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_band_is_the_whole_image(cuda, dtype):
    rng = np.random.default_rng(11)
    wts = _weights(rng, 2, 96, 2, cuda)
    x = torch.from_numpy(rng.normal(size=(1, 52, 100, 96)).astype(np.float32)).to(cuda, dtype)
    got = pstage.fused_transformer_stage_bands([x], [wts], LocalBands([cuda]))[0]
    assert torch.equal(got, pstage.fused_transformer_stage(x, **wts))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [2, 4])
def test_bands_match_the_whole_image(cuda, n_bands):
    """Bands of 63 and 31 rows: halo rows read from the neighbours, zeros
    only at the image's edges."""
    rng = np.random.default_rng(n_bands)
    bands = LocalBands([cuda] * n_bands)
    wts = _weights(rng, 2, 96, 1, cuda)
    x = torch.from_numpy(rng.normal(size=(1, 252, 96, 96)).astype(np.float32)).to(cuda)
    whole = pstage.fused_transformer_stage(x, **wts)
    got = torch.cat(pstage.fused_transformer_stage_bands(list(x.chunk(n_bands, 1)),
                                                         [wts] * n_bands, bands), 1)
    assert _rel(got, whole) <= TOL
