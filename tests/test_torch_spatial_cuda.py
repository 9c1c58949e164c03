"""The stage kernel on row bands against the whole-image kernel and against
its plain version, and spatially sharded serving, on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it also runs on a machine
without them:  python -m pytest --noconftest -m cuda tests/test_torch_spatial_cuda.py
Every test here is marked ``cuda`` and skips where there is no GPU. Bands
lie on the cards there are, in turn (all on one where there is one)."""

import numpy as np
import pytest
import torch

from rethink_acoustic_image_enhancement_tpu_torch.eval.infer import TeacherPredictor
from rethink_acoustic_image_enhancement_tpu_torch.models import KDLAETeacher, init_weights_
from rethink_acoustic_image_enhancement_tpu_torch.ops import stage as pstage
from rethink_acoustic_image_enhancement_tpu_torch.parallel.mesh import make_mesh
from rethink_acoustic_image_enhancement_tpu_torch.parallel.spatial import (
    LocalBands,
    join_rows,
    split_rows,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _devices(n):
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


def _weights(rng, n, c, heads, device):
    f = int(c * 2.66)

    def t(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device)

    return dict(
        ln1_w=t(n, c, scale=0.1, shift=1.0), w_qkv=t(n, 1, 1, c, 3 * c, scale=c ** -0.5),
        dw_qkv=t(n, 3, 3, 1, 3 * c, scale=1 / 3),
        temperature=t(n, heads, 1, 1, scale=0.2, shift=1.0),
        w_proj=t(n, 1, 1, c, c, scale=c ** -0.5), ln2_w=t(n, c, scale=0.1, shift=1.0),
        w_in=t(n, 1, 1, c, 2 * f, scale=c ** -0.5), w_dw=t(n, 3, 3, 1, 2 * f, scale=1 / 3),
        w_out=t(n, 1, 1, f, c, scale=f ** -0.5))


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_bands,heads", [
    ((1, 48, 40, 96), 2, 1), ((1, 40, 40, 96), 2, 1), ((2, 64, 24, 96), 4, 2),
    ((1, 48, 32, 192), 4, 4), ((1, 40, 24, 384), 2, 8)])
def test_band_kernel_matches_whole_kernel_and_plain(cuda, dtype, shape, n_bands, heads):
    """Band rows 24, 20 (4 mod 8: the last tile of a band is cut), 16, 12
    (4 mod 8) and 20 at 384 channels (the wide layout): the joined bands
    within 1e-2 of max|ref| of the whole-image kernel and of the band plain
    version on the same bands."""
    rng = np.random.default_rng(shape[1] * 10 + n_bands)
    bands = LocalBands(_devices(n_bands))
    wts = [_weights(np.random.default_rng(7), 2, shape[-1], heads, d) for d in bands.devices]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    whole = pstage.fused_transformer_stage(x, **wts[0])
    xs = split_rows(x, bands.devices, dim=1)
    before = pstage.fused_transformer_stage_bands.launches
    got = join_rows(pstage.fused_transformer_stage_bands(xs, wts, bands), cuda, dim=1)
    torch.cuda.synchronize()
    assert pstage.fused_transformer_stage_bands.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    plain = join_rows(pstage.stage_plain_bands(xs, wts, bands), cuda, dim=1)
    assert _rel(got, whole) <= 1e-2
    assert _rel(got, plain) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_band_is_the_whole_image_kernel(cuda, dtype):
    """One band (zero halo rows at both edges) runs the whole-image
    launches' arithmetic: the same bits."""
    rng = np.random.default_rng(3)
    wts = _weights(rng, 2, 96, 2, cuda)
    x = torch.from_numpy(rng.normal(size=(1, 36, 44, 96)).astype(np.float32)).to(cuda, dtype)
    bands = LocalBands([cuda])
    got = pstage.fused_transformer_stage_bands([x], [wts], bands)[0]
    assert torch.equal(got, pstage.fused_transformer_stage(x, **wts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_layout_matches_plain(cuda, dtype):
    """384 channels, 8 heads (the latent of a 2048^2 frame): the C x C
    weights go through the kernels in chunks; within 1e-2 of max|ref| of
    ``stage_plain``, and the same bits twice."""
    from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock

    plan = pblock.plan_tiles(pblock.lib(), 384, 8)
    assert plan.gram_chunk and plan.apply_chunk
    rng = np.random.default_rng(5)
    wts = _weights(rng, 2, 384, 8, cuda)
    x = torch.from_numpy(rng.normal(size=(1, 36, 28, 384)).astype(np.float32)).to(cuda, dtype)
    got = pstage.fused_transformer_stage(x, **wts)
    assert torch.equal(got, pstage.fused_transformer_stage(x, **wts))
    assert _rel(got, pstage.stage_plain(x, **wts)) <= 1e-2


@pytest.mark.cuda
def test_band_kernel_raises_rather_than_falls_back(cuda):
    """A shape the kernel does not take raises on the card: no plain
    version behind it."""
    rng = np.random.default_rng(4)
    bands = LocalBands(_devices(2))
    wts = [_weights(rng, 1, 96, 3, d) for d in bands.devices]  # C/heads = 32
    x = torch.zeros(1, 16, 16, 96, device=cuda)
    pstage.fused_transformer_stage_bands(split_rows(x, bands.devices, dim=1), wts, bands)
    wts = [_weights(rng, 1, 96, 4, d) for d in bands.devices]  # C/heads = 24
    with pytest.raises(ValueError, match="multiple of 16"):
        pstage.fused_transformer_stage_bands(split_rows(x, bands.devices, dim=1), wts, bands)
    with pytest.raises(ValueError, match="differ in shape"):
        pstage.fused_transformer_stage_bands(
            [x[:, :8], x[:, :6]], [wts[0], wts[0]], LocalBands([cuda, cuda]))


@pytest.mark.cuda
def test_spatial_predictor_matches_one_device(cuda):
    """A narrow bf16 teacher whose 96-channel stages the gate admits at
    256^2, fused, on 2 bands against one device: within 1 level on >= 99%
    of 'hq' and 'sr', the band kernel called where the gate admits."""
    model = KDLAETeacher(dim=48, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                         heads=(1, 2, 4, 8), layernorm_type="BiasFree", static="train",
                         params="cat")
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16)
    rng = np.random.default_rng(5)
    img = (rng.random((256, 256, 3)) * 255).astype(np.uint8)
    one = TeacherPredictor(model, fused=True, dtype=torch.bfloat16, device=cuda)(img, 0.8)
    before = pstage.fused_transformer_stage_bands.launches
    pred = TeacherPredictor(model, fused=True, dtype=torch.bfloat16,
                            mesh=make_mesh(n_spatial=2, devices=_devices(2)))
    got = pred(img, 0.8)
    # decoder_level1, refinement, refinement_out: 96 channels at 256^2
    assert pstage.fused_transformer_stage_bands.launches == before + 3
    for key in ("hq", "sr"):
        d = np.abs(got[key].astype(np.int16) - one[key].astype(np.int16))
        assert (d <= 1).mean() >= 0.99, key
